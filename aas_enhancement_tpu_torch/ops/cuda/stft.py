"""STFT and ISTFT: CUDA kernels (``csrc/stft.cu``, ``csrc/istft.cu``) and their
plain versions.

Replace ``aas_enhancement_tpu/ops/pallas/stft_kernel.py::stft_pallas`` and
``::istft_pallas``.  ``stft``/``istft`` here take the kernel for a CUDA tensor
and the plain segment-DFT (``dsp/stft.py``, re-exported as ``stft_plain`` and
``istft_plain``) for a CPU tensor; without a wanted gradient they go through
the operators ``aas_torch::stft`` / ``aas_torch::istft`` (``ops/library.py``),
whose CUDA implementations are ``stft_kernel`` / ``istft_kernel``.  Each
launcher counts its launches in the wrapper's ``.launches``.

Both kernels compute each frame's transform in two stages for n_fft =
n1 * n2 (``stft_factors`` picks the pair that needs the fewest operations;
320 = 32 x 10), the ISTFT as the adjoint of the STFT's stages, and take the
direct sum only where no pair saves operations (a prime n_fft) or, for the
ISTFT, where more than 8 frames cover a sample (``istft_route``); the rule is
on the shape alone and ``stft.route`` / ``istft.route`` hold the last
launch's (n1, n2), (0, 0) for direct.  Their bases come from one f32 table
built on the host once per (n_fft, device) (``dft_table``).  The STFT's
center reflect pad is index arithmetic inside the kernel's loads, and the
ISTFT kernel writes the trimmed output (center trim, then cut or zero-pad to
``length``), so each wrapper launches one kernel and no copy.
``stft_factorised_plain`` and ``istft_factorised_plain`` follow the kernels'
arithmetic step by step in plain PyTorch (index maps, twiddles, real-input
symmetry, mirrored indices) and are what the CPU tests hold to the plain
segment DFT and to the JAX package.

Gradients (no TPU counterpart: the JAX package differentiates its matmul-DFT
with XLA): on the card a wanted gradient takes an autograd Function whose
backward is a kernel of its own, the adjoint of the forward's linear map.
``stft_vjp`` (``csrc/istft.cu``: the inverse transform's stages with weight
1 on every bin, the window, an overlap-add with no division, and the reflect
pad folded back) and ``istft_vjp`` (``csrc/stft.cu``: the trim undone, the
COLA divide, the window, the forward transform's stages, each bin scaled by
g_k / n_fft).  ``stft_vjp_plain`` and ``istft_vjp_plain`` write the same
adjoints out in plain PyTorch; CPU tensors take them, and the CPU tests hold
them to ``torch.autograd`` through ``stft_plain`` / ``istft_plain`` and to
``jax.vjp`` of the JAX package's functions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from aas_enhancement_tpu_torch.dsp.stft import (
    _check_hop, _dft_bases_np, cola_norm, get_window, inverse_weights, istft as istft_plain,
    num_frames, stft as stft_plain, trim)
from aas_enhancement_tpu_torch.ops import library
from aas_enhancement_tpu_torch.ops.dispatch import check_kernel_inputs, uses_kernel
from aas_enhancement_tpu_torch.utils import kernel_build

__all__ = ["stft", "istft", "stft_kernel", "istft_kernel", "stft_plain", "istft_plain",
           "stft_factorised_plain", "istft_factorised_plain", "stft_vjp", "istft_vjp",
           "stft_vjp_plain", "istft_vjp_plain", "stft_factors", "istft_route", "dft_table",
           "reflect_index"]

ISTFT_MAX_OVERLAP = 8      # frames over a sample that the factorised ISTFT kernel takes


@functools.lru_cache(maxsize=8)
def _window(name: str, n_fft: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(get_window(name, n_fft)).to(device)


@functools.lru_cache(maxsize=8)
def dft_table(n_fft: int) -> np.ndarray:
    """W_N^m = (cos, -sin)(2 pi m / N) for m < N as float32 [N, 2], computed in
    double precision: exact to f32 rounding."""
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _table(n_fft: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(dft_table(n_fft)).to(device)


@functools.lru_cache(maxsize=64)
def stft_factors(n_fft: int) -> tuple[int, int]:
    """(n1, n2) with n1 * n2 = n_fft for the two-stage transform, or (0, 0)
    for the direct sum.  Per frame the stages cost n2 (n1/2+1) n1 2 FMAs
    (real n1-point DFTs, k1 <= n1/2) and (n1/2+1) n2 n2 4 FMAs (complex
    n2-point DFTs); the direct sum (n_fft/2+1) n_fft 2.  The cheapest pair is
    taken if it is cheaper than the direct sum: 320 -> (32, 10), 17,680 FMAs
    for 103,040; a prime, or 2 x a prime, -> (0, 0)."""
    best, best_cost = (0, 0), (n_fft // 2 + 1) * n_fft * 2
    for n1 in range(2, n_fft // 2 + 1):
        if n_fft % n1:
            continue
        n2 = n_fft // n1
        k1 = n1 // 2 + 1
        cost = n2 * k1 * n1 * 2 + k1 * n2 * n2 * 4
        if cost < best_cost:
            best, best_cost = (n1, n2), cost
    return best


def istft_route(n_fft: int, hop_length: int) -> tuple[int, int]:
    """The ISTFT kernel's route: ``stft_factors(n_fft)`` where at most
    ``ISTFT_MAX_OVERLAP`` frames cover a sample, else (0, 0), the direct sum."""
    if n_fft // hop_length > ISTFT_MAX_OVERLAP:
        return 0, 0
    return stft_factors(n_fft)


def reflect_index(pos: torch.Tensor, n: int) -> torch.Tensor:
    """Positions in a reflect-padded signal of n samples (relative to its
    first real sample, so -n < pos < 2n - 1) -> the real samples they mirror."""
    pos = pos.abs()
    return torch.where(pos >= n, 2 * (n - 1) - pos, pos)


def stft_factorised_plain(x: torch.Tensor, n_fft: int, hop_length: int,
                          window: str = "hann", center: bool = True
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch: [B, n] -> (re, im)
    [B, T, n_fft//2+1].  Frames through mirrored indices; for n_fft = n1 n2,
    n = n2 i1 + i2 and k = k1 + n1 k2: n1-point DFTs of the real data for
    k1 <= n1/2, the twiddles W_N^(i2 k1), n2-point complex DFTs, and the bins
    above n_fft/2 stored conjugated at n_fft - k.  Direct sum from the same
    table where ``stft_factors`` gives (0, 0)."""
    _check_hop(n_fft, hop_length)
    x = x.to(torch.float32)
    b, n = x.shape
    t = num_frames(n, n_fft, hop_length, center)
    shift = n_fft // 2 if center else 0
    pos = torch.arange(t)[:, None] * hop_length + torch.arange(n_fft)[None] - shift
    inside = pos < n + shift      # an odd n_fft's last frame ends one past the padded signal
    pos = reflect_index(pos.clamp(max=n + shift - 1), n)
    win = torch.from_numpy(get_window(window, n_fft))
    frames = (x[:, pos.to(x.device)] * (win * inside).to(x.device))      # [B, T, N]
    tab = torch.from_numpy(dft_table(n_fft)).to(x.device)
    n_bins = n_fft // 2 + 1
    n1, n2 = stft_factors(n_fft)
    if n1 == 0:
        idx = (torch.arange(n_fft)[:, None] * torch.arange(n_bins)[None]) % n_fft
        return frames @ tab[idx, 0], frames @ tab[idx, 1]
    ks1 = torch.arange(n1 // 2 + 1)
    w1 = tab[((torch.arange(n1)[:, None] * ks1[None]) % n1) * n2]        # [i1, k1, 2]
    xs = frames.reshape(b, t, n1, n2)                                    # [.., i1, i2]
    a_re = torch.einsum("btij,ik->btkj", xs, w1[..., 0])                 # [.., k1, i2]
    a_im = torch.einsum("btij,ik->btkj", xs, w1[..., 1])
    tw = tab[ks1[:, None] * torch.arange(n2)[None]]                      # [k1, i2, 2]
    a_re, a_im = a_re * tw[..., 0] - a_im * tw[..., 1], a_re * tw[..., 1] + a_im * tw[..., 0]
    w2 = tab[((torch.arange(n2)[:, None] * torch.arange(n2)[None]) % n2) * n1]   # [i2, k2, 2]
    x_re = a_re @ w2[..., 0] - a_im @ w2[..., 1]                         # [.., k1, k2]
    x_im = a_re @ w2[..., 1] + a_im @ w2[..., 0]
    k = ks1[:, None] + n1 * torch.arange(n2)[None]                       # [k1, k2]
    direct = k < n_bins
    mirrored = ~direct & (ks1[:, None] != 0) & (2 * ks1[:, None] != n1)
    re = x.new_zeros((b, t, n_bins))
    im = x.new_zeros((b, t, n_bins))
    re[..., k[direct]] = x_re[..., direct]
    im[..., k[direct]] = x_im[..., direct]
    re[..., n_fft - k[mirrored]] = x_re[..., mirrored]
    im[..., n_fft - k[mirrored]] = -x_im[..., mirrored]
    return re, im


def istft_factorised_plain(re: torch.Tensor, im: torch.Tensor, n_fft: int,
                           hop_length: int, window: str = "hann", center: bool = True,
                           length: int | None = None) -> torch.Tensor:
    """The ISTFT kernel's arithmetic in plain PyTorch: (re, im)
    [B, T, n_fft//2+1] -> wav [B, num_samples].  Spectra scaled by 1/n_fft and
    extended by Y[N - k] = conj(Y[k]); for n_fft = n1 n2, n = n2 i1 + i2 and
    k = k1 + n1 k2: n2-point complex inverse DFTs over k2 for k1 <= n1/2, the
    twiddles conj(W_N^(i2 k1)), the rows 0 < k1 < n1/2 weighted 2 for their
    mirrors, and n1-point DFTs keeping the real part; the direct sum (weights
    1 at DC and Nyquist, 2 elsewhere) from the same table where ``istft_route``
    gives (0, 0).  Then window, overlap-add, COLA divide and trim."""
    _check_hop(n_fft, hop_length)
    sre = re.to(torch.float32) / n_fft
    sim = im.to(torch.float32) / n_fft
    b, t, n_bins = sre.shape
    tab = torch.from_numpy(dft_table(n_fft)).to(sre.device)
    n1, n2 = istft_route(n_fft, hop_length)
    if n1 == 0:
        k = torch.arange(n_bins)
        g = torch.where((k == 0) | (2 * k == n_fft), 1.0, 2.0).to(sre.device)
        idx = (torch.arange(n_fft)[None] * k[:, None]) % n_fft              # [k, n]
        frames = (sre * g) @ tab[idx, 0] + (sim * g) @ tab[idx, 1]
    else:
        ks1 = torch.arange(n1 // 2 + 1)
        k = ks1[:, None] + n1 * torch.arange(n2)[None]                      # [k1, k2]
        mirrored = (2 * k > n_fft).to(sre.device)
        src = torch.where(2 * k > n_fft, n_fft - k, k)
        y_re = sre[..., src]                                                # [.., k1, k2]
        y_im = torch.where(mirrored, -sim[..., src], sim[..., src])
        w2 = tab[((torch.arange(n2)[:, None] * torch.arange(n2)[None]) % n2) * n1]   # [k2, i2]
        b_re = y_re @ w2[..., 0] + y_im @ w2[..., 1]                        # [.., k1, i2]
        b_im = y_im @ w2[..., 0] - y_re @ w2[..., 1]
        tw = tab[ks1[:, None] * torch.arange(n2)[None]]                     # [k1, i2, 2]
        g = torch.where((ks1 == 0) | (2 * ks1 == n1), 1.0, 2.0)[:, None].to(sre.device)
        twx, twy = g * tw[..., 0], g * tw[..., 1]
        v_re = b_re * twx + b_im * twy
        v_im = b_im * twx - b_re * twy
        w1 = tab[((torch.arange(n1)[:, None] * ks1[None]) % n1) * n2]       # [i1, k1, 2]
        x = (torch.einsum("btkj,ik->btij", v_re, w1[..., 0])
             + torch.einsum("btkj,ik->btij", v_im, w1[..., 1]))             # [.., i1, i2]
        frames = x.reshape(b, t, n_fft)
    frames = frames * torch.from_numpy(get_window(window, n_fft)).to(sre.device)
    k_ov = n_fft // hop_length
    y = sre.new_zeros((b, t - 1 + k_ov, hop_length))
    for q in range(k_ov):               # frame t - q covers hop-row t at offset q * hop
        y[:, q: q + t] += frames[..., q * hop_length: (q + 1) * hop_length]
    wsq = torch.from_numpy(cola_norm(t, n_fft, hop_length, window)).to(sre.device)
    return trim(y.reshape(b, -1) / torch.clamp(wsq, min=1e-8), n_fft, center, length)


def stft_vjp_plain(dre: torch.Tensor, dim: torch.Tensor, n_samples: int, n_fft: int,
                   hop_length: int, window: str = "hann", center: bool = True
                   ) -> torch.Tensor:
    """The adjoint of ``stft_plain``'s linear map: (dre, dim) [B, T,
    n_fft//2+1] -> dx [B, n_samples].  Each frame's gradient is dre_k cos -
    dim_k sin summed over the bins with weight 1 on every bin, times the
    window; the frames overlap-add (no division) into the padded signal's
    gradient, whose positions fold back onto the samples they were read
    from: the center pad's mirrors onto the samples they mirror, the zero
    tail nowhere."""
    _check_hop(n_fft, hop_length)
    dre, dim = dre.to(torch.float32), dim.to(torch.float32)
    b, t, _ = dre.shape
    hop, k = hop_length, n_fft // hop_length
    wc, ws = (torch.from_numpy(m).to(dre.device) for m in _dft_bases_np(n_fft))
    win = torch.from_numpy(get_window(window, n_fft)).to(dre.device)
    frames = (dre @ wc.T + dim @ ws.T) * win                       # [B, T, n_fft]
    buf = dre.new_zeros((b, t - 1 + k, hop))
    for q in range(k):
        buf[:, q: q + t] += frames[..., q * hop: (q + 1) * hop]
    buf = buf.reshape(b, -1)
    shift = n_fft // 2 if center else 0
    pos = torch.arange(buf.shape[1], device=dre.device) - shift    # in the real signal
    keep = pos < n_samples + shift                                 # not the zero tail
    src = reflect_index(pos[keep], n_samples) if center else pos[keep]
    return dre.new_zeros((b, n_samples)).index_add_(1, src, buf[:, keep])


def istft_vjp_plain(dy: torch.Tensor, n_frames: int, n_fft: int, hop_length: int,
                    window: str = "hann", center: bool = True
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The adjoint of ``istft_plain``'s linear map: dy [B, L] (the gradient
    of its output, ``length`` L) -> (dre, dim) [B, n_frames, n_fft//2+1].
    The trim undone (dy placed after the center trim, zero elsewhere), the
    COLA divide, each frame's samples times the window, the real DFT, and
    bin k scaled by g_k / n_fft."""
    _check_hop(n_fft, hop_length)
    dy = dy.to(torch.float32)
    b, length = dy.shape
    hop, k = hop_length, n_fft // hop_length
    buf_len = (n_frames - 1 + k) * hop
    shift = n_fft // 2 if center else 0
    m = max(0, min(length, buf_len - shift))
    buf = dy.new_zeros((b, buf_len))
    buf[:, shift: shift + m] = dy[:, :m]
    wsq = torch.from_numpy(cola_norm(n_frames, n_fft, hop, window)).to(dy.device)
    rows = (buf / torch.clamp(wsq, min=1e-8)).reshape(b, n_frames - 1 + k, hop)
    win = torch.from_numpy(get_window(window, n_fft)).to(dy.device)
    frames = torch.cat([rows[:, q: q + n_frames] for q in range(k)], dim=2) * win
    wc, ws = (torch.from_numpy(m).to(dy.device) for m in _dft_bases_np(n_fft))
    g = torch.from_numpy(inverse_weights(n_fft) / n_fft).to(dy.device)
    return (frames @ wc) * g, (frames @ ws) * g


def stft_kernel(x: torch.Tensor, n_fft: int, hop_length: int, window: str,
                center: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The STFT kernel's launcher (the ``aas_torch::stft`` operator's CUDA
    implementation, and ``_StftFn``'s forward): one launch, counted."""
    _check_hop(n_fft, hop_length)
    check_kernel_inputs("stft", (x,))
    if x.ndim != 2:
        raise ValueError(f"stft: needs [B, n], got {tuple(x.shape)}")
    b, n = x.shape
    if n <= n_fft // 2 if center else n < n_fft:
        raise ValueError(f"stft: {n} samples are too few for n_fft {n_fft}"
                         + (" with reflect padding" if center else ""))
    x = x.contiguous()
    t = num_frames(n, n_fft, hop_length, center)
    f = n_fft // 2 + 1
    re = torch.empty((b, t, f), dtype=torch.float32, device=x.device)
    im = torch.empty_like(re)
    n1, n2 = stft_factors(n_fft)
    err = kernel_build.load_library().aas_stft(
        x.data_ptr(), _window(window, n_fft, x.device).data_ptr(),
        _table(n_fft, x.device).data_ptr(), re.data_ptr(), im.data_ptr(),
        b, n, t, n_fft, hop_length, int(center), n1, n2,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernel_build.check(err, f"aas_stft (n_fft {n_fft} = {n1} x {n2})" if n1
                       else "aas_stft (direct)")
    stft.launches += 1
    stft.route = (n1, n2)
    return re, im


class _StftFn(torch.autograd.Function):
    """The STFT kernel forward, ``stft_vjp``'s kernel backward."""

    @staticmethod
    def forward(ctx, x, n_fft, hop_length, window, center):
        ctx.args = (x.shape[1], n_fft, hop_length, window, center)
        return stft_kernel(x, n_fft, hop_length, window, center)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dre, dim):
        return stft_vjp(dre, dim, *ctx.args), None, None, None, None


def stft(x: torch.Tensor, n_fft: int, hop_length: int, window: str = "hann",
         center: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, num_samples] -> (re, im) each [B, T, n_fft//2+1].  Without a
    wanted gradient, the operator ``aas_torch::stft`` (``ops/library.py``:
    the kernel on the card, the plain version on the CPU); with one, on the
    card ``_StftFn``, whose backward runs ``stft_vjp``'s kernel, and on the
    CPU autograd through the plain version."""
    if torch.is_grad_enabled() and x.requires_grad:
        if uses_kernel("stft", x):
            return _StftFn.apply(x, n_fft, hop_length, window, center)
        return stft_plain(x, n_fft, hop_length, window, center)
    return library.stft(x, n_fft, hop_length, window, center)


stft.launches = 0
stft.route = None


def stft_vjp(dre: torch.Tensor, dim: torch.Tensor, n_samples: int, n_fft: int,
             hop_length: int, window: str = "hann", center: bool = True) -> torch.Tensor:
    """The STFT's VJP: (dre, dim) [B, T, n_fft//2+1] -> dx [B, n_samples]
    (``stft_vjp_plain`` on the CPU).  The kernel's route is the ISTFT's
    (``istft_route``); ``stft_vjp.route`` holds the last launch's."""
    if not uses_kernel("stft_vjp", dre):
        return stft_vjp_plain(dre, dim, n_samples, n_fft, hop_length, window, center)
    _check_hop(n_fft, hop_length)
    check_kernel_inputs("stft_vjp", (dre, dim))
    b, t, f = dre.shape
    if dim.shape != dre.shape or f != n_fft // 2 + 1:
        raise ValueError(f"stft_vjp: needs dre, dim [B, T, {n_fft // 2 + 1}], got "
                         f"{tuple(dre.shape)}, {tuple(dim.shape)}")
    shift = n_fft // 2 if center else 0
    if t != num_frames(n_samples, n_fft, hop_length, center) or n_samples <= shift:
        raise ValueError(f"stft_vjp: {t} frames do not come from {n_samples} samples")
    dre, dim = dre.contiguous(), dim.contiguous()
    buf = torch.empty((b, (t - 1 + n_fft // hop_length) * hop_length), dtype=torch.float32,
                      device=dre.device)
    dx = torch.empty((b, n_samples), dtype=torch.float32, device=dre.device)
    n1, n2 = istft_route(n_fft, hop_length)
    err = kernel_build.load_library().aas_stft_vjp(
        dre.data_ptr(), dim.data_ptr(), _window(window, n_fft, dre.device).data_ptr(),
        _table(n_fft, dre.device).data_ptr(), buf.data_ptr(), dx.data_ptr(), b, n_samples,
        t, n_fft, hop_length, shift, n1, n2, torch.cuda.current_stream(dre.device).cuda_stream)
    kernel_build.check(err, f"aas_stft_vjp (n_fft {n_fft} = {n1} x {n2})" if n1
                       else "aas_stft_vjp (direct)")
    stft_vjp.launches += 1
    stft_vjp.route = (n1, n2)
    return dx


stft_vjp.launches = 0
stft_vjp.route = None


def istft_kernel(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop_length: int,
                 window: str, center: bool, length: int | None) -> torch.Tensor:
    """The ISTFT kernel's launcher (the ``aas_torch::istft`` operator's CUDA
    implementation, and ``_IstftFn``'s forward): one launch, counted."""
    _check_hop(n_fft, hop_length)
    check_kernel_inputs("istft", (re, im))
    if re.ndim != 3 or re.shape != im.shape or re.shape[2] != n_fft // 2 + 1:
        raise ValueError(f"istft: needs re, im [B, T, {n_fft // 2 + 1}], got "
                         f"{tuple(re.shape)}, {tuple(im.shape)}")
    b, t, _ = re.shape
    if t == 0:
        raise ValueError("istft: needs at least one frame")
    re, im = re.contiguous(), im.contiguous()
    shift = n_fft // 2 if center else 0
    out_len = (t - 1 + n_fft // hop_length) * hop_length - shift if length is None else length
    y = torch.empty((b, out_len), dtype=torch.float32, device=re.device)
    n1, n2 = istft_route(n_fft, hop_length)
    err = kernel_build.load_library().aas_istft(
        re.data_ptr(), im.data_ptr(), _window(window, n_fft, re.device).data_ptr(),
        _table(n_fft, re.device).data_ptr(), y.data_ptr(), b, t, n_fft, hop_length,
        shift, out_len, n1, n2, torch.cuda.current_stream(re.device).cuda_stream)
    kernel_build.check(err, f"aas_istft (n_fft {n_fft} = {n1} x {n2})" if n1
                       else "aas_istft (direct)")
    istft.launches += 1
    istft.route = (n1, n2)
    return y


class _IstftFn(torch.autograd.Function):
    """The ISTFT kernel forward, ``istft_vjp``'s kernel backward."""

    @staticmethod
    def forward(ctx, re, im, n_fft, hop_length, window, center, length):
        ctx.args = (re.shape[1], n_fft, hop_length, window, center)
        return istft_kernel(re, im, n_fft, hop_length, window, center, length)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        return (*istft_vjp(dy, *ctx.args), None, None, None, None, None)


def istft(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop_length: int,
          window: str = "hann", center: bool = True,
          length: int | None = None) -> torch.Tensor:
    """(re, im) [B, T, n_fft//2+1] -> wav [B, num_samples]: the overlap-add
    buffer [(T-1)*hop + n_fft] with the center trim (n_fft//2 samples off its
    head), then cut or zero-padded to ``length``.  Without a wanted gradient,
    the operator ``aas_torch::istft`` (``ops/library.py``); with one, on the
    card ``_IstftFn``, whose backward runs ``istft_vjp``'s kernel, and on the
    CPU autograd through the plain version."""
    if torch.is_grad_enabled() and (re.requires_grad or im.requires_grad):
        if uses_kernel("istft", re):
            return _IstftFn.apply(re, im, n_fft, hop_length, window, center, length)
        return istft_plain(re, im, n_fft, hop_length, window, center, length)
    return library.istft(re, im, n_fft, hop_length, window, center, length)


istft.launches = 0
istft.route = None


def istft_vjp(dy: torch.Tensor, n_frames: int, n_fft: int, hop_length: int,
              window: str = "hann", center: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ISTFT's VJP: dy [B, L] -> (dre, dim) [B, n_frames, n_fft//2+1]
    (``istft_vjp_plain`` on the CPU).  The kernel's route is the STFT's
    (``stft_factors``); ``istft_vjp.route`` holds the last launch's."""
    if not uses_kernel("istft_vjp", dy):
        return istft_vjp_plain(dy, n_frames, n_fft, hop_length, window, center)
    _check_hop(n_fft, hop_length)
    check_kernel_inputs("istft_vjp", (dy,))
    if dy.ndim != 2 or n_frames < 1:
        raise ValueError(f"istft_vjp: needs dy [B, L] and frames, got {tuple(dy.shape)}, "
                         f"{n_frames}")
    dy = dy.contiguous()
    b, length = dy.shape
    f = n_fft // 2 + 1
    dre = torch.empty((b, n_frames, f), dtype=torch.float32, device=dy.device)
    dim = torch.empty_like(dre)
    n1, n2 = stft_factors(n_fft)
    err = kernel_build.load_library().aas_istft_vjp(
        dy.data_ptr(), _window(window, n_fft, dy.device).data_ptr(),
        _table(n_fft, dy.device).data_ptr(), dre.data_ptr(), dim.data_ptr(), b, length,
        n_frames, n_fft, hop_length, n_fft // 2 if center else 0, n1, n2,
        torch.cuda.current_stream(dy.device).cuda_stream)
    kernel_build.check(err, f"aas_istft_vjp (n_fft {n_fft} = {n1} x {n2})" if n1
                       else "aas_istft_vjp (direct)")
    istft_vjp.launches += 1
    istft_vjp.route = (n1, n2)
    return dre, dim


istft_vjp.launches = 0
istft_vjp.route = None
