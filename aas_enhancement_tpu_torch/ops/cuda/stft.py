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
backward is a kernel of its own, the adjoint of the forward's linear map,
both in ``csrc/stft_vjp.cu`` over the radix FFT of ``csrc/fft.cuh``:
``stft_vjp`` (each frame's inverse real transform with weight 1 on every bin,
the window, the overlap-add in (row, run) work items of a cooperative grid,
the reflect pad folded back, one launch) and ``istft_vjp`` (the trim
undone, the COLA divide, the window, the forward real transform, each bin
scaled by g_k / n_fft).  ``vjp_plan`` picks their route from the shape: the
radices of the n_fft/2-point FFT and the launch's sizes, or the direct sums
(``DIRECT_PLAN``) for an odd n_fft and the like.  ``stft_vjp_plain`` and
``istft_vjp_plain`` write the adjoints out in plain PyTorch; CPU tensors take
them, and the CPU tests hold them to ``torch.autograd`` through
``stft_plain`` / ``istft_plain`` and to ``jax.vjp`` of the JAX package's
functions.  ``rfft_radix_plain``, ``irfft_radix_plain``,
``stft_vjp_runs_plain`` and ``istft_vjp_radix_plain`` follow the kernels'
arithmetic step by step, and the CPU tests hold them to those.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from aas_enhancement_tpu_torch.dsp.stft import (
    _dft_bases_np, cola_norm, get_window, inverse_weights, istft as istft_plain,
    istft_length, overlap, overlap_add, pad_frames, stft as stft_plain, stft_frames, trim)
from aas_enhancement_tpu_torch.ops import library
from aas_enhancement_tpu_torch.ops.dispatch import check_kernel_inputs, uses_kernel
from aas_enhancement_tpu_torch.utils import kernel_build

__all__ = ["stft", "istft", "stft_kernel", "istft_kernel", "stft_plain", "istft_plain",
           "stft_factorised_plain", "istft_factorised_plain", "stft_vjp", "istft_vjp",
           "stft_vjp_plain", "istft_vjp_plain", "stft_factors", "istft_route", "dft_table",
           "reflect_index", "VjpPlan", "DIRECT_PLAN", "vjp_plan", "vjp_runs",
           "rfft_radix_plain", "irfft_radix_plain", "stft_vjp_runs_plain",
           "istft_vjp_radix_plain", "vjp_residency"]

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
    if overlap(n_fft, hop_length) > ISTFT_MAX_OVERLAP:
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
    x = x.to(torch.float32)
    b, n = x.shape
    t = stft_frames(n, n_fft, hop_length, center)
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
    gives (0, 0).  Then window, overlap-add (frame t - q over hop-row t at
    offset q hop, for the K = ceil(n_fft / hop) offsets q that fall inside
    the frame), COLA divide and trim (``istft_length``)."""
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
    y = overlap_add(pad_frames(frames, n_fft, hop_length), hop_length)
    y = y[:, : (t - 1) * hop_length + n_fft]
    wsq = torch.from_numpy(cola_norm(t, n_fft, hop_length, window)).to(sre.device)
    return trim(y / torch.clamp(wsq, min=1e-8), n_fft, center, length,
                pad=n_fft % hop_length == 0)


def stft_vjp_plain(dre: torch.Tensor, dim: torch.Tensor, n_samples: int, n_fft: int,
                   hop_length: int, window: str = "hann", center: bool = True
                   ) -> torch.Tensor:
    """The adjoint of ``stft_plain``'s linear map: (dre, dim) [B, T,
    n_fft//2+1] -> dx [B, n_samples].  Each frame's gradient is dre_k cos -
    dim_k sin summed over the bins with weight 1 on every bin, times the
    window; the frames overlap-add (no division) into the padded signal's
    gradient, whose positions fold back onto the samples they were read
    from: the center pad's mirrors onto the samples they mirror, the zero
    tail nowhere (nor a gap between frames when hop > n_fft)."""
    dre, dim = dre.to(torch.float32), dim.to(torch.float32)
    wc, ws = (torch.from_numpy(m).to(dre.device) for m in _dft_bases_np(n_fft))
    win = torch.from_numpy(get_window(window, n_fft)).to(dre.device)
    frames = (dre @ wc.T + dim @ ws.T) * win                       # [B, T, n_fft]
    buf = overlap_add(pad_frames(frames, n_fft, hop_length), hop_length)
    b = buf.shape[0]
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
    dy = dy.to(torch.float32)
    b, length = dy.shape
    hop, k = hop_length, overlap(n_fft, hop_length)
    buf_len = (n_frames - 1) * hop + n_fft
    shift = n_fft // 2 if center else 0
    m = max(0, min(length, buf_len - shift))
    buf = dy.new_zeros((b, (n_frames - 1 + k) * hop))
    buf[:, shift: shift + m] = dy[:, :m]
    wsq = torch.from_numpy(cola_norm(n_frames, n_fft, hop, window)).to(dy.device)
    buf[:, :buf_len] /= torch.clamp(wsq, min=1e-8)
    rows = buf.reshape(b, n_frames - 1 + k, hop)
    win = torch.from_numpy(get_window(window, n_fft)).to(dy.device)
    frames = torch.cat([rows[:, q: q + n_frames] for q in range(k)], dim=2)[..., :n_fft] * win
    wc, ws = (torch.from_numpy(m).to(dy.device) for m in _dft_bases_np(n_fft))
    g = torch.from_numpy(inverse_weights(n_fft) / n_fft).to(dy.device)
    return (frames @ wc) * g, (frames @ ws) * g


VJP_RADICES = (16, 8, 4, 2, 5, 3)   # the butterflies csrc/fft.cuh writes out
VJP_THREADS = 128                   # threads a block of either VJP kernel
VJP_MAX_HALF = 512                  # the largest n_fft/2 of the radix route (shared memory)


class VjpPlan(NamedTuple):
    """How the VJP kernels (``csrc/stft_vjp.cu``) run one shape.  ``radices``
    are the passes of the n_fft/2-point complex FFT in order (() for the
    direct route); ``lanes`` threads share a frame and ``frames`` frames a
    block (``lanes * frames`` = ``VJP_THREADS``); ``run`` is the most frames
    of one ``stft_vjp`` work item; the exchange buffers hold complex point i
    of a frame's slot at float i + (i >> ``pad_shift``) (i for 0), and two
    slots ``frame_stride`` floats apart."""
    radices: tuple[int, ...]
    lanes: int
    frames: int
    run: int
    pad_shift: int
    frame_stride: int


DIRECT_PLAN = VjpPlan((), 0, 0, 0, 0, 0)


def _radices(m: int) -> tuple[int, ...]:
    """The passes of an m-point FFT: a pass of 5 or 3 per such factor, then
    the power of two in the fewest passes of at most 16 (at least two passes
    in all), as equal as they go, the larger first; () if m has another
    prime factor.  128 -> (16, 8), 160 -> (5, 8, 4), 256 -> (16, 16), 512 ->
    (8, 8, 8)."""
    out = []
    for p in (5, 3):
        while m % p == 0:
            out.append(p)
            m //= p
    if m & (m - 1):
        return ()
    e = m.bit_length() - 1
    passes = max(2 - len(out), -(-e // 4)) if e else 0
    if passes > e:
        return ()
    return tuple(out) + tuple(1 << (e // passes + (i < e % passes)) for i in range(passes))


def _wavefronts(m: int, radices: tuple[int, ...], lanes: int, pad_shift: int,
                frame_stride: int) -> int:
    """Shared-memory wavefronts of the passes' loads and stores, for the
    frames of one warp, in the model of 32 four-byte banks (a wavefront
    serves one distinct word per bank)."""
    def pad(i):
        return i + (i >> pad_shift) if pad_shift else i
    total, ns = 0, 1
    for r in radices:
        nb = m // r
        for first in range(0, nb, lanes):
            lanes_now = [j for j in range(first, min(first + lanes, nb))]
            for s in range(r):
                for index in (lambda j: j + s * nb,
                              lambda j: (j - j % ns) * r + j % ns + s * ns):
                    banks: dict[int, set] = {}
                    for f in range(max(1, 32 // lanes)):
                        for j in lanes_now:
                            a = f * frame_stride + pad(index(j))
                            banks.setdefault(a % 32, set()).add(a)
                    total += max(len(v) for v in banks.values())
        ns *= r
    return total


@functools.lru_cache(maxsize=64)
def vjp_plan(n_fft: int, hop_length: int) -> VjpPlan:
    """The VJP kernels' route for a shape, from the shape alone.  The radix
    route needs an even n_fft and hop, 16 <= n_fft/2 <= ``VJP_MAX_HALF`` and
    n_fft/2 = 2^a 3^b 5^c; every other shape (an odd or prime n_fft, 2048)
    takes the direct sums (``DIRECT_PLAN``).  ``lanes``: 8, 16 or 32,
    whichever leaves the fewest lanes idle in the passes; ``run`` (the rows a
    block keeps in shared memory): 4 tiles or 2K + 2 frames (K =
    ceil(n_fft / hop), the most frames over a sample), whichever is more,
    so that ``vjp_run_count`` can always split a row into runs of at most
    ``run`` and, where there are several, at least K + 1 frames; the
    exchange layout: the pad and frame stride with the
    fewest shared-memory wavefronts (``_wavefronts``; on an H100 a fixed
    rule, a pad every 16 points, ran up to 10% slower: PERF.md §6)."""
    m = n_fft // 2
    if n_fft % 2 or hop_length % 2 or not 16 <= m <= VJP_MAX_HALF:
        return DIRECT_PLAN
    radices = _radices(m)
    if not radices:
        return DIRECT_PLAN
    # Lane slots the passes take (a pass of nb butterflies runs ceil(nb /
    # lanes) rounds on all of a frame's lanes), weighted by a butterfly's
    # work, r (log2 r + 3): the fewest, the larger lanes on a tie.
    lanes = min((8, 16, 32), key=lambda n: (sum(-(-(m // r) // n) * n * r * (np.log2(r) + 3)
                                                 for r in radices), -n))
    frames = VJP_THREADS // lanes
    k = overlap(n_fft, hop_length)
    run = max(4 * frames, -(-(2 * k + 2) // frames) * frames)
    best = None
    for pad_shift in (0, 3, 4, 5):
        base = (m - 1 + ((m - 1) >> pad_shift if pad_shift else 0)) + 1
        for extra in range(32 if lanes < 32 else 1):
            cost = _wavefronts(m, radices, lanes, pad_shift, base + extra)
            if best is None or cost < best[0]:
                best = (cost, pad_shift, base + extra)
    return VjpPlan(radices, lanes, frames, run, best[1], best[2])


def _table_c(n_fft: int, device) -> torch.Tensor:
    tab = torch.from_numpy(dft_table(n_fft)).to(device)
    return torch.complex(tab[:, 0], tab[:, 1])                   # W_N^m, m < N


def _small_dft(r: int, device) -> torch.Tensor:
    """[s, q] = e^(-2 pi i s q / r), in double precision, rounded to c64."""
    s = np.arange(r)
    return torch.from_numpy(np.exp(-2j * np.pi * np.outer(s, s) / r).astype(np.complex64)
                            ).to(device)


def _fft_passes(z: torch.Tensor, radices: tuple[int, ...], tab: torch.Tensor) -> torch.Tensor:
    """The kernels' Stockham passes, forward, over the last axis (m points):
    pass r with span ns (the product of the radices before it) takes
    butterfly j < m/r's inputs at j + s m/r, multiplies input s by
    W_(ns r)^((j mod ns) s) = W_N^((j mod ns) s N/(ns r)) from the table of
    N = 2m, runs an r-point DFT and puts output q at (j - j mod ns) r +
    j mod ns + q ns.  The output is in natural order."""
    m = z.shape[-1]
    n, ns = 2 * m, 1
    for r in radices:
        nb = m // r
        j = torch.arange(nb)
        s = torch.arange(r)
        k = j % ns
        v = z[..., j[:, None] + s[None] * nb]                           # [.., nb, r]
        v = (v * tab[k[:, None] * s[None] * (n // (ns * r))]) @ _small_dft(r, z.device)
        out = torch.empty_like(z)
        out[..., ((j - k) * r + k)[:, None] + s[None] * ns] = v
        z, ns = out, ns * r
    return z


def rfft_radix_plain(x: torch.Tensor, radices: tuple[int, ...]) -> tuple[torch.Tensor,
                                                                          torch.Tensor]:
    """``istft_vjp``'s transform step by step: the real DFT of x [..., N]
    -> (re, im) [..., N/2+1].  The even and odd samples packed as z = x[2m] +
    i x[2m+1], the m = N/2-point FFT by ``radices`` (``_fft_passes``), then
    the split: X_k = E_k + W_N^k O_k, E_k = (Z_k + conj Z_(M-k)) / 2, O_k =
    -i (Z_k - conj Z_(M-k)) / 2, indices mod M, for k = 0 .. M."""
    x = x.to(torch.float32)
    m = x.shape[-1] // 2
    tab = _table_c(2 * m, x.device)
    z = _fft_passes(torch.complex(x[..., 0::2], x[..., 1::2]), radices, tab)
    k = torch.arange(m + 1)
    zk, zc = z[..., k % m], z[..., (m - k) % m].conj()
    xk = (zk + zc) / 2 + tab[k] * (-0.5j * (zk - zc))
    return xk.real, xk.imag


def irfft_radix_plain(re: torch.Tensor, im: torch.Tensor, radices: tuple[int, ...]
                      ) -> torch.Tensor:
    """``stft_vjp``'s transform step by step, the conjugate twin of
    ``rfft_radix_plain``: (re, im) [..., M+1] -> f [..., 2M], f[n] = sum_k
    re_k cos(2 pi n k / N) - im_k sin(2 pi n k / N) with weight 1 on every
    bin (the real DFT's adjoint; N irfft of the spectrum with its interior
    bins halved).  The split first: Z_k = A_k + i B_k with A_k = (Y_k +
    conj Y_(M-k)) / 2, B_k = (Y_k - conj Y_(M-k)) / 2 conj(W_N^k) for 0 < k <
    M, A_0 = re_0 + re_M, B_0 = re_0 - re_M; then the inverse m-point FFT as
    conj(FFT(conj Z)); f[2m] = Re z_m, f[2m+1] = Im z_m."""
    y = torch.complex(re.to(torch.float32), im.to(torch.float32))
    m = y.shape[-1] - 1
    tab = _table_c(2 * m, y.device)
    k = torch.arange(m)
    yk, yc = y[..., k], y[..., m - k].conj()
    z = (yk + yc) / 2 + 1j * ((yk - yc) / 2 * tab[k].conj())
    z[..., 0] = torch.complex(re[..., 0] + re[..., m], re[..., 0] - re[..., m]).to(z.dtype)
    z = _fft_passes(z.conj(), radices, tab).conj()
    return torch.stack([z.real, z.imag], dim=-1).reshape(*z.shape[:-1], 2 * m)


def _direct_frames(re, im, n_fft):
    """The direct route's frames: sum_k re_k cos - im_k sin from the table."""
    tab = torch.from_numpy(dft_table(n_fft)).to(re.device)
    idx = (torch.arange(n_fft // 2 + 1)[:, None] * torch.arange(n_fft)[None]) % n_fft
    return re.to(torch.float32) @ tab[idx, 0] + im.to(torch.float32) @ tab[idx, 1]


def vjp_run_count(n_frames: int, n_fft: int, hop_length: int, per_row: int = 0) -> int:
    """The runs (``stft_vjp``'s work items) a row of ``n_frames`` splits
    into: ``per_row`` (the blocks the card holds at once over the rows: one
    round of work items), within the plan's limits: at least ceil(T / run)
    (a run's rows fit its block's shared memory), at most T // (K + 1) (every
    run of a row of several holds K + 1 frames or more, so that the reflect
    folds stay within a row's first and last run).  1 for a direct plan."""
    run = vjp_plan(n_fft, hop_length).run
    if not run:
        return 1
    lo = -(-n_frames // run)
    return max(lo, min(per_row, n_frames // (overlap(n_fft, hop_length) + 1)))


def vjp_runs(n_frames: int, runs: int) -> list[int]:
    """The first frames of a row's ``runs`` runs and one past the last: T =
    q runs + rem, the first rem runs take q + 1 frames, the others q."""
    q, rem = divmod(n_frames, runs)
    return [r * q + min(r, rem) for r in range(runs + 1)]


def stft_vjp_runs_plain(dre: torch.Tensor, dim: torch.Tensor, n_samples: int, n_fft: int,
                        hop_length: int, window: str = "hann", center: bool = True,
                        runs: int | None = None) -> torch.Tensor:
    """``stft_vjp``'s kernel step by step: (dre, dim) [B, T, n_fft//2+1] ->
    dx [B, n_samples].  Each frame inverse-transformed once
    (``irfft_radix_plain``), windowed, and overlap-added into the rows of
    its run (``vjp_runs``; ``runs`` a row, ``vjp_run_count``'s least by
    default): the positions only its own frames cover become dx at once, with
    the reflect fold at a row's two ends (dx[i] += the padded signal's
    position shift - i, and the mirror at the tail); the K - 1 hop-rows a
    run shares with each neighbour are kept as partial sums and added
    afterwards, the earlier run's first.  K = ceil(n_fft / hop): each frame
    is zero-padded to K hop-rows, and the rows past the last frame's end
    hold zeros."""
    plan = vjp_plan(n_fft, hop_length)
    b, t, _ = dre.shape
    hop, k = hop_length, overlap(n_fft, hop_length)
    win = torch.from_numpy(get_window(window, n_fft)).to(dre.device)
    frames = pad_frames((irfft_radix_plain(dre, dim, plan.radices) if plan.radices
                         else _direct_frames(dre, dim, n_fft)) * win,
                        n_fft, hop)                                       # [B, T, K hop]
    shift = n_fft // 2 if center else 0
    buf_len = (t - 1 + k) * hop
    runs = runs or vjp_run_count(t, n_fft, hop_length)
    bounds = vjp_runs(t, runs)
    dx = dre.new_zeros((b, n_samples))
    heads, tails = {}, {}
    for r in range(runs):
        t0, t1 = bounds[r], bounds[r + 1]
        rows = overlap_add(frames[:, t0:t1], hop)

        def val(p, use, t0=t0, rows=rows):       # the padded signal's gradient at p
            idx = (p - t0 * hop).clamp(0, rows.shape[1] - 1)
            return torch.where(use & (p < buf_len), rows[:, idx], 0.0)

        lo = 0 if r == 0 else (t0 + k - 1) * hop
        hi = n_samples + shift if r == runs - 1 else t1 * hop
        i = torch.arange(max(0, lo - shift), min(n_samples, hi - shift))
        v = val(i + shift, True)
        if center:
            v = v + val(shift - i, (i >= 1) & (i <= shift))
            pos = 2 * (n_samples - 1) - i
            v = v + val(pos + shift, (pos >= n_samples) & (pos <= n_samples - 1 + shift))
        dx[:, i] = v
        heads[r] = rows[:, :(k - 1) * hop]
        tails[r] = rows[:, (t1 - t0) * hop:]
    for r in range(1, runs):
        i = torch.arange(bounds[r] * hop, (bounds[r] + k - 1) * hop) - shift
        dx[:, i] = tails[r - 1] + heads[r]
    return dx


def istft_vjp_radix_plain(dy: torch.Tensor, n_frames: int, n_fft: int, hop_length: int,
                          window: str = "hann", center: bool = True
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``istft_vjp``'s kernel step by step: dy [B, L] -> (dre, dim) [B,
    n_frames, n_fft//2+1].  Buffer position p holds dy[p - shift] (zero
    outside) times 1 / max(sum of window^2, 1e-8): from a table of hop
    entries (p mod hop) where all K = ceil(n_fft / hop) frames that can
    cover p exist, summed over the frames that do at a row's first and last
    K - 1 hop-rows (the window zero-padded to K hop: an offset past n_fft
    adds nothing); each frame windowed, transformed by ``rfft_radix_plain``
    (the direct sum for a direct plan), bin k scaled by g_k / n_fft."""
    plan = vjp_plan(n_fft, hop_length)
    dy = dy.to(torch.float32)
    b, length = dy.shape
    hop, k = hop_length, overlap(n_fft, hop_length)
    shift = n_fft // 2 if center else 0
    win = torch.from_numpy(get_window(window, n_fft)).to(dy.device)
    w2 = pad_frames(win * win, n_fft, hop).reshape(k, hop)
    inner = 1.0 / torch.clamp(w2.sum(0), min=1e-8)                     # [hop]
    p = torch.arange((n_frames - 1 + k) * hop, device=dy.device)
    row, j = p // hop, p % hop
    cover = sum(torch.where((row - q >= 0) & (row - q < n_frames), w2[q, j], 0.0)
                for q in range(k))
    edge = (row < k - 1) | (row > n_frames - 1)
    inv = torch.where(edge, 1.0 / torch.clamp(cover, min=1e-8), inner[j])
    src = p - shift
    ok = (src >= 0) & (src < length)
    d = torch.where(ok, dy[:, torch.where(ok, src, 0)], 0.0) * inv
    frames = torch.stack([d[:, t * hop: t * hop + n_fft] for t in range(n_frames)], 1) * win
    if plan.radices:
        re, im = rfft_radix_plain(frames, plan.radices)
    else:
        tab = torch.from_numpy(dft_table(n_fft)).to(dy.device)
        idx = (torch.arange(n_fft)[:, None] * torch.arange(n_fft // 2 + 1)[None]) % n_fft
        re, im = frames @ tab[idx, 0], frames @ tab[idx, 1]
    g = torch.from_numpy(inverse_weights(n_fft) / n_fft).to(dy.device)
    return re * g, im * g


def stft_kernel(x: torch.Tensor, n_fft: int, hop_length: int, window: str,
                center: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The STFT kernel's launcher (the ``aas_torch::stft`` operator's CUDA
    implementation, and ``_StftFn``'s forward): one launch, counted."""
    check_kernel_inputs("stft", (x,))
    if x.ndim != 2:
        raise ValueError(f"stft: needs [B, n], got {tuple(x.shape)}")
    b, n = x.shape
    if n <= n_fft // 2 if center else n < n_fft:
        raise ValueError(f"stft: {n} samples are too few for n_fft {n_fft}"
                         + (" with reflect padding" if center else ""))
    x = x.contiguous()
    t = stft_frames(n, n_fft, hop_length, center)
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


def _packed(radices: tuple[int, ...]) -> int:
    """The plan's radices as base-32 digits, pass 0 lowest (the C entries' form)."""
    return sum(r << (5 * i) for i, r in enumerate(radices))


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy of it where its data is not 16-byte aligned (the VJP
    kernels stage it with 16-byte cp.async)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _counter(frames_done: torch.Tensor | None, device: torch.device) -> int | None:
    """The device address of a VJP kernel's frame counter (None: not counted)."""
    if frames_done is None:
        return None
    if (frames_done.device != device or frames_done.dtype != torch.int32
            or frames_done.numel() != 1):
        raise ValueError("frames_done: needs an int32 [1] tensor on the kernel's device")
    return frames_done.data_ptr()


def _route_name(name: str, plan: VjpPlan, n_fft: int) -> str:
    return (f"{name} (n_fft {n_fft}: radices {'x'.join(map(str, plan.radices))})"
            if plan.radices else f"{name} (direct)")


def stft_vjp(dre: torch.Tensor, dim: torch.Tensor, n_samples: int, n_fft: int,
             hop_length: int, window: str = "hann", center: bool = True,
             frames_done: torch.Tensor | None = None) -> torch.Tensor:
    """The STFT's VJP: (dre, dim) [B, T, n_fft//2+1] -> dx [B, n_samples]
    (``stft_vjp_plain`` on the CPU).  One cooperative launch of
    ``csrc/stft_vjp.cu`` (the direct sums where ``vjp_plan`` gives
    ``DIRECT_PLAN``), each row split into as many runs as fill the card's
    resident blocks in one round (``vjp_run_count``); ``stft_vjp.route``
    and ``stft_vjp.runs`` hold the last launch's plan and runs a row.
    ``frames_done``: an int32 [1] tensor on the card that the radix kernel
    adds the frames it transforms to (for the checks; the direct route
    leaves it as it is)."""
    if not uses_kernel("stft_vjp", dre):
        return stft_vjp_plain(dre, dim, n_samples, n_fft, hop_length, window, center)
    check_kernel_inputs("stft_vjp", (dre, dim))
    b, t, f = dre.shape
    if dim.shape != dre.shape or f != n_fft // 2 + 1:
        raise ValueError(f"stft_vjp: needs dre, dim [B, T, {n_fft // 2 + 1}], got "
                         f"{tuple(dre.shape)}, {tuple(dim.shape)}")
    shift = n_fft // 2 if center else 0
    if t != stft_frames(n_samples, n_fft, hop_length, center) or n_samples <= shift:
        raise ValueError(f"stft_vjp: {t} frames do not come from {n_samples} samples")
    dre, dim = _aligned(dre.contiguous()), _aligned(dim.contiguous())
    plan = vjp_plan(n_fft, hop_length)
    runs = vjp_run_count(t, n_fft, hop_length,
                         _resident_blocks("stft_vjp", n_fft, hop_length, dre.device) // b)
    part = (overlap(n_fft, hop_length) - 1) * hop_length        # a run's shared stretch
    scratch = torch.empty((max(1, b * runs * 2 * part),), dtype=torch.float32,
                          device=dre.device)
    dx = torch.empty((b, n_samples), dtype=torch.float32, device=dre.device)
    counter = _counter(frames_done, dre.device)
    err = kernel_build.load_library().aas_stft_vjp(
        dre.data_ptr(), dim.data_ptr(), _window(window, n_fft, dre.device).data_ptr(),
        _table(n_fft, dre.device).data_ptr(), scratch.data_ptr(), scratch.numel(),
        dx.data_ptr(), b, n_samples, t, n_fft, hop_length, shift, _packed(plan.radices),
        plan.lanes, plan.frames, plan.run, plan.pad_shift, plan.frame_stride, runs, counter,
        torch.cuda.current_stream(dre.device).cuda_stream)
    kernel_build.check(err, _route_name("aas_stft_vjp", plan, n_fft))
    stft_vjp.launches += 1
    stft_vjp.route = plan
    stft_vjp.runs = runs
    return dx


stft_vjp.launches = 0
stft_vjp.route = None
stft_vjp.runs = None


def istft_kernel(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop_length: int,
                 window: str, center: bool, length: int | None) -> torch.Tensor:
    """The ISTFT kernel's launcher (the ``aas_torch::istft`` operator's CUDA
    implementation, and ``_IstftFn``'s forward): one launch, counted."""
    check_kernel_inputs("istft", (re, im))
    if re.ndim != 3 or re.shape != im.shape or re.shape[2] != n_fft // 2 + 1:
        raise ValueError(f"istft: needs re, im [B, T, {n_fft // 2 + 1}], got "
                         f"{tuple(re.shape)}, {tuple(im.shape)}")
    b, t, _ = re.shape
    if t == 0:
        raise ValueError("istft: needs at least one frame")
    re, im = re.contiguous(), im.contiguous()
    shift = n_fft // 2 if center else 0
    out_len = istft_length(t, n_fft, hop_length, center, length)
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
    head), then cut or (where hop | n_fft) zero-padded to ``length``
    (``istft_length``).  Without a wanted gradient,
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
              window: str = "hann", center: bool = True,
              frames_done: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ISTFT's VJP: dy [B, L] -> (dre, dim) [B, n_frames, n_fft//2+1]
    (``istft_vjp_plain`` on the CPU).  One launch of ``csrc/stft_vjp.cu``
    (the direct sums where ``vjp_plan`` gives ``DIRECT_PLAN``);
    ``istft_vjp.route`` holds the last launch's plan; ``frames_done`` as in
    ``stft_vjp``."""
    if not uses_kernel("istft_vjp", dy):
        return istft_vjp_plain(dy, n_frames, n_fft, hop_length, window, center)
    check_kernel_inputs("istft_vjp", (dy,))
    if dy.ndim != 2 or n_frames < 1:
        raise ValueError(f"istft_vjp: needs dy [B, L] and frames, got {tuple(dy.shape)}, "
                         f"{n_frames}")
    dy = _aligned(dy.contiguous())
    b, length = dy.shape
    f = n_fft // 2 + 1
    dre = torch.empty((b, n_frames, f), dtype=torch.float32, device=dy.device)
    dim = torch.empty_like(dre)
    plan = vjp_plan(n_fft, hop_length)
    counter = _counter(frames_done, dy.device)
    err = kernel_build.load_library().aas_istft_vjp(
        dy.data_ptr(), _window(window, n_fft, dy.device).data_ptr(),
        _table(n_fft, dy.device).data_ptr(), dre.data_ptr(), dim.data_ptr(), b, length,
        n_frames, n_fft, hop_length, n_fft // 2 if center else 0, _packed(plan.radices),
        plan.lanes, plan.frames, plan.pad_shift, plan.frame_stride, counter,
        torch.cuda.current_stream(dy.device).cuda_stream)
    kernel_build.check(err, _route_name("aas_istft_vjp", plan, n_fft))
    istft_vjp.launches += 1
    istft_vjp.route = plan
    return dre, dim


istft_vjp.launches = 0
istft_vjp.route = None


@functools.lru_cache(maxsize=32)
def _resident_blocks(name: str, n_fft: int, hop_length: int, device: torch.device) -> int:
    """Blocks of ``name``'s kernel the card holds at once at this shape."""
    if not vjp_plan(n_fft, hop_length).radices:
        return 0
    with torch.cuda.device(device):
        per_sm = vjp_residency(name, n_fft, hop_length)["blocks_per_sm"]
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def vjp_residency(name: str, n_fft: int, hop_length: int) -> dict:
    """What one launch of ``name`` ("stft_vjp" or "istft_vjp") holds on the
    current card at this shape: blocks resident on an SM (the occupancy
    calculator), dynamic shared memory a block, registers and local memory
    (spills) a thread, threads a block.  Needs the card."""
    plan = vjp_plan(n_fft, hop_length)
    out = (ctypes.c_int * 5)()
    err = kernel_build.load_library().aas_vjp_residency(
        0 if name == "stft_vjp" else 1, n_fft, hop_length, _packed(plan.radices), plan.lanes,
        plan.frames, plan.run, plan.pad_shift, plan.frame_stride, out)
    kernel_build.check(err, f"aas_vjp_residency ({name})")
    return dict(zip(("blocks_per_sm", "smem_bytes", "registers", "local_bytes", "threads"), out))
