"""Build the CUDA kernels under ``csrc/`` into one shared library and load it.

Counterpart of ``aas_enhancement_tpu/utils/native_build.py``, for the GPU
kernels.  ``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one
process per source, all started together, and links the objects into a
``.so`` with a plain C interface, loaded with ``ctypes``: no PyTorch headers,
so a build takes seconds.  The library lands in ``<repo>/build/torch_kernels/``
under a name keyed on a hash of the sources and flags, so a stale library is
never loaded.  The build happens at first use.  ``AAS_KERNEL_DEFINES`` (names
separated by spaces) adds a ``-D`` flag for each name: the switch-offs that
time a part of a kernel by its absence (``csrc/stft_vjp.cu``'s
``AAS_VJP_SKIP_*``, ``csrc/conv_dw.cu``'s ``AAS_DW_SKIP_*``;
``utils/kernel_bench.py``), in a library of their own.  A failed build raises: there
is no fallback, because a CUDA tensor must reach its kernel or an error.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C entry points: name -> argtypes.  Each returns its cudaError_t as an int
# (aas_conv_dw_slices and the two aas_*_res_clusters a count).
SIGNATURES = {
    # x, win, table, re, im, batch, n_samples, n_frames, n_fft, hop, center,
    # n1, n2 (n1 * n2 = n_fft: the two-stage transform; 0, 0: the direct sum), stream
    "aas_stft": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # re, im, win, table, y, batch, n_frames, n_fft, hop, shift (the center
    # trim), out_len, n1, n2 (as in aas_stft), stream
    "aas_istft": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # The STFT's VJP: dre, dim, win, table, scratch, its length, dx, batch,
    # n_samples, n_frames, n_fft, hop, shift (n_fft / 2 with the center pad,
    # else 0), then the plan (ops/cuda/stft.py::vjp_plan): radices as base-32
    # digits (0: the direct sums), lanes, frames, run, pad_shift, stride; runs
    # a row (vjp_run_count); frames_done (NULL, or an unsigned counter of the
    # frames transformed); stream
    "aas_stft_vjp": (_P, _P, _P, _P, _P, _L, _P, _I, _I, _I, _I, _I, _I, _L, _I, _I, _I, _I,
                     _I, _I, _P, _P),
    # The ISTFT's VJP: dy, win, table, dre, dim, batch, out_len (dy's length),
    # n_frames, n_fft, hop, shift (the center trim), radices, lanes, frames,
    # pad_shift, stride, frames_done (as in aas_stft_vjp), stream
    "aas_istft_vjp": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _I, _I, _I, _I, _P,
                      _P),
    # which (0 the STFT's VJP, 1 the ISTFT's), n_fft, hop, radices, lanes,
    # frames, run, pad_shift, stride, out[5]: blocks an SM, shared memory
    # bytes, registers, local bytes, threads
    "aas_vjp_residency": (_I, _I, _I, _L, _I, _I, _I, _I, _I, _P),
    # The recurrences, time-major (two tensors per direction) or stacked (two
    # halves of one tensor); saved buffers NULL for inference:
    # gx0, gx1, gx_stride_t, gx_stride_b, m, wh, bh, y0, y1, hp, cp, act,
    # stacked, cluster (blocks per cluster of the resident route, 0: the
    # streaming route), bf16 (gx, y, hp and cp are bf16, else f32), T, B, H,
    # stream
    "aas_lstm_fwd": (_P, _P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _P),
    # ... as aas_lstm_fwd without cp
    "aas_gru_fwd": (_P, _P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # cluster, variant (0 the forward's inference kernel, 1 its training
    # variant, 2 the backward), H -> the clusters of that resident kernel the
    # card runs at once (not an error code; minus the cudaError_t where it
    # can run none)
    "aas_lstm_res_clusters": (_I, _I, _I),
    "aas_gru_res_clusters": (_I, _I, _I),
    # m, w (wh for the resident route, whT for the streaming one), cp, act,
    # dy0, dy1, dgx, stacked, cluster (as in aas_lstm_fwd), bf16 (cp, dy and
    # dgx are bf16, else f32), T, B, H, stream
    "aas_lstm_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # m, w, hp, act, dy0, dy1, dgx, dgh (or NULL), stacked, cluster, bf16 (hp,
    # dy, dgx and dgh are bf16), T, B, H, stream
    "aas_gru_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # rows (B * T), Fo, kt, kf, ci, co, stride_f, multiprocessors -> slices
    # (not an error code; 0: the kernel does not take the shape)
    "aas_conv_dw_slices": (_I, _I, _I, _I, _I, _I, _I, _I),
    # x, scale, bias, lengths, lengths are int64 (else int32), y, mean, inv,
    # partials, partials' length, B, T, F, C, G, eps, act (0 none, 1 leaky_relu,
    # 2 hardtanh), slope, bf16 (x and y are bf16, else f32), stream: one
    # cooperative launch
    "aas_gn_act_fwd": (_P, _P, _P, _P, _I, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _F, _I,
                       _F, _I, _P),
    # x, dy, scale, bias, lengths, lengths are int64 (else int32), mean, inv,
    # dx, dscale, dbias, scratch (per-row, then per-item sums), its length, B,
    # T, F, C, G, act, slope, bf16 (x, dy and dx are bf16, else f32), stream:
    # the backward, one cooperative launch
    "aas_gn_act_bwd": (_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                       _I, _I, _F, _I, _P),
    # x, dy, part, dw, x strides (b, t, f), dy strides (b, t, f), B, T, F, Fo,
    # ci, co, kt, kf, stride_f, pad_t_low, pad_f_low, slices, stream: f32 x
    # and dy (the "fma" route)
    "aas_conv_dw": (_P, _P, _P, _P, _L, _L, _L, _L, _L, _L, _I, _I, _I, _I, _I, _I,
                    _I, _I, _I, _I, _I, _I, _P),
    # ... as aas_conv_dw to pad_f_low, then the plan (ops/cuda/conv_dw.py::
    # conv_dw_plan): planes (1: bf16 x and dy, the "mma" route; 3: f32 x and
    # dy split into three bf16 planes, "bf16x3"), cx, cd, groups, per_block,
    # win, ndt, slices, shared memory bytes; stream; dw is f32
    "aas_conv_dw_mma": (_P, _P, _P, _P, _L, _L, _L, _L, _L, _L, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _L, _P),
}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "aas_enhancement_tpu_torch cannot be built")


def nvcc_flags() -> tuple[str, ...]:
    """``NVCC_FLAGS`` and a ``-D`` flag for each name in ``AAS_KERNEL_DEFINES``."""
    names = os.environ.get("AAS_KERNEL_DEFINES", "").split()
    bad = [n for n in names if not n.isidentifier()]
    if bad:
        raise ValueError(f"AAS_KERNEL_DEFINES: not macro names: {bad}")
    return NVCC_FLAGS + tuple(f"-D{n}" for n in names)


def library_path() -> str:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(nvcc_flags()).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libaas_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if it is missing; returns its path.  Raises on failure."""
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tmp = f"{out}.{os.getpid()}.tmp"
    cmds = [[nvcc, *nvcc_flags(), "-c", src, "-o", f"{tmp}.{i}.o"]
            for i, src in enumerate(s for s in sources() if s.endswith(".cu"))]
    cmds.append([nvcc, "-shared", "-o", tmp, *[c[-1] for c in cmds]])
    log, failed = [], None
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for c in cmds[:-1]]
        results = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
        if all(rc == 0 for _, _, rc in results):
            p = subprocess.run(cmds[-1], capture_output=True, text=True)
            results.append((cmds[-1], p.stdout + p.stderr, p.returncode))
        for cmd, text, rc in results:
            log.append(" ".join(cmd) + "\n" + text)
            if rc != 0 and failed is None:
                failed = (rc, text)
    finally:
        for c in cmds[:-1]:
            if os.path.exists(c[-1]):
                os.remove(c[-1])
    with open(out[:-3] + ".log", "w") as f:
        f.write("".join(log))
    if failed is not None:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{failed[1]}")
    os.replace(tmp, out)      # atomic: a concurrent loader never sees half a file
    return out


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with argtypes declared."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a cudaError_t other than cudaSuccess."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
