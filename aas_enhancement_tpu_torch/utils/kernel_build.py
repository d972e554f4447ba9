"""Build the CUDA kernels under ``csrc/`` into one shared library and load it.

Counterpart of ``aas_enhancement_tpu/utils/native_build.py``, for the GPU
kernels.  ``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``) into a
``.so`` with a plain C interface, loaded with ``ctypes``: no PyTorch headers,
so a build takes seconds.  The library lands in ``<repo>/build/torch_kernels/``
under a name keyed on a hash of the sources and flags, so a stale library is
never loaded.  The build happens at first use.  A failed build raises: there
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C entry points: name -> argtypes.  Each returns its cudaError_t as an int.
SIGNATURES = {
    # x, win, re, im, batch, n_padded, n_frames, n_fft, hop, stream
    "aas_stft": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # re, im, win, y, batch, n_frames, n_fft, hop, stream
    "aas_istft": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # gxf, gxb, gx_stride_t, gx_stride_b, m, wh, bh, yf, yb, T, B, H, stream
    "aas_lstm_tm_fwd": (_P, _P, _L, _L, _P, _P, _P, _P, _P, _I, _I, _I, _P),
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


def library_path() -> str:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in sources() if s.endswith(".cu")]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(out[:-3] + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
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
