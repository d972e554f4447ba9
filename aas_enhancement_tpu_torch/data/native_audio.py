"""ctypes binding to the native C++ wav batch decoder (counterpart of
``aas_enhancement_tpu/data/native_audio.py``).

``native/audio/wav_batch.cc`` decodes RIFF files in parallel threads and packs
them into a zero-padded batch, bit for bit what the Python reader
(``data/wav.py``) gives; the dataset uses it when ``DataConfig.native_decode``
is set and augmentation is off (``data/dataset.py``).  Build the library with
``utils/native_build.py::build`` (or ``build()`` here); loading never
compiles.  Without the library ``batch_decode`` returns None, the dataset
reads with the Python reader, and one warning says so.  ``batch_decode.route``
records the path of the last call: ``"native"`` or ``"python"``.
"""

from __future__ import annotations

import ctypes
import logging
import os

import numpy as np

from aas_enhancement_tpu_torch.utils import native_build

_log = logging.getLogger(__name__)

_lib = None
_lib_tried = False


def build(timeout: float = 120.0) -> bool:
    """Build the native libraries; -> whether this one loads now."""
    global _lib, _lib_tried
    native_build.build(timeout)
    _lib, _lib_tried = None, False        # a fresh load attempt
    return available()


def _load_lib():
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    path = native_build.lib_path("libwavbatch.so")
    if not os.path.exists(path):
        _log.warning("native wav decoder not built (%s missing): using the Python "
                     "reader; utils/native_build.py::build() builds it", path)
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.wav_batch_decode.restype = ctypes.c_int
        lib.wav_batch_decode.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_long,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.wav_batch_decode_i16.restype = ctypes.c_int
        lib.wav_batch_decode_i16.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_long,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        _lib = lib
    except (OSError, AttributeError) as e:
        _log.warning("native wav decoder %s did not load (%s): using the Python "
                     "reader", path, e)
        _lib = None
    return _lib


def available() -> bool:
    return _load_lib() is not None


def batch_decode(paths: list[str], bucket: int, expected_sr: int = 0,
                 n_threads: int = 0,
                 dtype: str = "float32") -> tuple[np.ndarray, np.ndarray] | None:
    """Decode ``paths`` into a zero-padded [B, bucket] batch and lengths [B].

    ``"float32"`` equals ``data/wav.py``'s samples bit for bit; ``"int16"``
    copies PCM16 sources directly, equal to the dataset's ``_to_int16`` of
    them.  -> None without the native library (the caller reads with the
    Python reader); a file that fails to decode or has another sample rate
    raises ValueError, as the Python reader does."""
    lib = _load_lib()
    batch_decode.route = "python" if lib is None else "native"
    if lib is None:
        return None
    b = len(paths)
    i16 = dtype == "int16"
    out = np.empty((b, bucket), np.int16 if i16 else np.float32)
    lengths = np.zeros(b, np.int32)
    if b == 0:
        return out, lengths
    arr = (ctypes.c_char_p * b)(*[p.encode() for p in paths])
    fn = lib.wav_batch_decode_i16 if i16 else lib.wav_batch_decode
    ptr_t = ctypes.c_int16 if i16 else ctypes.c_float
    rc = fn(arr, b, bucket, expected_sr, out.ctypes.data_as(ctypes.POINTER(ptr_t)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
    if rc != 0:
        # The Python reader on the failing file gives the specific error.
        from aas_enhancement_tpu_torch.data.wav import read_wav
        path = paths[-rc - 1]
        _, sr = read_wav(path)
        if expected_sr and sr != expected_sr:
            raise ValueError(f"{path}: sample rate {sr} != {expected_sr}")
        raise ValueError(f"{path}: native decode failed")
    return out, lengths


batch_decode.route = None
