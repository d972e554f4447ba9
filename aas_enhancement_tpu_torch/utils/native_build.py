"""Build the native C++ host libraries under ``native/`` (counterpart of
``aas_enhancement_tpu/utils/native_build.py``).

``native/`` holds byte-for-byte copies of the JAX package's ``native/``: the
CTC beam decoder (``ctc_beam/ctc_beam.cc`` -> ``libctcbeam.so``) and the wav
batch decoder (``audio/wav_batch.cc`` -> ``libwavbatch.so``), and their
``Makefile``.  Loading never compiles: a binding module (``decode/beam.py``,
``data/native_audio.py``) only loads an existing library and falls back to
its pure-Python implementation, with one warning, when it is missing.
``build()`` compiles, and setup scripts, ``chip_smoke.py`` and the tests call
it.

Each library lands in ``<repo>/build/torch_native/`` under a name keyed on a
hash of its source and the Makefile (``libctcbeam-<hash>.so``), as
``utils/kernel_build.py`` names the kernel library, so a library built from
other source is never loaded.  ``make`` writes into a fresh temporary
directory and each library is renamed into place, so processes that build at
the same time (test files run in parallel) never load a half-written file.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(PKG_DIR, "native")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_native")

# library -> its source under NATIVE_DIR
SOURCES = {"libctcbeam.so": "ctc_beam/ctc_beam.cc",
           "libwavbatch.so": "audio/wav_batch.cc"}

_log = logging.getLogger(__name__)


def source_path(name: str) -> str:
    return os.path.join(NATIVE_DIR, SOURCES[name])


def lib_path(name: str) -> str:
    """Where the library ``name`` (e.g. ``libctcbeam.so``) built from the
    current source lives, whether or not it has been built."""
    h = hashlib.sha256()
    for path in (source_path(name), os.path.join(NATIVE_DIR, "Makefile")):
        with open(path, "rb") as f:
            h.update(f.read())
    stem = name[: -len(".so")]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build(timeout: float = 120.0) -> bool:
    """Build every native library whose hashed name is missing; -> success.

    One ``make`` covers both libraries.  A failure logs a warning and returns
    False; the bindings then take their Python paths."""
    targets = {name: lib_path(name) for name in SOURCES}
    if all(os.path.exists(p) for p in targets.values()):
        return True
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="make-", dir=BUILD_DIR)
    try:
        subprocess.run(["make", "-C", NATIVE_DIR, f"BUILD={tmp}"], check=True,
                       capture_output=True, timeout=timeout)
        for name, dest in targets.items():
            os.replace(os.path.join(tmp, name), dest)
        return True
    except (subprocess.SubprocessError, OSError) as e:
        detail = getattr(e, "stderr", b"") or b""
        _log.warning("native build failed (%s %s); the Python fallbacks will be "
                     "used", e, detail.decode(errors="replace")[-2000:])
        return False
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
