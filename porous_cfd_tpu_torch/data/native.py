"""ctypes binding to the native OpenFOAM numeric parser
(``runtime/foamio.cpp``), the port's counterpart of
``porous_cfd_tpu/data/native.py``.

The library is compiled with the host's C++ compiler at first use into
``build/porous_cfd_tpu_torch/libfoamio-<hash>.so`` (the hash covers the
source and the flags), once: the build runs under an exclusive
``fcntl.flock`` on a lock file beside it, and the finished library is moved
into place in one rename, so processes that start together (test workers,
data loaders) wait for the one build and then load the same file. When no
compiler or library is available ``available()`` is False and ``foam_io``
parses in pure Python, the JAX package's contract: the native parser is
never required.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "runtime" / "foamio.cpp"
BUILD_DIR = ROOT / "build" / "porous_cfd_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfoamio-{h.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """The built library, compiling it first under the lock if it is not
    there yet; None when it cannot be built."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if not SOURCE.exists():
        return None
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "foamio.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            if cxx is None:
                return None
            tmp = out.with_suffix(f".tmp{os.getpid()}")
            try:
                subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                               capture_output=True, timeout=300)
            except (subprocess.SubprocessError, OSError):
                tmp.unlink(missing_ok=True)
                return None
            os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.foamio_parse_floats.restype = ctypes.c_long
    lib.foamio_parse_floats.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                        ctypes.POINTER(ctypes.c_double), ctypes.c_long]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def parse_floats(text: str) -> Optional[np.ndarray]:
    """All floats in a text block (comments and identifiers skipped), or None
    when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    raw = text.encode()
    cap = max(16, len(raw) // 2 + 8)  # at most one float per 2 characters
    out = np.empty(cap, np.float64)
    n = lib.foamio_parse_floats(raw, len(raw),
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap)
    if n < 0:
        return None
    return out[:n].copy()
