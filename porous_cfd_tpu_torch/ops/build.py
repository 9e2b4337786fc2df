"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` for ``sm_90a`` into
``build/porous_cfd_tpu_torch/lib<name>-<hash>.so`` (a plain C interface, no
PyTorch headers) and loaded with ``ctypes``. The hash covers the source, the
shared header and the flags, so an edited source is rebuilt and a stale
library is never loaded. Nothing is built when a module is imported: the
first call on a CUDA tensor builds, or ``build_all()`` builds every source at
once with the compilers running side by side.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "porous_cfd_tpu_torch"
SOURCES = ("pointnet_global", "decoder_prop", "neural_op_prop", "sa_neighborhood", "fps")
HEADERS = ("common.cuh", "mlp_prop.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                           "GPU machine at first use")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu", *HEADERS):
        h.update((CSRC / f).read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every stale source, one ``nvcc`` per source, all started
    together. Returns the wall seconds each build took (0.0 when the library
    was up to date); raises with the compiler's output on failure. The
    ``-Xptxas -v`` register and shared-memory report of each build is kept
    beside its library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs, seconds = {}, {}
    start = time.perf_counter()
    for name in names:
        out = library_path(name)
        seconds[name] = 0.0
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - start
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def pointer_array(tensors) -> ctypes.Array:
    """A C array of device pointers (``const float* const*``)."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def int_array(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*[int(v) for v in values])


def check_launch(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")
