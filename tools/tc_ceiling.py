"""The card's TF32 tensor-core rate through mma.sync and wgmma, and a check of
the wgmma shared-memory layout the engine's kernels use.

    python tools/tc_ceiling.py

Builds ``tools/tc_ceiling.cu`` with nvcc for sm_90a into
``build/tc_ceiling/`` and times, with CUDA events, back-to-back TF32
products on every SM: ``mma.sync.m16n8k8`` with 4 or 16 independent
accumulators a warp and 8 or 16 warps an SM, and ``wgmma.m64n64k8`` (A in
registers, B in shared memory) with 1 to 4 warpgroups an SM. Then one
wgmma of random inputs, B laid out K-major without swizzling (core matrices
128 bytes apart along K, 256 along N), is held to float64. Prints one JSON
line with the card's name and power limit. Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SM_COUNT = 132


def build() -> Path:
    sys.path.insert(0, str(ROOT))
    from porous_cfd_tpu_torch.ops.build import nvcc_path
    out = ROOT / "build" / "tc_ceiling" / "libtc_ceiling.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(out), str(ROOT / "tools" / "tc_ceiling.cu")],
                   check=True)
    return out


def tf32(x: np.ndarray) -> np.ndarray:
    return ((x.view(np.int32) + 0x1000) & ~0x1FFF).view(np.float32)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tc_ceiling: no CUDA device", file=sys.stderr)
        return 2
    lib = ctypes.CDLL(str(build()))
    lib.tc_time.restype = ctypes.c_float
    lib.tc_wgmma_check.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    res = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                         "--format=csv,noheader"], capture_output=True,
                                        text=True, timeout=60).stdout.strip(),
           "mma_sync_tflops": {}, "wgmma_tflops": {}}
    iters = 20000
    for nacc in (4, 16):
        for blocks_per_sm, warps in ((1, 8), (2, 8)):
            ms = lib.tc_time(nacc, SM_COUNT * blocks_per_sm, warps * 32, iters)
            flop = SM_COUNT * blocks_per_sm * warps * iters * nacc * 16 * 8 * 8 * 2
            res["mma_sync_tflops"][f"acc{nacc}_warps{warps * blocks_per_sm}"] = flop / ms / 1e9
    iters = 5000
    for blocks_per_sm, groups in ((1, 1), (1, 2), (2, 2)):
        ms = lib.tc_time(0, SM_COUNT * blocks_per_sm, groups * 128, iters)
        flop = SM_COUNT * blocks_per_sm * groups * iters * 4 * 64 * 64 * 8 * 2
        res["wgmma_tflops"][f"warpgroups{groups * blocks_per_sm}"] = flop / ms / 1e9
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 8)).astype(np.float32)
    bt = rng.standard_normal((64, 8)).astype(np.float32)
    d = np.zeros((64, 64), np.float32)
    code = lib.tc_wgmma_check(a.ctypes.data, bt.ctypes.data, d.ctypes.data, 128, 256)
    ref = tf32(a).astype(np.float64) @ tf32(bt).astype(np.float64).T
    err = float(np.abs(d - ref).max())
    res["wgmma_layout_check"] = {"cuda_error": code, "max_abs_err": err,
                                 "max_ref": float(np.abs(ref).max())}
    print(json.dumps({"tc_ceiling": res}), flush=True)
    return 0 if code == 0 and err <= 1e-4 * float(np.abs(ref).max()) else 1


if __name__ == "__main__":
    sys.exit(main())
