"""Where the time of verbose prediction goes on the card.

    python -m porous_cfd_tpu_torch.profile_predict [--batches 8] [--trace DIR]

Builds the full-width duct_fixed_boundary ``pipn`` model (random weights from
seed 8421) and one batch of 13 synthetic cases at 1500/1000/700 points,
warms up, then runs ``--batches`` verbose predictions under
``torch.profiler``. Prints the device time per batch of each kernel (top
entries), the device busy share of the wall time, and one JSON summary line.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from porous_cfd_tpu_torch.data.synthetic import make_foam_batch, make_scalers
from porous_cfd_tpu_torch.models.pipn import pipn_foam
from porous_cfd_tpu_torch.train.engine import make_predict_functions

CONFIG = dict(nu=1489.4e-6, d=14000.0, f=17.11, fe_local_layers=[2, 64, 64],
              fe_global_layers=[69, 96, 128, 1024],
              seg_layers=[1088, 512, 256, 128, 3], seg_dropout=[0.05, 0.05, 0, 0])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", type=int, default=8)
    parser.add_argument("--trace", default=None,
                        help="directory for a Chrome trace of the window")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_predict: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    model = pipn_foam(**CONFIG, scalers=make_scalers(),
                      generator=torch.Generator().manual_seed(8421), device=dev)
    batch = make_foam_batch(13, 1500, 1000, 700, seed=8421).to(dev)
    predict = make_predict_functions(model).predict_batch
    for _ in range(3):
        predict(batch, True)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.batches):
            predict(batch, True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace:
        prof.export_chrome_trace(f"{args.trace}/predict_trace.json")

    # device-side events only (kernels, copies): the operator rows that
    # launch them would count the same time twice
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = evt.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us / args.batches / 1e3, evt.count // args.batches, evt.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    wall_ms = wall / args.batches * 1e3
    print(f"{torch.cuda.get_device_name(0)}: {wall_ms:.3f} ms wall per batch, "
          f"{device_ms:.3f} ms device time per batch "
          f"(busy share {device_ms / wall_ms:.3f})")
    for ms, count, key in rows[:15]:
        print(f"  {ms:9.4f} ms  x{count:<3d} {key[:90]}")
    print(json.dumps({"wall_ms_per_batch": wall_ms, "device_ms_per_batch": device_ms,
                      "busy_share": device_ms / wall_ms,
                      "top": [{"ms": ms, "count": c, "name": k[:120]}
                              for ms, c, k in rows[:15]]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
