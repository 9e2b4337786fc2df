"""Where the time of verbose prediction, or of a training step, goes on the
card.

    python -m porous_cfd_tpu_torch.profile_predict [--model pipn|pi_gano|pipn_pp]
                                                   [--mode predict|train]
                                                   [--batches 8] [--trace DIR]

Builds a full-width model (random weights from seed 8421): the
duct_fixed_boundary ``pipn`` or ``pipn-pp`` model or the
duct_variable_boundary ``pi-gano`` model, and one batch of 13 synthetic
cases at 1500/1000/700 points (with the model's per-dataset aux attached),
warms up, then runs ``--batches`` verbose
predictions (``predict``) or training steps with the examples' fixed loss
weights (``train``) under ``torch.profiler``. Prints the device time per
batch of each kernel (top entries), the device busy share of the wall time,
and one JSON summary line that also splits the device time into the port's
own kernels and the rest. The profiler's own cost per launch stretches the
wall time of the window; compare the device time with an unprofiled step
time (``chip_smoke.py``) for the busy share of a real run. Before the
window, ``--batches`` unprofiled runs, each from an idle card, give the
host's time to enqueue one run and the wall time to its end (medians): where
the two are close, the host and not the card sets the pace.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from porous_cfd_tpu_torch.data.synthetic import (VARIABLE_BOUNDARIES, make_foam_batch,
                                                 make_scalers)
from porous_cfd_tpu_torch.models.pi_gano import pi_gano
from porous_cfd_tpu_torch.models.pipn import pipn_foam, pipn_foam_pp
from porous_cfd_tpu_torch.physics.scaling import FixedLossScaler
from porous_cfd_tpu_torch.train.engine import (make_optimizer, make_predict_functions,
                                               make_train_functions)

NU = 1489.4e-6
CONFIGS = {
    "pipn": (pipn_foam, dict(nu=NU, d=14000.0, f=17.11, fe_local_layers=[2, 64, 64],
                             fe_global_layers=[69, 96, 128, 1024],
                             seg_layers=[1088, 512, 256, 128, 3],
                             seg_dropout=[0.05, 0.05, 0, 0])),
    "pi_gano": (pi_gano, dict(nu=NU, out_features=3, branch_layers=[8, 128, 352, 352, 352],
                              geometry_layers=[7, 64, 176, 176, 176],
                              local_layers=[2, 64, 176, 176, 176], n_operators=4,
                              operator_dropout=[0, 0.1, 0.1, 0],
                              variable_boundaries=VARIABLE_BOUNDARIES)),
    "pipn_pp": (pipn_foam_pp, dict(nu=NU, d=14000.0, f=17.11, fe_local_layers=[2, 64, 64],
                                   fe_global_layers=[[8, 64, 64], [66, 128, 128],
                                                     [130, 256, 1024]],
                                   fe_radius=[0.5, 1], fe_fraction=[0.5, 0.25],
                                   seg_layers=[1088, 378, 128, 3], seg_dropout=[0.05, 0, 0])),
}
LOSS_WEIGHTS = (1, 1, 1, 1, 1, 1, 100, 100, 100)
# device-kernel names of the port's hand-written CUDA kernels
OWN_KERNELS = ("mlp_prop_fwd", "mlp_prop_bwd_rows", "pointnet_tiles", "pointnet_reduce",
               "pointnet_last", "pointnet_lower_bwd", "weight_grad_partial",
               "sum_partials", "group_colsum", "sa_fwd", "sa_bwd", "fps_kernel")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=tuple(CONFIGS), default="pipn")
    parser.add_argument("--mode", choices=("predict", "train"), default="predict")
    parser.add_argument("--batches", type=int, default=8)
    parser.add_argument("--trace", default=None,
                        help="directory for a Chrome trace of the window")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_predict: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    factory, config = CONFIGS[args.model]
    model = factory(**config, scalers=make_scalers(),
                    generator=torch.Generator().manual_seed(8421), device=dev)
    batch = model.attach_neighbors(make_foam_batch(13, 1500, 1000, 700, seed=8421).to(dev))
    if args.mode == "predict":
        predict = make_predict_functions(model).predict_batch

        def run():
            predict(batch, True)
    else:
        fns = make_train_functions(model, make_optimizer(model, 4),
                                   FixedLossScaler(LOSS_WEIGHTS))
        state = fns.init_state(seed=8421)

        def run():
            fns.train_step(state, batch)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    enqueue, to_end = [], []
    for _ in range(args.batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        enqueue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        to_end.append(time.perf_counter() - t0)
    host_ms = statistics.median(enqueue) * 1e3
    idle_wall_ms = statistics.median(to_end) * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.batches):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace:
        prof.export_chrome_trace(f"{args.trace}/{args.model}_{args.mode}_trace.json")

    # device-side events only (kernels, copies): the operator rows that
    # launch them would count the same time twice, and so would the ranges
    # that annotate a span of kernels ("Optimizer.step#Adam.step"; a kernel
    # name may hold a '#' too, "{lambda(int)#1}", but never without '(')
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "#" in evt.key and "(" not in evt.key:
            continue
        dev_us = evt.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us / args.batches / 1e3, evt.count // args.batches, evt.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    own_ms = sum(r[0] for r in rows if any(k in r[2] for k in OWN_KERNELS))
    wall_ms = wall / args.batches * 1e3
    what = "batch" if args.mode == "predict" else "step"
    print(f"{torch.cuda.get_device_name(0)}: {args.model} {args.mode}, {wall_ms:.3f} ms wall "
          f"per {what}, "
          f"{device_ms:.3f} ms device time per {what} (busy share "
          f"{device_ms / wall_ms:.3f}); the port's kernels {own_ms:.3f} ms, the rest "
          f"{device_ms - own_ms:.3f} ms")
    print(f"unprofiled, from an idle card: the host enqueues a {what} in {host_ms:.3f} ms, "
          f"which ends after {idle_wall_ms:.3f} ms (medians of {args.batches})")
    for ms, count, key in rows[:20]:
        print(f"  {ms:9.4f} ms  x{count:<3d} {key[:90]}")
    print(json.dumps({"model": args.model, "mode": args.mode, f"wall_ms_per_{what}": wall_ms,
                      f"device_ms_per_{what}": device_ms, "own_kernels_ms": own_ms,
                      "other_device_ms": device_ms - own_ms,
                      "busy_share": device_ms / wall_ms,
                      f"host_enqueue_ms_per_{what}": host_ms,
                      f"unprofiled_wall_ms_per_{what}": idle_wall_ms,
                      "top": [{"ms": ms, "count": c, "name": k[:120]}
                              for ms, c, k in rows[:20]]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
