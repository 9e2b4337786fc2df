"""Where the time of verbose prediction, or of a training step, goes on the
card.

    python -m porous_cfd_tpu_torch.profile_predict
        [--model pipn|pipn_coupled|pipn_exact|pi_gano|pi_gano_full|pi_gano_pp|pipn_pp|
                 pipn_pp_mrg|pipn_pp_full|pi_gano_pp_full]
        [--mode predict|train] [--batches 8] [--trace DIR]

Builds a full-width model (random weights from seed 8421): the
duct_fixed_boundary ``pipn`` model (decoupled analytic path; ``pipn_coupled``:
the max-pool-coupled one, winner gather and decoder_prop's j0_add mode;
``pipn_exact``: the exact autodiff operator, no kernel), ``pipn-pp``,
``pipn-pp-mrg`` or ``pipn-pp-full`` (the U-Net) model, or the
duct_variable_boundary ``pi-gano``, ``pi-gano-full``, ``pi-gano-pp`` or
``pi-gano-pp-full`` model, and one batch of 13 synthetic cases at 1500/1000/700
points (with the model's per-dataset aux attached), warms up, then runs
``--batches`` verbose predictions (``predict``) or training steps with the examples' fixed loss
weights (``train``) under ``torch.profiler``. Prints the device time per
batch of each kernel (top entries), the device busy share of the wall time,
and one JSON summary line that also splits the device time into the port's
own kernels and the rest. The profiler's own cost per launch stretches the
wall time of the window; compare the device time with an unprofiled step
time (``chip_smoke.py``) for the busy share of a real run. Before the
window, ``--batches`` unprofiled runs, each from an idle card, give the
host's time to enqueue one run and the wall time to its end (medians): where
the two are close, the host and not the card sets the pace. One more run
under ``torch.cuda.set_sync_debug_mode("warn")`` counts the calls that make
the host wait for the card and prints where each was made; the profiled
window also counts the aten operator calls and device events per run, the
host's work. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
import traceback
import warnings
from argparse import Namespace
from pathlib import Path

import torch

from porous_cfd_tpu_torch.data.synthetic import (VARIABLE_BOUNDARIES, make_foam_batch,
                                                 make_scalers)
from porous_cfd_tpu_torch.examples.duct_fixed_boundary import train as fixed_train
from porous_cfd_tpu_torch.examples.duct_variable_boundary import train as variable_train
from porous_cfd_tpu_torch.models.pi_gano import pi_gano, pi_gano_pp
from porous_cfd_tpu_torch.models.pipn import pipn_foam, pipn_foam_pp, pipn_foam_pp_mrg
from porous_cfd_tpu_torch.physics.scaling import FixedLossScaler
from porous_cfd_tpu_torch.train.engine import (make_optimizer, make_predict_functions,
                                               make_train_functions)

NU = 1489.4e-6
PIPN = dict(nu=NU, d=14000.0, f=17.11, fe_local_layers=[2, 64, 64],
            fe_global_layers=[69, 96, 128, 1024], seg_layers=[1088, 512, 256, 128, 3],
            seg_dropout=[0.05, 0.05, 0, 0])
PI_GANO = dict(nu=NU, out_features=3, branch_layers=[8, 128, 352, 352, 352],
               geometry_layers=[7, 64, 176, 176, 176], local_layers=[2, 64, 176, 176, 176],
               n_operators=4, operator_dropout=[0, 0.1, 0.1, 0],
               variable_boundaries=VARIABLE_BOUNDARIES, fast_derivatives=True)
CONFIGS = {
    "pipn": (pipn_foam, PIPN),
    "pipn_coupled": (pipn_foam, dict(PIPN, coupled_context=True)),
    "pipn_exact": (pipn_foam, dict(PIPN, fast_derivatives=False)),
    "pi_gano": (pi_gano, PI_GANO),
    "pi_gano_full": (pi_gano, dict(PI_GANO, full=True)),
    "pi_gano_pp": (pi_gano_pp, dict(PI_GANO, geometry_layers=[[8, 64, 64], [66, 176, 176],
                                                              [178, 176, 176]],
                                    geometry_radius=[0.5, 1], geometry_fraction=[0.5, 0.25],
                                    max_neighbors=32)),
    "pipn_pp": (pipn_foam_pp, dict(nu=NU, d=14000.0, f=17.11, fe_local_layers=[2, 64, 64],
                                   fe_global_layers=[[8, 64, 64], [66, 128, 128],
                                                     [130, 256, 1024]],
                                   fe_radius=[0.5, 1], fe_fraction=[0.5, 0.25],
                                   seg_layers=[1088, 378, 128, 3], seg_dropout=[0.05, 0, 0])),
    "pipn_pp_mrg": (pipn_foam_pp_mrg, dict(n_dims=2, mrg_in_features=6, nu=NU, d=14000.0,
                                           f=17.11, fe_local_layers=[2, 64, 64],
                                           seg_layers=[1088, 384, 128, 3],
                                           seg_dropout=[0.05, 0, 0])),
}


def cli_model(cli, model_type: str):
    """A factory of ``model_type`` as the CLI module ``cli`` builds it (its
    ``get_model``, weights from its own seed 8421)."""

    def factory(scalers, generator, device):
        return cli.get_model(Namespace(model=model_type), scalers, device)

    return factory


# the U-Nets, with their encoders over all points
CONFIGS["pipn_pp_full"] = (cli_model(fixed_train, "pipn-pp-full"), {})
CONFIGS["pi_gano_pp_full"] = (cli_model(variable_train, "pi-gano-pp-full"), {})

LOSS_WEIGHTS = (1, 1, 1, 1, 1, 1, 100, 100, 100)
# device-kernel names of the port's hand-written CUDA kernels (the decoder's
# coupled modes run as mlp_prop_fwd / mlp_prop_bwd_rows too)
OWN_KERNELS = ("mlp_prop_fwd", "mlp_prop_bwd_rows", "split_weights", "pointnet_",
               "weight_grad_partial", "sum_partials", "sum_layer_parts", "group_colsum",
               "sa_fwd", "sa_bwd", "fps_kernel")


def sync_sites(run) -> list[str]:
    """The calls of one ``run()`` that make the host wait for the card, under
    ``torch.cuda.set_sync_debug_mode("warn")``: for each, the warning's
    ``file:line`` and the innermost frame of this package on the stack.
    Turning the mode on also warns, once per process, that it is a
    prototype feature that does not detect all "synchronizing operations";
    that notice is not a call and does not count."""
    sites = []
    here = Path(__file__).resolve().parent

    def where(frame) -> str:
        path = Path(frame.filename)
        if path.is_relative_to(here.parent):
            path = path.relative_to(here.parent)
        return f"{path}:{frame.lineno}"

    def hook(message, category, filename, lineno, file=None, line=None):
        text = str(message)
        if "synchronizing" not in text or "prototype" in text:
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if Path(f.filename).name != "warnings.py"]
        own = [f for f in stack if Path(f.filename).resolve().is_relative_to(here)
               and Path(f.filename).resolve() != Path(__file__).resolve()]
        site = own[-1] if own else stack[-1]
        sites.append(f"{filename}:{lineno} from {where(site)} ({site.name})")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


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
    sites = sync_sites(run)
    syncs = len(sites)
    torch.cuda.synchronize()

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
    aten_calls = 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            # the host's share: operator calls, nested ones included
            aten_calls += evt.count if evt.key.startswith("aten::") else 0
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
    device_events = sum(r[1] for r in rows)
    what = "batch" if args.mode == "predict" else "step"
    print(f"{torch.cuda.get_device_name(0)}: {args.model} {args.mode}, {wall_ms:.3f} ms wall "
          f"per {what}, "
          f"{device_ms:.3f} ms device time per {what} (busy share "
          f"{device_ms / wall_ms:.3f}); the port's kernels {own_ms:.3f} ms, the rest "
          f"{device_ms - own_ms:.3f} ms")
    print(f"unprofiled, from an idle card: the host enqueues a {what} in {host_ms:.3f} ms, "
          f"which ends after {idle_wall_ms:.3f} ms (medians of {args.batches}); "
          f"{syncs} synchronizing calls, {aten_calls // args.batches} aten operator calls "
          f"and {device_events} device events (kernels, copies) per {what}")
    for site in sites:
        print(f"  synchronizing call: {site}")
    for ms, count, key in rows[:20]:
        print(f"  {ms:9.4f} ms  x{count:<3d} {key[:90]}")
    print(json.dumps({"model": args.model, "mode": args.mode, f"wall_ms_per_{what}": wall_ms,
                      f"device_ms_per_{what}": device_ms, "own_kernels_ms": own_ms,
                      "other_device_ms": device_ms - own_ms,
                      "busy_share": device_ms / wall_ms,
                      f"host_enqueue_ms_per_{what}": host_ms,
                      f"unprofiled_wall_ms_per_{what}": idle_wall_ms,
                      f"host_syncs_per_{what}": syncs, "host_sync_sites": sites,
                      f"aten_calls_per_{what}": aten_calls // args.batches,
                      f"device_events_per_{what}": device_events,
                      "top": [{"ms": ms, "count": c, "name": k[:120]}
                              for ms, c, k in rows[:20]]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
