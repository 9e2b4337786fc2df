"""The readings a cell's limits are set from, in one process on the card.

    python3 -m portbench.calibrate --workload <cell> --seeds 12 [--first-seed N]
        [--controls 3] [--seconds 1] [--fault lr_flat|lr_per_step]

For each of ``--seeds`` seeds it runs the cell as ``portbench.run`` does, at
its own sizes and load (a window of ``--seconds``), and prints the program's
readings of each number compared. On the first ``--controls`` seeds it also
prints the control's readings: the reference computed in TF32 (the nearest
precision below the configuration's float32 with TF32 off) in the program's
place; on a training cell also the fault of half the batch left out (the
reference stepped on the first half of each batch, its mean over those
cases) in the program's place. A state left unchanged reads 1 by the
measure of ``change_gap`` and needs no run. With ``--fault`` the program
runs with that fault planted (a learning rate that never decays, or decays
every step), and its readings are the fault's. One JSON line a seed, then a
summary: the largest program reading and the smallest control and fault
readings of each number. ``correct`` on a seed's line is the run's own
verdict against the cell's limits.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys

import torch

from portbench import drive, inputs, manifest as mf


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 1001)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--fault", choices=sorted(FAULTS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    manifest = mf.load()
    cell = mf.cell(manifest, args.workload)
    spec, mix = mf.spec(manifest, cell["config"]), mf.traffic(cell["traffic"])
    limits = mf.limits(cell["name"])
    lowest, highest = {}, {}
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        control = "tf32" if k < args.controls else None
        with FAULTS[args.fault]() if args.fault else contextlib.nullcontext():
            run, readings, ctrl = drive.run_cell(spec, mix, seed, args.seconds, False, device,
                                                 control=control)
        within = run.failed == 0 and all(readings[n] <= v["limit"] for n, v in limits.items())
        line = {"seed": seed, "fault": args.fault, "correct": within, "program": readings,
                "control": ctrl, "failed": run.failed, "setup_s": run.setup_s,
                "attempted": run.attempted}
        if control and mix["kind"] == "train":
            line["half_batch"] = half_batch(spec, mix, seed, device)
        if args.fault:
            line[args.fault] = readings
        else:
            for key, value in readings.items():
                highest[key] = max(highest.get(key, 0.0), value)
        for name in ("control", "half_batch", args.fault):
            for key, value in (line.get(name) or {}).items():
                lowest[f"{name}.{key}"] = min(lowest.get(f"{name}.{key}", float("inf")), value)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": cell["name"], "program_max": highest,
                      "fault_min": lowest}), flush=True)
    return 0


def half_batch(spec, mix, seed, device) -> dict:
    """The readings of the reference stepped on the first half of each of
    the check's batches, against the whole batches."""
    from portbench import traffic
    from portbench.reference import model as ref
    data, domain = spec.dataset.make_batch(mix["cases"], mix["n_internal"], mix["n_boundary"],
                                           mix["n_obs"], inputs.rng(seed, inputs.DATA))
    data = torch.from_numpy(data).to(device)
    domain = {k: torch.from_numpy(v).to(device) for k, v in domain.items()}
    model, _ = drive.program_model(spec, device)
    init = inputs.draw_weights(model.module.named_parameters(), seed, device)
    del model
    batches = [torch.as_tensor(b).to(device) for b in traffic.epochs(mix, seed, 1)[0][:3]]
    half = (mix["batch"] + 1) // 2
    steps = mix["cases"] // mix["batch"]
    lr = [ref.lr_at(spec.cfg, 2, steps)]
    with drive.precision("f32", device):
        whole = ref.train(spec, init, data, domain, batches, seed, steps)
        part = ref.train(spec, init, data, domain, [b[:half] for b in batches], seed, steps)
    return drive.train_readings(spec.cfg, (*part, lr), (*whole, lr))


@contextlib.contextmanager
def _patched_optimizer(**changes):
    """The program's optimizer recipe with ``changes`` to its fields."""
    from porous_cfd_tpu_torch.train import engine
    make = engine.make_optimizer
    engine.make_optimizer = lambda model, steps: dataclasses.replace(make(model, steps),
                                                                     **changes)
    try:
        yield
    finally:
        engine.make_optimizer = make


# faults planted in the program: a learning rate that never decays, and one
# that decays every step instead of every epoch
FAULTS = {"lr_flat": lambda: _patched_optimizer(lr_gamma=1.0),
          "lr_per_step": lambda: _patched_optimizer(steps_per_epoch=1)}


if __name__ == "__main__":
    sys.exit(main())
