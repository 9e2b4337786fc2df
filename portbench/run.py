"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as its last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` the
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit, which also end standard error. Earlier lines
give the card, its power limit and the per-kernel detail. Exits non-zero,
with no result, without a CUDA card or with fewer than the cell asks for,
and if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "porous_cfd_tpu")


def loaded_forbidden() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``porous_cfd_tpu_torch`` is not ``porous_cfd_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_label(device) -> str | None:
    """``nvidia-smi``'s name and power limit of the card; None off the card."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", str(device.index or 0)],
                             capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip()


def end_to_end(run) -> dict:
    """The end-to-end metrics a run measured, by name."""
    out = {"setup_s": run.setup_s}
    if run.kind == "train":
        out["train_cases_per_s"] = run.cases / run.wall_s
    else:
        out["predict_cases_per_s"] = run.cases / run.wall_s
        lat = sorted(run.latency_s)
        out["predict_p95_ms"] = statistics.quantiles(lat, n=20)[18] * 1e3 if len(lat) > 1 \
            else lat[0] * 1e3
    return out


def result(manifest, cell, run, readings, limits, traced: bool, device, root) -> dict:
    """The result line's object, ``checks`` last."""
    from portbench import manifest as mf
    import torch
    values = {}
    if traced:
        for m in mf.metrics(manifest, cell["name"], True):
            v = mf.reader(m["name"], root)(run)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = end_to_end(run)
        for m in mf.metrics(manifest, cell["name"], False):
            values[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    checks = {k: {"value": readings[k], "limit": v["limit"]} for k, v in limits.items()}
    correct = run.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": values, "device": dev}
    if traced and run.traced:
        dev["busy_s"] = run.traced["busy_s"]
        dev["window_s"] = run.traced["window_s"]
        out["breakdown"] = {"device_ops": run.traced["device_ops"],
                            "idle_gaps": run.traced["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv=None, device=None, root=None) -> int:
    """The command line; ``device`` and ``root`` (the checkout whose
    ``BENCHMARK.json`` and ``portbench/`` files are read) are for tests,
    which run it on the CPU."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from portbench import drive, manifest as mf
    root = mf.ROOT if root is None else root
    manifest = mf.load(root)
    cell = mf.cell(manifest, args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"portbench: {cell['name']} needs {cell['chips']} CUDA card(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    spec = mf.spec(manifest, cell["config"], root)
    mix = mf.traffic(cell["traffic"], root)
    limits = mf.limits(cell["name"], root)
    card = card_label(device)
    if device.type == "cuda":
        from porous_cfd_tpu_torch.ops import build
        built = build.build_all(tuple(spec.cfg["kernels"]))
        print(json.dumps({"built_s": built, "card": card}), flush=True)
    run, readings, _ = drive.run_cell(spec, mix, args.seed, args.seconds, bool(args.trace),
                                      device, T_START, root=root)
    found = loaded_forbidden()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    out = result(manifest, cell, run, readings, limits, bool(args.trace), device, root)
    detail = {"card": card, "device": out["device"]["kind"], "count": cell["chips"],
              "requests_or_steps": run.attempted, "cases": run.cases,
              "window_s": run.wall_s, "setup_s": run.setup_s, "check_s": run.check_s}
    if run.timeline:
        # steps enqueued in each second of the window, on the host's clock
        marks = [next(n for t, n in run.timeline if t >= k) for k in range(1, int(run.wall_s))]
        detail["steps_by_second"] = [b - a for a, b in zip([0] + marks, marks)]
    if args.trace:
        detail["kernel_bound_s"] = run.kernel_bounds
        detail["traced"] = {k: v for k, v in run.traced.items()
                            if k not in ("device_ops", "idle_gaps")}
    print(json.dumps(detail), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']:.6g} limit {c['limit']:.6g}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
