"""Test-only cells at a size a CPU holds: a copy of the benchmark's files in a
temporary checkout, with tiny traffic mixes and cells added as files and
entries, the way a later change adds them."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

TINY_TRAIN = {"kind": "train", "cases": 8, "batch": 2, "n_internal": 24, "n_boundary": 16,
              "n_obs": 8, "warmup_epochs": 1, "profile_epochs": 1}
TINY_SERVE = {"kind": "serve", "pool": 12, "n_internal": 24, "n_boundary": 16, "min_cases": 2,
              "max_cases": 4, "rate_rps": 40, "check_requests": 3, "profile_requests": 4}
TINY_SATURATED = dict(TINY_SERVE, rate_rps=1000, stop_at_close=True)
TINY_MIXES = {"tiny_train": TINY_TRAIN, "tiny_serve": TINY_SERVE,
              "tiny_serve_saturated": TINY_SATURATED}
TINY_CELLS = {"pipn_duct2d.tiny_train": ("pipn_duct2d", "tiny_train"),
              "pi_gano_duct2d.tiny_train": ("pi_gano_duct2d", "tiny_train"),
              "pipn_duct2d.tiny_serve": ("pipn_duct2d", "tiny_serve"),
              "pipn_duct2d.tiny_serve_saturated": ("pipn_duct2d", "tiny_serve_saturated")}


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A checkout holding ``BENCHMARK.json`` and ``portbench/`` with the
    tiny cells added: three traffic files, four workload entries and their
    limits files (the cells' own, copied from the full-size cells')."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, mix in TINY_MIXES.items():
        (root / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for cell, (config, mix) in TINY_CELLS.items():
        manifest["workloads"].append({"name": cell, "config": config, "traffic": mix,
                                      "chips": 1, "why": "a CPU test's size"})
        full = f"{config}.{mix[len('tiny_'):]}"
        shutil.copy(root / "portbench" / "limits" / f"{full}.json",
                    root / "portbench" / "limits" / f"{cell}.json")
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if full in m.get("workloads", []):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return root
