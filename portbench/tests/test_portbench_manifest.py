"""``BENCHMARK.json`` against the rules of its format, and every file it
names found by name."""
from __future__ import annotations

import json
import re

import pytest

from portbench import manifest as mf

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
M = mf.load()


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert M["paths"] == ["portbench"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len(M["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in M["command"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(section):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                             "workloads"}}[section]
    names = [e["name"] for e in M[section]]
    assert len(names) == len(set(names))
    for e in M[section]:
        assert set(e) <= allowed, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            if text is not None:
                assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metrics_moves_and_workloads():
    cells = {w["name"] for w in M["workloads"]}
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert {"train_cases_per_s", "predict_cases_per_s", "predict_p95_ms", "setup_s"} == set(e2e)
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for c in m["workloads"]:
            assert c in cells and c in moved.get("workloads", cells), (m["name"], c)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in cells:
        reports = [n for n, m in e2e.items() if c in m.get("workloads", cells)]
        assert "setup_s" in reports and len(reports) >= 2
        assert any(c in m["workloads"] for m in M["per_layer"])


def test_chips_and_configs_used():
    four = [w for w in M["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in M["workloads"])
    assert len(four) <= max(1, len(M["workloads"]) // 4)
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("entry", M["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    assert entry["file"].startswith("portbench/configs/")
    cfg = mf.config(M, entry["name"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["precision"] == "float32"


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda w: w["name"])
def test_cells_find_their_files(cell):
    mix = mf.traffic(cell["traffic"])
    assert callable(mf.plugin("kinds", mix["kind"]).Cell)
    spec = mf.spec(M, cell["config"])
    for fn in ("forward_shapes", "kernel_calls", "param_shapes", "pool_rows", "outputs",
               "porosity"):
        assert callable(getattr(spec.family, fn)), fn
    assert callable(spec.dataset.make_batch) and spec.dataset.DIMS == spec.cfg["dims"]
    limits = mf.limits(cell["name"])
    # each limit lies between the readings it was set from (an exact
    # comparison's sound runs read 0)
    assert limits and all(0 <= v["lower"] < v["limit"] < v["upper"] for v in limits.values())
    for m in mf.metrics(M, cell["name"], True):
        assert callable(mf.reader(m["name"]))


def test_every_metric_reader_finds_nothing_in_an_empty_run():
    from portbench.drive import Run
    for m in M["per_layer"]:
        for kind in ("train", "serve"):
            assert mf.reader(m["name"])(Run(kind)) is None


def test_file_under_limits():
    text = json.dumps(M)
    assert len(text.encode()) <= 64 * 1024
