"""Whole runs of the test-only tiny cells on the CPU: the result line, the
reference against the program's CPU path, the lower-precision control and
each fault the cells can have coming out as not correct, and the readers of
a metric added as a file."""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from portbench import drive, manifest as mf, run as bench_run
from portbench.tests.conftest import TINY_SATURATED, TINY_SERVE, TINY_TRAIN

CPU = torch.device("cpu")
SEED = 2 ** 31 + 97


def run_cell(root, cell, capsys, trace=0, seed=SEED):
    rc = bench_run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.2",
                         "--trace", str(trace)], device=CPU, root=root)
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("cell", ["pipn_duct2d.tiny_train", "pi_gano_duct2d.tiny_train",
                                  "pipn_duct2d.tiny_serve", "pipn_duct2d.tiny_serve_saturated"])
def test_result_line_and_correct(tiny_root, capsys, cell):
    line, err = run_cell(tiny_root, cell, capsys)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    names = {m["name"] for m in mf.metrics(mf.load(tiny_root), cell, False)}
    assert set(line["metrics"]) == names and "setup_s" in names
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    # each number compared beside its limit ends standard error
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


def test_a_saturated_window_ends_at_its_close(tiny_root):
    """Above capacity no request starts after the close: the window's work
    is what the system finished in it, and the check's sample is of those."""
    m = mf.load(tiny_root)
    spec = mf.spec(m, "pipn_duct2d", tiny_root)
    run, readings, _ = drive.run_cell(spec, TINY_SATURATED, SEED, 0.3, False, CPU,
                                      root=tiny_root)
    due = round(TINY_SATURATED["rate_rps"] * 0.3)
    assert 0 < run.attempted < due and len(run.latency_s) == run.attempted
    assert run.wall_s < 0.3 + 5 * max(run.service_s)
    assert readings["field_err"] < 1e-4


def test_traced_run_reports_its_host_metrics(tiny_root, capsys):
    line, _ = run_cell(tiny_root, "pipn_duct2d.tiny_train", capsys, trace=1)
    # no device trace on the CPU: the device readers find nothing and stay out
    assert set(line["metrics"]) == {"engine_host_ms.train", "mfu_pct.train"}


def test_cpu_is_refused_by_the_command_line(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc = bench_run.main(["--workload", "pipn_duct2d.train", "--seed", "1", "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


@pytest.mark.parametrize("cell", ["pipn_duct2d.tiny_train", "pi_gano_duct2d.tiny_train"])
def test_bf16_control_fails_a_training_limit(tiny_root, cell):
    m = mf.load(tiny_root)
    c = mf.cell(m, cell)
    run, readings, control = drive.run_cell(mf.spec(m, c["config"], tiny_root), TINY_TRAIN,
                                            SEED, 0.1, False, CPU, control="bf16",
                                            root=tiny_root)
    limits = mf.limits(cell, tiny_root)
    assert all(readings[k] <= v["limit"] / 10 for k, v in limits.items()), readings
    assert any(control[k] > v["limit"] for k, v in limits.items()), control


def test_bf16_control_fails_the_serving_limit(tiny_root):
    m = mf.load(tiny_root)
    run, readings, control = drive.run_cell(mf.spec(m, "pipn_duct2d", tiny_root), TINY_SERVE,
                                            SEED, 0.2, False, CPU, control="bf16",
                                            root=tiny_root)
    limit = mf.limits("pipn_duct2d.tiny_serve", tiny_root)["field_err"]["limit"]
    assert readings["field_err"] <= limit / 10 < limit < control["field_err"]


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from porous_cfd_tpu_torch.train import engine
    whole = engine.gather_cases
    monkeypatch.setattr(engine, "gather_cases",
                        lambda ds, idx: whole(ds, idx[:(len(idx) + 1) // 2]))


def _lr_flat(monkeypatch):
    """A learning rate that never decays."""
    from porous_cfd_tpu_torch.train import engine
    monkeypatch.setattr(engine.AdamExpLR, "lr", lambda self, step: self.learning_rate)


def _lr_per_step(monkeypatch):
    """The staircase stepped every step instead of every epoch."""
    from porous_cfd_tpu_torch.train import engine
    make = engine.make_optimizer
    monkeypatch.setattr(engine, "make_optimizer",
                        lambda model, steps: dataclasses.replace(make(model, steps),
                                                                 steps_per_epoch=1))


def _answer_altered(monkeypatch):
    from porous_cfd_tpu_torch.train import engine
    make = engine.make_predict_functions

    def altered(model, mesh=None):
        fns = make(model, mesh)

        def predict_batch(batch, verbose=False):
            pred, extra = fns.predict_batch(batch, verbose)
            pred.data[0, 0, 0] += 0.01 * pred.data.abs().max()
            return pred, extra

        return engine.PredictFunctions(fns.eval_batch, predict_batch)

    monkeypatch.setattr(engine, "make_predict_functions", altered)


@pytest.mark.parametrize("cell,fault", [("pipn_duct2d.tiny_train", _state_unchanged),
                                        ("pipn_duct2d.tiny_train", _half_batch),
                                        ("pi_gano_duct2d.tiny_train", _state_unchanged),
                                        ("pi_gano_duct2d.tiny_train", _half_batch),
                                        ("pipn_duct2d.tiny_train", _lr_flat),
                                        ("pipn_duct2d.tiny_train", _lr_per_step),
                                        ("pi_gano_duct2d.tiny_train", _lr_flat),
                                        ("pipn_duct2d.tiny_serve", _answer_altered),
                                        ("pipn_duct2d.tiny_serve_saturated", _answer_altered)],
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_is_not_correct(tiny_root, capsys, monkeypatch, cell, fault):
    fault(monkeypatch)
    line, _ = run_cell(tiny_root, cell, capsys)
    assert line["correct"] is False


def test_a_metric_added_as_a_file_is_read(tiny_root, capsys):
    """A later change adds a per-layer metric with a reader file and an
    entry, editing no file that is there."""
    reader = tiny_root / "portbench" / "metrics" / "steps_per_s.test.py"
    reader.write_text("def read(run):\n"
                      "    return run.attempted / run.wall_s if run.kind == 'train' else None\n")
    manifest = json.loads((tiny_root / "BENCHMARK.json").read_text())
    manifest["per_layer"].append({"name": "steps_per_s.test", "unit": "steps/s",
                                  "better": "higher", "source": "host_clock",
                                  "layer": "engine", "moves": "train_cases_per_s",
                                  "workloads": ["pipn_duct2d.tiny_train"]})
    path = tiny_root / "BENCHMARK.json"
    before = path.read_text()
    try:
        path.write_text(json.dumps(manifest))
        line, _ = run_cell(tiny_root, "pipn_duct2d.tiny_train", capsys, trace=1)
    finally:
        path.write_text(before)
        reader.unlink()
    assert line["metrics"]["steps_per_s.test"]["value"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["pipn_duct2d.tiny_train", "pi_gano_duct2d.tiny_train",
                                  "pipn_duct2d.tiny_serve"])
def test_tf32_control_fails_on_the_card(tiny_root, cell):
    """The control the limits were set against: the reference in TF32 in the
    program's place, at a test's size, on the card with the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m = mf.load(tiny_root)
    c = mf.cell(m, cell)
    run, readings, control = drive.run_cell(
        mf.spec(m, c["config"], tiny_root), mf.traffic(c["traffic"], tiny_root), SEED, 0.2,
        False, torch.device("cuda", 0), control="tf32", root=tiny_root)
    limits = mf.limits(cell, tiny_root)
    assert all(readings[k] <= v["limit"] for k, v in limits.items()), readings
    assert any(control[k] > v["limit"] for k, v in limits.items()), control


def test_training_readings_tell_a_norm_gap_from_a_difference():
    """A leaf's gradient turned with its norm kept moves the difference's
    norm and not the norms' gap; a pooled leaf's change does not move the
    number over the unpooled leaves."""
    cfg = {"pooled": ["enc."]}
    g = torch.arange(1.0, 7.0)
    ref_grad = {"enc.w": g.clone(), "dec.w": g.clone(), "dec.b": g.clone()}
    refs = ([1.0], ref_grad, dict(ref_grad), [1e-3])
    turned = dict(ref_grad, **{"dec.w": g.flip(0)})
    r = drive.train_readings(cfg, ([1.0], turned, dict(ref_grad), [1e-3]), refs)
    assert r["grad_gap"] == 0 and r["grad_diff_unpooled_median"] > 0 and r["lr_gap"] == 0
    pooled = dict(ref_grad, **{"enc.w": 2 * g})
    r = drive.train_readings(cfg, ([1.0], pooled, dict(ref_grad), [1e-3]), refs)
    assert r["grad_gap"] == pytest.approx(1.0)
    assert r["grad_diff_unpooled_median"] == 0


def test_a_family_a_dataset_and_a_kind_added_as_files(tiny_root, capsys):
    """A later change adds a model family (its work count and reference), a
    dataset and a kind of run as files of their own, with a configuration,
    a mix, a cell and its limits: no file that is there is edited, and the
    run reads each new file by the name the configuration and the mix give."""
    pb = tiny_root / "portbench"
    counter = ("\nCALLS = []\n_{f} = {f}\n\n\n"
               "def {f}(*args, **kwargs):\n"
               "    CALLS.append(1)\n"
               "    return _{f}(*args, **kwargs)\n")
    added = {pb / "families" / "pipn_twin.py": (pb / "families" / "pipn.py", "outputs"),
             pb / "datasets" / "foam2d_twin.py": (pb / "datasets" / "foam2d.py", "make_batch"),
             pb / "kinds" / "train_twin.py": (pb / "kinds" / "train.py", "Cell")}
    for path, (src, fn) in added.items():
        path.write_text(src.read_text() + counter.format(f=fn))
    cfg = json.loads((pb / "configs" / "pipn_duct2d.json").read_text())
    cfg.update(name="pipn_twin_duct2d", family="pipn_twin", dataset="foam2d_twin")
    extra = {pb / "configs" / "pipn_twin_duct2d.json": cfg,
             pb / "traffic" / "tiny_train_twin.json": dict(TINY_TRAIN, kind="train_twin")}
    for path, obj in extra.items():
        path.write_text(json.dumps(obj))
    limits = pb / "limits" / "pipn_twin_duct2d.tiny_train_twin.json"
    limits.write_text((pb / "limits" / "pipn_duct2d.train.json").read_text())
    manifest = json.loads((tiny_root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "pipn_twin_duct2d", "source": cfg["source"],
                                "file": "portbench/configs/pipn_twin_duct2d.json",
                                "reduced": [], "why": "a test's family"})
    manifest["workloads"].append({"name": "pipn_twin_duct2d.tiny_train_twin",
                                  "config": "pipn_twin_duct2d", "traffic": "tiny_train_twin",
                                  "chips": 1, "why": "a test's size"})
    for m in manifest["end_to_end"]:
        if "pipn_duct2d.train" in m.get("workloads", []):
            m["workloads"].append("pipn_twin_duct2d.tiny_train_twin")
    path = tiny_root / "BENCHMARK.json"
    before = path.read_text()
    try:
        path.write_text(json.dumps(manifest))
        line, _ = run_cell(tiny_root, "pipn_twin_duct2d.tiny_train_twin", capsys)
        calls = {p.stem: len(mf.plugin(p.parent.name, p.stem, tiny_root).CALLS) for p in added}
    finally:
        path.write_text(before)
        for p in [*added, *extra, limits]:
            p.unlink()
    assert line["correct"] is True and line["attempted"] > 0
    assert all(n > 0 for n in calls.values()), calls


def test_an_unknown_family_is_refused(tiny_root):
    m = mf.load(tiny_root)
    cfg = mf.config(m, "pipn_duct2d", tiny_root)
    with pytest.raises(KeyError, match="no families file"):
        mf.plugin("families", cfg["family"] + "_unknown", tiny_root)
