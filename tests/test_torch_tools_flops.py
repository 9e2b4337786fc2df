"""The port's FLOP inventory (``porous_cfd_tpu_torch/tools/roofline.py``)
against the JAX tool's (``tools/roofline.py``, loaded by path), with the
port's two documented differences applied here: (a) ``1 + 2D`` (v, J,
H-diag) rows an internal point; (b) the PIPN decoders' first layer on its 64
local columns every row and its 1024 context columns once a case. Then the
arithmetic of ``roofline``, ``mfu`` and ``profile_step`` at fixed times and
rates, and the inventory's widths against the bench zoo's models."""
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from porous_cfd_tpu_torch import bench
from porous_cfd_tpu_torch.tools import mfu, profile_step, roofline
from porous_cfd_tpu_torch.tools.pieces import ENVELOPE, Envelope

ROOT = Path(__file__).resolve().parents[1]
TINY = Envelope(cases=2, batch=2, n_int=24, n_bnd=16, n_obs=8)


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_roofline_tool", ROOT / "tools/roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def with_differences(jax_tool, family):
    """The JAX tool's inventory with (a) and (b) applied."""
    saved = jax_tool.R_VJH, jax_tool.R_WINNER
    vjh = 1 + 2 * jax_tool.N_DIMS
    jax_tool.R_VJH = jax_tool.BATCH * (jax_tool.N_INT * vjh + jax_tool.N_BND)
    jax_tool.R_WINNER = jax_tool.BATCH * jax_tool.F_GLOBAL * vjh
    try:
        shapes = jax_tool.family_shapes(family)
    finally:
        jax_tool.R_VJH, jax_tool.R_WINNER = saved
    if family == "pipn_exact":        # the exact path keeps the JAX count
        return jax_tool.family_shapes(family)
    out = []
    for m, k, n in shapes:
        if k == 1024 + 64 and family in ("pipn", "pipn_coupled", "pipn_pp"):
            out += [(m, 64, n), (jax_tool.BATCH, 1024, n)]
        else:
            out.append((m, k, n))
    return out


@pytest.mark.parametrize("family", roofline.FAMILIES)
def test_family_shapes_equal_the_jax_tools_up_to_the_two_differences(jax_tool, family):
    assert roofline.family_shapes(family) == with_differences(jax_tool, family)


def test_the_differences_are_what_the_paths_compute(jax_tool):
    # (a): the JAX tool counts the whole symmetric Hessian; the port the diagonal
    assert jax_tool.VJH == 1 + 2 + 3 and roofline.VJH == 1 + 2 * 2
    # (b): pipn's decoder forward, one decoder_prop call (both launches)
    port = roofline.decoder_fwd_flops("pipn")
    local_rows = 13 * (1500 * 5 + 1000)
    assert port == 2.0 * local_rows * (64 * 512 + 512 * 256 + 256 * 128 + 128 * 3) \
        + 2.0 * 13 * 1024 * 512
    assert abs(port / 43.54e9 - 1) < 5e-4 and round(port / 1e9, 1) == 43.5
    jax_count = sum(2.0 * m * k * n for m, k, n in jax_tool.family_shapes("pipn")[-4:])
    assert round(jax_count / 1e9, 1) == 187.5       # 4.3 times the port's
    assert roofline.step_flops("pipn") == 3 * sum(2.0 * m * k * n
                                                  for m, k, n in roofline.family_shapes("pipn"))


def test_inventory_widths_are_the_bench_zoos():
    def widths(linears):
        return [linears[0].in_features] + [lin.out_features for lin in linears]

    pipn = bench.make_model("pipn", "cpu")[0].module
    assert widths(pipn.feature_extract.local_feature.linears) == roofline.PIPN_LOCAL
    assert widths(pipn.feature_extract.global_feature.linears) == roofline.PIPN_GLOBAL
    assert widths(pipn.decoder.linears) == roofline.PIPN_SEG
    pp = bench.make_model("pipn_pp", "cpu")[0].module
    seq = pp.feature_extract.global_feature
    assert [widths(getattr(seq, f"sa_{i}").conv_mlp.linears) for i in range(2)] \
        + [widths(seq.global_sa.mlp.linears)] == list(roofline.PP_SA)
    assert tuple(seq.fraction) == roofline.PP_FRACTION and pp.max_neighbors == 64
    assert widths(pp.decoder.linears) == roofline.PP_SEG
    pg = bench.make_model("pi_gano", "cpu")[0].module
    assert widths(pg.branch.linear.linears) == roofline.PG_BRANCH
    assert widths(pg.geometry_encoder.linear.linears) == roofline.PG_GEOMETRY
    assert widths(pg.points_encoder.linears) == roofline.PG_LOCAL
    assert widths(pg.neural_ops.linears) == roofline.PG_TRUNK
    assert widths([pg.reduction]) == roofline.PG_REDUCTION


def test_roofline_arithmetic_at_fixed_rates(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(roofline, "measure_dot_rate", lambda m, k, n, device: 2e12)
    target = tmp_path / "doc.md"
    target.write_text("# doc\n\n<!-- ROOFLINE:begin -->\nold\n<!-- ROOFLINE:end -->\ntail\n")
    out = roofline.run(["--families", "pipn,pi_gano", "--peak-tflops", "40",
                        "--measured", json.dumps({"pipn": 100.0}), "--update", str(target)],
                       device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["per_family"] \
        == json.loads(json.dumps(out["per_family"]))
    e = out["per_family"]["pipn"]
    flops = roofline.step_flops("pipn")
    assert e["matmul_gflops_per_step"] == pytest.approx(flops / 1e9)
    assert e["dot_model_ms"] == pytest.approx(flops / 2e12 * 1e3)
    assert e["measured_ms"] == pytest.approx(10.0)
    assert e["fusion_speedup_vs_dot_model"] == pytest.approx(flops / 2e12 * 1e3 / 10.0)
    assert e["achieved_tflops"] == pytest.approx(flops / 0.01 / 1e12)
    assert e["pct_of_matmul_peak"] == pytest.approx(100 * flops / 0.01 / 40e12)
    assert e["decoder_fwd_gflops"] == pytest.approx(roofline.decoder_fwd_flops("pipn") / 1e9)
    assert "measured_ms" not in out["per_family"]["pi_gano"]
    text = target.read_text()
    assert text.startswith("# doc\n\n<!-- ROOFLINE:begin -->") and text.endswith(
        "<!-- ROOFLINE:end -->\ntail\n")
    assert "old" not in text and "| pipn |" in text and "not measured" in text
    # a file without the block gets one appended
    other = tmp_path / "other.md"
    other.write_text("text\n")
    roofline.run(["--families", "pipn", "--peak-tflops", "40", "--update", str(other)],
                 device="cpu")
    assert other.read_text().startswith("text\n\n<!-- ROOFLINE:begin -->")


def fake_subject(*args, **kwargs):
    return SimpleNamespace(fns=SimpleNamespace(train_step=None, eval_batch=None), state=None,
                           batch=None)


def test_mfu_arithmetic_at_fixed_rates(monkeypatch, tmp_path):
    monkeypatch.setattr(mfu, "measure_matmul_peak",
                        lambda device: {"f32": 50e12, "bf16": 400e12})
    monkeypatch.setattr(mfu, "load_subject", fake_subject)
    monkeypatch.setattr(mfu.profiling, "steps_per_sec", lambda *a, **k: (40.0, None))
    target = tmp_path / "PERF.md"
    out = mfu.run(["--families", "pipn,pipn_exact", "--update", str(target)], device="cpu")
    for family in ("pipn", "pipn_exact"):
        r = out["families"][family]
        flops = roofline.step_flops(family)
        assert r["flops_per_step"] == flops and r["steps_per_sec"] == 40.0
        assert r["mfu_vs_f32_peak"] == pytest.approx(flops * 40 / 50e12)
        assert r["mfu_vs_bf16_peak"] == pytest.approx(flops * 40 / 400e12)
        assert 0 < r["mfu_vs_bf16_peak"] < r["mfu_vs_f32_peak"] <= 1
    assert out["matmul_peak_tflops"] == {"f32": 50.0, "bf16": 400.0}
    text = target.read_text()
    assert text.count("<!-- MFU:begin -->") == 1 and "| pipn_exact |" in text


def test_profile_step_arithmetic_at_fixed_rates(monkeypatch):
    monkeypatch.setattr(profile_step, "matmul_rate",
                        lambda device, m, k, n, tf32: 400e12 if tf32 else 50e12)
    monkeypatch.setattr(profile_step, "load_subject", fake_subject)
    monkeypatch.setattr(profile_step, "time_piece",
                        lambda fn, device: {"device_ms": None, "wall_ms": 1.0})
    monkeypatch.setattr(profile_step.profiling, "steps_per_sec", lambda *a, **k: (50.0, None))
    out = profile_step.run(["--family", "pi_gano"], device="cpu")
    flops = roofline.step_flops("pi_gano")
    assert out["train_step_ms"] == pytest.approx(20.0)
    assert out["inventory_step_gflops"] == pytest.approx(flops / 1e9)
    assert out["achieved_tflops"] == pytest.approx(flops * 50 / 1e12)
    assert out["mfu_vs_f32_peak_pct"] == pytest.approx(100 * flops * 50 / 50e12)
    assert out["mfu_vs_tf32_peak_pct"] == pytest.approx(100 * flops * 50 / 400e12)
    assert out["matmul_peak_tf32_tflops"] == 400.0 and out["matmul_peak_f32_tflops"] == 50.0


def test_dot_rate_and_peak_measure_on_the_cpu():
    """The timing paths run (host clock on the CPU) and give positive rates."""
    cpu = torch.device("cpu")
    assert roofline.measure_dot_rate(64, 32, 16, cpu) > 0
    peak = mfu.measure_matmul_peak(cpu, n=64, iters=2)
    assert set(peak) == {"f32", "bf16"} and min(peak.values()) > 0
    assert profile_step.matmul_rate(cpu, 64, 32, 16, False) > 0


def test_cut_envelope_counts():
    r = roofline.rows(TINY)
    assert r == {"vjh": 2 * (24 * 5 + 16), "all": 2 * 40, "exact": 2 * 40 * 7,
                 "winner": 2 * 1024 * 5}
    # PI-GANO's branch keeps the JAX tool's 1,600 rows a case
    assert roofline.family_shapes("pi_gano", TINY)[0] == (2 * 1600, 8, 128)
    assert roofline.rows() == roofline.rows(ENVELOPE)
