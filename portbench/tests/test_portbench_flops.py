"""The frozen FLOP inventory and the per-kernel counts against hand counts at
the envelope, and each configuration's widths against the module its
example builds."""
from __future__ import annotations

import pytest
import torch

from portbench import drive, flops, manifest as mf

M = mf.load()
PIPN = mf.spec(M, "pipn_duct2d")
GANO = mf.spec(M, "pi_gano_duct2d")
B, NI, NB = 13, 1500, 1000


def macs(widths):
    return sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def test_pipn_step_inventory():
    vjh, every = B * (NI * 5 + NB), B * (NI + NB)
    fwd = 2 * (vjh * macs([2, 64, 64]) + every * macs([69, 96, 128, 1024])
               + vjh * (64 * 512 + macs([512, 256, 128, 3])) + B * 1024 * 512)
    assert flops.step_flops(PIPN, B, NI, NB) == pytest.approx(3 * fwd)
    # the program's own count at commit 4a0a8ad, PERF.md's 162.7 GFLOP a step
    assert flops.step_flops(PIPN, B, NI, NB) / 1e9 == pytest.approx(162.7, abs=0.05)


def test_pi_gano_step_inventory_counts_the_branch_at_its_rows():
    vjh, every, branch = B * (NI * 5 + NB), B * (NI + NB), B * (NI + NB // 4)
    assert branch == 13 * 1750
    fwd = 2 * (branch * macs([8, 128, 352, 352, 352]) + every * macs([7, 64, 176, 176, 176])
               + vjh * macs([2, 64, 176, 176, 176]) + vjh * 4 * 352 * 352 + vjh * 352 * 3)
    assert flops.step_flops(GANO, B, NI, NB) == pytest.approx(3 * fwd)
    # 429.0 GFLOP with the branch at 1,600 rows, plus 150 rows a case
    extra = 3 * 2 * B * 150 * macs([8, 128, 352, 352, 352])
    assert (flops.step_flops(GANO, B, NI, NB) - extra) / 1e9 == pytest.approx(429.0, abs=0.05)


def test_kernel_counts_at_the_envelope():
    pipn = {n: f for n, f, _ in flops.kernel_calls(PIPN, B, NI, NB,
                                                   {"pointnet_global": 6200}, True)}
    # the kernel table's work column (PERF.md, PRs 7-8)
    assert pipn["pointnet_global.fwd"] / 1e9 == pytest.approx(9.75, abs=0.01)
    assert pipn["decoder_prop.fwd"] / 1e9 == pytest.approx(43.5, abs=0.05)
    assert pipn["decoder_prop.bwd"] == pytest.approx(2 * pipn["decoder_prop.fwd"])
    assert pipn["pointnet_global.bwd"] / 1e9 == pytest.approx(0.71, abs=0.01)
    gano = {n: f for n, f, _ in flops.kernel_calls(
        GANO, B, NI, NB, {"pointnet_global.geometry": 1231, "pointnet_global.branch": 1793},
        True)}
    assert gano["pointnet_global.geometry.fwd"] / 1e9 == pytest.approx(4.79, abs=0.01)
    assert gano["pointnet_global.branch.fwd"] / 1e9 == pytest.approx(13.37, abs=0.01)
    assert gano["neural_ops_prop.fwd"] / 1e9 == pytest.approx(96.1, abs=0.05)
    assert gano["pointnet_global.geometry.bwd"] / 1e9 == pytest.approx(0.32, abs=0.01)
    assert gano["pointnet_global.branch.bwd"] / 1e9 == pytest.approx(1.84, abs=0.01)


def test_bound_is_the_larger_of_operations_and_bytes():
    assert flops.bound_s(494.7e12, 0) == pytest.approx(1.0)
    assert flops.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert flops.bound_s(494.7e9, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("spec", [PIPN, GANO], ids=lambda s: s.cfg["name"])
def test_widths_match_the_built_module(spec):
    cfg = spec.cfg
    model, scaler = drive.program_model(spec, torch.device("cpu"))
    shapes = {n: tuple(p.shape) for n, p in model.module.named_parameters()}
    assert shapes == spec.family.param_shapes(cfg)
    # each MLP's widths, read back from the module's layers
    for prefix, key in (("feature_extract.local_feature", "fe_local_layers"),
                        ("feature_extract.global_feature", "fe_global_layers"),
                        ("decoder", "seg_layers"), ("geometry_encoder.linear", "geometry_layers"),
                        ("branch.linear", "branch_layers"), ("points_encoder", "local_layers")):
        if key in cfg:
            got = [shapes[f"{prefix}.linear_0.weight"][1]] + [
                shapes[f"{prefix}.linear_{i}.weight"][0] for i in range(len(cfg[key]) - 1)]
            assert got == cfg[key], key
    if "operator_dropout" in cfg:
        f = cfg["local_layers"][-1] + cfg["geometry_layers"][-1]
        for i, rate in enumerate(cfg["operator_dropout"]):
            assert shapes[f"neural_ops.operator_{i}.Dense_0.weight"] == (f, f)
            assert model.module.neural_ops.operators[i].dropout == rate
        assert shapes["reduction.weight"] == (cfg["dims"] + 1, f)
    if "seg_dropout" in cfg:
        assert list(model.module.seg_dropout) == cfg["seg_dropout"]
    assert list(scaler.weights) == cfg["loss_weights"]
    assert model.learning_rate == cfg["learning_rate"] and model.lr_gamma == cfg["lr_gamma"]
    assert model.adam_eps == cfg["adam_eps"]
    assert model.momentum_loss.nu == cfg["nu"]
    assert model.dims == cfg["dims"]
    if "d" in cfg:
        assert (model.momentum_loss.d, model.momentum_loss.f) == (cfg["d"], cfg["f"])


def test_a_module_of_other_widths_is_refused():
    cfg = dict(PIPN.cfg, seg_layers=[1088, 512, 256, 64, 3])
    with pytest.raises(ValueError, match="other widths"):
        drive.program_model(mf.Spec(cfg, PIPN.family, PIPN.dataset), torch.device("cpu"))


def test_the_count_follows_the_dimensions():
    """A point's (v, J, H) rows are 1 + 2D: the same widths at D = 3 count
    the internal rows at 7 a point."""
    cfg3 = dict(PIPN.cfg, dims=3)
    shapes2 = PIPN.family.forward_shapes(PIPN.cfg, B, NI, NB)
    shapes3 = PIPN.family.forward_shapes(cfg3, B, NI, NB)
    assert shapes2[0][0] == B * (NI * 5 + NB) and shapes3[0][0] == B * (NI * 7 + NB)
