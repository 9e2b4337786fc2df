"""Rules of the port: weights carry across both ways, entry points refuse to
fall back to the CPU without being asked, nothing in the port imports JAX or
the JAX package, and the kernel modules import without nvcc or a GPU."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from porous_cfd_tpu_torch.convert import params_from_flax, params_to_flax
from porous_cfd_tpu_torch.data.synthetic import (VARIABLE_BOUNDARIES, make_foam_batch,
                                                 make_scalers)
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.models.pi_gano import pi_gano, pi_gano_pp, pi_gano_pp_full
from porous_cfd_tpu_torch.models.pipn import (PipnModule, pipn_foam, pipn_foam_pp,
                                              pipn_foam_pp_full, pipn_foam_pp_mrg,
                                              pipn_manufactured_pp)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "porous_cfd_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "porous_cfd_tpu")
SMALL = dict(fe_local_layers=[2, 8, 8], fe_global_layers=[13, 8, 16],
             seg_layers=[24, 8, 3])
PI_GANO_SMALL = dict(out_features=3, branch_layers=[8, 16], geometry_layers=[7, 8],
                     local_layers=[2, 8], n_operators=2, operator_dropout=[0.0, 0.1],
                     variable_boundaries=VARIABLE_BOUNDARIES)
PP_SMALL = dict(fe_local_layers=[2, 8, 8], fe_global_layers=[[8, 8, 8], [10, 8, 8], [10, 8, 16]],
                fe_radius=[0.5, 1.0], fe_fraction=[0.5, 0.25], seg_layers=[24, 8, 3],
                max_neighbors=8)


def small_module(seed):
    return PipnModule(**SMALL, generator=torch.Generator().manual_seed(seed))


def test_convert_round_trip():
    src, dst = small_module(1), small_module(2)
    tree = params_to_flax(src)
    assert tree["decoder"]["linear_0"]["kernel"].shape == (24, 8)   # (in, out)
    params_from_flax(tree, dst)
    for (k, a), (_, b) in zip(src.state_dict().items(), dst.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    again = params_to_flax(dst)
    np.testing.assert_array_equal(again["feature_extract"]["global_feature"]
                                  ["linear_1"]["kernel"],
                                  tree["feature_extract"]["global_feature"]
                                  ["linear_1"]["kernel"])


def test_convert_rejects_wrong_trees():
    tree = params_to_flax(small_module(1))
    bad = params_to_flax(small_module(1))
    bad["decoder"]["linear_1"]["kernel"] = np.zeros((3, 8), np.float32)
    with pytest.raises(ValueError, match="decoder/linear_1/kernel"):
        params_from_flax(bad, small_module(2))
    missing = params_to_flax(small_module(1))
    del missing["decoder"]["linear_0"]["bias"]
    with pytest.raises(KeyError):
        params_from_flax(missing, small_module(2))
    extra = dict(tree, stray={"kernel": np.zeros(1, np.float32)})
    with pytest.raises(KeyError, match="stray"):
        params_from_flax(extra, small_module(2))


def test_dense_init_is_flax_lecun_normal():
    """Truncated normal with variance 1/fan_in, cut at two standard deviations
    of the untruncated draw, and a zero bias."""
    from porous_cfd_tpu_torch.models.mlp import dense
    lin = dense(256, 512, torch.Generator().manual_seed(0))
    w = lin.weight.detach()
    assert w.shape == (512, 256)
    assert abs(w.std().item() - 1 / 16) < 2e-3
    assert w.abs().max().item() <= 2 * (1 / 16) / 0.87962566103423978 + 1e-6
    assert torch.count_nonzero(lin.bias) == 0
    again = dense(256, 512, torch.Generator().manual_seed(0)).weight.detach()
    torch.testing.assert_close(w, again, rtol=0, atol=0)


def test_entry_points_refuse_cpu_without_being_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        pipn_foam(1e-3, 1.0, 1.0, **SMALL, scalers=make_scalers())
    with pytest.raises(RuntimeError, match="CUDA"):
        pi_gano(1e-3, **PI_GANO_SMALL, scalers=make_scalers())
    with pytest.raises(RuntimeError, match="CUDA"):
        pipn_foam_pp(1e-3, 1.0, 1.0, **PP_SMALL, scalers=make_scalers())
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_paths_raise():
    import dataclasses

    from porous_cfd_tpu_torch.train.engine import make_optimizer, make_train_functions
    model = pipn_foam(1e-3, 1.0, 1.0, **SMALL, scalers=make_scalers(),
                      seg_dropout=[0.1, 0.0], device="cpu")
    for knob in (dict(microbatch=1), dict(remat=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_train_functions(dataclasses.replace(model, **knob),
                                 make_optimizer(model, 1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_functions(model, make_optimizer(model, 1), mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipn_foam(1e-3, 1.0, 1.0, **SMALL, scalers=make_scalers(),
                  fast_derivatives=False, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipn_foam(1e-3, 1.0, 1.0, **SMALL, scalers=make_scalers(),
                  coupled_context=True, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.with_precision("bf16-mixed")
    for kwargs in (dict(full=True), dict(fast_derivatives=False)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pi_gano(1e-3, **PI_GANO_SMALL, scalers=make_scalers(), device="cpu", **kwargs)
    for factory in (pi_gano_pp, pi_gano_pp_full, pipn_foam_pp_mrg, pipn_manufactured_pp,
                    pipn_foam_pp_full):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            factory(1e-3, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipn_foam_pp(1e-3, 1.0, 1.0, **PP_SMALL, scalers=make_scalers(),
                     fast_derivatives=False, device="cpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_jax_import_anywhere_in_the_port():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import porous_cfd_tpu_torch\n"
        "import porous_cfd_tpu_torch.models.pipn\n"
        "import porous_cfd_tpu_torch.models.pi_gano\n"
        "for info in pkgutil.walk_packages(porous_cfd_tpu_torch.__path__,"
        " 'porous_cfd_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "", "PYTHONPATH": str(ROOT),
                              "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_kernel_modules_need_no_nvcc_or_gpu(monkeypatch):
    """Importing the kernel modules builds nothing; on CPU tensors the
    wrappers take the plain versions and never reach the build."""
    from porous_cfd_tpu_torch.ops import (build, decoder_cuda, fps_cuda, neural_op_cuda,
                                          pointnet_cuda, sa_cuda)

    def no_build(*args, **kwargs):
        raise AssertionError("the CPU path must not build a kernel")

    monkeypatch.setattr(build, "library", no_build)
    monkeypatch.setattr(build, "build_all", no_build)
    assert build.SOURCES == ("pointnet_global", "decoder_prop", "neural_op_prop",
                             "sa_neighborhood", "fps")
    for src in build.SOURCES:
        assert (build.CSRC / f"{src}.cu").exists()
    for header in build.HEADERS:
        assert (build.CSRC / header).exists()
    counters = (pointnet_cuda.pointnet_global, pointnet_cuda.pointnet_global_backward,
                decoder_cuda.decoder_prop, decoder_cuda.decoder_prop_backward,
                neural_op_cuda.neural_ops_prop, neural_op_cuda.neural_ops_prop_backward,
                sa_cuda.sa_neighborhood, sa_cuda.sa_neighborhood_backward,
                fps_cuda.farthest_point_sampling)
    before = [c.launches for c in counters]
    for model in (pipn_foam(1e-3, 1.0, 1.0, **SMALL, scalers=make_scalers(),
                            seg_dropout=[0.1, 0.0], device="cpu"),
                  pi_gano(1e-3, **PI_GANO_SMALL, scalers=make_scalers(), device="cpu"),
                  pipn_foam_pp(1e-3, 1.0, 1.0, **PP_SMALL, scalers=make_scalers(),
                               seg_dropout=[0.1, 0.0], device="cpu")):
        batch = model.attach_neighbors(make_foam_batch(1, 8, 4, 2, seed=0))
        out, jac, lap = model.derivative_apply(batch, deterministic=False, seed=5)
        assert out.shape == (1, 12, 3) and jac.shape == lap.shape == (1, 8, 3, 2)
        sum(o.sum() for o in (out, jac, lap)).backward()
    # the counters count kernel launches only
    assert [c.launches for c in counters] == before


def test_wrappers_reject_other_devices():
    from porous_cfd_tpu_torch.ops import decoder_cuda, pointnet_cuda
    mlp = small_module(0)
    x = torch.empty((1, 4, 13), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pointnet_cuda.pointnet_global(mlp.feature_extract.global_feature.linears,
                                      x, "silu")
    v = torch.empty((1, 4, 8), device="meta")
    jt = torch.empty((1, 2, 4, 8), device="meta")
    g = torch.empty((1, 1, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        decoder_cuda.decoder_prop(mlp.decoder.linears, 8, v, jt, jt, None, g, "silu")
    from porous_cfd_tpu_torch.ops import neural_op_cuda
    trunk = pi_gano(1e-3, **PI_GANO_SMALL, scalers=make_scalers(), device="cpu").module
    par = torch.empty((1, 1, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        neural_op_cuda.neural_ops_prop(trunk.neural_ops.linears, trunk.reduction, 8, v, jt,
                                       jt, None, v, par, "silu")
    from porous_cfd_tpu_torch.ops import fps_cuda, sa_cuda
    conv = pipn_foam_pp(1e-3, 1.0, 1.0, **PP_SMALL, scalers=make_scalers(),
                        device="cpu").module.feature_extract.global_feature.sa_1.conv_mlp
    x = torch.empty((1, 4, 8), device="meta")
    idx = torch.empty((1, 2, 8), dtype=torch.int64, device="meta")
    mask = torch.empty((1, 2, 8), dtype=torch.bool, device="meta")
    rel = torch.empty((1, 2, 8, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sa_cuda.sa_neighborhood(conv.linears, x, idx, mask, rel, "silu")
    with pytest.raises(ValueError, match="no kernel"):
        sa_cuda.sa_neighborhood(conv.linears, x, idx, mask, rel, "silu",
                                torch.empty((1, 16, 8), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        fps_cuda.farthest_point_sampling(torch.empty((2, 10, 2), device="meta"), 4)
