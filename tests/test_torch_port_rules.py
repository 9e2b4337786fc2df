"""Rules of the port: weights carry across both ways, entry points refuse to
fall back to the CPU without being asked, nothing in the port imports JAX or
the JAX package, and the kernel modules import without nvcc or a GPU."""
import ast
import importlib
import shutil
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
                                              pipn_manufactured, pipn_manufactured_pp)
from porous_cfd_tpu_torch.parallel.mesh import make_mesh

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "porous_cfd_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "porous_cfd_tpu")
# the JAX package's example and tool scripts and its bench, which the port
# keeps its own counterparts of
FORBIDDEN_SCRIPTS = ("examples", "tools", "bench")
# the port's measurement tools (porous_cfd_tpu_torch/tools/)
MEASUREMENT_TOOLS = ("pieces", "roofline", "mfu", "profile_step", "profile_pp", "profile_gano",
                     "profile_delta", "measure_full_rates", "torch_baseline", "samehost_ratio",
                     "make_mesh_assets", "render_smoke")
# the drawing and table libraries the card's machine lacks
PLOTTING = ("matplotlib", "pandas")
EXPERIMENTS = ("duct_fixed_boundary", "duct_fixed_boundary_hard",
               "vertical_duct_fixed_boundary", "duct_variable_boundary",
               "manufactured_solutions", "abc", "windbreaks")
# the experiments whose generate_data drives OpenFOAM (datagen/generator.py)
GENERATED = tuple(e for e in EXPERIMENTS if e != "manufactured_solutions")
SMALL = dict(fe_local_layers=[2, 8, 8], fe_global_layers=[13, 8, 16],
             seg_layers=[24, 8, 3])
PI_GANO_SMALL = dict(out_features=3, branch_layers=[8, 16], geometry_layers=[7, 8],
                     local_layers=[2, 8], n_operators=2, operator_dropout=[0.0, 0.1],
                     variable_boundaries=VARIABLE_BOUNDARIES)
PP_SMALL = dict(fe_local_layers=[2, 8, 8], fe_global_layers=[[8, 8, 8], [10, 8, 8], [10, 8, 16]],
                fe_radius=[0.5, 1.0], fe_fraction=[0.5, 0.25], seg_layers=[24, 8, 3],
                max_neighbors=8)
PI_GANO_PP_SMALL = dict(PI_GANO_SMALL, geometry_layers=[[8, 8], [10, 8], [10, 8]],
                        geometry_radius=[0.5, 1.0], geometry_fraction=[0.5, 0.25],
                        max_neighbors=8)
# the MRG encoder's widths are the model's own; the local and decoder stacks
# are narrow
MRG_SMALL = dict(n_dims=2, mrg_in_features=6, fe_local_layers=[2, 8, 8],
                 seg_layers=[1024 + 8, 8, 3], max_neighbors=8)
UNET_ENC = dict(enc_layers=[[9, 8, 8], [10, 8, 8], [10, 16]], enc_radius=[0.5, 1.0],
                enc_fraction=[0.5, 0.25], dec_layers=[[24, 8], [16, 8], [15, 8, 3]],
                dec_k=[3, 3, 3], max_neighbors=8)
UNET_SMALL = dict(UNET_ENC, nu=1e-3, d=1.0, f=1.0, dec_dropout=[0, 0, [0.1, 0]])
UNET_GANO_SMALL = dict(UNET_ENC, nu=1e-3, out_features=3, branch_layers=[8, 16],
                       fp_dropout=[0, 0, [0.1, 0]], variable_boundaries=VARIABLE_BOUNDARIES)


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
    with pytest.raises(RuntimeError, match="CUDA"):
        pipn_manufactured(1e-2, 50.0, 1.0, [2, 8, 8], [11, 8, 16], [24, 8, 3])
    with pytest.raises(RuntimeError, match="CUDA"):
        pipn_foam_pp_mrg(nu=1e-3, d=1.0, f=1.0, **MRG_SMALL, scalers=make_scalers())
    # the entry points ask for the card before they read or write anything
    from porous_cfd_tpu_torch import bench
    from porous_cfd_tpu_torch.examples.duct_fixed_boundary import evaluate, inference, train
    from porous_cfd_tpu_torch.examples import abc, duct_variable_boundary, windbreaks
    from porous_cfd_tpu_torch.tools import golden_spread, train_golden_3d, train_golden_duct
    missing = ["--checkpoint", "no/model.ckpt", "--data-dir", "no/split"]
    entries = [(train.run, ["--model", "pipn", "--train-dir", "no/split"]),
               (inference.run, missing), (evaluate.run, missing), (bench.run, []),
               (train_golden_duct.main, ["--root", "no/golden"]),
               (golden_spread.main, ["--root", "no/golden"]),
               (train_golden_3d.main, ["--root", "no/golden"])]
    # the 3D experiments' CLIs and the variable duct's inference and evaluate
    import importlib
    for pkg, model in ((abc, "pipn"), (windbreaks, "pi-gano"), (duct_variable_boundary, None)):
        for cli in ("train", "inference", "evaluate"):
            mod = importlib.import_module(f"{pkg.__name__}.{cli}")
            if cli == "train":
                entries.append((mod.run, ["--model", model or "pi-gano", "--train-dir",
                                          "no/split"]))
            else:
                entries.append((mod.run, missing))
    for entry, argv in entries:
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(argv)
    from porous_cfd_tpu_torch.datagen.fvm3d_batch import solve_duct3_batch
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_duct3_batch([("sphere", (0.1, 0.0, 0.0), 0.14, 0.2)], nx=8, ny=6, nz=6)
    # the 2D batched solver, the grid tools and the hard and vertical CLIs
    from porous_cfd_tpu_torch.datagen.fvm_batch import solve_duct_batch
    with pytest.raises(RuntimeError, match="CUDA"):
        solve_duct_batch([dict(shape="circle")], nx=8, ny=6)
    from porous_cfd_tpu_torch.examples import duct_fixed_boundary_hard, vertical_duct_fixed_boundary
    from porous_cfd_tpu_torch.tools import (analyze_grid_errors, analyze_p_offset,
                                            golden_transform_grid, train_golden_grid,
                                            train_golden_variable)
    later = [(golden_transform_grid.main, ["fixed", "--root", "no/grid"]),
             (train_golden_grid.main, ["--root", "no/grid"]),
             (train_golden_variable.main, ["--root", "no/grid"]),
             (analyze_grid_errors.main, ["--root", "no/grid"]),
             (analyze_p_offset.main, ["--root", "no/grid"])]
    for pkg in (duct_fixed_boundary_hard, vertical_duct_fixed_boundary):
        for cli in ("train", "inference", "evaluate"):
            mod = importlib.import_module(f"{pkg.__name__}.{cli}")
            later.append((mod.run, ["--model", "pipn", "--train-dir", "no/split"]
                          if cli == "train" else missing))
    # the seven compare CLIs
    for experiment in EXPERIMENTS:
        mod = importlib.import_module(f"porous_cfd_tpu_torch.examples.{experiment}.compare")
        later.append((mod.run, missing + ["--checkpoint-other", "no/other.ckpt"]))
    # the measurement tools (make_mesh_assets and render_smoke run no device)
    from porous_cfd_tpu_torch.tools import (measure_full_rates, mfu, profile_delta,
                                            profile_gano, profile_pp, profile_step, roofline,
                                            samehost_ratio, torch_baseline)
    from porous_cfd_tpu_torch.utils import profiling
    for tool in (roofline, mfu, profile_step, profile_pp, profile_gano, profile_delta,
                 measure_full_rates, torch_baseline, samehost_ratio):
        later.append((tool.run, []))
    later.append((lambda argv: profiling.device_ms(lambda: None), []))
    for entry, argv in later:
        with pytest.raises(RuntimeError, match="CUDA"):
            entry(argv)
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_paths_raise():
    """Named when more of the port raised: now nothing does (multi-device
    training on both axes is ported), and every path it once refused builds
    and steps."""
    import dataclasses

    from porous_cfd_tpu_torch.train.engine import make_optimizer, make_train_functions
    model = pipn_foam(1e-3, 1.0, 1.0, **SMALL, scalers=make_scalers(),
                      seg_dropout=[0.1, 0.0], device="cpu")
    # micro-batch accumulation is ported (tests/test_torch_unet.py holds it
    # to the JAX engine): it takes a training step on either path
    foam = make_foam_batch(2, 20, 16, 4, seed=5)
    for fast in (True, False):
        base = pipn_foam(1e-3, 1.0, 1.0, **SMALL, scalers=make_scalers(),
                         fast_derivatives=fast, device="cpu")
        knobbed = dataclasses.replace(base, microbatch=1)
        fns = make_train_functions(knobbed, make_optimizer(knobbed, 1))
        state, m = fns.train_step(fns.init_state(seed=1), foam)
        assert state.step == 1 and bool(torch.isfinite(m).all())
    # a mesh is a parallel.mesh.Mesh; points sharding of PIPN++ is ported
    # (tests/test_torch_parallel.py holds every path to one process)
    with pytest.raises(TypeError):
        make_train_functions(model, make_optimizer(model, 1), mesh=object())
    pp = pipn_foam_pp(1e-3, 1.0, 1.0, **PP_SMALL, scalers=make_scalers(), device="cpu")
    fns = make_train_functions(pp, make_optimizer(pp, 1), mesh=make_mesh(1, 1, devices=["cpu"]),
                               shard_points=True)
    state, m = fns.train_step(fns.init_state(seed=1), pp.attach_neighbors(foam))
    assert state.step == 1 and bool(torch.isfinite(m).all())
    # PIPN's exact and coupled paths, PiGanoFull, PI-GANO++, PIPN++ MRG and
    # bf16-mixed are ported; so are the exact paths of PI-GANO (its default,
    # with full too), PI-GANO++, PIPN++ and PIPN++ MRG, and the manufactured
    # PIPN++: each builds and takes a training step
    for kwargs in (dict(fast_derivatives=False), dict(coupled_context=True)):
        assert pipn_foam(1e-3, 1.0, 1.0, **SMALL, scalers=make_scalers(), device="cpu",
                         **kwargs) is not None
    assert model.with_precision("bf16-mixed").eval_dtype == torch.bfloat16
    assert pi_gano(1e-3, **PI_GANO_SMALL, scalers=make_scalers(), device="cpu",
                   full=True).module.full
    from porous_cfd_tpu_torch.data.manufactured import make_manufactured_batch
    manufactured = make_manufactured_batch(np.random.default_rng(5), 2, 20, 16)
    exact = [(pi_gano(1e-3, **PI_GANO_SMALL, scalers=make_scalers(), device="cpu"), foam),
             (pi_gano(1e-3, **PI_GANO_SMALL, scalers=make_scalers(), device="cpu",
                      full=True), foam),
             (pi_gano_pp(1e-3, **PI_GANO_PP_SMALL, scalers=make_scalers(), device="cpu",
                         fast_derivatives=False), foam),
             (pipn_foam_pp(1e-3, 1.0, 1.0, **PP_SMALL, scalers=make_scalers(),
                           fast_derivatives=False, device="cpu"), foam),
             (pipn_foam_pp_mrg(nu=1e-3, d=1.0, f=1.0, **MRG_SMALL, scalers=make_scalers(),
                               fast_derivatives=False, device="cpu"), foam),
             (pipn_manufactured_pp(1e-2, 50.0, 1.0, [2, 8, 8], [[6, 8], [10, 8], [10, 16]],
                                   [0.6, 1.2], [0.5, 0.25], [24, 8, 3], max_neighbors=8,
                                   fast_derivatives=False, device="cpu"), manufactured)]
    for exact_model, batch in exact:
        assert exact_model.derivative_apply is None
        fns = make_train_functions(exact_model, make_optimizer(exact_model, 1))
        state, m = fns.train_step(fns.init_state(seed=1), exact_model.attach_neighbors(batch))
        assert state.step == 1 and bool(torch.isfinite(m).all())
    assert pipn_manufactured_pp(1e-2, 50.0, 1.0, [2, 8, 8], [[6, 8], [10, 8], [10, 16]],
                                [0.6, 1.2], [0.5, 0.25], [24, 8, 3],
                                device="cpu").derivative_apply is not None
    # the U-Nets are ported too: both factories build on both paths, and
    # both CLIs build them (full width, no step)
    for factory, kwargs in ((pi_gano_pp_full, UNET_GANO_SMALL), (pipn_foam_pp_full,
                                                                  UNET_SMALL)):
        for fast in (True, False):
            unet = factory(**kwargs, scalers=make_scalers(), fast_derivatives=fast,
                           device="cpu")
            assert (unet.derivative_apply is None) == (not fast)
            assert unet.microbatch == (None if fast else 2)
    from porous_cfd_tpu_torch.examples.duct_variable_boundary.train import get_model
    from porous_cfd_tpu_torch.pipelines.training import build_arg_parser, train
    assert get_model(build_arg_parser().parse_args(["--model", "pi-gano-pp-full"]),
                     make_scalers(), "cpu").derivative_apply is not None
    assert get_model(build_arg_parser().parse_args(["--model", "pi-gano-pp-full"]),
                     make_scalers(), "cpu", fast_derivatives=False).microbatch == 2
    from porous_cfd_tpu_torch.examples.duct_fixed_boundary import train as fixed
    assert fixed.get_model(build_arg_parser().parse_args(["--model", "pipn-pp-full"]),
                           make_scalers(), "cpu").derivative_apply is not None
    assert fixed.get_model(build_arg_parser().parse_args(["--model", "pipn-pp-full"]),
                           make_scalers(), "cpu", fast_derivatives=False).microbatch == 2
    # the training CLI's mesh flags no longer say "not ported"
    assert "not ported" not in build_arg_parser().format_help()
    assert callable(train)


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
    # the data layer, the case writer, the pipelines and the CLIs included
    for sub in ("data", "datagen", "pipelines", "examples", "tools"):
        assert any(PORT / sub in f.parents for f in files), sub
    # the FVM solver, the fixed-boundary CLIs, the inference pipeline, the
    # golden-duct run, the bench, the manufactured dataset and split writer,
    # the manufactured CLIs, the verification run and the U-Nets' analytic path
    for rel in ("datagen/fvm.py", "examples/duct_fixed_boundary/train.py",
                "examples/duct_fixed_boundary/inference.py",
                "examples/duct_fixed_boundary/evaluate.py", "pipelines/inference.py",
                "pipelines/evaluation.py", "tools/train_golden_duct.py",
                "tools/golden_spread.py", "bench.py", "data/manufactured.py",
                "datagen/synthetic_case.py", "examples/manufactured_solutions/train.py",
                "examples/manufactured_solutions/generate_data.py",
                "examples/manufactured_solutions/inference.py",
                "examples/manufactured_solutions/evaluate.py",
                "tools/convergence_report.py", "models/fp_analytic.py",
                # the 3D experiments, their solvers and golden run, the
                # variable duct's inference and evaluate
                "datagen/fvm3d.py", "datagen/fvm3d_batch.py", "examples/abc/train.py",
                "examples/abc/inference.py", "examples/abc/evaluate.py",
                "examples/windbreaks/train.py", "examples/windbreaks/inference.py",
                "examples/windbreaks/evaluate.py", "tools/train_golden_3d.py",
                "examples/duct_variable_boundary/inference.py",
                "examples/duct_variable_boundary/evaluate.py",
                # the 2D batched solver, the grid tools, the hard and
                # vertical experiments
                "datagen/fvm_batch.py", "tools/golden_transform_grid.py",
                "tools/scoring_util.py", "tools/train_golden_grid.py",
                "tools/train_golden_variable.py", "tools/analyze_grid_errors.py",
                "tools/analyze_p_offset.py", "examples/duct_fixed_boundary_hard/train.py",
                "examples/duct_fixed_boundary_hard/inference.py",
                "examples/duct_fixed_boundary_hard/evaluate.py",
                "examples/vertical_duct_fixed_boundary/vertical_duct_dataset.py",
                "examples/vertical_duct_fixed_boundary/train.py",
                "examples/vertical_duct_fixed_boundary/inference.py",
                "examples/vertical_duct_fixed_boundary/evaluate.py",
                # the viz modules, the comparison pipeline and its CLIs
                "viz/common.py", "viz/viz2d.py", "viz/viz3d.py", "pipelines/compare.py",
                *(f"examples/{e}/compare.py" for e in EXPERIMENTS),
                # multi-device training, the distance ops, the dry run and
                # the numpy datagen helpers
                "parallel/mesh.py", "ops/distance.py", "dryrun.py",
                "datagen/momentum_error.py", "datagen/mesh_filter.py",
                "datagen/mesh_ops.py", "utils/profiling.py",
                # the measurement tools
                *(f"tools/{t}.py" for t in MEASUREMENT_TOOLS),
                # data generation: the generator, the experiments' generators
                # and CLIs, abc's preprocess, the stage runner
                "datagen/generator.py", "run_experiment.py", "examples/abc/data_preprocess.py",
                *(f"examples/{e}/generate_data.py" for e in GENERATED),
                "examples/duct_fixed_boundary/generator_2d_fixed.py",
                "examples/duct_fixed_boundary_hard/generator_2d_fixed.py",
                "examples/duct_variable_boundary/generator_2d_variable.py",
                "examples/abc/abc_generator.py", "examples/windbreaks/windbreak_generator.py"):
        assert PORT / rel in files, rel
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN + FORBIDDEN_SCRIPTS, \
                f"{path.relative_to(ROOT)} imports {name}"


def _snapshot(paths):
    return {p: (p.stat().st_mtime_ns, p.stat().st_size) for root in paths
            for p in ([root] if root.is_file() else sorted(root.rglob("*"))) if p.is_file()}


def test_port_tools_write_only_where_they_are_told(tmp_path, monkeypatch, capsys):
    """No port tool writes PARITY.md, PERF.md or under examples/ unless
    given that path; each writes where its arguments say and nowhere else
    (nothing in the working directory)."""
    from porous_cfd_tpu_torch.tools import make_mesh_assets, mfu, render_smoke, roofline
    watched = [ROOT / "PARITY.md", ROOT / "PERF.md",
               ROOT / "examples/duct_fixed_boundary/assets/meshes/standard"]
    before = _snapshot(watched)
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(roofline, "measure_dot_rate", lambda m, k, n, device: 1e12)
    monkeypatch.setattr(mfu, "measure_matmul_peak", lambda device: {"f32": 1e12,
                                                                    "bf16": 2e12})
    monkeypatch.setattr(mfu, "measure_family", lambda family, device, env: {
        "steps_per_sec": 1.0, "flops_per_step": 1e9, "achieved_flops_per_sec": 1e9})
    out = tmp_path / "out"
    roofline.run(["--families", "pipn", "--peak-tflops", "1", "--update",
                  str(out / "PERF.md")], device="cpu")
    mfu.run(["--families", "pipn", "--update", str(out / "PERF.md")], device="cpu")
    make_mesh_assets.main([str(out / "meshes")])
    assert render_smoke.main(["--out", str(out / "render")]) == 0
    capsys.readouterr()
    assert _snapshot(watched) == before
    assert list(cwd.iterdir()) == []
    assert sorted(p.name for p in out.iterdir()) == ["PERF.md", "meshes", "render"]
    for name in MEASUREMENT_TOOLS:
        text = (PORT / "tools" / f"{name}.py").read_text()
        assert "PARITY.md" not in text, name


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import porous_cfd_tpu_torch\n"
        "import porous_cfd_tpu_torch.models.pipn\n"
        "import porous_cfd_tpu_torch.models.pi_gano\n"
        "import porous_cfd_tpu_torch.examples.duct_variable_boundary.train\n"
        "import porous_cfd_tpu_torch.examples.duct_fixed_boundary.evaluate\n"
        "import porous_cfd_tpu_torch.datagen.fvm\n"
        "import porous_cfd_tpu_torch.tools.train_golden_duct\n"
        "import porous_cfd_tpu_torch.tools.train_golden_3d\n"
        "import porous_cfd_tpu_torch.datagen.fvm3d_batch\n"
        "import porous_cfd_tpu_torch.datagen.fvm_batch\n"
        "import porous_cfd_tpu_torch.tools.golden_transform_grid\n"
        "import porous_cfd_tpu_torch.tools.train_golden_grid\n"
        "import porous_cfd_tpu_torch.examples.vertical_duct_fixed_boundary.train\n"
        "import porous_cfd_tpu_torch.bench\n"
        "import porous_cfd_tpu_torch.parallel.mesh\n"
        "import porous_cfd_tpu_torch.dryrun\n"
        "import porous_cfd_tpu_torch.ops.distance\n"
        "import porous_cfd_tpu_torch.datagen.mesh_ops\n"
        "import porous_cfd_tpu_torch.datagen.momentum_error\n"
        "import porous_cfd_tpu_torch.datagen.generator\n"
        "import porous_cfd_tpu_torch.examples.windbreaks.generate_data\n"
        "import porous_cfd_tpu_torch.examples.abc.data_preprocess\n"
        "import porous_cfd_tpu_torch.run_experiment\n"
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
    counters += tuple(c for modes in (decoder_cuda.MODE_COUNTS, neural_op_cuda.MODE_COUNTS)
                      for pair in modes.values() for c in pair)
    before = [c.launches for c in counters]
    for model in (pipn_foam(1e-3, 1.0, 1.0, **SMALL, scalers=make_scalers(),
                            seg_dropout=[0.1, 0.0], device="cpu"),
                  pipn_foam(1e-3, 1.0, 1.0, **SMALL, scalers=make_scalers(),
                            seg_dropout=[0.1, 0.0], coupled_context=True, device="cpu"),
                  pi_gano(1e-3, **PI_GANO_SMALL, scalers=make_scalers(), device="cpu",
                          fast_derivatives=True),
                  pi_gano(1e-3, **PI_GANO_SMALL, scalers=make_scalers(), device="cpu",
                          full=True, fast_derivatives=True),
                  pi_gano_pp(1e-3, **PI_GANO_PP_SMALL, scalers=make_scalers(), device="cpu"),
                  pipn_foam_pp(1e-3, 1.0, 1.0, **PP_SMALL, scalers=make_scalers(),
                               seg_dropout=[0.1, 0.0], device="cpu"),
                  pipn_foam_pp_mrg(nu=1e-3, d=1.0, f=1.0, **MRG_SMALL, scalers=make_scalers(),
                                   seg_dropout=[0.1, 0.0], device="cpu")):
        batch = model.attach_neighbors(make_foam_batch(1, 8, 4, 2, seed=0))
        out, jac, lap = model.derivative_apply(batch, deterministic=False, seed=5)
        assert out.shape == (1, 12, 3) and jac.shape == lap.shape == (1, 8, 3, 2)
        sum(o.sum() for o in (out, jac, lap)).backward()
    from porous_cfd_tpu_torch.train.engine import compute_losses
    exact = pipn_foam(1e-3, 1.0, 1.0, **SMALL, scalers=make_scalers(), seg_dropout=[0.1, 0.0],
                      fast_derivatives=False, device="cpu")
    compute_losses(exact, make_foam_batch(1, 8, 4, 2, seed=0), seed=5)[0].sum().backward()
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
    mrg = pipn_foam_pp_mrg(nu=1e-3, d=1.0, f=1.0, **MRG_SMALL, scalers=make_scalers(),
                           device="cpu").module.global_fe
    level = (None, idx, mask, rel, torch.empty((1, 2, 2), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        sa_cuda.sa_mrg_fused(mrg, "silu", torch.empty((1, 4, 6), device="meta"),
                             torch.empty((1, 4, 2), device="meta"), [level, level])


def test_sync_sites_count_calls_and_not_the_modes_notice(monkeypatch):
    """profile_predict.sync_sites counts the warnings that name a call that
    made the host wait, each with its site in the port; the notice that
    set_sync_debug_mode gives once per process, that the mode is a prototype
    which does not detect all synchronizing operations, is not such a call."""
    import warnings

    from porous_cfd_tpu_torch import profile_predict
    modes = []
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)

    def run():
        warnings.warn("Synchronization debug mode is a prototype feature and does not yet "
                      "detect all synchronizing operations")
        warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("an unrelated warning")

    sites = profile_predict.sync_sites(run)
    assert modes == ["warn", "default"]
    assert len(sites) == 1 and "test_torch_port_rules.py" in sites[0]


def test_no_pandas_and_no_module_level_matplotlib_in_the_port():
    """The port imports pandas nowhere, and matplotlib only inside the
    functions that draw: every module imports on the card's machine."""
    for path in sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        assert "pandas" not in {n.split(".")[0] for n in _imports(path)}, path
        tree = ast.parse(path.read_text(), filename=str(path))
        top = [n for stmt in tree.body for n in ast.walk(stmt)
               if not isinstance(stmt, (ast.FunctionDef, ast.ClassDef))]
        for node in top:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] == "matplotlib" or n == "mpl_toolkits"
                           for n in names), f"{path.relative_to(ROOT)} imports {names}"


def test_port_imports_with_matplotlib_and_pandas_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        f"for m in {PLOTTING!r}: sys.modules[m] = None\n"
        "import porous_cfd_tpu_torch\n"
        "names = [info.name for info in pkgutil.walk_packages(porous_cfd_tpu_torch.__path__,"
        " 'porous_cfd_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'porous_cfd_tpu_torch.viz.viz3d' in names\n"
        "assert 'porous_cfd_tpu_torch.examples.windbreaks.compare' in names\n"
        "assert 'porous_cfd_tpu_torch.datagen.generator' in names\n"
        "assert 'porous_cfd_tpu_torch.examples.windbreaks.generate_data' in names\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "", "PYTHONPATH": str(ROOT),
                              "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) > 80


@pytest.fixture(scope="module")
def fixed_checkpoints(tmp_path_factory):
    """2 + 2 golden-duct cases at 24 x 16 and two ``pipn`` checkpoints the
    fixed training CLI wrote, one epoch each."""
    from porous_cfd_tpu_torch.datagen import fvm, meta, synthetic_case
    from porous_cfd_tpu_torch.examples.duct_fixed_boundary import train
    root = tmp_path_factory.mktemp("no_matplotlib")
    data = root / "data"
    for name, cases in (("train", fvm.GOLDEN_CASES[:2]), ("val", fvm.GOLDEN_CASES[3:5])):
        fvm.write_golden_split(data / name, cases, nx=24, ny=16)
        synthetic_case.write_data_config(data / name, ["C", "U", "p", "cellToRegion"], {},
                                         {"Scale": [], "Standardize": ["C", "U", "p"]},
                                         ["x", "y"])
        meta.generate_meta(data / name, "C", "U", "p", "cellToRegion", max_dim=2)
    meta.generate_min_points(data)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    for name in ("pipn-a", "pipn-b"):
        train.run(["--model", "pipn", "--name", name, "--epochs", "1", "--batch-size", "2",
                   "--train-dir", str(data / "train"), "--val-dir", str(data / "val"),
                   "--logs-dir", str(root), "--n-internal", "48", "--n-boundary", "40",
                   "--n-observations", "16"], device="cpu")
    torch.set_num_threads(n)
    return data, root / "lightning_logs"


def test_clis_run_without_matplotlib_and_save_plots_refuses_first(fixed_checkpoints,
                                                                   monkeypatch, capsys,
                                                                   tmp_path):
    """With matplotlib and pandas blocked, as on the card's machine, the
    evaluate and compare CLIs and the six generate_data CLIs (``--meta-only``)
    run without ``--save-plots``; with it, every CLI raises the ImportError
    that names matplotlib before it predicts or writes anything."""
    from porous_cfd_tpu_torch.examples.duct_fixed_boundary import compare, evaluate, inference
    from porous_cfd_tpu_torch.pipelines import evaluation
    from porous_cfd_tpu_torch.pipelines import inference as inference_pipeline
    data, logs = fixed_checkpoints
    for name in PLOTTING:
        monkeypatch.setitem(sys.modules, name, None)
    argv = ["--checkpoint", str(logs / "pipn-a" / "model.ckpt"), "--data-dir",
            str(data / "val"), "--meta-dir", str(data / "train"), "--n-internal", "48",
            "--n-boundary", "40", "--n-observations", "16"]
    other = ["--checkpoint-other", str(logs / "pipn-b" / "model.ckpt")]
    summary = evaluate.run(argv, device="cpu")
    assert summary["cases"] == 2 and "Pressure drop" in summary["errors"]
    got = compare.run(argv + other, device="cpu")
    assert sorted(p.name for p in got.path.iterdir()) == ["Shapiro.csv", "Test.csv"]
    assert not (logs / "pipn-a" / "plots").exists()

    def predicted(*args, **kwargs):
        raise AssertionError("predicted before matplotlib was checked")

    monkeypatch.setattr(evaluation, "evaluate", predicted)
    monkeypatch.setattr(inference_pipeline, "make_predict_functions", predicted)
    for cli, extra in ((evaluate, []), (inference, []), (compare, other)):
        with pytest.raises(ImportError, match="--save-plots needs matplotlib"):
            cli.run(argv + extra + ["--save-plots"], device="cpu")
    assert not (logs / "pipn-a" / "plots").exists()

    for experiment in GENERATED:
        cli = importlib.import_module(f"porous_cfd_tpu_torch.examples.{experiment}.generate_data")
        assets = ROOT / "examples" / experiment / "assets"
        assets_before = _snapshot([assets])
        root = tmp_path / experiment
        shutil.copytree(data, root)
        gen = cli.run(["--meta-only", "--data-root-dir", str(root)])
        assert gen.meta_only and not gen.save_plots, experiment
        assert (root / "min_points.json").exists() and not (root / "plots").exists()
        for split in ("train", "val"):
            assert (root / split / "data_config.json").read_bytes() == \
                (assets / "data_config.json").read_bytes()
        before = _snapshot([root])
        fresh = tmp_path / f"{experiment}_fresh"
        for extra, dest in ((["--meta-only"], root), ([], fresh)):
            with pytest.raises(ImportError, match="--save-plots needs matplotlib"):
                cli.run(extra + ["--save-plots", "--data-root-dir", str(dest)])
        assert _snapshot([root]) == before and not fresh.exists()
        assert _snapshot([assets]) == assets_before, experiment
