"""The port's data generation (``porous_cfd_tpu_torch/datagen/generator.py``,
the six experiments' generators and ``generate_data`` CLIs, abc's
``data_preprocess``, ``run_experiment`` and ``launch.sh``) held to the JAX
package on the CPU.

Both packages run on copies of the same assets with the same
``Random(8421)`` and must write the same trees, byte for byte. The JAX
generators are imported through the ``examples`` package
(``examples.<experiment>.<module>``): two of its example directories hold a
module named ``generator_2d_fixed``, so importing them from the example
directory on ``sys.path``, as ``tests/test_generator_e2e.py`` does for one,
would hand the second test the first one's module.

``generate()`` runs end to end through a stand-in engine written here: an
executable (``#!`` the running interpreter, the standard library only) that
reads a Run script's path on its standard input, as the OpenFOAM shell
wrapper does, and installs a small solved case that this file wrote with
``synthetic_case.write_case`` (the same bytes in both packages,
``tests/test_torch_dataset.py``), chosen by the case's name.
"""
import json
import shutil
import subprocess
import sys
import tarfile
import warnings
from pathlib import Path
from random import Random

import numpy as np
import pytest

from examples.abc import abc_generator as jax_abc
from examples.abc import data_preprocess as jax_preprocess
from examples.duct_fixed_boundary import generator_2d_fixed as jax_fixed
from examples.duct_fixed_boundary_hard import generator_2d_fixed as jax_hard
from examples.duct_variable_boundary import generator_2d_variable as jax_variable
from examples.vertical_duct_fixed_boundary import generate_data as jax_vertical
from examples.windbreaks import windbreak_generator as jax_windbreaks
from porous_cfd_tpu.datagen import mesh_ops as jax_mesh_ops
from porous_cfd_tpu_torch import run_experiment
from porous_cfd_tpu_torch.datagen import mesh_ops, synthetic_case
from porous_cfd_tpu_torch.examples.abc import abc_generator, data_preprocess
from porous_cfd_tpu_torch.examples.duct_fixed_boundary import generator_2d_fixed
from porous_cfd_tpu_torch.examples.duct_fixed_boundary_hard import generator_2d_fixed as hard
from porous_cfd_tpu_torch.examples.duct_variable_boundary import generator_2d_variable
from porous_cfd_tpu_torch.examples.vertical_duct_fixed_boundary import generate_data as vertical
from porous_cfd_tpu_torch.examples.windbreaks import windbreak_generator
from test_datagen import analytic, exact_lap_vectors

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
SEED = 8421
PACKAGES = ("port", "jax")
# experiment -> (the port's generator class, the JAX one's)
GENERATORS = {
    "duct_fixed_boundary": (generator_2d_fixed.Generator2DFixed, jax_fixed.Generator2DFixed),
    "duct_variable_boundary": (generator_2d_variable.Generator2DVariable,
                               jax_variable.Generator2DVariable),
    "duct_fixed_boundary_hard": (hard.Generator2DFixedHard, jax_hard.Generator2DFixedHard),
    "vertical_duct_fixed_boundary": (vertical.Generator2DFixedHardTop,
                                     jax_vertical.Generator2DFixedHardTop),
    "abc": (abc_generator.AbcGenerator, jax_abc.AbcGenerator),
    "windbreaks": (windbreak_generator.WindbreakGenerator, jax_windbreaks.WindbreakGenerator),
}
# the experiments whose meshes the generator makes itself (Blender-free);
# the others' come from Blender, and are fabricated here
TRANSFORMED = ("duct_fixed_boundary", "duct_variable_boundary", "abc")
# cases a test instantiates (the meshes kept after augmentation)
KEEP_MESHES = {"duct_fixed_boundary": 8, "duct_variable_boundary": 2, "abc": 1}


def tree(root: Path) -> dict:
    """Every file under ``root``: relative path -> bytes (PNG files: None)."""
    return {str(p.relative_to(root)): (None if p.suffix == ".png" else p.read_bytes())
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


def split_members(root: Path) -> dict:
    return {s.name: sorted(c.name for c in s.iterdir() if c.is_dir())
            for s in sorted(Path(root).iterdir()) if s.is_dir()}


def copy_assets(experiment: str, dest: Path) -> Path:
    shutil.copytree(EXAMPLES / experiment / "assets", dest)
    return dest


def make_generators(experiment: str, root: Path, engine="openfoam", **kwargs):
    """Both packages' generators, each on its own copy of the assets."""
    return {pkg: cls(str(copy_assets(experiment, root / pkg / "assets")), engine, 2, **kwargs)
            for pkg, cls in zip(PACKAGES, GENERATORS[experiment])}


def fabricate_meshes(experiment: str, dest: Path) -> None:
    """The Blender stage's output, made from shipped meshes: two composed
    cases of sub-meshes (hard, vertical) or two tree rows with a house and
    their species (windbreaks)."""
    assets = EXAMPLES / experiment / "assets" / "meshes" / "standard"
    if experiment == "windbreaks":
        for i, species in enumerate(("oak.obj", "pine.obj")):
            (dest / str(i)).mkdir(parents=True)
            shutil.copyfile(assets / species, dest / str(i) / "mesh.obj")
            shutil.copyfile(assets / "houses" / f"house_{i}.obj", dest / str(i) / "solid.obj")
            (dest / str(i) / "species.json").write_text(json.dumps({"species": species}))
        return
    for i, parts in enumerate((("circle", "square"), ("rhombus", "ellipse", "rectangle"))):
        (dest / str(i)).mkdir(parents=True)
        for k, name in enumerate(parts):
            verts, faces = mesh_ops.read_obj(assets / f"{name}.obj")
            mesh_ops.write_obj(dest / str(i) / f"{name}_{k}.obj",
                               mesh_ops.transform_verts(verts, rotation_z_deg=30.0 * k,
                                                        offset=(0.01 * k, 0.0, 0.0)), faces)


@pytest.mark.parametrize("experiment", list(GENERATORS))
def test_generators_write_the_jax_packages_meshes_cases_and_splits(experiment, tmp_path):
    """Each generator's ``generate_transformed_meshes`` (or, where Blender
    composes the meshes, a fabricated directory of them) and
    ``generate_openfoam_cases``: the same relative paths and bytes as the JAX
    package's; ``generate_split`` the same membership; the rng left in the
    same state, so every draw came in the same order."""
    gens = make_generators(experiment, tmp_path)
    rngs = {pkg: Random(SEED) for pkg in PACKAGES}
    for pkg, gen in gens.items():
        gen.create_case_template_dirs()
        mesh_set = gen.meshes_dir / "standard"
        meshes = tmp_path / pkg / "meshes"
        meshes.mkdir()
        if experiment in TRANSFORMED:
            gen.generate_transformed_meshes(mesh_set, meshes, rngs[pkg])
        else:
            fabricate_meshes(experiment, meshes)
    port_meshes, jax_meshes = (tree(tmp_path / pkg / "meshes") for pkg in PACKAGES)
    assert port_meshes == jax_meshes
    if experiment == "duct_fixed_boundary":
        assert len(port_meshes) == 152
    for pkg, gen in gens.items():
        # trimmed for time, as tests/test_generator_e2e.py does
        objs = sorted((tmp_path / pkg / "meshes").glob("*.obj"))
        for m in objs[KEEP_MESHES.get(experiment, len(objs)):]:
            m.unlink()
        cases = tmp_path / pkg / "data" / "standard"
        cases.mkdir(parents=True)
        gen.generate_openfoam_cases(tmp_path / pkg / "meshes", cases,
                                    gen.meshes_dir / "standard", rngs[pkg])
    port_cases, jax_cases = (tree(tmp_path / pkg / "data") for pkg in PACKAGES)
    assert port_cases == jax_cases
    assert port_cases
    assert not any(b"$n_proc" in v for v in port_cases.values() if v is not None)
    for pkg, gen in gens.items():
        gen.generate_split(tmp_path / pkg / "data" / "standard", gen.meshes_dir / "standard",
                           rngs[pkg])
    splits = split_members(tmp_path / "port" / "data")
    assert splits == split_members(tmp_path / "jax" / "data")
    assert sorted(splits) == ["test", "train", "val"]
    assert rngs["port"].getstate() == rngs["jax"].getstate()


def test_compute_proc_split_equals_jax(tmp_path):
    """n_procs 1-64: the same (x, y) split; an odd count refused by both
    when the decomposition is written."""
    gens = make_generators("duct_fixed_boundary", tmp_path)
    case = tmp_path / "case"
    for n in range(1, 65):
        for gen in gens.values():
            gen.n_procs = n
        split = gens["port"].compute_proc_split()
        assert split == gens["jax"].compute_proc_split(), n
        if n % 2:
            for gen in gens.values():
                with pytest.raises(ValueError, match="n_proc must be an even number!"):
                    gen.set_decompose_par(str(case))
    for n, split in ((2, (2, 1)), (8, (4, 2)), (64, (8, 8))):
        gens["port"].n_procs = n
        assert gens["port"].compute_proc_split() == split


@pytest.mark.parametrize("experiment", list(GENERATORS))
def test_parse_shipped_transforms_equals_jax(experiment, tmp_path):
    """The rotation, scale, jitter and angle grids each experiment's
    ``transforms.json`` and ``config.json`` give, in both packages."""
    gens = make_generators("duct_fixed_boundary", tmp_path)
    standard = EXAMPLES / experiment / "assets" / "meshes" / "standard"
    transforms = json.loads((standard / "transforms.json").read_text())
    config = json.loads((standard / "config.json").read_text())

    def parsed(gen):
        out = []
        for spec_list in transforms.values():
            for spec in (spec_list if isinstance(spec_list, list) else [spec_list]):
                out.append((gen.parse_rotations(spec.get("rotation", [])),
                            gen.parse_scale(spec.get("scale", {"x": [], "y": []})),
                            gen.parse_position_jitter(spec.get("jitter"))))
        return out, gen.parse_angles(config.get("cfd params", {}))

    assert parsed(gens["port"]) == parsed(gens["jax"])


def cell_zones(n: int) -> str:
    """An OpenFOAM cellZones file of one zone of ``n`` cells (the count after
    ``List<label> ``, the first branch of ``is_sane``'s regex)."""
    labels = "\n".join(map(str, range(n)))
    return ("FoamFile\n{\n    class       regIOobject;\n    object      cellZones;\n}\n\n"
            f"1\n(\nmesh\n{{\n    type cellZone;\ncellLabels      List<label> \n{n}\n(\n"
            f"{labels}\n)\n;\n}}\n)\n")


def test_is_sane_equals_jax_on_both_branches_of_its_regex(tmp_path):
    gens = make_generators("abc", tmp_path)
    case = tmp_path / "case"
    (case / "constant" / "polyMesh").mkdir(parents=True)
    zones, regions = case / "constant" / "polyMesh" / "cellZones", case / "0" / "cellToRegion"
    # the OpenFOAM layout (first branch; the plain 'N\n(' pattern would read
    # the zone count, 1) and write_case's cellToRegion (fallback branch)
    for n_porous, sane in ((40, True), (60, False), (50, False)):
        synthetic_case.write_case(case, np.zeros((100, 2)), np.zeros(100), {})
        (case / "constant" / "polyMesh").mkdir(parents=True)
        zones.write_text(cell_zones(n_porous))
        assert gens["port"].is_sane(str(case)) is gens["jax"].is_sane(str(case)) is sane
    # the fallback branch on both files (tests/test_datagen.py's layout)
    zones.write_text("mesh\n{\ncellLabels List<label>\n30\n(\n1\n)\n}\n")
    regions.write_text("internalField nonuniform List<scalar>\n100\n(\n0\n)\n")
    assert gens["port"].is_sane(str(case)) is gens["jax"].is_sane(str(case)) is True
    zones.write_text("mesh\n{\ncellLabels List<label>\n80\n(\n1\n)\n}\n")
    assert gens["port"].is_sane(str(case)) is gens["jax"].is_sane(str(case)) is False


# -- generate() end to end through a stand-in engine ---------------------------

ENGINE = '''#!{python}
"""A stand-in for the OpenFOAM shell wrapper: reads a Run script's path on
standard input; a snappyHexMesh stage succeeds; any other stage installs a
solved case into the Run's directory, picked by the case's name."""
import shutil
import sys
import zlib
from pathlib import Path

SOLVED = {solved!r}
INSANE_SOLVED, INSANE_CASE = {insane_solved!r}, {insane!r}
FAIL = {fail!r}
run = Path(sys.stdin.read().strip())
stage = run.parent
case = stage.parent.name if stage.name in ("snappyHexMesh", "simpleFoam") else stage.name
if FAIL and FAIL in case:
    (stage / "log.txt").write_text(f"stand-in engine: {{stage.name}} of {{case}} failed\\n")
    sys.exit(1)
if stage.name == "snappyHexMesh":
    sys.exit(0)
if INSANE_CASE and INSANE_CASE == case:
    src = INSANE_SOLVED
else:
    src = SOLVED[zlib.crc32(case.encode()) % len(SOLVED)]
shutil.copytree(src, stage, dirs_exist_ok=True)
'''


def write_solved_case(case: Path, seed: int, dims: int, porous_share: float) -> None:
    """A small solved case: Taylor-Green U and p with every gradient field
    ``write_momentum_error`` reads (tests/test_datagen.py), an inlet and a
    walls patch, ``mag(grad(Unorm))``, and (3D) a cellZones file holding
    ``porous_share`` of the cells."""
    rng = np.random.default_rng(seed)
    n = 40

    def fields_for(pts):
        u, grad_p, jac = analytic(pts)
        lap = exact_lap_vectors(pts)
        x, y = pts[:, 0], pts[:, 1]
        out = {"U": u[:, :dims], "p": -0.25 * (np.cos(2 * x) + np.cos(2 * y)),
               "grad(p)": grad_p}
        for i in "xyz":
            for j in "xyz":
                out[f"grad(U){i}{j}"] = jac[f"{i}{j}"]
                out[f"grad(grad(U){i}{j})"] = lap[f"{i}{j}"]
        return out

    pts = rng.uniform(0.5, 5.0, size=(n, dims))
    zone = (np.arange(n) < porous_share * n).astype(np.float64)
    patches = {name: rng.uniform(0.5, 5.0, size=(10, dims)) for name in ("inlet", "walls")}
    fields = fields_for(pts)
    fields["mag(grad(Unorm))"] = np.abs(fields["grad(U)xx"])
    synthetic_case.write_case(case, pts, zone, patches, fields=fields,
                              patch_fields={k: fields_for(v) for k, v in patches.items()},
                              d=[5000.0, 7000.0, 0.0], f=[16.381, 20.783, 0.0], nu=0.01,
                              elapsed_ns=10 ** 9 + seed)
    if dims == 3:
        (case / "constant" / "polyMesh").mkdir(parents=True)
        (case / "constant" / "polyMesh" / "cellZones").write_text(
            cell_zones(int(porous_share * n)))


def write_engine(root: Path, dims: int, insane: str = "", fail: str = "") -> str:
    solved = []
    for k in range(3):
        solved.append(str(root / f"solved_{k}"))
        write_solved_case(root / f"solved_{k}", k, dims, 0.3)
    write_solved_case(root / "solved_insane", 7, dims, 0.75)
    engine = root / "engine"
    engine.write_text(ENGINE.format(python=sys.executable, solved=solved,
                                    insane_solved=str(root / "solved_insane"), insane=insane,
                                    fail=fail))
    engine.chmod(0o755)
    return str(engine)


# two meshes of the fixed set, 4 + 2 variants: 6 cases (test 1 + the
# remainder, train 3, val 1); abc with three objects at keep_p 1: 9 cases
E2E_TRANSFORMS = {"circle.obj": {"rotation": [], "scale": {"x": [0.75, 1, 2],
                                                          "y": [0.75, 1, 2]}},
                  "square.obj": {"rotation": [0, 45, 2], "scale": {"x": [], "y": []}}}
E2E = {"2d": ("duct_fixed_boundary", {}), "3d": ("abc", {"keep_p": 1.0})}
# a 3D case the stand-in engine makes malformed (porous past half the cells);
# it falls in the test split
INSANE_CASE = "sample_object_u0.2"


def e2e_generators(dims_key: str, root: Path, engine: str):
    experiment, kwargs = E2E[dims_key]
    gens = make_generators(experiment, root, engine=engine, **kwargs)
    for gen in gens.values():
        standard = gen.meshes_dir / "standard"
        if dims_key == "2d":
            (standard / "transforms.json").write_text(json.dumps(E2E_TRANSFORMS))
        else:
            verts, faces = mesh_ops.read_obj(standard / "sample_object.obj")
            for k, scale in ((1, 0.5), (2, 1.5)):
                mesh_ops.write_obj(standard / f"object_{k}.obj",
                                   mesh_ops.transform_verts(verts, scale=(scale, 1.0, 1.0)),
                                   faces)
    return gens


@pytest.mark.parametrize("dims_key", list(E2E))
def test_generate_end_to_end_equals_jax(dims_key, tmp_path):
    """``generate()`` through the stand-in engine: the same data tree (cases
    with their momentError, meta, min-points, data_config.json and, in 2D
    with plots on, the plot file names) in both packages; in 3D, plots off
    (the port's default), the malformed case deleted by both with the
    warning."""
    dims = 2 if dims_key == "2d" else 3
    engine = write_engine(tmp_path, dims, insane=INSANE_CASE if dims == 3 else "")
    gens = e2e_generators(dims_key, tmp_path, engine)
    for pkg, gen in gens.items():
        gen.save_plots = dims == 2
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            gen.generate(tmp_path / pkg / "data", seed=SEED)
        malformed = [str(w.message) for w in caught if "malformed" in str(w.message)]
        if dims == 3:
            assert malformed == [f"Case {tmp_path / pkg / 'data' / 'test' / INSANE_CASE}"
                                 " is malformed, will be deleted!"]
        else:
            assert malformed == []
    port, jax = (tree(tmp_path / pkg / "data") for pkg in PACKAGES)
    assert port == jax
    splits = split_members(tmp_path / "port" / "data")
    assert sorted(splits) == (["plots"] if dims == 2 else []) + ["test", "train", "val"]
    n_cases = {"2d": (2, 3, 1), "3d": (2, 5, 1)}[dims_key]
    assert tuple(len(splits[s]) for s in ("test", "train", "val")) == n_cases
    assert INSANE_CASE not in sum(splits.values(), [])
    for split in ("test", "train", "val"):
        assert f"{split}/meta.json" in port and f"{split}/data_config.json" in port
        for case in splits[split]:
            assert f"{split}/{case}/1000/momentError" in port
            assert not any(k.startswith(f"{split}/{case}/simpleFoam") for k in port)
        assert sorted(k.split("/")[-1] for k in port if k.startswith(f"plots/{split}/")) == \
            (["Average U direction change per case.png", "Fields boxplot.png",
              f"{split} distribution.png"] if dims == 2 else [])
    assert "min_points.json" in port
    # the augmented meshes sit in each package's copy of the assets, equal
    assert tree(gens["port"].generated_meshes_dir) == tree(gens["jax"].generated_meshes_dir)


@pytest.mark.parametrize("dims_key", list(E2E))
def test_generate_failure_raises_the_jax_packages_error(dims_key, tmp_path):
    """A case whose Run fails: both packages raise the same RuntimeError,
    the case's log.txt in it (paths aside)."""
    dims = 2 if dims_key == "2d" else 3
    engine = write_engine(tmp_path, dims, fail="square" if dims == 2 else "object_1")
    gens = e2e_generators(dims_key, tmp_path, engine)
    messages = {}
    for pkg, gen in gens.items():
        with pytest.raises(RuntimeError) as err:
            gen.generate(tmp_path / pkg / "data", seed=SEED)
        messages[pkg] = str(err.value).replace(str(tmp_path / pkg), "<root>")
    assert messages["port"] == messages["jax"]
    stage = "snappyHexMesh" if dims == 2 else ""
    assert messages["port"].startswith("Failed to generate mesh for case " if dims == 2
                                       else "Failed to run ")
    assert f"stand-in engine: {stage or 'object_1_u'}" in messages["port"]


def test_save_plots_needs_matplotlib_before_anything_is_written(tmp_path, monkeypatch):
    gens = e2e_generators("2d", tmp_path, "openfoam")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    gens["port"].save_plots = True
    with pytest.raises(ImportError, match="--save-plots needs matplotlib"):
        gens["port"].generate(tmp_path / "port" / "data")
    assert not (tmp_path / "port" / "data").exists()
    assert not gens["port"].generated_meshes_dir.exists()


# -- Blender, the ABC archive, the stage runner ----------------------------------

def _bpy_calls(root: Path):
    """(name, the port's call, the JAX package's call) for every path that
    needs Blender."""
    gens = {e: make_generators(e, root / e) for e in ("duct_fixed_boundary_hard",
                                                      "vertical_duct_fixed_boundary",
                                                      "windbreaks")}
    out = []
    for e, g in gens.items():
        standard = {pkg: g[pkg].meshes_dir / "standard" for pkg in PACKAGES}
        out.append((f"{e} generate_transformed_meshes",
                    *(lambda pkg=pkg, g=g, s=standard: g[pkg].generate_transformed_meshes(
                        s[pkg], root / "out", Random(SEED)) for pkg in PACKAGES)))
        if e != "windbreaks":
            out.append((f"{e} generate_object",
                        *(lambda pkg=pkg, g=g, s=standard: g[pkg].generate_object(
                            str(s[pkg]), ["circle.obj"], Random(SEED)) for pkg in PACKAGES)))
            out.append((f"{e} merge_meshes",
                        *(lambda pkg=pkg, g=g: g[pkg].merge_meshes([None, None])
                          for pkg in PACKAGES)))
    for name, args in (("is_manifold", (None,)), ("clean_scene", ()),
                       ("copy_to_meshes", (str(root), str(root / "meshes"), 2))):
        out.append((f"data_preprocess {name}",
                    lambda n=name, a=args: getattr(data_preprocess, n)(*a),
                    lambda n=name, a=args: getattr(jax_preprocess, n)(*a)))
    return out


def test_every_blender_path_raises_the_jax_packages_error(tmp_path):
    try:
        import bpy  # noqa: F401
        pytest.skip("Blender is installed")
    except ImportError:
        pass
    calls = _bpy_calls(tmp_path)
    assert len(calls) == 10
    for name, port_call, jax_call in calls:
        with pytest.raises(RuntimeError, match="bpy") as port_err:
            port_call()
        with pytest.raises(RuntimeError, match="bpy") as jax_err:
            jax_call()
        assert str(port_err.value) == str(jax_err.value), name
    with pytest.raises(RuntimeError) as err:
        mesh_ops.require_bpy()
    with pytest.raises(RuntimeError) as jax_err:
        jax_mesh_ops.require_bpy()
    assert str(err.value) == str(jax_err.value)
    assert not (tmp_path / "out").exists() and not (tmp_path / "meshes").exists()


def test_data_preprocess_extract_and_download_equal_jax(tmp_path, capsys):
    """``extract`` on a small tar (stale .obj files cleared first) and
    ``download`` of a ``file://`` URL, no network: the same files and the
    same printed lines as the JAX module's."""
    raw = tmp_path / "raw"
    (raw / "chunk").mkdir(parents=True)
    for k in range(3):
        (raw / "chunk" / f"part_{k}.obj").write_text(f"v {k} 0 0\nv 0 1 0\nv 0 0 1\nf 1 2 3\n")
    archive = tmp_path / "abc_chunk.tar"
    with tarfile.open(archive, "w") as fh:
        fh.add(raw / "chunk", arcname="chunk")
    printed = {}
    for pkg, module in zip(PACKAGES, (data_preprocess, jax_preprocess)):
        dest = tmp_path / pkg / "extracted"
        dest.mkdir(parents=True)
        (dest / "stale.obj").write_text("v 0 0 0\n")
        module.extract(str(archive), str(dest))
        out = tmp_path / pkg / "chunk.tar"
        module.download(archive.as_uri(), str(out), block_size=64)
        module.download(archive.as_uri(), str(out))   # already there
        printed[pkg] = capsys.readouterr().out.replace(str(tmp_path / pkg), "<root>")
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    assert sorted(tree(tmp_path / "port" / "extracted")) == \
        [f"chunk/part_{k}.obj" for k in range(3)]
    assert (tmp_path / "port" / "chunk.tar").read_bytes() == archive.read_bytes()
    assert printed["port"] == printed["jax"]
    assert printed["port"].endswith("<root>/chunk.tar already downloaded!\n")


def golden_like_split(root: Path) -> Path:
    """A two-split dataset of solved 2D cases, its meta files deleted."""
    for split in ("train", "val"):
        for k in range(2):
            write_solved_case(root / split / f"case_{k}", k + (2 if split == "val" else 0), 2, 0.3)
    return root


def test_run_experiment_dispatches_generate_data(tmp_path, monkeypatch):
    """``EXPERIMENT=duct_fixed_boundary RUNCMD=generate_data`` runs the
    port's generate_data CLI from ``examples/duct_fixed_boundary``, here on
    ``--meta-only``: the JAX CLI's meta files."""
    data = golden_like_split(tmp_path / "data")
    jax_data = tmp_path / "jax_data"
    shutil.copytree(data, jax_data)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("EXPERIMENT", "duct_fixed_boundary")
    monkeypatch.setenv("RUNCMD", "generate_data")
    monkeypatch.setattr(sys, "argv", ["run_experiment", "--meta-only",
                                      "--data-root-dir", str(data)])
    gen = run_experiment.main()
    assert type(gen) is generator_2d_fixed.Generator2DFixed and gen.meta_only
    assert Path.cwd() == EXAMPLES / "duct_fixed_boundary"
    jax_gen = jax_fixed.Generator2DFixed(str(EXAMPLES / "duct_fixed_boundary" / "assets"),
                                         None, 2, meta_only=True)
    jax_gen.save_plots = False
    jax_gen.generate(jax_data)
    assert tree(data) == tree(jax_data)
    assert {"min_points.json", "train/meta.json", "val/data_config.json"} <= set(tree(data))
    assert not (data / "plots").exists()
    assert not (EXAMPLES / "duct_fixed_boundary" / "assets" / "generated_meshes").exists()


def test_launch_sh_runs_the_stage(tmp_path):
    """The port's launch.sh: ``-x duct_fixed_boundary -g "--meta-only ..."``
    through ``python -m porous_cfd_tpu_torch.run_experiment``."""
    data = golden_like_split(tmp_path / "data")
    res = subprocess.run(["bash", str(REPO / "porous_cfd_tpu_torch" / "launch.sh"), "-x",
                          "duct_fixed_boundary", "-g", f"--meta-only --data-root-dir {data}"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("=== duct_fixed_boundary :: generate_data --meta-only")
    assert (data / "min_points.json").exists() and (data / "train" / "meta.json").exists()
