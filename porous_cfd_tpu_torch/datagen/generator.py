"""OpenFOAM dataset generator orchestration (the port's counterpart of
``porous_cfd_tpu/datagen/generator.py``; reference
``datagen/data_generator.py``).

Drives the external engines the reference uses — Blender for mesh
augmentation, OpenFOAM for ground-truth CFD — from templates, then splits
cases, computes metadata and sampling constraints. The engines stay external;
what runs here is host code (numpy and the standard library), as in the JAX
package: template instantiation, dict editing, decomposePar configuration,
split moving, sanity checks, meta generation and, under ``--save-plots``, the
dataset plots. The same ``Random(seed)`` writes the same files as the JAX
package's generator. Mesh ops that are pure linear algebra come from
``mesh_ops`` (Blender-free); boolean/remesh augmentation requires bpy.

The templates and meshes are the JAX side's ``examples/<experiment>/assets``
(:func:`example_assets`), read where they are; ``generate`` writes the
augmented meshes into ``<assets>/generated_meshes`` as the JAX package does.

Plots are drawn only when ``save_plots`` is set (the CLIs' ``--save-plots``);
then ``generate`` raises the ``ImportError`` that names matplotlib before it
writes anything where matplotlib is missing (the JAX generator always draws,
after all the solving).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
from abc import abstractmethod
from argparse import ArgumentParser
from pathlib import Path
from random import Random

import numpy as np

from porous_cfd_tpu_torch.datagen import mesh_ops
from porous_cfd_tpu_torch.datagen.meta import generate_meta, generate_min_points
from porous_cfd_tpu_torch.datagen.momentum_error import write_momentum_error

EXAMPLES = Path(__file__).resolve().parents[2] / "examples"


def example_assets(experiment: str) -> Path:
    """``examples/<experiment>/assets``: the OpenFOAM case templates, meshes,
    transforms and configs the experiment's generator reads."""
    return EXAMPLES / experiment / "assets"


def build_arg_parser() -> ArgumentParser:
    """Reference CLI (data_generator.py:26-36), with ``--save-plots``."""
    p = argparse.ArgumentParser()
    p.add_argument("--openfoam-dir", type=str,
                   help="OpenFOAM installation directory")
    p.add_argument("--openfoam-procs", type=int, default=2,
                   help="number of processors for OpenFOAM simulations")
    p.add_argument("--data-root-dir", type=str, default="data")
    p.add_argument("--meta-only", action="store_true", default=False,
                   help="regenerate the meta files")
    p.add_argument("--save-plots", action="store_true", default=False,
                   help="draw each split's dataset plots under <data-root-dir>/plots "
                        "(needs matplotlib)")
    return p


def run_cli(generator_cls, experiment: str, argv=None):
    """An experiment's ``generate_data`` CLI: its generator over
    :func:`example_assets`, writing under ``--data-root-dir``."""
    args = build_arg_parser().parse_args(argv)
    gen = generator_cls(str(example_assets(experiment)), args.openfoam_dir,
                        args.openfoam_procs, meta_only=args.meta_only)
    gen.save_plots = args.save_plots
    gen.generate(args.data_root_dir)
    return gen


class DataGeneratorBase:
    """Base generator: template + meshes + config-driven case generation with
    splits, metadata and sanity checks (data_generator.py:57-443)."""

    def __init__(self, src_dir: str, openfoam_bin: str, n_procs: int,
                 keep_p: float = 0.5, meta_only: bool = False):
        self.openfoam_bin = openfoam_bin
        self.n_procs = n_procs
        self.src_dir = Path(src_dir)
        self.meshes_dir = self.src_dir / "meshes"
        self.case_template_dir = self.src_dir / "openfoam-case-template"
        self.keep_p = keep_p
        self.meta_only = meta_only
        self.save_plots = False
        self.write_momentum = True

        self.data_config_path = self.src_dir / "data_config.json"
        with open(self.data_config_path) as f:
            cfg = json.load(f)
        self.fields = cfg["Fields"]
        self.dims = cfg["Dims"]

        self.meshes_sets_paths = [Path(p) for p in
                                  glob.glob(str(self.src_dir / "meshes/*/"))]
        self.generated_meshes_dir = self.src_dir / "generated_meshes"

    # -- file editing helpers ----------------------------------------------
    def clean_dir(self, directory):
        """Empty ``directory`` without removing the directory itself."""
        for entry in Path(directory).iterdir():
            if entry.is_dir() and not entry.is_symlink():
                shutil.rmtree(entry)
            else:
                entry.unlink()

    def write_locations_in_mesh(self, case_path: str, loc) -> None:
        """Set locationInMesh / insidePoint in snappyHexMeshDict
        (data_generator.py:109-115); regex edit, keeps the rest verbatim."""
        path = Path(case_path) / "system" / "snappyHexMeshDict"
        text = path.read_text()
        vec = f"({loc[0]} {loc[1]} {loc[2]})"
        text = re.sub(r"locationInMesh\s+\([^)]*\)\s*;",
                      f"locationInMesh {vec};", text)
        text = re.sub(r"insidePoint\s+\([^)]*\)\s*;",
                      f"insidePoint {vec};", text)
        path.write_text(text)

    def compute_proc_split(self) -> tuple[int, int]:
        """Power-of-two x/y processor split (data_generator.py:117-138)."""
        i = 1
        while True:
            proc_x = 2 ** i
            proc_y = self.n_procs / proc_x
            if proc_y % 2 != 0 or proc_y <= proc_x:
                proc_y = int(proc_y)
                break
            i += 1
        return max(proc_x, proc_y), min(proc_x, proc_y)

    def set_par_dict_coeffs(self, dict_path: str) -> None:
        proc_x, proc_y = self.compute_proc_split()
        text = Path(dict_path).read_text()
        text = re.sub(r"numberOfSubdomains\s+\d+;",
                      f"numberOfSubdomains {self.n_procs};", text)
        text = re.sub(r"n\s+\(.+\)", f"n ({proc_x} {proc_y} 1)", text)
        Path(dict_path).write_text(text)

    def set_run_n_proc(self, run_path: str) -> None:
        text = Path(run_path).read_text()
        Path(run_path).write_text(text.replace("$n_proc", str(self.n_procs)))

    def set_decompose_par(self, case_path: str) -> None:
        if self.n_procs % 2 != 0:
            raise ValueError("n_proc must be an even number!")
        self.set_par_dict_coeffs(f"{case_path}/system/decomposeParDict")
        self.set_run_n_proc(f"{case_path}/Run")

    def set_internal_velocity(self, u_path: str, vec) -> None:
        """Set ``internalField uniform (...)`` in a 0/U (the inlet's
        condition refers to $internalField in the templates)."""
        text = Path(u_path).read_text()
        text = re.sub(r"internalField\s+uniform\s+\([^)]*\)\s*;",
                      f"internalField   uniform ({vec[0]} {vec[1]} {vec[2]});", text)
        Path(u_path).write_text(text)

    def write_coefs(self, fv_options_path: str, values, coef: str) -> None:
        """Set d/f porosity coefficients in fvOptions (data_generator.py:161-170)."""
        text = Path(fv_options_path).read_text()
        text = re.sub(rf"{coef}\s+(.+);",
                      f"{coef} ({values[0]} {values[1]} {values[2]});", text)
        Path(fv_options_path).write_text(text)

    # -- abstract hooks ------------------------------------------------------
    @abstractmethod
    def create_case_template_dirs(self):
        """Create untracked template directories."""

    @abstractmethod
    def generate_transformed_meshes(self, meshes_dir: Path, dest_dir: Path,
                                    rng: Random):
        """Augment meshes per transforms.json."""

    @abstractmethod
    def generate_openfoam_cases(self, meshes_dir: Path, dest_dir: Path,
                                case_config_dir: Path, rng: Random):
        """Instantiate the template per generated mesh."""

    @abstractmethod
    def generate_data(self, split_dir: Path):
        """Run all OpenFOAM cases of a split."""

    # -- split + checks ------------------------------------------------------
    def generate_split(self, data_path: Path, config_dir: Path, rng: Random):
        """Move cases into split dirs per config.json ratios; the remainder
        goes to the first split by name (data_generator.py:201-231)."""
        config_path = Path(config_dir) / "config.json"
        if not config_path.exists():
            return
        with open(config_path) as f:
            config = json.load(f)
        if "splits" not in config:
            return
        splits = dict(sorted(config["splits"].items()))
        cases = sorted(os.listdir(data_path))
        rng.shuffle(cases)
        n = len(cases)
        start = 0
        for s, ratio in splits.items():
            end = start + int(ratio * n)
            (Path(data_path).parent / s).mkdir(exist_ok=True, parents=True)
            for case in cases[start:end]:
                shutil.move(f"{data_path}/{case}",
                            f"{Path(data_path).parent}/{s}/{case}")
            start = end
        first = list(splits.keys())[0]
        for case in os.listdir(data_path):
            shutil.move(f"{data_path}/{case}",
                        f"{Path(data_path).parent}/{first}/{case}")
        shutil.rmtree(Path(data_path))

    def get_random_in_range(self, lo, hi, rng: Random):
        return lo + rng.random() * (hi - lo)

    def raise_with_log_text(self, case_path: str, text: str):
        with open(f"{case_path}/log.txt") as log:
            raise RuntimeError(f"{text} {case_path}\n\n {log.read()}")

    def run_openfoam_script(self, script_path: str) -> int:
        """Run a case's Run script through the OpenFOAM shell wrapper, which
        reads the script's path on its standard input (generator_2d.py:98-111)."""
        process = subprocess.Popen(self.openfoam_bin, stdin=subprocess.PIPE,
                                   stderr=subprocess.DEVNULL,
                                   stdout=subprocess.DEVNULL, text=True,
                                   start_new_session=True)
        process.communicate(str(script_path))
        process.wait()
        return process.returncode

    def get_location_inside(self, mesh_path: str) -> np.ndarray:
        """Convex inside point = center of mass (data_generator.py:259-273),
        Blender-free."""
        return mesh_ops.center_of_mass(mesh_path)

    def is_sane(self, case_path: str) -> bool:
        """Porous cells must be fewer than half the total
        (data_generator.py:275-287)."""
        def parsed_count(path):
            text = Path(path).read_text()
            m = re.search(r">.+\n(\d+)\n\(", text, flags=re.MULTILINE)
            if m is None:  # fall back to plain 'N\n(' count lines
                m = re.search(r"\n(\d+)\n\(", text)
            return int(m.groups()[0])

        n_porous = parsed_count(f"{case_path}/constant/polyMesh/cellZones")
        n_total = parsed_count(f"{case_path}/0/cellToRegion")
        return n_porous < n_total / 2

    # -- orchestration ---------------------------------------------------------
    def generate(self, dest_dir, seed: int = 8421):
        """Full dataset generation (data_generator.py:388-442): augment meshes,
        instantiate + run cases, split, metadata, plots (``save_plots``),
        min-points."""
        if self.save_plots:
            from porous_cfd_tpu_torch.viz.common import (plot_dataset_dist,
                                                         plot_u_direction_change,
                                                         require_matplotlib)
            matplotlib = require_matplotlib()
        rng = Random(seed)
        dest_dir = Path(dest_dir)
        dest_dir.mkdir(exist_ok=True, parents=True)
        plots_dir = dest_dir / "plots"
        if self.save_plots:
            plots_dir.mkdir(exist_ok=True, parents=True)

        if not self.meta_only:
            self.create_case_template_dirs()
            self.clean_dir(dest_dir)
            self.generated_meshes_dir.mkdir(exist_ok=True, parents=True)
            self.clean_dir(self.generated_meshes_dir)

            for mesh_set in self.meshes_sets_paths:
                gen_set_dir = self.generated_meshes_dir / mesh_set.name
                gen_set_dir.mkdir(parents=True, exist_ok=True)
                self.generate_transformed_meshes(mesh_set, gen_set_dir, rng)

                set_dest = dest_dir / mesh_set.name
                set_dest.mkdir(parents=True, exist_ok=True)
                self.generate_openfoam_cases(gen_set_dir, set_dest, mesh_set,
                                             rng)
                self.generate_split(set_dest, mesh_set, rng)

        if self.save_plots:
            default_backend = matplotlib.get_backend()
            matplotlib.use("Agg")
        for split in sorted(glob.glob(f"{dest_dir}/*/")):
            split_path = Path(split)
            if split_path.name == "plots":
                continue
            if not self.meta_only:
                self.generate_data(split_path)
            generate_meta(split_path, *self.fields, max_dim=len(self.dims))
            self.clean_processor_data(split_path)
            shutil.copyfile(self.data_config_path,
                            split_path / "data_config.json")
            if self.save_plots:
                case_plots = plots_dir / split_path.name
                case_plots.mkdir(exist_ok=True, parents=True)
                plot_dataset_dist(split, case_plots)
                try:
                    plot_u_direction_change(split, case_plots)
                except FileNotFoundError:
                    pass  # mag(grad(Unorm)) absent for geometry-only datasets
        if self.save_plots:
            matplotlib.use(default_backend)
        generate_min_points(dest_dir)

    def clean_processor_data(self, data_dir):
        for case in glob.glob(f"{data_dir}/*/"):
            for proc in glob.glob(f"{case}/processor*/"):
                shutil.rmtree(proc)


class Generator2DBase(DataGeneratorBase):
    """2D generation via two sub-cases per case: snappyHexMesh (meshing +
    extrusion) then simpleFoam (reference datagen/generator_2d.py)."""

    def create_case_template_dirs(self):
        (self.case_template_dir / "snappyHexMesh/0").mkdir(
            parents=True, exist_ok=True)
        (self.case_template_dir / "snappyHexMesh/constant/triSurface").mkdir(
            parents=True, exist_ok=True)

    # -- transforms.json parsing (generator_2d.py:33-82) -------------------
    def parse_rotations(self, rotation_values: list) -> list:
        if not rotation_values:
            return [0]
        start, stop, n = rotation_values
        return np.linspace(start, stop, n).tolist()

    def parse_scale(self, scale_dict: dict) -> list:
        import itertools
        if [] in scale_dict.values():
            return [(1, 1)]
        if "xy" in scale_dict:
            s = np.linspace(*scale_dict["xy"][:2], scale_dict["xy"][2])
            return list(zip(s, s))
        sx = np.linspace(*scale_dict["x"][:2], scale_dict["x"][2])
        sy = np.linspace(*scale_dict["y"][:2], scale_dict["y"][2])
        return list(itertools.product(sx, sy))

    def parse_position_jitter(self, jitter_dict: dict) -> list:
        if not jitter_dict or [] in jitter_dict.values():
            return [[0, 0], [0, 0]]
        if "xy" in jitter_dict:
            return [jitter_dict["xy"], jitter_dict["xy"]]
        return [jitter_dict["x"], jitter_dict["y"]]

    def parse_angles(self, config: dict) -> list:
        if "angle" in config:
            start, stop, n = config["angle"]
            return np.linspace(start, stop, n + 1).tolist()
        return [0]

    def generate_transformed_meshes(self, meshes_dir: Path, dest_dir: Path,
                                    rng: Random):
        """Rotation/scale grid augmentation per transforms.json — pure linear
        transforms, Blender-free (the reference drives Blender for the same
        result, e.g. manufactured_generator.py:38-64)."""
        with open(meshes_dir / "transforms.json") as f:
            transforms = json.load(f)
        for mesh, spec_list in transforms.items():
            if isinstance(spec_list, dict):
                spec_list = [spec_list]
            verts, faces = mesh_ops.read_obj(meshes_dir / mesh)
            for spec in spec_list:
                rotations = self.parse_rotations(spec.get("rotation", []))
                scales = self.parse_scale(spec.get("scale", {"x": [], "y": []}))
                for sx, sy in scales:
                    for r in rotations:
                        out = mesh_ops.transform_verts(
                            verts, scale=(sx, sy, 1.0), rotation_z_deg=r)
                        mesh_ops.write_obj(
                            dest_dir / f"s{sx}-{sy}_r{r}_{mesh}", out, faces)

    def generate_openfoam_cases(self, meshes_dir: Path, dest_dir: Path,
                                case_config_dir: Path, rng: Random):
        """Template copy per mesh with inside-point + decomposePar setup."""
        for m in sorted(glob.glob(f"{meshes_dir}/*.obj")):
            case_path = Path(dest_dir) / Path(m).stem
            shutil.copytree(self.case_template_dir, case_path)
            shutil.copyfile(m, case_path / "snappyHexMesh/constant/triSurface/mesh.obj")
            self.write_locations_in_mesh(str(case_path / "snappyHexMesh"),
                                         self.get_location_inside(m))
            self.set_decompose_par(str(case_path / "snappyHexMesh"))
            self.set_decompose_par(str(case_path / "simpleFoam"))

    def generate_data(self, split_dir: Path):
        """Run the two-stage Run scripts, write momentError, collapse the case
        dir (generator_2d.py:92-120)."""
        for case in sorted(glob.glob(f"{split_dir}/*")):
            if self.run_openfoam_script(f"{case}/snappyHexMesh/Run") != 0:
                self.raise_with_log_text(f"{case}/snappyHexMesh",
                                         "Failed to generate mesh for case ")
        for case in sorted(glob.glob(f"{split_dir}/*")):
            if self.run_openfoam_script(f"{case}/simpleFoam/Run") != 0:
                self.raise_with_log_text(f"{case}/simpleFoam", "Failed to run ")
            if self.write_momentum:
                write_momentum_error(f"{case}/simpleFoam")
            self.clean_dir(f"{case}/snappyHexMesh")
            os.rmdir(f"{case}/snappyHexMesh")
            # collapse: the solved simpleFoam sub-case becomes the case root
            # (staged next to the case, not in the CWD, so parallel runs and
            # read-only CWDs are safe)
            shutil.move(f"{case}/simpleFoam", f"{case}.tmp")
            os.rmdir(case)
            shutil.move(f"{case}.tmp", case)


class Generator3DBase(DataGeneratorBase):
    """3D generation: single-case Run + sanity deletion (reference
    datagen/generator_3d.py)."""

    def create_case_template_dirs(self):
        (self.case_template_dir / "constant/triSurface").mkdir(
            parents=True, exist_ok=True)

    def get_location_inside(self, mesh_path: str) -> np.ndarray:
        """Grid-probe deepest interior point for concave meshes
        (generator_3d.py:22-55), Blender-free."""
        return mesh_ops.grid_inside_point(mesh_path)

    def generate_data(self, split_dir: Path):
        import warnings
        for case in sorted(glob.glob(f"{split_dir}/*")):
            if self.run_openfoam_script(f"{case}/Run") != 0:
                self.raise_with_log_text(case, "Failed to run ")
            write_momentum_error(case)
            if not self.is_sane(case):
                warnings.warn(f"Case {case} is malformed, will be deleted!")
                shutil.rmtree(case)
