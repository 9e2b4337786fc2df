"""ABC case generator (the port's counterpart of
``examples/abc/abc_generator.py``): aligns and rescales filtered ABC CAD
objects into a cylindrical duct template, one case per (object x inlet
speed). Alignment/rescale are linear (Blender-free); the inside point is the
grid probe's."""
import glob
import itertools
import json
import shutil
from pathlib import Path
from random import Random

import numpy as np

from porous_cfd_tpu_torch.datagen import mesh_ops
from porous_cfd_tpu_torch.datagen.generator import Generator3DBase


class AbcGenerator(Generator3DBase):
    """Reference abc_generator.py:15-98."""

    duct_radius = 0.05
    duct_center = np.array([0.0, 0.0, 0.0])
    target_size = 0.06

    def generate_transformed_meshes(self, meshes_dir: Path, dest_dir: Path,
                                    rng: Random):
        """Center each object at the duct axis and rescale its largest extent
        to the target size (alignment is pure linear algebra)."""
        for m in sorted(glob.glob(f"{meshes_dir}/*.obj")):
            verts, faces = mesh_ops.read_obj(m)
            lo, hi = verts.min(axis=0), verts.max(axis=0)
            center = (lo + hi) / 2
            extent = float(np.max(hi - lo))
            if extent <= 0:
                continue
            scale = self.target_size / extent
            out = (verts - center) * scale + self.duct_center
            mesh_ops.write_obj(Path(dest_dir) / Path(m).name, out, faces)

    def generate_openfoam_cases(self, meshes_dir: Path, dest_dir: Path,
                                case_config_dir: Path, rng: Random):
        config_path = Path(case_config_dir) / "config.json"
        inlets = [0.2]
        if config_path.exists():
            with open(config_path) as f:
                inlets = json.load(f).get("cfd params", {}).get("inlet", inlets)
        for m, ux in itertools.product(sorted(glob.glob(f"{meshes_dir}/*.obj")),
                                       inlets):
            if len(inlets) > 1 and rng.random() > self.keep_p:
                continue
            case_path = f"{dest_dir}/{Path(m).stem}_u{ux}"
            shutil.copytree(self.case_template_dir, case_path)
            shutil.copyfile(m, f"{case_path}/constant/triSurface/mesh.obj")
            self.write_locations_in_mesh(case_path,
                                         self.get_location_inside(m))
            self.set_internal_velocity(f"{case_path}/0/U", [ux, 0, 0])
            self.set_decompose_par(case_path)
