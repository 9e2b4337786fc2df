"""Variable-BC 2D case generator (the port's counterpart of
``examples/duct_variable_boundary/generator_2d_variable.py``).

Augments porous-object meshes (rotation/scale grid + position jitter, dropped
with probability 1-keep_p) and instantiates one OpenFOAM case per
(inlet speed x coefficient pair x mesh) combination with jittered inlet speed
and a random inlet angle, writing 0/U and fvOptions per case. Mesh transforms
are pure linear algebra (Blender-free, see ``datagen/mesh_ops.py``).

The inlet jitter accumulates as in the JAX generator: ``inlet_u +=`` carries
each mesh's jitter into the next mesh's speed within one (inlet, coeffs)
pair.
"""
import glob
import itertools
import json
import math
import shutil
from pathlib import Path
from random import Random

from porous_cfd_tpu_torch.datagen import mesh_ops
from porous_cfd_tpu_torch.datagen.generator import Generator2DBase


class Generator2DVariable(Generator2DBase):
    def generate_transformed_meshes(self, meshes_dir: Path, dest_dir: Path,
                                    rng: Random):
        """Rotation/scale grid + position jitter, random case dropping
        (generator_2d_variable.py:24-64)."""
        with open(Path(meshes_dir) / "transforms.json") as f:
            transforms = json.load(f)
        for mesh, spec in transforms.items():
            verts, faces = mesh_ops.read_obj(Path(meshes_dir) / mesh)
            rotations = self.parse_rotations(spec["rotation"])
            scales = self.parse_scale(spec["scale"])
            jitter_x, jitter_y = self.parse_position_jitter(spec.get("jitter"))
            params = list(itertools.product(rotations, scales))
            for r, s in params:
                if len(params) > 1 and rng.random() > self.keep_p:
                    continue
                offset = (self.get_random_in_range(*jitter_x, rng),
                          self.get_random_in_range(*jitter_y, rng), 0.0)
                out = mesh_ops.transform_verts(verts, scale=(s[0], s[1], 1.0),
                                               rotation_z_deg=r, offset=offset)
                mesh_ops.write_obj(Path(dest_dir) / f"s{s[0]}-{s[1]}_r{r}_{mesh}",
                                   out, faces)

    def generate_openfoam_cases(self, meshes_dir: Path, dest_dir: Path,
                                case_config_dir: Path, rng: Random):
        """(inlet x coeffs x mesh) grid with jitter and random angle
        (generator_2d_variable.py:66-100)."""
        with open(Path(case_config_dir) / "config.json") as fh:
            config = json.load(fh)["cfd params"]
        jitter_config = config.get("jitter")
        params = list(itertools.product(config["inlet"], config["coeffs"]))
        inlet_angles = self.parse_angles(config)
        for inlet_u, coeffs in params:
            for m in sorted(glob.glob(f"{meshes_dir}/*.obj")):
                if len(params) > 1 and rng.random() > self.keep_p:
                    continue
                d, f = coeffs["d"], coeffs["f"]
                if jitter_config and "inlet" in jitter_config:
                    inlet_u += self.get_random_in_range(
                        -jitter_config["inlet"] / 2,
                        jitter_config["inlet"] / 2, rng)
                angle = self.get_random_in_range(min(inlet_angles),
                                                 max(inlet_angles), rng)
                rad = math.radians(angle)
                u_x, u_y = inlet_u * math.cos(rad), inlet_u * math.sin(rad)

                case_path = (f"{dest_dir}/{Path(m).stem}_d{d[0]}_{f[0]}"
                             f"_in{inlet_u:.4f}_a{angle:.2f}")
                shutil.copytree(self.case_template_dir, case_path)
                shutil.copyfile(
                    m, f"{case_path}/snappyHexMesh/constant/triSurface/mesh.obj")
                self.write_locations_in_mesh(f"{case_path}/snappyHexMesh",
                                             self.get_location_inside(m))
                self.set_internal_velocity(f"{case_path}/simpleFoam/0/U",
                                        [u_x, u_y, 0])
                fv = f"{case_path}/simpleFoam/system/fvOptions"
                self.write_coefs(fv, d, "d")
                self.write_coefs(fv, f, "f")
                self.set_decompose_par(f"{case_path}/snappyHexMesh")
                self.set_decompose_par(f"{case_path}/simpleFoam")
