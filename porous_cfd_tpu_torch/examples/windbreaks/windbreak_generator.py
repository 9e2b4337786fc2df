"""Windbreak 3D case generator (the port's counterpart of
``examples/windbreaks/windbreak_generator.py``): rows of randomly
scaled/rotated trees merged via BVH-overlap-checked placement + boolean
union + Catmull-Clark remesh, one random house per case, inlet Ux over a
7-value grid and per-tree-species Darcy-Forchheimer coefficients from
config.json.

Tree placement/merging requires Blender (bpy + BVH); those steps are gated
behind :func:`mesh_ops.require_bpy`. Case instantiation (template copy,
inlet velocity, coefficients, decomposePar) is Blender-free.
"""
import glob
import json
import math
import shutil
from pathlib import Path
from random import Random

from porous_cfd_tpu_torch.datagen import mesh_ops
from porous_cfd_tpu_torch.datagen.generator import Generator3DBase


class WindbreakGenerator(Generator3DBase):
    def __init__(self, src_dir, openfoam_bin, n_procs, keep_p=0.5,
                 meta_only=False, n_rows=2, trees_per_row=4):
        super().__init__(src_dir, openfoam_bin, n_procs, keep_p, meta_only)
        self.n_rows = n_rows
        self.trees_per_row = trees_per_row

    # -- Blender-dependent mesh composition (reference :31-120) -----------
    def generate_transformed_meshes(self, meshes_dir: Path, dest_dir: Path,
                                    rng: Random):
        bpy = mesh_ops.require_bpy()
        import mathutils
        from bpy import ops
        from mathutils.bvhtree import BVHTree

        with open(Path(meshes_dir) / "config.json") as f:
            config = json.load(f)
        trees = list(config["cfd params"]["trees"].keys())
        houses = sorted(glob.glob(f"{meshes_dir}/houses/*.obj"))

        for i in range(config["cfd params"].get("n cases", 50)):
            case_dir = Path(dest_dir) / str(i)
            case_dir.mkdir(parents=True, exist_ok=True)
            ops.object.select_all(action="SELECT")
            ops.object.delete()

            species = rng.choice(trees)
            placed = []
            for row in range(self.n_rows):
                for t in range(self.trees_per_row):
                    ops.wm.obj_import(filepath=f"{meshes_dir}/{species}",
                                      forward_axis="Y", up_axis="Z")
                    obj = bpy.context.selected_objects[0]
                    obj.scale = mathutils.Vector(
                        [0.8 + rng.random() * 0.4] * 3)
                    obj.rotation_euler = mathutils.Euler(
                        (0, 0, rng.random() * 2 * math.pi))
                    obj.location = (t * 1.5 + rng.random() * 0.5,
                                    row * 3.0, 0.0)
                    bpy.ops.object.transform_apply()
                    # BVH overlap check against already placed trees
                    bm_new = BVHTree.FromObject(
                        obj, bpy.context.evaluated_depsgraph_get())
                    if any(bm_new.overlap(p) for p in placed):
                        bpy.ops.object.delete()
                        continue
                    placed.append(bm_new)
            # boolean-union all trees + Catmull-Clark remesh
            objs = list(bpy.context.scene.objects)
            merged = objs[0]
            for other in objs[1:]:
                mod = merged.modifiers.new(name="Boolean", type="BOOLEAN")
                mod.operation = "UNION"
                mod.object = other
                bpy.context.view_layer.objects.active = merged
                bpy.ops.object.modifier_apply(modifier=mod.name)
            mod = merged.modifiers.new(name="Remesh", type="REMESH")
            mod.mode = "SMOOTH"
            bpy.ops.object.modifier_apply(modifier=mod.name)
            ops.wm.obj_export(filepath=str(case_dir / "mesh.obj"),
                              forward_axis="Y", up_axis="Z",
                              export_materials=False)
            # one random house per case
            house = rng.choice(houses)
            shutil.copyfile(house, case_dir / "solid.obj")
            (case_dir / "species.json").write_text(
                json.dumps({"species": species}))

    # -- Blender-free case instantiation (reference :122-168) --------------
    def generate_openfoam_cases(self, meshes_dir: Path, dest_dir: Path,
                                case_config_dir: Path, rng: Random):
        with open(Path(case_config_dir) / "config.json") as f:
            config = json.load(f)
        inlets = config["cfd params"]["inlet"]
        species_coeffs = config["cfd params"]["trees"]
        for m_c in sorted(glob.glob(f"{meshes_dir}/*/")):
            species = json.loads(
                (Path(m_c) / "species.json").read_text())["species"]
            coeffs = species_coeffs[species]
            for ux in inlets:
                # the draw comes first: it is taken even with one inlet
                if rng.random() > self.keep_p and len(inlets) > 1:
                    continue
                case_path = f"{dest_dir}/{Path(m_c).stem}_u{ux}"
                shutil.copytree(self.case_template_dir, case_path)
                for mesh in ["mesh.obj", "solid.obj"]:
                    shutil.copyfile(Path(m_c) / mesh,
                                    f"{case_path}/constant/triSurface/{mesh}")
                self.write_locations_in_mesh(
                    case_path, self.get_location_inside(f"{m_c}/mesh.obj"))
                self.set_internal_velocity(f"{case_path}/0/U", [ux, 0, 0])
                fv = f"{case_path}/system/fvOptions"
                self.write_coefs(fv, coeffs["d"], "d")
                self.write_coefs(fv, coeffs["f"], "f")
                self.set_decompose_par(case_path)
