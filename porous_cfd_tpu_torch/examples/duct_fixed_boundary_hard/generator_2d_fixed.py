"""Hard fixed-BC generator (the port's counterpart of
``examples/duct_fixed_boundary_hard/generator_2d_fixed.py``): composes 1-5
random rotated/offset primitives per case, boolean-unions them and
voxel-remeshes (200 cases), registering each sub-mesh in snappyHexMeshDict.

Boolean union and voxel remeshing require Blender-as-module (bpy); those
operations sit behind :func:`mesh_ops.require_bpy` with the same algorithmic
structure as the reference. ``add_porous_meshes_to_case`` and the case
instantiation are Blender-free."""
import glob
import json
import math
import re
import shutil
from pathlib import Path
from random import Random

from porous_cfd_tpu_torch.datagen import mesh_ops
from porous_cfd_tpu_torch.datagen.generator import Generator2DBase


class Generator2DFixedHard(Generator2DBase):
    n_cases = 200

    def add_porous_meshes_to_case(self, case_path: str, meshes: list[str]):
        """Register each composed sub-mesh in snappyHexMeshDict (reference
        :16-72): the template's single 'mesh' geometry and refinementSurfaces
        entries are used as templates, duplicated once per sub-mesh with its
        own insidePoint."""
        snappy = Path(case_path) / "system" / "snappyHexMeshDict"
        text = snappy.read_text()

        geo_m = re.search(r"(mesh\.obj\s*\{.*?\n    \})", text, re.DOTALL)
        surf_m = re.search(
            r"(        mesh\s*\{.*?\n        \})", text, re.DOTALL)
        if geo_m is None or surf_m is None:
            raise ValueError(f"template {snappy} lacks the 'mesh' entries")

        geo_blocks, surf_blocks = [], []
        for m in sorted(meshes):
            inside = self.get_location_inside(
                f"{case_path}/constant/triSurface/{m}.obj")
            vec = f"({inside[0]} {inside[1]} {inside[2]})"
            geo = geo_m.group(1).replace("mesh.obj", f"{m}.obj")
            geo = geo.replace("name mesh;", f"name {m};")
            surf = surf_m.group(1).replace("mesh\n", f"{m}\n", 1)
            surf = re.sub(r"^        mesh\s*\{", f"        {m}\n        {{",
                          surf)
            surf = re.sub(r"insidePoint\s+\([^)]*\)\s*;",
                          f"insidePoint {vec};", surf)
            surf = surf.replace("faceZone mesh;", f"faceZone {m};")
            surf = surf.replace("cellZone mesh;", f"cellZone {m};")
            geo_blocks.append(geo)
            surf_blocks.append(surf)

        text = text.replace(geo_m.group(1), "\n    ".join(geo_blocks))
        text = text.replace(surf_m.group(1), "\n".join(surf_blocks))
        snappy.write_text(text)

    def generate_object(self, meshes_dir: str, src_meshes: list[str],
                        rng: Random):
        """Arrange up to 5 randomly rotated/offset primitives (reference
        :109-143). Requires bpy."""
        bpy = mesh_ops.require_bpy()
        import mathutils
        from bpy import ops
        src = rng.choice(src_meshes)
        ops.wm.obj_import(filepath=f"{meshes_dir}/{src}", forward_axis="Y",
                          up_axis="Z")
        ops.object.select_all(action="SELECT")
        src_obj = bpy.context.selected_objects[0]
        src_obj.rotation_euler = mathutils.Euler(
            (0.0, 0.0, rng.random() * 2 * math.pi))
        meshes = [src_obj]
        for _ in range(rng.randint(1, 4)):
            m = rng.choice(src_meshes)
            ops.wm.obj_import(filepath=f"{meshes_dir}/{m}", forward_axis="Y",
                              up_axis="Z")
            obj = bpy.context.selected_objects[0]
            obj.rotation_euler = mathutils.Euler(
                (0.0, 0.0, rng.random() * 2 * math.pi))
            bpy.ops.object.transform_apply(location=True, rotation=True,
                                           scale=True)
            offset = ((rng.random() - 0.5) * src_obj.dimensions[0],
                      (rng.random() - 0.5) * src_obj.dimensions[1])
            obj.location = (*offset, 0)
            bpy.ops.object.transform_apply(location=True)
            meshes.append(obj)
        return meshes

    def merge_meshes(self, meshes):
        """Boolean-union the arranged meshes (reference :145-160). Requires
        bpy."""
        bpy = mesh_ops.require_bpy()
        mesh = meshes[0]
        for i, _ in enumerate(meshes[:-1]):
            mod = mesh.modifiers.new(name="Boolean", type="BOOLEAN")
            mod.operation = "UNION"
            mod.object = meshes[i + 1]
            bpy.context.view_layer.objects.active = mesh
            bpy.ops.object.modifier_apply(modifier=mod.name)
        return mesh

    def generate_transformed_meshes(self, meshes_dir: Path, dest_dir: Path,
                                    rng: Random):
        """Compose + union + voxel remesh 200 cases (reference :162-200).
        Requires bpy."""
        bpy = mesh_ops.require_bpy()
        from bpy import ops
        with open(Path(meshes_dir) / "transforms.json") as f:
            meshes = list(json.load(f).keys())
        dest_dir.mkdir(parents=True, exist_ok=True)
        for i in range(self.n_cases):
            base = Path(dest_dir) / str(i)
            base.mkdir()
            objs = self.generate_object(str(meshes_dir), meshes, rng)
            obj = self.merge_meshes(objs)
            mod = obj.modifiers.new(name="Remesh", type="REMESH")
            mod.voxel_size = 0.002
            bpy.context.view_layer.objects.active = obj
            bpy.ops.object.modifier_apply(modifier=mod.name)
            ops.wm.obj_export(filepath=f"{base}/mesh.obj", forward_axis="Y",
                              up_axis="Z", export_materials=False,
                              export_selected_objects=True)
            ops.object.select_all(action="SELECT")
            ops.object.delete()

    def generate_openfoam_cases(self, meshes_dir: Path, dest_dir: Path,
                                case_config_dir: Path, rng):
        for m_c in sorted(glob.glob(f"{meshes_dir}/*/")):
            case_path = f"{dest_dir}/{Path(m_c).stem}"
            shutil.copytree(self.case_template_dir, case_path)
            meshes = [Path(s).stem for s in glob.glob(f"{m_c}/*.obj")]
            for m in meshes:
                shutil.copyfile(
                    f"{m_c}/{m}.obj",
                    f"{case_path}/snappyHexMesh/constant/triSurface/{m}.obj")
            self.add_porous_meshes_to_case(f"{case_path}/snappyHexMesh", meshes)
            self.set_decompose_par(f"{case_path}/snappyHexMesh")
            self.set_decompose_par(f"{case_path}/simpleFoam")
