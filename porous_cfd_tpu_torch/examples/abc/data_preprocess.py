"""ABC CAD dataset acquisition + mesh filtering (the port's counterpart of
``examples/abc/data_preprocess.py``; reference
examples/abc/data_preprocess.py:18-256): download an ABC chunk (GDrive mirror
or direct URL), extract/convert the meshes, then copy up to ``n_meshes``
OpenFOAM-suitable ones into the assets meshes dir. Suitability = manifold,
bounded bbox aspect, and volume/bbox ratio above a floor; objects made of
several loose parts are split and the first acceptable part is kept under the
original mesh name.

The geometric predicates run on numpy arrays (``datagen/mesh_filter.py``,
testable without Blender); only the scene workflow needs bpy, and the
archive workflow needs network egress. Both are gated with actionable
errors.

    python -m porous_cfd_tpu_torch.examples.abc.data_preprocess --src RAW_DIR \\
        --dest examples/abc/assets/meshes/standard [--n-meshes 200]
"""
import glob
import os
import shutil
import subprocess
import tarfile
from functools import partial
from pathlib import Path
from random import Random
from urllib.request import urlopen

import numpy as np

from porous_cfd_tpu_torch.datagen import mesh_filter, mesh_ops

ABC_CHUNK_GDRIVE_ID = "1KPM2IvOa8YUUtt7yHfVA551xKat2Mdzx"


def download_from_gdrive(file_id: str, out_path: str):
    """Fetch a Google Drive file by id via wget (reference :18-39); skipped
    when ``out_path`` already exists."""
    if os.path.exists(out_path):
        print(f"{out_path} already downloaded! Remove it to download again.")
        return
    subprocess.run(
        ["wget",
         "https://drive.usercontent.google.com/download"
         f"?id={file_id}&confirm=t",
         "-O", out_path],
        check=True, stdout=subprocess.PIPE, text=True)


def download(url: str, out_path: str, block_size: int = 32768):
    """Plain-URL download with streamed blocks (reference :42-66)."""
    if os.path.exists(out_path):
        print(f"{out_path} already downloaded!")
        return
    response = urlopen(url)
    total = int(response.info().get("Content-length") or 0)
    written = 0
    with open(out_path, "wb") as fh:
        for block in iter(partial(response.read, block_size), b""):
            fh.write(block)
            written += len(block)
            if total:
                print(f"\r{written / total:.0%} of {url.split('/')[-1]}",
                      end="", flush=True)
    print()


def extract(data_file: str, dest_dir: str):
    """Unpack a tar archive into ``dest_dir``, clearing stale .obj files
    first (reference :69-81)."""
    Path(dest_dir).mkdir(exist_ok=True, parents=True)
    for stale in glob.glob(f"{dest_dir}/*.obj"):
        os.remove(stale)
    with tarfile.open(data_file, "r") as fh:
        fh.extractall(dest_dir)


def convert_to_obj(data_dir: str, meshconv_path: str):
    """Convert every .off under ``data_dir`` to .obj with the external
    ``meshconv`` tool (reference :95-122)."""
    for off in glob.glob(f"{data_dir}/**/*.off", recursive=True):
        subprocess.run([meshconv_path, off, "-c", "obj"], check=True,
                       stdout=subprocess.DEVNULL)


# --- Blender-object adapters over the numpy predicates ---------------------

def object_arrays(obj):
    """Extract (verts, edges, tri_faces) numpy arrays from a Blender mesh
    object, with the world transform applied to vertices."""
    mesh = obj.data
    n = len(mesh.vertices)
    verts = np.empty(n * 3, dtype=np.float64)
    mesh.vertices.foreach_get("co", verts)
    verts = verts.reshape(n, 3)
    mw = np.array(obj.matrix_world)
    verts = verts @ mw[:3, :3].T + mw[:3, 3]
    edges = np.empty(len(mesh.edges) * 2, dtype=np.int64)
    mesh.edges.foreach_get("vertices", edges)
    polys = [list(p.vertices) for p in mesh.polygons]
    return verts, edges.reshape(-1, 2), mesh_filter.triangulate_fan(polys)


def is_manifold(obj) -> bool:
    """Every edge shared by exactly two faces (reference :84-92 selects
    non-manifold geometry in edit mode; bmesh exposes the same predicate)."""
    mesh_ops.require_bpy()
    import bmesh
    bm = bmesh.new()
    bm.from_mesh(obj.data)
    try:
        return all(e.is_manifold for e in bm.edges)
    finally:
        bm.free()


def has_multiple_islands(obj) -> bool:
    """Loose-part detection via vertex connectivity (reference :125-149)."""
    verts, edges, _ = object_arrays(obj)
    return mesh_filter.has_multiple_islands(len(verts), edges)


def get_volume(obj) -> float:
    """World-space enclosed volume (reference :152-173)."""
    verts, _, tris = object_arrays(obj)
    return mesh_filter.mesh_volume(verts, tris)


def is_object_good(obj, min_aspect: float, min_volume_ratio: float) -> bool:
    """Reference :176-186 acceptance test on a Blender object."""
    verts, _, tris = object_arrays(obj)
    return mesh_filter.is_mesh_good(verts, tris, min_aspect, min_volume_ratio)


def clean_scene():
    """Remove all objects + purge orphan data blocks (reference :189-193)."""
    bpy = mesh_ops.require_bpy()
    bpy.ops.object.select_all(action="SELECT")
    bpy.ops.object.delete()
    bpy.ops.outliner.orphans_purge(do_local_ids=True, do_linked_ids=True,
                                   do_recursive=False)


def copy_to_meshes(data_dir: str, meshes_dir: str, n_meshes: int,
                   rng: Random | None = None, min_aspect: float = 0.2,
                   min_volume_ratio: float = 0.2) -> list[str]:
    """Filter raw ABC .obj files into ``meshes_dir`` (reference :196-256).

    Caps the output at ``n_meshes``. Single-part objects passing the checks
    are copied verbatim; multi-part objects are separated and the first
    acceptable loose part is exported under the original file name. ``rng``
    is accepted for signature parity (reserved in the reference too).
    """
    bpy = mesh_ops.require_bpy()
    ops = bpy.ops
    meshes_dir = Path(meshes_dir)
    meshes_dir.mkdir(exist_ok=True, parents=True)

    kept: list[str] = []
    to_copy: list[str] = []
    for m in sorted(glob.glob(f"{data_dir}/**/*.obj", recursive=True)):
        if len(kept) + len(to_copy) >= n_meshes:
            break
        ops.object.select_all(action="DESELECT")
        ops.wm.obj_import(filepath=m, forward_axis="Y", up_axis="Z")
        obj = bpy.context.selected_objects[0]

        if not is_manifold(obj):
            clean_scene()
            continue

        if has_multiple_islands(obj):
            ops.mesh.separate(type="LOOSE")
            ops.object.select_all(action="SELECT")
            for part in bpy.context.selected_objects:
                if is_object_good(part, min_aspect, min_volume_ratio):
                    ops.object.select_all(action="DESELECT")
                    part.select_set(True)
                    out = meshes_dir / Path(m).name
                    ops.wm.obj_export(filepath=str(out), forward_axis="Y",
                                      up_axis="Z", export_materials=False,
                                      export_selected_objects=True)
                    kept.append(str(out))
                    break
        elif is_object_good(obj, min_aspect, min_volume_ratio):
            to_copy.append(m)
        clean_scene()

    for m in to_copy:
        dest = meshes_dir / Path(m).name
        shutil.copyfile(m, dest)
        kept.append(str(dest))
    return kept


def main(argv=None) -> list[str]:
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--src", type=str, required=True)
    p.add_argument("--dest", type=str, required=True)
    p.add_argument("--n-meshes", type=int, default=200)
    p.add_argument("--min-aspect", type=float, default=0.2)
    p.add_argument("--min-volume-ratio", type=float, default=0.2)
    a = p.parse_args(argv)
    out = copy_to_meshes(a.src, a.dest, a.n_meshes,
                         min_aspect=a.min_aspect,
                         min_volume_ratio=a.min_volume_ratio)
    print(f"kept {len(out)} meshes")
    return out


if __name__ == "__main__":
    main()
