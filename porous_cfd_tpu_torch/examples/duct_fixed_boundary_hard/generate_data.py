"""duct_fixed_boundary_hard data generation (the port's counterpart of
``examples/duct_fixed_boundary_hard/generate_data.py``). The mesh
composition (boolean union, voxel remesh) requires Blender (bpy); the
solve, OpenFOAM.

    python -m porous_cfd_tpu_torch.examples.duct_fixed_boundary_hard.generate_data \\
        --openfoam-dir /usr/bin/openfoam2412 [--openfoam-procs 2] \\
        [--data-root-dir data] [--meta-only] [--save-plots]

``--meta-only`` needs neither; ``--save-plots`` needs matplotlib.
"""
from porous_cfd_tpu_torch.datagen.generator import run_cli
from porous_cfd_tpu_torch.examples.duct_fixed_boundary_hard.generator_2d_fixed import \
    Generator2DFixedHard


def run(argv=None):
    return run_cli(Generator2DFixedHard, "duct_fixed_boundary_hard", argv)


if __name__ == "__main__":
    run()
