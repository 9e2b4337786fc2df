"""vertical_duct_fixed_boundary data generation (the port's counterpart of
``examples/vertical_duct_fixed_boundary/generate_data.py``): the hard
composed generator with the two-inlet duct template. The composition
requires Blender (bpy); the solve, OpenFOAM.

    python -m porous_cfd_tpu_torch.examples.vertical_duct_fixed_boundary.generate_data \\
        --openfoam-dir /usr/bin/openfoam2412 [--openfoam-procs 2] \\
        [--data-root-dir data] [--meta-only] [--save-plots]

``--meta-only`` needs neither; ``--save-plots`` needs matplotlib.
"""
from porous_cfd_tpu_torch.datagen.generator import run_cli
from porous_cfd_tpu_torch.examples.duct_fixed_boundary_hard.generator_2d_fixed import \
    Generator2DFixedHard


class Generator2DFixedHardTop(Generator2DFixedHard):
    pass


def run(argv=None):
    return run_cli(Generator2DFixedHardTop, "vertical_duct_fixed_boundary", argv)


if __name__ == "__main__":
    run()
