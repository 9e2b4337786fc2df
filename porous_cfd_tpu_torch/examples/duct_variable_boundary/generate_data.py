"""duct_variable_boundary data generation (the port's counterpart of
``examples/duct_variable_boundary/generate_data.py``): mesh augmentation +
case instantiation with variable BCs, then the OpenFOAM runs (the OpenFOAM
toolchain through its shell wrapper, ``--openfoam-dir``).

    python -m porous_cfd_tpu_torch.examples.duct_variable_boundary.generate_data \\
        --openfoam-dir /usr/bin/openfoam2412 [--openfoam-procs 2] \\
        [--data-root-dir data] [--meta-only] [--save-plots]

``--meta-only`` needs no OpenFOAM; ``--save-plots`` needs matplotlib.
"""
from porous_cfd_tpu_torch.datagen.generator import run_cli
from porous_cfd_tpu_torch.examples.duct_variable_boundary.generator_2d_variable import \
    Generator2DVariable


def run(argv=None):
    return run_cli(Generator2DVariable, "duct_variable_boundary", argv)


if __name__ == "__main__":
    run()
