"""duct_fixed_boundary data generation (the port's counterpart of
``examples/duct_fixed_boundary/generate_data.py``): the 11 primitive shapes
under their rotation / scale grid (152 meshes), one OpenFOAM case each,
solved through the OpenFOAM shell wrapper, split 0.6 / 0.2 / 0.2, with each
split's ``meta.json`` and ``data_config.json`` and the root's
``min_points.json``.

    python -m porous_cfd_tpu_torch.examples.duct_fixed_boundary.generate_data \\
        --openfoam-dir /usr/bin/openfoam2412 [--openfoam-procs 2] \\
        [--data-root-dir data] [--meta-only] [--save-plots]

``--meta-only`` rewrites the meta files of an existing dataset and needs no
OpenFOAM; ``--save-plots`` draws the dataset plots (matplotlib). It needs no
card.
"""
from porous_cfd_tpu_torch.datagen.generator import run_cli
from porous_cfd_tpu_torch.examples.duct_fixed_boundary.generator_2d_fixed import \
    Generator2DFixed


def run(argv=None):
    return run_cli(Generator2DFixed, "duct_fixed_boundary", argv)


if __name__ == "__main__":
    run()
