"""abc data generation (the port's counterpart of
``examples/abc/generate_data.py``): the filtered ABC meshes under
``assets/meshes`` (``data_preprocess.py`` downloads and filters them),
aligned into the duct, one case per (object x inlet speed), solved by
OpenFOAM; a malformed case (porous cells past half the mesh) is deleted
with a warning.

    python -m porous_cfd_tpu_torch.examples.abc.generate_data \\
        --openfoam-dir /usr/bin/openfoam2412 [--openfoam-procs 2] \\
        [--data-root-dir data] [--meta-only] [--save-plots]

``--meta-only`` needs no OpenFOAM; ``--save-plots`` needs matplotlib.
"""
from porous_cfd_tpu_torch.datagen.generator import run_cli
from porous_cfd_tpu_torch.examples.abc.abc_generator import AbcGenerator


def run(argv=None):
    return run_cli(AbcGenerator, "abc", argv)


if __name__ == "__main__":
    run()
