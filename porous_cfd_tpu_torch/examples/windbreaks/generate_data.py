"""windbreaks data generation (the port's counterpart of
``examples/windbreaks/generate_data.py``). The tree placement and merging
require Blender (bpy); the solve, OpenFOAM.

    python -m porous_cfd_tpu_torch.examples.windbreaks.generate_data \\
        --openfoam-dir /usr/bin/openfoam2412 [--openfoam-procs 2] \\
        [--data-root-dir data] [--meta-only] [--save-plots]

``--meta-only`` needs neither; ``--save-plots`` needs matplotlib.
"""
from porous_cfd_tpu_torch.datagen.generator import run_cli
from porous_cfd_tpu_torch.examples.windbreaks.windbreak_generator import WindbreakGenerator


def run(argv=None):
    return run_cli(WindbreakGenerator, "windbreaks", argv)


if __name__ == "__main__":
    run()
