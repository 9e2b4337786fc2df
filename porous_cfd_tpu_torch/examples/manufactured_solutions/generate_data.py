"""manufactured_solutions data generation (the port's counterpart of
``examples/manufactured_solutions/generate_data.py``): synthesized
geometry-only cases (C and cellToRegion; U, p and the forcing are analytic
and made at load time), 16 / 4 / 4 cases of 200 internal and 40 + 40
boundary points, with each split's ``data_config.json`` and ``meta.json``
and the root's ``min_points.json``. From one seed it writes the JAX
package's bytes.

    python -m porous_cfd_tpu_torch.examples.manufactured_solutions.generate_data \\
        [--dest-dir data]

It needs no card.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from porous_cfd_tpu_torch.datagen import synthetic_case
from porous_cfd_tpu_torch.datagen.meta import generate_meta, generate_min_points

SPLITS = {"train": 16, "val": 4, "test": 4}


def run(dest_dir: str = "data", seed: int = 8421, splits=SPLITS) -> None:
    rng = np.random.default_rng(seed)
    dest = Path(dest_dir)
    for split, n_cases in splits.items():
        synthetic_case.write_manufactured_split(dest / split, n_cases, rng)
        synthetic_case.write_data_config(
            dest / split, fields=["C", "cellToRegion"], variable_boundaries={},
            normalize={"Scale": [], "Standardize": []}, dims=["x", "y"])
        generate_meta(dest / split, "C", "cellToRegion", max_dim=2)
    generate_min_points(dest)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dest-dir", default="data")
    run(ap.parse_args(argv).dest_dir)


if __name__ == "__main__":
    main()
