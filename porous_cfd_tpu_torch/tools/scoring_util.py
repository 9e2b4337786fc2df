"""Chunked split scoring for the golden-dataset tools (the port's
counterpart of ``tools/scoring_util.py``).

One batch of a whole split does not fit the card for the ++ families at
hundreds of cases (their attached neighbour structures multiply a case's
footprint), so the split is predicted in chunks of cases and each field's
squared error and squared reference are summed over them: the split's
rel-L2 stays exact.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.train.engine import gather_cases, make_predict_functions

# the golden tools' seed: every split is sampled from its own rng of it
SEED = 8421


def predict_split(model, stacked, n_cases: int, chunk: int = 64):
    """Yield (first case, predicted, reference) for each chunk of ``chunk``
    cases of a split, both host ``FoamData``s (the prediction in f32 on the
    model's device, after its ``attach_neighbors``)."""
    fns = make_predict_functions(model)
    stacked = stacked.to(stacked.data.device if torch.is_tensor(stacked.data) else "cpu")
    for c0 in range(0, n_cases, chunk):
        idx = torch.arange(c0, min(n_cases, c0 + chunk), device=stacked.data.device)
        batch = model.attach_neighbors(gather_cases(stacked, idx).to(model.device))
        with torch.no_grad():
            pred = fns.predict_batch(batch, False).numpy()
        yield c0, pred, batch.numpy()


def denormalize(scaler, x) -> np.ndarray:
    """``scaler``'s inverse of ``x`` on the host, in float64."""
    return scaler.to("cpu").inverse_transform(torch.as_tensor(np.asarray(x))).numpy() \
        .astype(np.float64)


def split_rel_l2(model, stacked, n_cases: int, scalers: dict, chunk: int = 64) -> dict:
    """The denormalised rel-L2 of each field of ``scalers`` over a split.

    :param model: the trained model (its module holds the weights).
    :param stacked: the split's stacked ``FoamData`` (host or device).
    :param scalers: {field: scaler}, the fields to score (e.g. U, p).
    :returns: {field: rel_l2}.
    """
    sq = {fld: [0.0, 0.0] for fld in scalers}
    for _, pred, ref in predict_split(model, stacked, n_cases, chunk):
        for fld, sc in scalers.items():
            pr, rf = denormalize(sc, pred[fld]), denormalize(sc, ref[fld])
            sq[fld][0] += float(np.sum((pr - rf) ** 2))
            sq[fld][1] += float(np.sum(rf ** 2))
    return {fld: float(np.sqrt(a / b)) for fld, (a, b) in sq.items()}


def load_split(root: Path, split: str, points) -> FoamDataset:
    """A split under ``root`` at ``points`` (internal, boundary,
    observations), normalised with the train split's statistics."""
    n_int, n_bnd, n_obs = points
    meta_dir = None if split == "train" else str(root / "train")
    return FoamDataset(str(root / split), n_int, n_bnd, n_obs, np.random.default_rng(SEED),
                       meta_dir=meta_dir)


def score_splits(model, root: Path, points, splits=("train", "val", "test"), chunk=64,
                 fields=("U", "p")) -> dict:
    """``split_rel_l2`` of ``fields`` on each split under ``root``, with the
    train split's normalizers: {split: {field: rel_l2}}."""
    scalers = load_split(root, "train", points).normalizers
    out = {}
    for split in splits:
        ds = load_split(root, split, points)
        out[split] = split_rel_l2(model, ds.stacked(), len(ds),
                                  {f: scalers[f] for f in fields}, chunk)
    return out
