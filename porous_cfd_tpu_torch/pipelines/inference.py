"""Inference pipeline (counterpart of ``porous_cfd_tpu/pipelines/inference.py``):
the CLI's flags and per-case prediction, a batch of one case as the
reference's DataLoader gives them, with an optional per-case callback that
gets the case's plot directory, ``<checkpoint parent>/plots/<split>/<case>``
under ``--save-plots`` (None without; the experiments' callbacks draw only
then, with matplotlib).
"""
from __future__ import annotations

import argparse
import os
from argparse import ArgumentParser, Namespace
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.data.foam_data import FoamData
from porous_cfd_tpu_torch.data.parser import parse_model_type
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.models.base import PinnModel
from porous_cfd_tpu_torch.train.engine import gather_cases, make_predict_functions
from porous_cfd_tpu_torch.train.trainer import load_checkpoint
from porous_cfd_tpu_torch.viz.common import require_matplotlib


def default_checkpoint() -> str:
    """The last run under ``lightning_logs``, alphabetically
    (inference.py:23-26)."""
    try:
        last = sorted(os.listdir("lightning_logs"))[-1]
        return str(Path("lightning_logs") / last / "model.ckpt")
    except (FileNotFoundError, IndexError):
        return "model.ckpt"


def build_arg_parser() -> ArgumentParser:
    """Reference CLI (inference.py:19-39)."""
    p = argparse.ArgumentParser()
    p.add_argument("--save-plots", action="store_true", default=False,
                   help="save all the inference plots (needs matplotlib)")
    p.add_argument("--checkpoint", type=str, default=default_checkpoint(),
                   help="path of the saved model checkpoint")
    p.add_argument("--data-dir", type=str, default="data/test")
    p.add_argument("--meta-dir", type=str, default="data/train",
                   help="directory containing the meta.json file")
    p.add_argument("--n-internal", type=int, default=1000)
    p.add_argument("--n-boundary", type=int, default=200)
    p.add_argument("--n-observations", type=int, default=500)
    p.add_argument("--precision", type=str, default="bf16-mixed")
    return p


def create_plots_root(args: Namespace) -> Path | None:
    """``<checkpoint parent>/plots/<split>``, made, under ``--save-plots``,
    with matplotlib on its Agg backend (the ``ImportError`` that names
    matplotlib when the machine has none); None without."""
    if not getattr(args, "save_plots", False):
        return None
    require_matplotlib().use("Agg")
    path = Path(args.checkpoint).parent / "plots" / Path(args.data_dir).name
    path.mkdir(exist_ok=True, parents=True)
    return path


def create_case_plot_dir(plots_root: Path | None, case_name: str) -> Path | None:
    """``<plots root>/<case>``, made; None without a plots root."""
    if plots_root is None:
        return None
    d = plots_root / case_name
    d.mkdir(exist_ok=True, parents=True)
    return d


# (dataset, target case, predicted case, case directory, case plot directory
# or None) -> None
ResultFn = Callable[[FoamDataset, FoamData, FoamData, Path, Optional[Path]], None]


def predict(args: Namespace, model: PinnModel, data: FoamDataset,
            result_process_fn: Optional[ResultFn] = None) -> list[FoamData]:
    """Predict each case of ``data`` alone on the model's device, in the
    ``--precision`` the arguments ask for (bf16 compute with f32 weights
    under ``bf16*``), after the model's per-dataset aux is attached once.
    Returns each case's prediction as a host ``FoamData`` (N, F) and hands
    it to ``result_process_fn`` beside the case's target and its plot
    directory (made under ``--save-plots``, after matplotlib is checked and
    before anything is predicted)."""
    plots_root = create_plots_root(args)
    model = model.with_precision(getattr(args, "precision", "32-true"))
    fns = make_predict_functions(model)
    device = model.device
    stacked = model.attach_neighbors(data.stacked().to(device))
    predictions = []
    for i in range(len(data)):
        batch = gather_cases(stacked, torch.tensor([i], device=device))
        predicted = fns.predict_batch(batch, False).numpy().squeeze()
        predictions.append(predicted)
        if result_process_fn is not None:
            case_path = Path(data.samples[i])
            result_process_fn(data, data[i], predicted, case_path,
                              create_case_plot_dir(plots_root, case_path.name))
    return predictions


def restore(args: Namespace, data: FoamDataset, get_model, device=None):
    """The model of the checkpoint's type (its ``model_meta.json``) that an
    experiment's ``get_model(args, normalizers, device)`` builds over
    ``data``'s normalizers on ``device`` (the CUDA card unless ``"cpu"`` is
    asked for), with the checkpoint's weights restored into its module.
    Returns (model, state)."""
    model = get_model(Namespace(**{**vars(args), "model": parse_model_type(args.checkpoint),
                                   "loss_scaler": "fixed"}),
                      data.normalizers, resolve_device(device))
    state, _ = load_checkpoint(args.checkpoint, model)
    return model, state


def run(argv, get_model, seed: int, device=None, dataset_cls=FoamDataset,
        result_process_fn: Optional[ResultFn] = None) -> list[FoamData]:
    """An experiment's inference CLI: parse ``argv`` (the command line when
    None), load the split as a ``dataset_cls`` with the rng of ``seed``,
    restore the checkpoint through ``get_model`` and predict each case on
    ``device``, handing each to ``result_process_fn`` (the experiment's
    plots); returns the predictions."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    data = dataset_cls(args.data_dir, args.n_internal, args.n_boundary, args.n_observations,
                       np.random.default_rng(seed), args.meta_dir)
    model, _ = restore(args, data, get_model, device)
    return predict(args, model, data, result_process_fn)
