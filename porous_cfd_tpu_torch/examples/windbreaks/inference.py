"""windbreaks inference (the port's counterpart of
``examples/windbreaks/inference.py``): restore a checkpoint the training
CLI wrote and predict every case of a split, one at a time; with
``--save-plots`` each case's denormalised predicted (titled with its d, f
and inlet speed) and ground-truth fields are drawn as 3D scatters under
``<checkpoint parent>/plots/<split>/<case>/``, then, with PyVista, the
predicted streamlines and the house's errors on its mesh, or without it the
house's surface errors as a scatter (matplotlib).

    python -m porous_cfd_tpu_torch.examples.windbreaks.inference \\
        --checkpoint lightning_logs/NAME/model.ckpt --data-dir data/val \\
        --meta-dir data/train

The model type comes from the ``model_meta.json`` beside the checkpoint.
From the command line it runs on the CUDA card; ``run(argv, device="cpu")``
on the CPU.
"""
from __future__ import annotations

from argparse import Namespace
from pathlib import Path

import numpy as np

from porous_cfd_tpu_torch.data.dataset import FoamDataset
from porous_cfd_tpu_torch.examples.windbreaks.train import SEED, get_model
from porous_cfd_tpu_torch.pipelines import inference
from porous_cfd_tpu_torch.pipelines.evaluation import inverse_transform
from porous_cfd_tpu_torch.viz import viz3d


def load_model_and_params(args: Namespace, data: FoamDataset, device=None):
    """The model of the checkpoint's type built over ``data``'s normalizers
    on ``device`` (the CUDA card unless ``"cpu"`` is asked for), with the
    checkpoint's weights restored into its module. Returns (model, state)."""
    return inference.restore(args, data, get_model, device)


def sample_process_fn(data, target, predicted, case_path, plot_path):
    """The 3D field scatters, the streamlines and the house's errors
    (windbreaks/inference.py:27-65); nothing without a plot directory."""
    if plot_path is None:
        return
    n, tgt = data.normalizers, target.numpy()
    pts = inverse_transform(n["C"], tgt["C"])
    d = float(np.max(inverse_transform(n["d"], tgt["d"])))
    f = float(np.max(inverse_transform(n["f"], tgt["f"])))
    inlet_ux = float(np.max(inverse_transform(n["U"][0], tgt["Ux-inlet"])))
    pred_u = inverse_transform(n["U"], predicted["U"])
    pred_p = inverse_transform(n["p"], predicted["p"])
    tgt_u = inverse_transform(n["U"], tgt["U"])
    tgt_p = inverse_transform(n["p"], tgt["p"])

    viz3d.plot_fields_3d(f"Predicted D={d:.3f} F={f:.3f} Inlet={inlet_ux:.3f}",
                         pts, pred_u, pred_p, save_path=plot_path)
    viz3d.plot_fields_3d("Ground truth", pts, tgt_u, tgt_p, save_path=plot_path)
    solids = {"solid": "oldlace", "mesh": "mediumseagreen"}
    if viz3d.HAS_PYVISTA:
        viz3d.plot_streamlines("Predicted streamlines", case_path, pts, pred_u,
                               pred_p, additional_meshes=solids,
                               save_path=plot_path, interp_radius=7)
    if "solid" in tgt:
        u_err = np.abs(pred_u - tgt_u)
        p_err = np.abs(pred_p - tgt_p)
        solid_rows = np.asarray(tgt.domain["solid"])
        house_obj = Path(case_path) / "constant/triSurface/solid.obj"
        if viz3d.HAS_PYVISTA and house_obj.exists():
            viz3d.plot_houses("House", pts[solid_rows], u_err[solid_rows],
                              p_err[solid_rows], house_obj, save_path=plot_path)
        else:
            viz3d.plot_surface_errors("House surface U error", pts[solid_rows],
                                      np.linalg.norm(u_err[solid_rows], axis=-1),
                                      save_path=plot_path)


def run(argv=None, device=None):
    """Parse ``argv`` (the command line when None), load the split and
    predict each case on ``device``; returns the predictions."""
    return inference.run(argv, get_model, SEED, device, result_process_fn=sample_process_fn)


if __name__ == "__main__":
    run()
