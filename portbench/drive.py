"""One run of a cell: set-up, the measured window, the traced stretch and the
check against the plain reference.

The program is ``porous_cfd_tpu_torch``, imported here and in the kinds of
run (``kinds/<kind>.py``, picked by the mix's ``kind``) only, through its
normal path: the configuration's example builds the model (``get_model`` and
``get_loss_scaler``), ``train/engine.py`` gives ``train_step`` and
``predict_batch``. The harness makes the inputs and the weights from the
seed and hands the same to the program and the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time
from typing import Optional

import numpy as np
import torch

from portbench import manifest as mf, trace
from portbench.reference import model as ref


@dataclasses.dataclass
class Run:
    """What a run measured, for the end-to-end metrics and the per-layer
    readers (``metrics/<name>.py``)."""
    kind: str
    setup_s: float = 0.0
    wall_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    cases: int = 0
    host_call_s: list = dataclasses.field(default_factory=list)
    latency_s: list = dataclasses.field(default_factory=list)
    service_s: list = dataclasses.field(default_factory=list)
    flops_per_case: float = 0.0
    traced: dict = dataclasses.field(default_factory=dict)
    traced_units: int = 0
    traced_bound_s: float = 0.0
    kernel_bounds: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    timeline: list = dataclasses.field(default_factory=list)
    check_s: float = 0.0


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def precision(mode: str, device):
    """Matmuls in float32 (``f32``: TF32 off), TF32 (``tf32``) or bfloat16
    autocast (``bf16``) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        if mode == "bf16":
            with torch.autocast(device.type, dtype=torch.bfloat16):
                yield
        else:
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def program_model(spec, device):
    """The configuration's model and loss scaler, built by its example; a
    module whose parameters are not the family's ``param_shapes`` of the
    configuration is refused."""
    from porous_cfd_tpu_torch.data.scalers import Normalizer, StandardScaler
    cfg, ds = spec.cfg, spec.dataset
    example = importlib.import_module(f"porous_cfd_tpu_torch.examples.{cfg['example']}.train")
    args = example.build_arg_parser().parse_args(cfg["model_flags"])
    scalers = {k: (StandardScaler(*v) if k in ds.STANDARDIZED else Normalizer(*v))
               for k, v in ds.SCALERS.items()}
    model = example.get_model(args, scalers, device)
    built = {n: tuple(p.shape) for n, p in model.module.named_parameters()}
    stated = spec.family.param_shapes(cfg)
    if built != stated:
        odd = sorted(set(built.items()) ^ set(stated.items()))[:6]
        raise ValueError(f"{cfg['name']}: the example builds other widths than the "
                         f"configuration states: {odd}")
    return model, example.get_loss_scaler(args)


def foam_data(spec, data: torch.Tensor, domain: dict):
    from porous_cfd_tpu_torch.data.foam_data import FoamData
    return FoamData(data, spec.dataset.LABELS, domain)


def domain_tensors(domain: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in domain.items()}


def finite(*tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def pool_winners(spec, params: dict, data: torch.Tensor, domain: dict) -> dict:
    """The distinct winning rows of each max-pool of the model on a batch,
    by the reference's own arithmetic: the rows a pooling backward works
    on."""
    out = {}
    with torch.no_grad():
        for name, rows in ref.pool_rows(spec, params, data, domain).items():
            win = ref.pooled_mlp(spec, params, name, rows).argmax(dim=-2)
            case = rows.shape[-2] * torch.arange(rows.shape[0], device=rows.device)[:, None]
            out[name] = int(torch.unique(win + case).numel())
    return out


def _leaf_gaps(prog: dict, refs: dict, keep=None) -> list:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of the reference's norm of the leaf and of the median leaf."""
    names = [k for k in refs if keep is None or k in keep]
    r = {k: float(torch.linalg.vector_norm(refs[k].double())) for k in names}
    med = float(np.median(list(r.values())))
    return [abs(float(torch.linalg.vector_norm(prog[k].double())) - r[k]) / max(r[k], med)
            for k in names]


def _leaf_diffs(prog: dict, refs: dict, keep) -> list:
    """Each leaf's norm of the program's difference from the reference, over
    the larger of the reference's norm of the leaf and of the median leaf."""
    r = {k: float(torch.linalg.vector_norm(refs[k].double())) for k in keep}
    med = float(np.median(list(r.values())))
    return [float(torch.linalg.vector_norm(prog[k].double() - refs[k].double()))
            / max(r[k], med) for k in keep]


def train_readings(cfg, prog, refs) -> dict:
    """loss_gap: the worst step's relative gap of the total loss; grad_gap,
    change_gap: the worst leaf's gap of the first gradient's norm and of the
    norm of the change after the steps, leaves whose reference gradient is
    under a thousandth of the median leaf's left out of the change;
    grad_diff_unpooled_median: the median, over the leaves that feed no
    max-pool (not under a prefix of the configuration's ``pooled``), of the
    norm of the first gradient's difference. TF32's rounding lies across a
    leaf's gradient and moves its norm little, so only the difference's norm
    tells it from the program's. A pooled channel whose two best rows lie
    within rounding of each other may send its gradient to either row, on
    either side; the other leaves' first gradients do not depend on which,
    but every leaf's later steps do, most of all the pooled leaves'.
    lr_gap: the worst parameter group's relative gap of the learning rate
    the last step applied, the staircase's over every epoch the run
    stepped."""
    (p_loss, p_grad, p_change, p_lr), (r_loss, r_grad, r_change, r_lr) = prog, refs
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in r_grad.items()}
    med = float(np.median(list(norms.values())))
    moving = {k for k, n in norms.items() if n >= 1e-3 * med}
    unpooled = [k for k in r_grad if not k.startswith(tuple(cfg["pooled"]))]
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(p_loss, r_loss)),
            "grad_gap": max(_leaf_gaps(p_grad, r_grad)),
            "grad_diff_unpooled_median": float(np.median(_leaf_diffs(p_grad, r_grad,
                                                                      unpooled))),
            "change_gap": max(_leaf_gaps(p_change, r_change, moving)),
            "lr_gap": max(abs(lr - r_lr[0]) / r_lr[0] for lr in p_lr)}


def field_error(prog, refs) -> float:
    """The worst channel's largest error over its largest reference value,
    of fields and residuals alike."""
    worst = 0.0
    for p, r in zip(prog, refs):
        r = r.to(p.device)
        scale = r.abs().amax(dim=tuple(range(r.dim() - 1))).clamp_min(1e-30)
        worst = max(worst, float(((p - r).abs().amax(dim=tuple(range(r.dim() - 1))) / scale)
                                 .max()))
    return worst


def run_cell(spec, mix: dict, seed: int, seconds: float, traced: bool, device,
             t_start: Optional[float] = None, control: Optional[str] = None,
             root=mf.ROOT):
    """Set-up, the window (and with ``traced`` the traced stretch), the
    program's state freed, then the reference. The mix's ``kind`` picks the
    run's code, ``kinds/<kind>.py`` of the checkout ``root``. Returns (the
    ``Run``, the readings compared, and with ``control`` the readings of the
    reference computed in that precision in the program's place)."""
    t_start = time.perf_counter() if t_start is None else t_start
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        # one process driving one card; few host threads keep its pace steady
        torch.set_num_threads(1)
        torch.empty(0, device=device)            # the card's context, before its counters
        torch.cuda.reset_peak_memory_stats(device)
    spans = trace.Spans()
    kind = mf.plugin("kinds", mix["kind"], root)
    cell = kind.Cell(spec, mix, seed, device, seconds, t_start, spans)
    cell.window(seconds)
    if traced:
        cell.traced()
    run = cell.run
    if device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    t_check = time.perf_counter()
    prog = cell.release()
    refs = cell.reference()
    readings = cell.readings(prog, refs)
    run.check_s = time.perf_counter() - t_check
    ctrl = cell.readings(cell.reference(control), refs) if control else None
    return run, readings, ctrl
