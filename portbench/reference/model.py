"""The plain reference of the benchmarked models, in float32 PyTorch.

It follows the published models (Gallinator/porous-cfd) with no kernel, no
cache and no batching trick, and imports nothing of the program. What is a
family's own, its max-pools and its forward, is in ``families/<family>.py``
(found by the configuration's ``family``); the inputs' columns and scalers
are the configuration's dataset's (``datasets/<dataset>.py``). Here is what
every family shares, each what the program's product path computes:

- Derivatives are taken by autograd: J = d out / d x and the Hessian's
  diagonal d2 out / d x_d2 on the internal rows, which the losses use. What
  the forward holds constant in the coordinates is the family's to say.
- The residuals: momentum and continuity in standardized coordinates, in
  ``dims`` dimensions, the outputs [U (dims), p].
- Dropout draws the masks of ``dropout.py``'s frozen counter rule.
- Training: Adam with the staircase exponential decay of the learning rate
  each epoch.
"""
from __future__ import annotations

import torch

from portbench.reference import dropout
from portbench.reference.layers import field, mlp, subdomain


def pool_rows(spec, params, data, domain) -> dict:
    """Each max-pool's input rows, by the names of the family's ``POOLS``."""
    return spec.family.pool_rows(spec, params, data, domain)


def pooled_mlp(spec, params, name: str, rows):
    """The MLP of pool ``name`` on its rows, before the max."""
    prefix, layers = spec.family.POOLS[name]
    return mlp(rows, params, prefix, len(spec.cfg[layers]) - 1)


def pooled(spec, params, data, domain) -> dict:
    """Each max-pool's (B, 1, C) feature, on the rows of ``data``."""
    return {name: pooled_mlp(spec, params, name, rows).amax(dim=-2, keepdim=True)
            for name, rows in pool_rows(spec, params, data, domain).items()}


def outputs(spec, params, data, domain, x_int, seed=None, case0: int = 0):
    """The model's outputs (B, Ni + Nb, dims + 1) on [internal || boundary]
    rows of ``data``, differentiable in ``x_int`` (B, Ni, dims), the
    internal rows' coordinates; ``seed`` turns dropout on, for cases that
    are the batch's from ``case0`` on."""
    return spec.family.outputs(spec, params, data, domain, x_int, seed, case0)


def derivatives(out_int, x_int, create_graph: bool):
    """(jac, lap) (B, Ni, O, D) of ``out_int`` (B, Ni, O) in ``x_int``:
    each row's outputs depend on its own coordinates alone, so the gradient
    of a channel's sum is the row's derivative."""
    jac, lap = [], []
    for o in range(out_int.shape[-1]):
        j = torch.autograd.grad(out_int[..., o].sum(), x_int, create_graph=True)[0]
        h = [torch.autograd.grad(j[..., d].sum(), x_int, create_graph=create_graph,
                                 retain_graph=True)[0][..., d]
             for d in range(x_int.shape[-1])]
        jac.append(j)
        lap.append(torch.stack(h, dim=-1))
    return torch.stack(jac, dim=-2), torch.stack(lap, dim=-2)


def _scaler(spec, name, device):
    return tuple(torch.tensor(v, dtype=torch.float32, device=device)
                 for v in spec.dataset.SCALERS[name])


def residuals(spec, internal, out_int, jac, lap):
    """Momentum (B, Ni, D) and continuity (B, Ni) residuals in standardized
    coordinates: (u . grad) u - nu lap u + grad p + u (d nu + |u| f / 2) *
    zone, with d, f the family's ``porosity``, and div u."""
    cfg, dims, dev = spec.cfg, spec.cfg["dims"], out_int.device
    u_std, u_mean = _scaler(spec, "U", dev)
    p_std, _ = _scaler(spec, "p", dev)
    c_std, _ = _scaler(spec, "C", dev)
    u_jac, u_lap, p_grad = jac[..., :dims, :], lap[..., :dims, :], jac[..., dims, :]
    u_raw = u_std * out_int[..., :dims] + u_mean
    d, f = spec.family.porosity(spec, internal)
    nu = cfg["nu"]
    source = u_raw * (d * nu + 0.5 * torch.linalg.vector_norm(u_raw, dim=-1, keepdim=True) * f)
    convection = torch.einsum("...ij,...j->...i", u_jac, u_raw / c_std) * u_std
    viscosity = nu * torch.einsum("...ij,...j->...i", u_lap, 1.0 / c_std ** 2) * u_std
    pressure = (p_std / c_std) * p_grad
    momentum = (convection - viscosity + pressure
                + source * field(spec.dataset, internal, "cellToRegion"))
    div = torch.sum(torch.diagonal(u_jac, dim1=-2, dim2=-1) * u_std / c_std, dim=-1)
    return momentum, div


def _coords(spec, data, n_int):
    return field(spec.dataset, data, "C")[:, :n_int].clone().requires_grad_(True)


def predict(spec, params, data, domain):
    """Verbose prediction: (fields (B, N, D + 1) [U, p], residuals (B, Ni,
    D + 1) [momentum, div]) with no dropout."""
    n_int = domain["internal"].shape[-1]
    with torch.enable_grad():
        x_int = _coords(spec, data, n_int)
        out = outputs(spec, params, data, domain, x_int)
        jac, lap = derivatives(out[:, :n_int], x_int, create_graph=False)
    momentum, div = residuals(spec, data[:, :n_int], out[:, :n_int].detach(), jac.detach(),
                              lap.detach())
    return out.detach().float(), torch.cat([momentum, div[..., None]], dim=-1).float()


def losses(spec, params, data, domain, seed, case0: int = 0):
    """The training loss vector [continuity, momentum (D), boundary U (D),
    boundary p, observations U (D), observations p] of a batch's cases from
    ``case0`` on, dropout drawn from ``seed``."""
    dims, ds = spec.cfg["dims"], spec.dataset
    n_int = domain["internal"].shape[-1]
    x_int = _coords(spec, data, n_int)
    out = outputs(spec, params, data, domain, x_int, seed, case0)
    out_int = out[:, :n_int]
    jac, lap = derivatives(out_int, x_int, create_graph=True)
    internal = data[:, :n_int]
    momentum, div = residuals(spec, internal, out_int, jac, lap)
    bnd, tgt_b = out[:, n_int:], data[:, n_int:]

    def comp_mse(x, y):
        return ((x - y) ** 2).reshape(-1, x.shape[-1]).mean(dim=0)

    ids = domain["obs"]
    pred_obs = subdomain(out_int, ids)
    tgt_obs = subdomain(torch.cat([field(ds, internal, "U"), field(ds, internal, "p")], -1),
                        ids)
    return torch.cat([(div ** 2).mean()[None], (momentum ** 2).reshape(-1, dims).mean(dim=0),
                      comp_mse(bnd[..., :dims], field(ds, tgt_b, "U")),
                      comp_mse(bnd[..., dims:dims + 1], field(ds, tgt_b, "p")),
                      comp_mse(pred_obs[..., :dims], tgt_obs[..., :dims]),
                      comp_mse(pred_obs[..., dims:dims + 1], tgt_obs[..., dims:dims + 1])])


def lr_at(cfg, step: int, steps_per_epoch: int) -> float:
    """The learning rate of 0-based step ``step``: the staircase exponential
    decay, ``learning_rate * lr_gamma ** epoch``."""
    return cfg["learning_rate"] * cfg["lr_gamma"] ** (step // steps_per_epoch)


def train(spec, params0: dict, data, domain, batches, run_seed: int, steps_per_epoch: int,
          chunk: int = 13):
    """Plain Adam with the staircase exponential decay over ``batches`` (a
    list of case-index tensors, one a step) from ``params0``, the step's
    dropout seed ``fold_in(run_seed, step)``. Each loss term is a mean with
    as many rows in every case, so a batch's loss and gradient are the sums
    of its blocks of ``chunk`` cases, each weighed by its share of the
    cases: blocks keep the derivative graphs within the card. Returns (each
    step's total weighted loss, the first step's gradient {name: tensor},
    the change of each parameter after the last step)."""
    cfg = spec.cfg
    w = torch.tensor(cfg["loss_weights"], dtype=torch.float32, device=data.device)
    b1, b2 = cfg["adam_betas"]
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    totals, first = [], None
    for t, idx in enumerate(batches):
        seed, n = dropout.fold_in(run_seed, t), len(idx)
        total, grads = 0.0, None
        for c0 in range(0, n, chunk):
            sub = idx[c0:c0 + chunk]
            loss = losses(spec, params, data[sub], {k: d[sub] for k, d in domain.items()}, seed,
                          c0)
            part = torch.sum(w * loss.float()) * (len(sub) / n)
            g = torch.autograd.grad(part, list(params.values()))
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            total += float(part.detach())
            del loss, part, g
        totals.append(total)
        if first is None:
            first = {k: g.detach().float() for k, g in zip(params, grads)}
        lr = lr_at(cfg, t, steps_per_epoch)
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                g = g.float()
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[k] / (1 - b1 ** (t + 1))
                v_hat = v2[k] / (1 - b2 ** (t + 1))
                p.sub_(lr * m_hat / (v_hat.sqrt() + cfg["adam_eps"]))
        del grads
    change = {k: (params[k].detach() - params0[k]).float() for k in params}
    return totals, first, change
