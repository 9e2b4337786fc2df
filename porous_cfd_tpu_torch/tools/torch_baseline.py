"""The reference formulation's training step in plain PyTorch autograd, on
the card (the port's own copy of ``tools/torch_baseline.py``).

    python -m porous_cfd_tpu_torch.tools.torch_baseline [--steps 10] [--warmup 1]

The computational shape of the reference training step on the
duct_fixed_boundary envelope (batch 13, 1500 / 1000 / 700 points, the PIPN
topology): the forward on all points, then D Jacobian, D^2 Laplacian and one
pressure-gradient autograd replays with ``create_graph`` (seven), the
composite loss and an Adam step. It is a baseline, not a kernel port: its
products run in cuBLAS. The weights come from seed 8421 and the inputs from
an explicit ``torch.Generator`` of that seed. ``samehost_ratio`` holds the
port's own steps to it on the same card. Prints one JSON line, with the
card's name and power limit. Runs on the CUDA card; ``run(argv,
device="cpu")`` on the CPU.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch import nn

from porous_cfd_tpu_torch.bench import card_label
from porous_cfd_tpu_torch.device import resolve_device
from porous_cfd_tpu_torch.utils import profiling

B, NI, NB, NOBS, DIMS = 13, 1500, 1000, 700, 2
SEED = 8421


def mlp(sizes, act=nn.SiLU, last_act=False):
    layers = []
    for i in range(len(sizes) - 1):
        layers.append(nn.Linear(sizes[i], sizes[i + 1]))
        if i < len(sizes) - 2 or last_act:
            layers.append(act())
    return nn.Sequential(*layers)


class Pipn(nn.Module):
    def __init__(self):
        super().__init__()
        self.local = mlp([2, 64, 64], last_act=True)
        self.glob = mlp([64 + 5, 96, 128, 1024], last_act=True)
        self.seg = mlp([1024 + 64, 512, 256, 128, 3])

    def forward(self, pts, feats):
        loc = self.local(pts)
        g = self.glob(torch.cat([loc, feats], -1)).max(dim=1, keepdim=True)[0]
        return self.seg(torch.cat([loc, g.expand(-1, loc.shape[1], -1)], -1))


def grad_sum(out, pts):
    return torch.autograd.grad(out, pts, torch.ones_like(out),
                               retain_graph=True, create_graph=True)[0]


def step(model, opt, pts_i, pts_b, feats, target, n_obs: int = NOBS):
    """One step on (B, Ni, D) internal and (B, Nb, D) boundary points; the
    first ``n_obs`` rows are observed. Returns the loss (a host float, as the
    reference logs it)."""
    n_int, dims = pts_i.shape[1], pts_i.shape[2]
    pts_i.requires_grad_(True)
    pts = torch.cat([pts_i, pts_b], dim=1)
    y = model(pts, feats)
    u, p = y[..., :dims], y[..., dims:]
    u_i = u[:, :n_int]

    jac = torch.stack([grad_sum(u_i[..., d:d + 1], pts_i) for d in range(dims)], -2)
    lap = torch.stack(
        [torch.cat([grad_sum(jac[..., i:i + 1, j], pts_i)[..., j:j + 1]
                    for j in range(dims)], -1) for i in range(dims)], -2)
    dp = grad_sum(p[:, :n_int], pts_i)

    cont = jac.diagonal(0, -1, -2).sum(-1).pow(2).mean()
    conv = (jac @ u_i.unsqueeze(-1)).squeeze(-1)
    mom = (conv - 1e-3 * lap.sum(-1) + dp + 14.0 * u_i).pow(2).mean()
    bnd = (u[:, n_int:] - target[:, n_int:, :2]).pow(2).mean()
    obs = (y[:, :n_obs] - target[:, :n_obs]).pow(2).mean()
    loss = cont + mom + bnd + 100 * obs

    opt.zero_grad()
    loss.backward()
    opt.step()
    return float(loss.detach())


def make_inputs(device, batch=B, n_int=NI, n_bnd=NB, seed=SEED):
    """(pts_i, pts_b, feats, target) from an explicit generator, on
    ``device``."""
    gen = torch.Generator().manual_seed(seed)
    shapes = ((batch, n_int, DIMS), (batch, n_bnd, DIMS), (batch, n_int + n_bnd, 5),
              (batch, n_int + n_bnd, 3))
    return tuple(torch.rand(s, generator=gen).to(device) for s in shapes)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=1)
    return p


def run(argv=None, device=None, shape=(B, NI, NB, NOBS)) -> dict:
    """The baseline's steps/s on ``device`` (the CUDA card unless ``"cpu"``
    is asked for) at ``shape`` (batch, internal, boundary, observed points);
    prints and returns the line."""
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(device)
    batch, n_int, n_bnd, n_obs = shape
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        model = Pipn().to(device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    pts_i, pts_b, feats, target = make_inputs(device, batch, n_int, n_bnd)
    for _ in range(args.warmup):
        step(model, opt, pts_i.clone(), pts_b, feats, target, n_obs)
    profiling.sync(device)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = step(model, opt, pts_i.clone(), pts_b, feats, target, n_obs)
    profiling.sync(device)
    out = {"tool": "torch_baseline", "device": str(device), "card": card_label(device),
           "torch": torch.__version__, "steps_per_sec": args.steps / (time.perf_counter() - t0),
           "loss": loss, "batch": batch, "points": n_int + n_bnd}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    run()
