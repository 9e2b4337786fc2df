"""PIPN on its decoupled analytic path (Gallinator/porous-cfd
``examples/duct_fixed_boundary``): its work count and its plain reference
forward.

The work count is the frozen copy of ``porous_cfd_tpu_torch/tools/roofline.py``'s
pipn inventory at commit 4a0a8ad (``flops.py`` has the rules). The port's
kernels on this path: ``pointnet_global`` (the global feature's max-pool,
with dX) and ``decoder_prop`` (the fused (v, J, H) decoder, its 1024 context
columns read once a case).

The reference forward holds the pooled global feature constant in the
differentiated coordinates (its dependence on them through each channel's
winning row is left out), as the port's default analytic path holds it: the
pool's rows take the local MLP on the data's coordinates.
"""
from __future__ import annotations

import torch

from portbench import flops
from portbench.reference import model
from portbench.reference.layers import field, mlp

POOLS = {"pointnet_global": ("feature_extract.global_feature", "fe_global_layers")}


def forward_shapes(cfg, batch, n_int, n_bnd):
    """The forward's matmuls (M, K, N) of a batch."""
    vjh = flops.vjh_rows(cfg["dims"], batch, n_int, n_bnd)
    every = batch * (n_int + n_bnd)
    return (flops.mlp_shapes(cfg["fe_local_layers"], vjh)
            + flops.mlp_shapes(cfg["fe_global_layers"], every)
            + flops.decoder_shapes(cfg["seg_layers"], vjh, batch, cfg["fe_local_layers"][-1]))


def kernel_calls(cfg, batch, n_int, n_bnd, winners, train):
    seg, n_local = cfg["seg_layers"], cfg["fe_local_layers"][-1]
    macs_row = n_local * seg[1] + flops.macs(seg[1:])
    n_par = flops.macs(seg) + sum(seg[1:])
    stack = ("decoder_prop", (macs_row, 2.0 * (seg[0] - n_local) * seg[1], n_local,
                              seg[0] - n_local, n_par, seg[-1]))
    pools = [("pointnet_global", cfg["fe_global_layers"], n_int + n_bnd, True)]
    return flops.pooled_and_prop_calls(pools, stack, cfg["dims"], batch, n_int, n_bnd,
                                       winners, train)


def param_shapes(cfg) -> dict:
    """{parameter name: shape} of the module the configuration builds."""
    out = {}
    for prefix, key in (("feature_extract.local_feature", "fe_local_layers"),
                        ("feature_extract.global_feature", "fe_global_layers"),
                        ("decoder", "seg_layers")):
        w = cfg[key]
        for i in range(len(w) - 1):
            out[f"{prefix}.linear_{i}.weight"] = (w[i + 1], w[i])
            out[f"{prefix}.linear_{i}.bias"] = (w[i + 1],)
    return out


def pool_rows(spec, params, data, domain) -> dict:
    """[local features || boundary ids || sdf] of every row, the local MLP
    on the data's coordinates, so that the pool is constant in the
    differentiated ones."""
    ds, cfg = spec.dataset, spec.cfg
    feats = torch.cat([field(ds, data, "boundaryId"), field(ds, data, "sdf")], dim=-1)
    local = mlp(field(ds, data, "C"), params, "feature_extract.local_feature",
                len(cfg["fe_local_layers"]) - 1)
    return {"pointnet_global": torch.cat([local, feats], dim=-1)}


def outputs(spec, params, data, domain, x_int, seed, case0):
    cfg = spec.cfg
    n_int = x_int.shape[-2]
    x_bnd = field(spec.dataset, data, "C")[:, n_int:]
    g = model.pooled(spec, params, data, domain)["pointnet_global"]
    loc = mlp(torch.cat([x_int, x_bnd], dim=-2), params, "feature_extract.local_feature",
              len(cfg["fe_local_layers"]) - 1)
    seg_in = torch.cat([loc, g.expand(*loc.shape[:-1], g.shape[-1])], dim=-1)
    return mlp(seg_in, params, "decoder", len(cfg["seg_layers"]) - 1, last_activation=False,
               rates=cfg["seg_dropout"], seed=seed, case0=case0)


def porosity(spec, internal):
    """The Darcy and Forchheimer coefficients: the configuration's constants."""
    return spec.cfg["d"], spec.cfg["f"]
