"""PI-GANO (Gallinator/porous-cfd ``examples/duct_variable_boundary``): its
work count and its plain reference forward.

The work count is the frozen copy of ``porous_cfd_tpu_torch/tools/roofline.py``'s
pi_gano inventory at commit 4a0a8ad (``flops.py`` has the rules), with one
fix: the branch is counted at the rows its input has, the inlet's and the
internal rows (1,750 a case at the envelope), where the copy counted 1,600.
The port's kernels: ``pointnet_global`` twice (the geometry and the branch
pools, no dX) and ``neural_ops_prop`` (the fused (v, J, H) NeuralOperator
trunk).

The geometry and branch embeddings are constant in the differentiated
coordinates by the model's own definition; the trunk's dropout draws from
the frozen rule's trunk stream.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench import flops
from portbench.reference import dropout, model
from portbench.reference.layers import field, linear, mask, mlp, subdomain

POOLS = {"pointnet_global.geometry": ("geometry_encoder.linear", "geometry_layers"),
         "pointnet_global.branch": ("branch.linear", "branch_layers")}


def _branch_rows(n_int, n_bnd):
    return n_int + n_bnd // 4            # the inlet's rows and the internal


def _width(cfg):
    return cfg["local_layers"][-1] + cfg["geometry_layers"][-1]


def forward_shapes(cfg, batch, n_int, n_bnd):
    """The forward's matmuls (M, K, N) of a batch."""
    vjh = flops.vjh_rows(cfg["dims"], batch, n_int, n_bnd)
    every = batch * (n_int + n_bnd)
    trunk = [_width(cfg)] * (len(cfg["operator_dropout"]) + 1)
    return (flops.mlp_shapes(cfg["branch_layers"], batch * _branch_rows(n_int, n_bnd))
            + flops.mlp_shapes(cfg["geometry_layers"], every)
            + flops.mlp_shapes(cfg["local_layers"], vjh)
            + flops.mlp_shapes(trunk, vjh)
            + flops.mlp_shapes([trunk[-1], cfg["dims"] + 1], vjh))


def kernel_calls(cfg, batch, n_int, n_bnd, winners, train):
    n_local, n_geom, f = cfg["local_layers"][-1], cfg["geometry_layers"][-1], _width(cfg)
    n_ops, n_out = len(cfg["operator_dropout"]), cfg["dims"] + 1
    macs_row = n_local * f + (n_ops - 1) * f * f + f * n_out
    n_par = n_ops * (f * f + f) + f * n_out + n_out + f    # the operators, the reduction, par
    stack = ("neural_ops_prop", (macs_row, 2.0 * n_geom * f, n_local, n_geom + f, n_par,
                                 n_out))
    pools = [("pointnet_global.geometry", cfg["geometry_layers"], n_int + n_bnd, False),
             ("pointnet_global.branch", cfg["branch_layers"], _branch_rows(n_int, n_bnd),
              False)]
    return flops.pooled_and_prop_calls(pools, stack, cfg["dims"], batch, n_int, n_bnd,
                                       winners, train)


def param_shapes(cfg) -> dict:
    """{parameter name: shape} of the module the configuration builds."""
    out = {}
    for prefix, key in (("geometry_encoder.linear", "geometry_layers"),
                        ("branch.linear", "branch_layers"), ("points_encoder", "local_layers")):
        w = cfg[key]
        for i in range(len(w) - 1):
            out[f"{prefix}.linear_{i}.weight"] = (w[i + 1], w[i])
            out[f"{prefix}.linear_{i}.bias"] = (w[i + 1],)
    f = _width(cfg)
    for i in range(len(cfg["operator_dropout"])):
        out[f"neural_ops.operator_{i}.Dense_0.weight"] = (f, f)
        out[f"neural_ops.operator_{i}.Dense_0.bias"] = (f,)
    out["reduction.weight"], out["reduction.bias"] = (cfg["dims"] + 1, f), (cfg["dims"] + 1,)
    return out


def pool_rows(spec, params, data, domain) -> dict:
    """The geometry rows [boundary ids || sdf || C] of every row and the
    branch rows [C || U-inlet || d || f] of the inlet's and the internal
    rows."""
    ds = spec.dataset
    feats = torch.cat([field(ds, data, "boundaryId"), field(ds, data, "sdf")], dim=-1)
    par_in = torch.cat([torch.cat([field(ds, sub, k) for k in ("C", "U-inlet", "d", "f")], -1)
                        for sub in (subdomain(data, domain["inlet"]),
                                    subdomain(data, domain["internal"]))], dim=-2)
    return {"pointnet_global.geometry": torch.cat([feats, field(ds, data, "C")], dim=-1),
            "pointnet_global.branch": par_in}


def outputs(spec, params, data, domain, x_int, seed, case0):
    cfg = spec.cfg
    n_int = x_int.shape[-2]
    x_bnd = field(spec.dataset, data, "C")[:, n_int:]
    pools = model.pooled(spec, params, data, domain)
    geom, par = pools["pointnet_global.geometry"], pools["pointnet_global.branch"]
    loc = mlp(torch.cat([x_int, x_bnd], dim=-2), params, "points_encoder",
              len(cfg["local_layers"]) - 1)
    x = torch.cat([loc, geom.expand(*loc.shape[:-1], geom.shape[-1])], dim=-1)
    t_seed = None if seed is None else dropout.trunk_seed(seed)
    for i, rate in enumerate(cfg["operator_dropout"]):
        y = F.silu(linear(x, params, f"neural_ops.operator_{i}.Dense_0"))
        if t_seed is not None and rate > 0:
            y = y * mask(t_seed, i, rate, y, case0)
        x = y * par
    return linear(x, params, "reduction")


def porosity(spec, internal):
    """The Darcy and Forchheimer coefficients: the rows' own fields,
    unscaled."""
    ds = spec.dataset
    d_min, d_max = (torch.tensor(v, dtype=torch.float32, device=internal.device)
                    for v in ds.SCALERS["d"])
    f_min, f_max = (torch.tensor(v, dtype=torch.float32, device=internal.device)
                    for v in ds.SCALERS["f"])
    return (d_min + (d_max - d_min) * field(ds, internal, "d"),
            f_min + (f_max - f_min) * field(ds, internal, "f"))
