"""Time the (v, J, H) engine, pointnet_global, sa_neighborhood and FPS on the card.

    python tools/time_engine.py [--root DIR] [--label NAME] [--kernels] [--parts LIST]

Imports ``porous_cfd_tpu_torch`` from ``--root`` (default: this checkout),
so the same script times another tree of the port (a ``git archive`` of a
parent commit) through the same public wrappers, for comparisons in turns
within one run on one card. At pipn's decoder shapes (13 cases, 1500
internal and 1000 boundary points, [64 local + 1024 context] -> 512 -> 256
-> 128 -> 3, dropout 0.05 on the first two layers) and PI-GANO's trunk
shapes (176 local, four 352-wide operators, dropout 0.1 on the middle two,
reduction to 3) it times, with CUDA events (mean of 20 after 3 warm-ups):
the forward (both launches, no gradient), the internal launch alone, the
backward kernel from a training stash, and its internal launch. Where the
tree has ``mlp_prop_cuda.weight_grad`` it also times that contraction alone
at every layer's stash shapes, beside cuBLAS's ``a.t() @ g`` in full f32
(TF32 off), and the rows sweep as the backward less its weight gradients.
pointnet_global is timed at chip_smoke.py's five shapes (pipn; pi-gano's
geometry encoder and branch; the pipn-pp and pi-gano-pp global levels)
through ``pointnet_global`` alone: the forward without a gradient, and the
backward as ``torch.autograd.grad`` of ``sum(cot * max)`` on a retained
graph, so that trees with other backward entry points are timed alike.
sa_neighborhood is timed the same way at pipn-pp's and pi-gano-pp's two
radius levels, on each model's own neighbour chain; with ``--kernels`` also
each of its kernels' device ms per call under ``torch.profiler`` (10 calls),
for either direction. FPS is timed through ``farthest_point_sampling`` at
PIPN++'s two levels over 52 cases' boundary clouds and over one case's, and
at the latency floor's 32-point cloud; ``--parts fps_sweep`` times every
design the kernel can run around its crossover (a tree with
``fps_cuda.launch``). ``--parts`` picks what is timed (default: all but the
sweep). Prints one JSON line, with the card's name and power limit. Needs
a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _chip_smoke():
    """This checkout's chip_smoke.py (its shapes, timer and weight_grad
    split), loaded by path before ``--root`` takes the package's place."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()
BATCH, N_INT, N_BND, SEED = cs.BATCH, cs.N_INT, cs.N_BND, cs.SEED
SEG, SEG_LOCAL, SEG_DROPOUT = cs.SEG, cs.FE_LOCAL[-1], cs.SEG_DROPOUT
PG_LOCAL, PG_F = cs.PG_LOCAL[-1], cs.PG_BRANCH[-1]
PG_OPERATORS, PG_DROPOUT = cs.PG_OPERATORS, cs.PG_DROPOUT
time_ms, kernel_times = cs.time_ms, cs.kernel_times


def time_decoder(torch, gen, dev):
    from porous_cfd_tpu_torch.models.mlp import MLP
    from porous_cfd_tpu_torch.ops import decoder_cuda, mlp_prop_cuda
    dec = MLP(SEG, SEG_DROPOUT, "silu", last_activation=False, generator=gen).to(dev)
    lin = dec.linears

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    v, v_b = rnd(BATCH, N_INT, SEG_LOCAL), rnd(BATCH, N_BND, SEG_LOCAL)
    jt, ht = rnd(BATCH, 2, N_INT, SEG_LOCAL, scale=0.5), rnd(BATCH, 2, N_INT, SEG_LOCAL, scale=0.5)
    g = rnd(BATCH, 1, SEG[0] - SEG_LOCAL)
    res = {}
    with torch.no_grad():
        args = (lin, SEG_LOCAL, v, jt, ht, v_b, g, "silu", SEG_DROPOUT, False, SEED)
        out = decoder_cuda.decoder_prop(*args)
        if not all(bool(o.isfinite().all()) for o in out):
            raise SystemExit("time_engine: decoder_prop gave non-finite values")
        res["fwd_ms"] = time_ms(torch, lambda: decoder_cuda.decoder_prop(*args))
        args_int = (lin, SEG_LOCAL, v, jt, ht, None, g, "silu", SEG_DROPOUT, False, SEED)
        res["fwd_internal_ms"] = time_ms(torch, lambda: decoder_cuda.decoder_prop(*args_int))
        widths = tuple([SEG_LOCAL] + SEG[1:])
        meta = mlp_prop_cuda.Meta(SEG_LOCAL, "silu", tuple(SEG_DROPOUT), SEED, 2, BATCH, N_INT,
                                  N_BND, widths)
        weights = [lin_.weight.detach() for lin_ in lin]
        ctx = torch.nn.functional.linear(g[:, 0], lin[0].weight[:, SEG_LOCAL:],
                                         lin[0].bias).contiguous()
        _, _, _, stashes = mlp_prop_cuda.forward(decoder_cuda.DECODER, meta, v, jt, ht, v_b, ctx,
                                                 weights, [x.bias.detach() for x in lin[1:]],
                                                 True)
        gv, gj, gh = (torch.randn(o.shape, generator=gen).to(dev) for o in out)
        res["bwd_ms"] = time_ms(torch, lambda: decoder_cuda.decoder_prop_backward(
            meta, weights, stashes, gv, gj, gh))
        meta_int = mlp_prop_cuda.Meta(SEG_LOCAL, "silu", tuple(SEG_DROPOUT), SEED, 2, BATCH,
                                      N_INT, 0, widths)
        gv_int = gv[:, :N_INT].contiguous()
        res["bwd_internal_ms"] = time_ms(torch, lambda: decoder_cuda.decoder_prop_backward(
            meta_int, weights, stashes[:2], gv_int, gj, gh))
        del stashes
        if hasattr(mlp_prop_cuda, "weight_grad"):
            res["weight_grad"] = cs.time_weight_grads(torch, cs.grad_shapes(widths, widths))
            res["rows_sweep_ms"] = res["bwd_ms"] - res["weight_grad"]["ms"]
    return res


def time_trunk(torch, gen, dev):
    from porous_cfd_tpu_torch.models.mlp import NeuralOperatorSequential, dense
    from porous_cfd_tpu_torch.ops import mlp_prop_cuda, neural_op_cuda
    ops = NeuralOperatorSequential(PG_OPERATORS, PG_F, PG_DROPOUT, "silu", generator=gen).to(dev)
    red = dense(PG_F, 3, gen).to(dev)
    linears = ops.linears + [red]

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    v, v_b = rnd(BATCH, N_INT, PG_LOCAL), rnd(BATCH, N_BND, PG_LOCAL)
    jt, ht = rnd(BATCH, 2, N_INT, PG_LOCAL, scale=0.5), rnd(BATCH, 2, N_INT, PG_LOCAL, scale=0.5)
    geom = rnd(BATCH, 1, PG_F - PG_LOCAL)
    par = (torch.rand((BATCH, 1, PG_F), generator=gen) + 0.5).to(dev)
    seed = neural_op_cuda.trunk_seed(SEED)
    res = {}
    with torch.no_grad():
        args = (ops.linears, red, PG_LOCAL, v, jt, ht, v_b, geom, par, "silu", PG_DROPOUT, False,
                SEED)
        out = neural_op_cuda.neural_ops_prop(*args)
        if not all(bool(o.isfinite().all()) for o in out):
            raise SystemExit("time_engine: neural_ops_prop gave non-finite values")
        res["fwd_ms"] = time_ms(torch, lambda: neural_op_cuda.neural_ops_prop(*args))
        args_int = (ops.linears, red, PG_LOCAL, v, jt, ht, None, geom, par, "silu", PG_DROPOUT,
                    False, SEED)
        res["fwd_internal_ms"] = time_ms(torch, lambda: neural_op_cuda.neural_ops_prop(*args_int))
        widths = (PG_LOCAL,) + (PG_F,) * PG_OPERATORS + (3,)
        rates = mlp_prop_cuda.dropout_rates(PG_DROPOUT, PG_OPERATORS, False) + (0.0,)
        meta = mlp_prop_cuda.Meta(PG_LOCAL, "silu", rates, seed, 2, BATCH, N_INT, N_BND, widths)
        weights = [lin.weight.detach() for lin in linears]
        biases = [lin.bias.detach() for lin in linears[1:]]
        ctx = torch.nn.functional.linear(geom[:, 0], linears[0].weight[:, PG_LOCAL:],
                                         linears[0].bias).contiguous()
        par2 = par[:, 0].contiguous()
        _, _, _, stashes = mlp_prop_cuda.forward(neural_op_cuda.TRUNK, meta, v, jt, ht, v_b, ctx,
                                                 weights, biases, True, par2)
        gv, gj, gh = (torch.randn(o.shape, generator=gen).to(dev) for o in out)
        res["bwd_ms"] = time_ms(torch, lambda: neural_op_cuda.neural_ops_prop_backward(
            meta, weights, par2, stashes, gv, gj, gh))
        meta_int = mlp_prop_cuda.Meta(PG_LOCAL, "silu", rates, seed, 2, BATCH, N_INT, 0, widths)
        gv_int = gv[:, :N_INT].contiguous()
        res["bwd_internal_ms"] = time_ms(torch, lambda: neural_op_cuda.neural_ops_prop_backward(
            meta_int, weights, par2, stashes[:2], gv_int, gj, gh))
        del stashes
        if hasattr(mlp_prop_cuda, "weight_grad"):
            res["weight_grad"] = cs.time_weight_grads(torch, cs.grad_shapes(widths, widths))
            res["rows_sweep_ms"] = res["bwd_ms"] - res["weight_grad"]["ms"]
    return res


def time_pointnet(torch, gen, dev):
    """pointnet_global's forward and backward (ms) at the five shapes."""
    from porous_cfd_tpu_torch.models.mlp import MLP
    from porous_cfd_tpu_torch.models.neighbors import fps_count
    from porous_cfd_tpu_torch.ops import pointnet_cuda
    n_pp = fps_count(fps_count(N_BND, cs.PP_FRACTION[0]), cs.PP_FRACTION[1])
    n_pgp = fps_count(fps_count(N_BND, cs.PGP_FRACTION[0]), cs.PGP_FRACTION[1])
    shapes = {"pipn": (cs.FE_GLOBAL, N_INT + N_BND, True),
              "pi_gano_geometry": (cs.PG_GEOMETRY, N_INT + N_BND, False),
              "pi_gano_branch": (cs.PG_BRANCH, cs.PG_N_BRANCH, False),
              "pipn_pp_global": (cs.PP_GLOBAL[-1], n_pp, True),
              "pi_gano_pp_global": (cs.PGP_GEOMETRY[-1], n_pgp, True)}
    res = {}
    for key, (layers, n_pts, x_grad) in shapes.items():
        mlp = MLP(layers, activation="silu", generator=gen).to(dev)
        x = torch.randn((BATCH, n_pts, layers[0]), generator=gen).to(dev)
        cot = torch.randn((BATCH, 1, layers[-1]), generator=gen).to(dev)
        lin = mlp.linears
        with torch.no_grad():
            fwd_ms = time_ms(torch, lambda: pointnet_cuda.pointnet_global(lin, x, "silu"))
        xg = x.clone().requires_grad_(x_grad)
        wrt = ([xg] if x_grad else []) + list(mlp.parameters())
        m, _ = pointnet_cuda.pointnet_global(lin, xg, "silu")
        loss = (m * cot).sum()
        bwd_ms = time_ms(torch, lambda: torch.autograd.grad(loss, wrt, retain_graph=True))
        res[key] = {"input": [BATCH, n_pts, layers[0]], "widths": layers, "fwd_ms": fwd_ms,
                    "bwd_ms": bwd_ms}
        del m, loss
    return res


def time_sa(torch, gen, dev, kernels=False):
    """sa_neighborhood's forward and backward (ms) at pipn-pp's and
    pi-gano-pp's two radius levels, on each model's own chain of BATCH
    cases: level 0 static (its xg), level 1 dynamic on random level-0
    features that need a gradient; with ``kernels`` each direction's
    kernels too (kernel_times)."""
    from porous_cfd_tpu_torch.data.synthetic import (VARIABLE_BOUNDARIES, make_foam_batch,
                                                     make_scalers)
    from porous_cfd_tpu_torch.models.neighbors import extract_sa_neighbors
    from porous_cfd_tpu_torch.models.pi_gano import pi_gano_pp
    from porous_cfd_tpu_torch.models.pipn import pipn_foam_pp
    from porous_cfd_tpu_torch.ops import sa_cuda
    from porous_cfd_tpu_torch.train.engine import gather_cases
    data = make_foam_batch(BATCH, N_INT, N_BND, cs.N_OBS, seed=SEED)
    scalers = make_scalers()
    batch = gather_cases(data, torch.arange(BATCH)).to(dev)
    models = {
        "pipn_pp": (pipn_foam_pp(cs.NU, cs.D, cs.F, cs.PP_LOCAL, cs.PP_GLOBAL, cs.PP_RADIUS,
                                 cs.PP_FRACTION, cs.PP_SEG, scalers, seg_dropout=cs.PP_DROPOUT,
                                 max_neighbors=cs.PP_NEIGHBORS,
                                 generator=torch.Generator().manual_seed(SEED), device=dev),
                    lambda m: m.module.feature_extract.global_feature),
        "pi_gano_pp": (pi_gano_pp(cs.NU, 3, cs.PG_BRANCH, cs.PGP_GEOMETRY, cs.PGP_RADIUS,
                                  cs.PGP_FRACTION, cs.PG_LOCAL, cs.PG_OPERATORS, cs.PG_DROPOUT,
                                  scalers, VARIABLE_BOUNDARIES, max_neighbors=cs.PGP_NEIGHBORS,
                                  generator=torch.Generator().manual_seed(SEED), device=dev),
                       lambda m: m.module.geometry_encoder.set_abstraction)}
    res = {}
    for key, (model, seq_of) in models.items():
        seq = seq_of(model)
        nbrs = extract_sa_neighbors(model.neighbor_precompute(batch), 2)
        for i in range(2):
            lin = getattr(seq, f"sa_{i}").conv_mlp.linears
            _, idx, mask, rel, _ = nbrs[i][:5]
            xg = nbrs[0][5] if i == 0 else None
            x = None
            if i:
                f_in = lin[0].weight.shape[1] - rel.shape[-1]
                x = torch.randn((BATCH, nbrs[0][0].shape[1], f_in), generator=gen).to(dev)
                x.requires_grad_()
            def fwd():
                with torch.no_grad():
                    return sa_cuda.sa_neighborhood(lin, x, idx, mask, rel, "silu", xg)

            fwd_ms = time_ms(torch, fwd)
            out = sa_cuda.sa_neighborhood(lin, x, idx, mask, rel, "silu", xg)
            cot = torch.randn(out.shape, generator=gen).to(dev)
            wrt = list(getattr(seq, f"sa_{i}").conv_mlp.parameters()) + ([x] if i else [])
            loss = (out * cot).sum()

            def bwd():
                return torch.autograd.grad(loss, wrt, retain_graph=True)

            level = {"centroids": list(mask.shape[:2]), "neighbors": mask.shape[2],
                     "widths": [lin[0].weight.shape[1]] + [t.weight.shape[0] for t in lin],
                     "fwd_ms": fwd_ms, "bwd_ms": time_ms(torch, bwd)}
            if kernels:
                level["fwd_kernels"] = kernel_times(torch, fwd)
                level["bwd_kernels"] = kernel_times(torch, bwd)
            res[f"{key}_level_{i}"] = level
            del out, loss
    return res


def time_fps(torch, gen, dev):
    """FPS through the public wrapper (ms, CUDA events; at the levels also
    the kernel's device ms under torch.profiler, free of the host's time
    between launches): PIPN++'s two levels over 52 cases' boundary clouds
    and over one case's, and the latency floor's 32-point cloud to 32 and
    to cs.FLOOR_PICKS picks (its cost a pick: the slope of device ms)."""
    from porous_cfd_tpu_torch.data.synthetic import make_foam_batch
    from porous_cfd_tpu_torch.models.neighbors import fps_count, gather_points
    from porous_cfd_tpu_torch.ops import fps_cuda
    fps = fps_cuda.farthest_point_sampling
    data = make_foam_batch(cs.N_CASES, N_INT, N_BND, cs.N_OBS, seed=SEED)
    pos = data.data[:, N_INT:, data.column_indices("C")].contiguous().to(dev)
    levels = [fps_count(N_BND, cs.PP_FRACTION[0])]
    levels.append(fps_count(levels[0], cs.PP_FRACTION[1]))
    res = {}
    for tag, cloud in ((f"b{cs.N_CASES}", pos), ("b1", pos[:1].contiguous())):
        total = 0.0
        for i, n_samples in enumerate(levels):
            ms = time_ms(torch, lambda: fps(cloud, n_samples))
            res[f"{tag}_level_{i}_ms"] = ms
            res[f"{tag}_level_{i}_device_ms"] = kernel_times(
                torch, lambda: fps(cloud, n_samples))["device_ms"]
            total += ms
            cloud = gather_points(cloud, fps(cloud, n_samples))
        res[f"{tag}_levels_ms"] = total
    floor_pos = (torch.rand((1, cs.FLOOR_N, 2), generator=gen) * 2 - 1).to(dev)
    for picks in (cs.FLOOR_N, cs.FLOOR_PICKS):
        res[f"floor_{picks}_picks_ms"] = time_ms(torch, lambda: fps(floor_pos, picks))
        res[f"floor_{picks}_picks_device_ms"] = kernel_times(
            torch, lambda: fps(floor_pos, picks))["device_ms"]
    res["floor_us_per_pick"] = 1e3 * (res[f"floor_{cs.FLOOR_PICKS}_picks_device_ms"]
                                      - res[f"floor_{cs.FLOOR_N}_picks_device_ms"]) / (
                                          cs.FLOOR_PICKS - cs.FLOOR_N)
    return res


def fps_sweep(torch, gen, dev, picks=500, timed_picks=4096):
    """Every design the kernel can run (design A at each points-a-thread,
    design B at 8 and 16 CTAs a cluster) at cloud sizes around the
    crossover and the paths', one cloud, 2D and 3D: the first ``picks``
    picks held equal to the plain version's, then ms a pick over
    ``timed_picks`` picks (past N the picks repeat point 0, the same work a
    pick), and which design ``fps_design`` takes. Needs a tree with
    ``fps_cuda.launch``."""
    import math
    from porous_cfd_tpu_torch.ops import fps_cuda
    rows = []
    for d in (2, 3):
        for n in (32, 500, 1000, 2048, 3072, 4096, 8192, 16384, 40000, 100000):
            pts = (torch.rand((1, n, d), generator=gen) * 2 - 1).to(dev)
            n_check = min(picks, n)
            ref = fps_cuda.farthest_point_sampling_plain(pts, n_check)
            chosen = fps_cuda.fps_design(1, n, d)
            for ctas in (1, 8, 16):
                slice_ = math.ceil(n / ctas)
                if ctas > 1 and slice_ < 64:
                    continue
                for p in fps_cuda.PER_THREAD:
                    threads = 32 * math.ceil(slice_ / (32 * p))
                    if threads > fps_cuda.MAX_THREADS:
                        continue
                    des = fps_cuda.Design("A" if ctas == 1 else "B", ctas, threads, p)
                    try:
                        got = fps_cuda.launch(pts, n_check, des)
                    except RuntimeError as exc:
                        rows.append({"d": d, "n": n, "design": des._asdict(), "error": str(exc)})
                        continue
                    ms = time_ms(torch, lambda: fps_cuda.launch(pts, timed_picks, des), n=5)
                    rows.append({"d": d, "n": n, "design": des._asdict(), "chosen": des == chosen,
                                 "equal": bool(torch.equal(got, ref)), "ms": ms,
                                 "us_per_pick": 1e3 * ms / (timed_picks - 1)})
    # a batch of clouds past the crossover: fps_design's cluster against one
    # block a cloud
    for b in (13, 52):
        pts = (torch.rand((b, 4096, 2), generator=gen) * 2 - 1).to(dev)
        for des in (fps_cuda.fps_design(b, 4096, 2), fps_cuda.Design("A", 1, 128, 32)):
            ms = time_ms(torch, lambda: fps_cuda.launch(pts, timed_picks, des), n=5)
            rows.append({"d": 2, "b": b, "n": 4096, "design": des._asdict(), "ms": ms,
                         "chosen": des == fps_cuda.fps_design(b, 4096, 2),
                         "us_per_pick": 1e3 * ms / (timed_picks - 1)})
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(HERE),
                        help="the tree whose porous_cfd_tpu_torch is timed")
    parser.add_argument("--label", default="")
    parser.add_argument("--kernels", action="store_true",
                        help="add sa_neighborhood's device time kernel by kernel")
    parser.add_argument("--parts", default="decoder,trunk,pointnet,sa,fps",
                        help="comma-separated parts to time, of decoder, trunk, pointnet, "
                             "sa, fps and fps_sweep (every FPS design, on a tree that has "
                             "fps_cuda.launch)")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_engine: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from porous_cfd_tpu_torch.ops import build
    parts = args.parts.split(",")
    sources = {"decoder": "decoder_prop", "trunk": "neural_op_prop",
               "pointnet": "pointnet_global", "sa": "sa_neighborhood", "fps": "fps",
               "fps_sweep": "fps"}
    build.build_all(tuple(dict.fromkeys(sources[p] for p in parts)))
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    res = {"label": args.label, "root": str(args.root), "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smi}
    timers = {"decoder": ("decoder_pipn", lambda: time_decoder(torch, gen, dev)),
              "trunk": ("trunk_pi_gano", lambda: time_trunk(torch, gen, dev)),
              "pointnet": ("pointnet", lambda: time_pointnet(torch, gen, dev)),
              "sa": ("sa", lambda: time_sa(torch, gen, dev, args.kernels)),
              "fps": ("fps", lambda: time_fps(torch, gen, dev)),
              "fps_sweep": ("fps_sweep", lambda: fps_sweep(torch, gen, dev))}
    for part in parts:
        key, timer = timers[part]
        res[key] = timer()
        torch.cuda.empty_cache()
    print(json.dumps({"time_engine": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
