"""Launching the kernels of ``csrc/mlp_prop.cuh``: the (value, J, H)
propagation through a dense stack with activated, dropped-out hidden layers
and a linear last layer, forward and backward, shared by ``decoder_prop``
(the PIPN decoder, ``csrc/decoder_prop.cu``) and ``neural_ops_prop`` (the
PI-GANO trunk, ``csrc/neural_op_prop.cu``, whose hidden outputs are also
multiplied per case by ``par``).

Each call launches twice, once for the internal (v, J, H) rows and once
value-only for the boundary rows. When a gradient is wanted the kernels run
inside ``MlpProp``, a ``torch.autograd.Function``: the training forward also
stashes each layer's input rows and pre-activations, and the backward is the
backward kernel, again one internal and one boundary launch.

The trunk has two modes besides (``Meta.reduction`` and
``Meta.last_activation``): without a reduction every layer is an operator
and the output is the last operator's, F wide; without the last activation
the last operator is linear (still dropped out and modulated).

The decoder's internal launch has two layer-0 modes besides (``Meta.mode``):
``j0_add`` adds (B, D, Ni, F1) terms to the J/H rows' layer-0
pre-activations and gives their cotangents back; ``ctx_width`` takes J/H
rows ``ctx_width`` columns wider than the value rows, through the full
layer-0 weight. Each mode counts the launches it changes in a
``ModeCount`` of its own (a decoder mode its internal launches, a trunk mode
both), beside the wrapper's count of all launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from porous_cfd_tpu_torch.ops import build, dropout as dropout_mod

ACT_CODES = {"silu": 0, "tanh": 1}
MAX_DIMS = 3

# csrc's block shape: a tile of (1 + 2D) rows a point, 8 points to D = 2
# and 4 at D = 3 (mlp_prop.cuh, tile_points); row buffers of stride
# round8(k) + 4 floats (tc.cuh, row_ld); a ring of 3 split weight tiles of
# 32 x 128 (and its 3 barriers); layer 0's context columns staged 128 at a
# time
RING_FLOATS = 3 * 2 * 32 * 128 + 2 * 3
CTX_CHUNK = 128
# an H100's shared bytes a block (cudaDevAttrMaxSharedMemoryPerBlockOptin)
H100_SHARED_BYTES = 232_448


def tile_rows(d_dims: int) -> int:
    """Rows of a row kernel's block at ``d_dims`` dimensions."""
    return (1 + 2 * d_dims) * (8 if d_dims <= 2 else 4)


def _row_ld(k: int) -> int:
    return ((k + 7) & ~7) + 4


def forward_shared_bytes(widths: Sequence[int], n_local: int, d_dims: int) -> int:
    """Dynamic shared bytes of a forward launch over ``widths`` (layer 0's
    input first, its first ``n_local`` columns staged with the rows, the
    rest context columns): csrc's ``fwd_smem``."""
    bw = [0, 0]
    for i in range(len(widths) - 1):
        bw[i & 1] = max(bw[i & 1], _row_ld(n_local if i == 0 else widths[i]))
    if n_local < widths[0]:
        bw[0] = max(bw[0], _row_ld(n_local) + _row_ld(CTX_CHUNK))
    return 4 * (tile_rows(d_dims) * (bw[0] + bw[1]) + RING_FLOATS)


def backward_shared_bytes(widths: Sequence[int], reduction: bool, d_dims: int) -> int:
    """Dynamic shared bytes of a backward row launch over ``widths``:
    csrc's ``bwd_smem``."""
    nl = len(widths) - 1
    top = nl - 1 if reduction else nl
    bw = [0, 0]
    for li in range(top, -1, -1):
        buf = (top - li) & 1
        bw[buf] = max(bw[buf], _row_ld(widths[nl] if li == nl else widths[li + 1]))
        if li > 0:
            bw[buf ^ 1] = max(bw[buf ^ 1], _row_ld(widths[nl] if li == nl else widths[li]))
    return 4 * (tile_rows(d_dims) * (bw[0] + bw[1]) + RING_FLOATS)


def shared_limit(device) -> int:
    """The card's shared bytes a block (an H100's where torch does not say)."""
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin", H100_SHARED_BYTES))


def check_fits(fn: str, meta: "Meta", limit: int) -> None:
    """Raise ``ValueError`` when a launch of ``meta`` needs more shared bytes
    a block than ``limit``: the widths, D and the bytes in the message."""
    need = max(forward_shared_bytes(meta.int_widths, meta.n_local, meta.d_dims),
               backward_shared_bytes(meta.int_widths, meta.reduction, meta.d_dims))
    if need > limit:
        raise ValueError(f"{fn}: widths {list(meta.int_widths)} at D = {meta.d_dims} need "
                         f"{need} shared bytes a block ({tile_rows(meta.d_dims)} rows), "
                         f"past the card's {limit}")


def dropout_rates(dropout: Optional[Sequence[float]], n_layers: int,
                  deterministic: bool, fn: str = "decoder_prop") -> tuple[float, ...]:
    """Per-layer dropout rates in force: all zero when deterministic."""
    if dropout is None or deterministic:
        return (0.0,) * n_layers
    if len(dropout) != n_layers:
        raise ValueError(f"{fn}: {len(dropout)} dropout rates for {n_layers} layers")
    return tuple(float(r) for r in dropout)


def check_tensor(label: str, t: torch.Tensor, shape: tuple, device, fn: str) -> None:
    if (t.device != device or t.dtype != torch.float32 or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{fn}: {label} must be a contiguous float32 "
                         f"{tuple(shape)} tensor on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")


class ModeCount:
    """Launches of one kernel mode, counted as the wrappers count theirs."""

    def __init__(self):
        self.launches = 0


class Kernels:
    """One instantiation of ``csrc/mlp_prop.cuh``: the C entry points
    ``<prefix>_forward``, ``<prefix>_forward_workspace``,
    ``<prefix>_backward_workspace`` and ``<prefix>_backward`` of
    ``csrc/<source>.cu``. A modulated one (the trunk) takes ``par,
    last_activation, reduction`` after the forward's other arguments and
    ``par, dpar_rows, dpar, last_activation, reduction`` after the
    backward's; the other (the decoder) ``v_width, j0_add, h0_add`` and
    ``v_width, dja, dha``; every forward then the scratch of its split
    weights and its size. The launch counts go to the
    ``launches`` attributes of ``forward_counter`` and ``backward_counter``,
    and those of a mode also to ``mode_counts[mode]`` (forward,
    backward)."""

    def __init__(self, source: str, prefix: str, modulated: bool, forward_counter,
                 backward_counter, mode_counts: dict):
        self.source = source
        self.prefix = prefix
        self.modulated = modulated
        self.coupled = not modulated
        self.forward_counter = forward_counter
        self.backward_counter = backward_counter
        self.mode_counts = mode_counts

    def library(self) -> ctypes.CDLL:
        lib = build.library(self.source)
        fwd = getattr(lib, f"{self.prefix}_forward")
        if fwd.argtypes is None:
            p, i, u, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
            fwd.argtypes = ([i, i, i, p, p, p, i, i, p, i, p, p, p, p, i, i, p, p, u, u, p, p,
                             p, i, i, p, p] + [p, i, i] * self.modulated
                            + [i, p, p] * self.coupled + [p, ll, p])
            fwd.restype = i
            fws = getattr(lib, f"{self.prefix}_forward_workspace")
            fws.argtypes = [i, p, i]
            fws.restype = ll
            ws = getattr(lib, f"{self.prefix}_backward_workspace")
            ws.argtypes = [i, ll, i, p]
            ws.restype = ll
            bwd = getattr(lib, f"{self.prefix}_backward")
            bwd.argtypes = ([i, i, i, p, i, i, p, p, i, i, i, p, p, p, u, u, p, p, p, i, i, p,
                             p, p, p, p, p, p, p, p, p, ll] + [p, p, p, i, i] * self.modulated
                            + [i, p, p] * self.coupled + [p])
            bwd.restype = i
        return lib

    def coupled_args(self, meta: "Meta", a=None, h=None) -> list:
        """A coupled entry point's trailing ``v_width`` and ``j0_add/h0_add``
        (forward) or ``dja/dha`` (backward) pointers, null where None; none
        for the others."""
        if not self.coupled:
            return []
        return [meta.n_local] + [None if t is None else t.data_ptr() for t in (a, h)]

    def mode_args(self, meta: "Meta") -> list:
        """A modulated entry point's trailing mode flags; none for the
        others."""
        return [int(meta.last_activation), int(meta.reduction)] if self.modulated else []

    def count_mode(self, meta: "Meta", direction: int, boundary: bool = False) -> None:
        """Count a launch in its mode, if the mode changes that launch (the
        decoder's layer-0 modes leave the boundary launch as it is)."""
        if meta.mode is not None and not (boundary and meta.layer0_mode):
            self.mode_counts[meta.mode][direction].launches += 1


class Meta:
    """What one call fixes besides its tensors. ``widths`` are the value
    rows' (L, F1, ..., O); with ``ctx_width`` the internal launch's J/H rows
    are that much wider (``int_widths``); ``j0_add`` marks the additive
    layer-0 mode. Without ``reduction`` every layer is an activated (or,
    the last one without ``last_activation``, linear) operator and O is the
    last operator's width. ``placement`` puts the launches' cases and rows
    at their places in the whole batch, for the dropout masks."""

    def __init__(self, n_local, activation, rates, seed, d_dims, b_cases, n_int, n_bnd,
                 widths, ctx_width: int = 0, j0_add: bool = False, reduction: bool = True,
                 last_activation: bool = True,
                 placement: dropout_mod.Placement = dropout_mod.WHOLE):
        if ctx_width and j0_add:
            raise ValueError("the ctx_width and j0_add modes exclude each other")
        self.placement = placement
        self.reduction = reduction
        self.last_activation = last_activation
        self.ctx_width = ctx_width
        self.j0_add = j0_add
        self.n_local = n_local
        self.activation = activation
        self.rates = rates
        self.seed = 0 if seed is None else int(seed)
        self.d_dims = d_dims
        self.b_cases = b_cases
        self.n_int = n_int
        self.n_bnd = n_bnd
        self.widths = widths                     # (L, F1, ..., O)

    @property
    def n_layers(self):
        return len(self.widths) - 1

    @property
    def n_operators(self):
        """Layers through the activation rules, dropout and modulation."""
        return self.n_layers - 1 if self.reduction else self.n_layers

    @property
    def int_widths(self):
        """The internal launch's widths: layer 0's input with the context
        columns of the ctx_width mode."""
        return (self.widths[0] + self.ctx_width,) + tuple(self.widths[1:])

    @property
    def layer0_mode(self) -> bool:
        return self.j0_add or bool(self.ctx_width)

    @property
    def mode(self) -> Optional[str]:
        """The name of the launch's mode, None for the default one."""
        if self.layer0_mode:
            return "j0_add" if self.j0_add else "ctx_width"
        trunk = [name for name, on in (("linear_last", not self.last_activation),
                                       ("no_reduction", not self.reduction)) if on]
        return "_".join(trunk) or None

    def dropout_args(self, boundary: bool = False):
        """(k0, k1, thresholds, scales, on, case0, row0) of the internal or
        the ``boundary`` launch for the C interface."""
        nl = self.n_layers
        on = [int(r > 0) for r in self.rates]
        thresh = (ctypes.c_uint * nl)(*[dropout_mod.keep_threshold(r) if r > 0 else 0
                                        for r in self.rates])
        scale = (ctypes.c_float * nl)(*[1.0 / (1.0 - r) if r > 0 else 1.0
                                        for r in self.rates])
        pl = self.placement
        return (self.seed & dropout_mod.MASK32, (self.seed >> 32) & dropout_mod.MASK32,
                thresh, scale, build.int_array(on), pl.case0,
                pl.launch_row0(self.n_int, boundary))

    def stash_floats(self, rows, w):
        """Floats of a launch's stash: every layer's input rows, and the
        operators' pre-activations."""
        return rows * sum(w[:-1]), rows * sum(w[1:1 + self.n_operators])


def forward(kern: Kernels, meta: Meta, v, jt, ht, v_b, ctx, weights, biases, stash: bool,
            par=None, ja=None, ha=None):
    """Both launches, after ``check_fits``; with ``stash`` also the training
    stash of each.
    ``weights`` are the layers' nn.Linear weights (layer 0's local block is
    read, and its context block too in the ctx_width mode), ``biases`` those
    of layers 1 on; ``ctx`` (B, F1) takes layer 0's bias's place; ``par``
    (B, F) for a modulated ``kern``; ``ja``/``ha`` (B, D, Ni, F1) the j0_add
    mode's addends. Returns (ov, oj, oh, [a_int, z_int, a_bnd, z_bnd])."""
    dev = v.device
    check_fits(kern.prefix, meta, shared_limit(dev))
    b_cases, n_int, n_bnd, d_dims = meta.b_cases, meta.n_int, meta.n_bnd, meta.d_dims
    n_out = meta.widths[-1]
    ov = torch.empty((b_cases, n_int + n_bnd, n_out), dtype=torch.float32, device=dev)
    oj = torch.empty((b_cases, n_int, n_out, d_dims), dtype=torch.float32, device=dev)
    oh = torch.empty_like(oj)
    # the kernel reads weights as (in, out): nn.Linear's weight transposed,
    # for layer 0 the columns the internal launch uses (the boundary launch
    # reads the first n_local rows of the same matrix)
    ws = ([weights[0].detach()[:, :meta.int_widths[0]].t().contiguous()]
          + [w.detach().t().contiguous() for w in weights[1:]])
    bs = [ctx] + [b.detach() for b in biases]
    lib = kern.library()
    fn = getattr(lib, f"{kern.prefix}_forward")
    # the launches' weights split for the tensor cores (each launch splits
    # into it in turn)
    ws_fn = getattr(lib, f"{kern.prefix}_forward_workspace")
    n_split = max(ws_fn(len(ws), build.int_array(w), meta.n_local)
                  for w in (meta.int_widths, meta.widths))
    wsplit = torch.empty((n_split,), dtype=torch.float32, device=dev)
    w_ptrs, b_ptrs = build.pointer_array(ws), build.pointer_array(bs)
    drop = meta.dropout_args()
    mod = [par.data_ptr()] if kern.modulated else []
    stashes = []

    def stash_for(rows, widths):
        if not stash:
            return None, None
        na, nz = meta.stash_floats(rows, widths)
        a = torch.empty((na,), dtype=torch.float32, device=dev)
        z = torch.empty((nz,), dtype=torch.float32, device=dev)
        stashes.extend([a, z])
        return a.data_ptr(), z.data_ptr() if nz else None

    act = ACT_CODES[meta.activation]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        sa, sz = stash_for(b_cases * n_int * (1 + 2 * d_dims), meta.int_widths)
        code = fn(d_dims, act, 1, v.data_ptr(), jt.data_ptr(), ht.data_ptr(), b_cases, n_int,
                  ctx.data_ptr(), len(ws), w_ptrs, b_ptrs, build.int_array(meta.int_widths),
                  ov.data_ptr(), n_int + n_bnd, 0, oj.data_ptr(), oh.data_ptr(), *drop, sa, sz,
                  *mod, *kern.mode_args(meta), *kern.coupled_args(meta, ja, ha),
                  wsplit.data_ptr(), n_split, stream)
        build.check_launch(f"{kern.prefix} (internal)", code)
        kern.forward_counter.launches += 1
        kern.count_mode(meta, 0)
        if v_b is not None:
            sa, sz = stash_for(b_cases * n_bnd, meta.widths)
            code = fn(d_dims, act, 0, v_b.data_ptr(), None, None, b_cases, n_bnd,
                      ctx.data_ptr(), len(ws), w_ptrs, b_ptrs, build.int_array(meta.widths),
                      ov.data_ptr(), n_int + n_bnd, n_int, None, None,
                      *meta.dropout_args(boundary=True), sa, sz, *mod,
                      *kern.mode_args(meta), *kern.coupled_args(meta), wsplit.data_ptr(),
                      n_split, stream)
            build.check_launch(f"{kern.prefix} (boundary)", code)
            kern.forward_counter.launches += 1
            kern.count_mode(meta, 0, boundary=True)
    return ov, oj, oh, stashes


def backward(kern: Kernels, meta: Meta, weights, stashes, gv, gj, gh, par=None):
    """The backward kernel, internal then boundary launch: (dv, djt, dht,
    dv_b or None, dctx (B, F1), dW per layer ((in, out); layer 0's rows the
    internal launch uses), db per layer from 1 on, dpar (B, F) or None, dja
    and dha (B, D, Ni, F1) or None). djt/dht are as wide as the internal
    launch's J/H rows."""
    dev = gv.device
    b_cases, n_int, n_bnd, d_dims = meta.b_cases, meta.n_int, meta.n_bnd, meta.d_dims
    widths, int_widths = meta.widths, meta.int_widths
    nl = meta.n_layers
    lib = kern.library()
    fn = getattr(lib, f"{kern.prefix}_backward")
    w_int, w_bnd = build.int_array(int_widths), build.int_array(widths)
    ldw = build.int_array([w.shape[1] for w in weights])
    w_ptrs = build.pointer_array(weights)
    dws = [torch.zeros((int_widths[i], widths[i + 1]), dtype=torch.float32, device=dev)
           for i in range(nl)]
    dbs = [torch.zeros((widths[i + 1],), dtype=torch.float32, device=dev) for i in range(nl)]
    dctx = dbs[0].new_zeros((b_cases, widths[1]))
    # db[0] is not used: dctx takes its place
    db_ptrs = build.pointer_array([dctx] + dbs[1:])
    dw_ptrs = build.pointer_array(dws)
    drop = meta.dropout_args()
    act = ACT_CODES[meta.activation]
    rows_int = b_cases * n_int * (1 + 2 * d_dims)
    rows_bnd = b_cases * n_bnd
    ws_fn = getattr(lib, f"{kern.prefix}_backward_workspace")
    n_scratch = max(ws_fn(b_cases, r, nl, w) for r, w in ((rows_int, w_int), (rows_bnd, w_bnd))
                    if r)
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=dev)
    gz = torch.empty((max(rows_int, rows_bnd) * sum(widths[1:]),), dtype=torch.float32,
                     device=dev)
    dpar, mod = None, []
    if kern.modulated:
        dpar = torch.zeros_like(par)
        dpar_rows = torch.empty(
            (b_cases * max(n_int, n_bnd) * sum(widths[1:1 + meta.n_operators]),),
            dtype=torch.float32, device=dev)
        mod = [par.data_ptr(), dpar_rows.data_ptr(), dpar.data_ptr(), *kern.mode_args(meta)]
    dja = dha = None
    if meta.j0_add:
        dja = torch.empty((b_cases, d_dims, n_int, widths[1]), dtype=torch.float32, device=dev)
        dha = torch.empty_like(dja)

    dv = torch.empty((b_cases, n_int, widths[0]), dtype=torch.float32, device=dev)
    djt = torch.empty((b_cases, d_dims, n_int, int_widths[0]), dtype=torch.float32, device=dev)
    dht = torch.empty_like(djt)
    dv_b = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # the internal launch writes dja/dha itself: the boundary launch
        # reuses gz, which holds GZ_0's J/H rows until then
        code = fn(d_dims, act, 1, gv.data_ptr(), n_int + n_bnd, 0, gj.data_ptr(),
                  gh.data_ptr(), b_cases, n_int, nl, w_ptrs, ldw, w_int, *drop,
                  stashes[0].data_ptr(), stashes[1].data_ptr() if stashes[1].numel() else None,
                  gz.data_ptr(), dv.data_ptr(), djt.data_ptr(), dht.data_ptr(), dw_ptrs,
                  db_ptrs, dctx.data_ptr(), scratch.data_ptr(), n_scratch, *mod,
                  *kern.coupled_args(meta, dja, dha), stream)
        build.check_launch(f"{kern.prefix} backward (internal)", code)
        kern.backward_counter.launches += 1
        kern.count_mode(meta, 1)
        if n_bnd:
            dv_b = torch.empty((b_cases, n_bnd, widths[0]), dtype=torch.float32, device=dev)
            code = fn(d_dims, act, 0, gv.data_ptr(), n_int + n_bnd, n_int, None, None, b_cases,
                      n_bnd, nl, w_ptrs, ldw, w_bnd, *meta.dropout_args(boundary=True),
                      stashes[2].data_ptr(),
                      stashes[3].data_ptr() if stashes[3].numel() else None, gz.data_ptr(),
                      dv_b.data_ptr(), None, None, dw_ptrs, db_ptrs, dctx.data_ptr(),
                      scratch.data_ptr(), n_scratch, *mod, *kern.coupled_args(meta), stream)
            build.check_launch(f"{kern.prefix} backward (boundary)", code)
            kern.backward_counter.launches += 1
            kern.count_mode(meta, 1, boundary=True)
    return dv, djt, dht, dv_b, dctx, dws, dbs[1:], dpar, dja, dha


class MlpProp(torch.autograd.Function):
    """The forward kernels with their stash, and the backward kernels.
    Inputs: (kern, meta, v, jt, ht, v_b, ctx, par or None, ja or None, ha or
    None, *weights, *biases of layers 1 on)."""

    @staticmethod
    def forward(ctx, kern, meta, v, jt, ht, v_b, cctx, par, ja, ha, *params):
        nl = meta.n_layers
        weights, biases = params[:nl], params[nl:]
        ov, oj, oh, stashes = forward(kern, meta, v, jt, ht, v_b, cctx, weights, biases,
                                      True, par, ja, ha)
        ctx.kern, ctx.meta = kern, meta
        ctx.save_for_backward(*weights, *stashes, *([par] if kern.modulated else []))
        return ov, oj, oh

    @staticmethod
    def backward(ctx, gv, gj, gh):
        kern, meta = ctx.kern, ctx.meta
        nl = meta.n_layers
        saved = list(ctx.saved_tensors)
        par = saved.pop().detach() if kern.modulated else None
        weights = [w.detach() for w in saved[:nl]]
        dv, djt, dht, dv_b, dctx, dws, dbs, dpar, dja, dha = backward(
            kern, meta, weights, saved[nl:], gv.contiguous(), gj.contiguous(),
            gh.contiguous(), par)
        # layer 0's kernel gradient covers the columns the internal launch
        # reads (the local block; all of it in the ctx_width mode); autograd
        # adds the value rows' context-block gradient through ctx's F.linear
        dw0 = torch.zeros_like(weights[0])
        dw0[:, :meta.int_widths[0]] = dws[0].t()
        return (None, None, dv, djt, dht, dv_b, dctx, dpar, dja, dha, dw0,
                *[dw.t() for dw in dws[1:]], *dbs)


# launches of weight_grad through its own entry point (the backward
# launches count theirs on their wrappers)
WEIGHT_GRAD = ModeCount()


def weight_grad_plain(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return a.t() @ g


def weight_grad(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """a^T g, (K, N), for a (rows, K) and g (rows, N): the engine's weight
    gradient contraction alone (``csrc/common.cuh``'s ``weight_grad``: 3xTF32
    tensor-core tiles over row chunks added in order), as each backward
    launch runs it for every layer. CPU tensors take ``weight_grad_plain``."""
    fn = "weight_grad"
    if a.device.type == "cpu":
        return weight_grad_plain(a, g)
    if a.dim() != 2 or g.dim() != 2 or a.shape[0] != g.shape[0]:
        raise ValueError(f"{fn}: shapes {tuple(a.shape)} and {tuple(g.shape)} do not "
                         "contract over rows")
    rows, k = a.shape
    n = g.shape[1]
    check_tensor("a", a, (rows, k), a.device, fn)
    check_tensor("g", g, (rows, n), a.device, fn)
    lib = build.library("decoder_prop")
    entry = lib.decoder_prop_weight_grad
    if entry.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        entry.argtypes = [p, p, i, i, i, p, ll, p, p]
        entry.restype = i
        lib.decoder_prop_weight_grad_workspace.argtypes = [i, i, i]
        lib.decoder_prop_weight_grad_workspace.restype = ll
    n_scratch = lib.decoder_prop_weight_grad_workspace(rows, k, n)
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=a.device)
    out = torch.zeros((k, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = entry(a.data_ptr(), g.data_ptr(), rows, k, n, scratch.data_ptr(), n_scratch,
                     out.data_ptr(), stream)
    build.check_launch(fn, code)
    WEIGHT_GRAD.launches += 1
    return out


def occupancy(kern: Kernels, widths: Sequence[int], n_local: Optional[int] = None,
              reduction: bool = True, d_dims: int = 2) -> dict:
    """Blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; 0
    past the card's shared bytes) and dynamic shared bytes of ``kern``'s
    internal forward and backward kernels in the default mode (silu) at
    ``d_dims`` and ``widths`` (the decoder's layer 0 reads ``n_local``
    columns), and of weight_grad's 128 x 128 tile. Needs the card."""
    lib = kern.library()
    entry = getattr(lib, f"{kern.prefix}_occupancy")
    out = (ctypes.c_int * 6)()
    n_layers = len(widths) - 1
    mode = int(reduction) if kern.modulated else int(n_local or widths[0])
    entry.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p]
    entry.restype = ctypes.c_int
    build.check_launch(f"{kern.prefix}_occupancy",
                       entry(d_dims, n_layers, build.int_array(widths), mode, out))
    keys = ("fwd_blocks_per_sm", "fwd_smem_bytes", "bwd_blocks_per_sm", "bwd_smem_bytes",
            "weight_grad_blocks_per_sm", "weight_grad_smem_bytes")
    return dict(zip(keys, list(out)))


def run(kern: Kernels, meta: Meta, v, jt, ht, v_b, ctx, par, weights, biases, ja=None,
        ha=None):
    """The kernels on validated inputs, inside ``MlpProp`` when a gradient
    is wanted: (v (B, Ni + Nb, O), jac (B, Ni, O, D), lap)."""
    tensors = [v, jt, ht, ctx, *weights, *biases] + [t for t in (v_b, par, ja, ha)
                                                    if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return MlpProp.apply(kern, meta, v, jt, ht, v_b, ctx, par, ja, ha, *weights, *biases)
    return forward(kern, meta, v, jt, ht, v_b, ctx, weights, biases, False, par, ja, ha)[:3]
