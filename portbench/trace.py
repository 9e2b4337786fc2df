"""The traced stretch: ``torch.profiler`` over a short stretch of the cell's
own work, reduced to what the per-layer readers read.

The harness marks its own spans (``portbench.<what>``) with
``record_function`` around each call into the program; device kernels,
copies and sets come from the profiler's CUDA activity. Everything is kept
in memory; nothing is written.
"""
from __future__ import annotations

import contextlib
import re
from collections import defaultdict

import torch

# device-kernel names of the port's hand-written CUDA kernels (the program's
# libraries, ops/csrc/*.cu, at commit 4a0a8ad)
OWN_KERNELS = ("mlp_prop_fwd", "mlp_prop_bwd_rows", "split_weights", "pointnet_",
               "weight_grad_partial", "sum_partials", "sum_layer_parts", "group_colsum",
               "sa_fwd", "sa_bwd", "fps_kernel", "philox_kernel")
SPAN = "portbench."
WINDOW = "portbench.traced"


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template and
    argument lists."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    base = re.split(r"[(<]", name, maxsplit=1)[0]
    return base.rsplit("::", 1)[-1][:120] or name[:120]


def is_own(name: str) -> bool:
    return any(k in name for k in OWN_KERNELS)


class Spans:
    """``span(name)``: a ``record_function`` while a stretch is traced, else
    nothing."""

    def __init__(self):
        self.on = False

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(SPAN + name)


def traced(run, spans: Spans, device) -> dict:
    """Run ``run()`` under the profiler and reduce what it saw: device ops by
    name, the port's and the other kernels' seconds, the device's busy
    seconds and the stretch's length, the idle gaps by the harness span the
    host was in when each began."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    spans.on = True
    try:
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW):
                run()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
    finally:
        spans.on = False
    return reduce_events(prof.events())


def reduce_events(events) -> dict:
    host, dev = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the card's side of a host annotation spans the kernels it
            # launched; only kernels, copies and sets count
            if not getattr(e, "is_user_annotation", False):
                dev.append((start, end, e.name))
        elif e.name.startswith(SPAN):
            host.append((start, end, e.name[len(SPAN):]))
    window = [(s, t) for s, t, n in host if n == WINDOW[len(SPAN):]]
    if not window:
        return {}
    w0, w1 = window[0]
    dev = [(max(s, w0), min(t, w1), n) for s, t, n in dev if t > w0 and s < w1]
    by_name, own_s, plain_s = defaultdict(float), 0.0, 0.0
    for s, t, n in dev:
        sec = (t - s) * 1e-6
        by_name[short_name(n)] += sec
        if n.startswith("Memcpy") or n.startswith("Memset"):
            continue
        if is_own(n):
            own_s += sec
        else:
            plain_s += sec
    busy, gaps = 0.0, defaultdict(float)
    spans = [(s, t, n) for s, t, n in host if n != WINDOW[len(SPAN):]]
    cursor = w0
    for s, t, _ in sorted(dev):
        if s > cursor:
            gaps[_host_span(spans, cursor, s)] += (s - cursor) * 1e-6
        busy += max(0.0, t - max(s, cursor)) * 1e-6
        cursor = max(cursor, t)
    if w1 > cursor:
        gaps[_host_span(spans, cursor, w1)] += (w1 - cursor) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy, "own_kernel_s": own_s,
            "plain_kernel_s": plain_s, "device_ops": _top(by_name), "idle_gaps": _top(gaps),
            "n_device_events": len(dev)}


def _host_span(spans, a, b) -> str:
    """The harness span the host spent most of the gap [a, b] in: the
    innermost where spans nest."""
    best, name = 0.0, "between spans"
    for s, e, n in sorted(spans):
        overlap = min(b, e) - max(a, s)
        if overlap > 0 and overlap >= best:
            best, name = overlap, n
    return name


def _top(d, n=10):
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
