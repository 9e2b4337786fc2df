"""What the serving cells' per-layer readers (``metrics/<name>.py``) read
from a ``Run``: one function a quantity, which returns None where the run
has nothing to read."""
from __future__ import annotations

import statistics

from portbench import flops


def _traced(run, key):
    t = run.traced
    return t if run.kind == "serve" and t and t.get(key) else None


def engine_host_ms(run):
    """Host ms from a request's start to its last launch enqueued: the copy
    in and ``predict_batch`` returning (mean over the window's requests)."""
    if run.kind != "serve" or not run.host_call_s:
        return None
    return statistics.fmean(run.host_call_s) * 1e3


def mfu_in_service(run):
    """Verbose prediction's share of the card's TF32 peak: the inventory's
    forward FLOPs a case times the cases, over the seconds the requests were
    in service (from their start to their outputs in host memory; the wait
    for due times left out)."""
    if run.kind != "serve" or not run.service_s:
        return None
    return 100.0 * run.flops_per_case * run.cases / sum(run.service_s) / flops.PEAK_FLOPS


def mfu_in_window(run):
    """The same over the window's seconds: the cases finished a second."""
    if run.kind != "serve" or not run.wall_s or not run.cases:
        return None
    return 100.0 * run.flops_per_case * run.cases / run.wall_s / flops.PEAK_FLOPS


def plain_device_us_per_case(run):
    """Device us a case predicted in kernels that the port's own libraries
    did not launch, traced."""
    t = _traced(run, "n_device_events")
    return None if t is None else t["plain_kernel_s"] / run.traced_units * 1e6


def kernel_roofline(run):
    """The port's kernels' share of their roofline, as
    ``kernel_roofline.train`` reckons it."""
    t = _traced(run, "own_kernel_s")
    return None if t is None else 100.0 * run.traced_bound_s / t["own_kernel_s"]


def device_idle_pct(run):
    """Share of the requests' service time in which no kernel, copy or set
    ran on the card: the traced stretch's busy device seconds a case, times
    the window's cases, over the seconds the window's requests were in
    service (from their start to their outputs in host memory; the waits
    for due times left out)."""
    t = _traced(run, "n_device_events")
    if t is None or not run.service_s:
        return None
    busy = t["busy_s"] / run.traced_units * run.cases
    return 100.0 * (1.0 - busy / sum(run.service_s))
