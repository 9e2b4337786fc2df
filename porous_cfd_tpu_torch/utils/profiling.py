"""Timing and tracing with an honest device synchronization (counterpart of
``porous_cfd_tpu/utils/profiling.py``).

PyTorch returns before the card has finished, so every host clock here ends
in ``torch.cuda.synchronize()`` (``sync``):

  * ``trace(log_dir)``: a ``torch.profiler`` context that writes a
    TensorBoard-readable trace into ``log_dir``;
  * ``Timer`` / ``timed``: wall-clock timing, synchronized;
  * ``steps_per_sec``: the throughput of a (state, ...) -> (state, metrics)
    step function, as the bench measures it;
  * ``device_ms``: the card's own time per call of a function, the sum of its
    kernels' times under ``torch.profiler``, beside the CUDA-event wall time
    per call. This stands in for the JAX tools' "scan delta" (n against 2n
    iterations of one jitted scan, so that dispatch cancels): PyTorch runs no
    such program, and the kernel sum is what those tools call device ms per
    iteration. It raises without a card: it never returns a host time in
    its place.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch


def sync(device=None) -> None:
    """Wait for all work queued on ``device`` (no-op on the CPU)."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(device)


def _devices_of(tree, out: set) -> set:
    if torch.is_tensor(tree):
        out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices_of(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _devices_of(v, out)
    return out


def sync_result(tree) -> None:
    """Wait for the work producing the tensors of ``tree`` (nested tuples,
    lists and dicts): every CUDA device that holds one of them; the current
    one when ``tree`` holds no tensor."""
    devices = _devices_of(tree, set())
    if not devices:
        sync()
    for device in devices:
        sync(device)


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (host operators, and the
    card's kernels where there is a card), written into ``log_dir`` for
    TensorBoard's profiler plugin."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))):
        yield
        sync()


class Timer:
    """Accumulating wall-clock timer; ``stop(result)`` first waits for the
    work producing ``result``."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._start = None

    def start(self):
        self._start = time.perf_counter()

    def stop(self, result=None):
        if result is not None:
            sync_result(result)
        self.total += time.perf_counter() - self._start
        self.count += 1

    @property
    def mean(self) -> float:
        return self.total / max(1, self.count)


def timed(fn: Callable, *args, n: int = 10, warmup: int = 1, **kwargs):
    """Mean wall time of ``fn(*args)`` over n calls, synchronized.
    :return: (seconds_per_call, last_result)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    sync_result(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args, **kwargs)
    sync_result(out)
    return (time.perf_counter() - t0) / n, out


def steps_per_sec(step_fn: Callable, state, *args, n_steps: int = 20):
    """Throughput of a (state, ...) -> (state, metrics) step function, after
    one warm-up step. :return: (steps/s, state)."""
    state, m = step_fn(state, *args)
    sync_result(m)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, m = step_fn(state, *args)
    sync_result(m)
    return n_steps / (time.perf_counter() - t0), state


# profiled windows device_ms tries before it gives up: in a long process a
# window has come back from the profiler without any device activity
PROFILE_ATTEMPTS = 3


def device_ms(fn: Callable, n: int = 10, warmup: int = 2, device=None) -> dict:
    """The card's time per call of ``fn()``: after ``warmup`` calls, ``n``
    calls between two CUDA events give the wall ms per call
    (``wall_ms``); ``n`` more under ``torch.profiler`` give the sum of the
    device activities' (kernels', copies') times per call (``device_ms``),
    free of the host's time between launches, and the largest of them
    (``kernels``, ms per call). A profiled window without any device
    activity is run again, up to ``PROFILE_ATTEMPTS`` windows (``windows``:
    how many it took). Raises on the CPU, and where no window sees device
    time."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device_ms: no CUDA device; the card's time has no CPU "
                               "counterpart")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"device_ms: {device} is not a CUDA device; the card's time has "
                           "no CPU counterpart")
    with torch.cuda.device(device):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        wall = start.elapsed_time(end) / n
        for windows in range(1, PROFILE_ATTEMPTS + 1):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize(device)
            rows = []
            for e in prof.key_averages():
                us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
                if us and e.count:
                    rows.append({"name": e.key[:90], "ms": us / n / 1e3, "count": e.count / n})
            if rows:
                break
        else:
            raise RuntimeError(f"device_ms: torch.profiler recorded no device time in "
                               f"{PROFILE_ATTEMPTS} windows; the last recorded:\n"
                               + prof.key_averages().table(row_limit=8))
    rows.sort(key=lambda r: -r["ms"])
    return {"device_ms": sum(r["ms"] for r in rows), "wall_ms": wall, "kernels": rows[:5],
            "windows": windows}
