"""Host ms of each ``train_step`` call in the window, which returns without a
sync: the engine's enqueue of a step (mean over the window's steps)."""
import statistics


def read(run):
    if run.kind != "train" or not run.host_call_s:
        return None
    return statistics.fmean(run.host_call_s) * 1e3
