"""Share of a training step's wall time in which no kernel, copy or set ran
on the card: the traced stretch's busy device seconds a step over the
unprofiled window's seconds a step (the profiler's own host cost stretches
the traced stretch's wall time, not the card's work)."""


def read(run):
    t = run.traced
    if run.kind != "train" or not t or not t.get("n_device_events") or not run.attempted:
        return None
    busy = t["busy_s"] / run.traced_units
    return 100.0 * (1.0 - busy / (run.wall_s / run.attempted))
