"""The training step's share of the card's TF32 peak: the frozen inventory's
FLOPs a case times the window's cases a second (``flops.py``)."""
from portbench import flops


def read(run):
    if run.kind != "train" or not run.wall_s:
        return None
    return 100.0 * run.flops_per_case * run.cases / run.wall_s / flops.PEAK_FLOPS
