"""The port's kernels' share of their roofline in a training step: the sum of
each kernel call's bound (``flops.kernel_calls``: the larger of its FLOPs at
the TF32 peak and its bytes at HBM bandwidth) over the traced device seconds
of every kernel the port's libraries launched."""


def read(run):
    t = run.traced
    if run.kind != "train" or not t or not t.get("own_kernel_s"):
        return None
    return 100.0 * run.traced_bound_s / t["own_kernel_s"]
