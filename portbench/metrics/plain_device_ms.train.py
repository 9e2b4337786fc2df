"""Device ms a step in kernels that the port's own libraries did not launch
(the plain PyTorch of the model, losses, autograd and Adam), traced."""


def read(run):
    t = run.traced
    if run.kind != "train" or not t or not t.get("n_device_events"):
        return None
    return t["plain_kernel_s"] / run.traced_units * 1e3
