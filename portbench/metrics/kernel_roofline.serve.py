"""The port's kernels' share of their roofline in verbose prediction, at
the fixed rate below capacity (``readers.kernel_roofline``)."""
from portbench.readers import kernel_roofline as read  # noqa: F401
