"""Verbose prediction's share of the TF32 peak over the window, above
capacity: the cases finished a second (``readers.mfu_in_window``)."""
from portbench.readers import mfu_in_window as read  # noqa: F401
