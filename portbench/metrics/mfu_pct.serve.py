"""Verbose prediction's share of the TF32 peak over the seconds in service,
at the fixed rate below capacity (``readers.mfu_in_service``)."""
from portbench.readers import mfu_in_service as read  # noqa: F401
