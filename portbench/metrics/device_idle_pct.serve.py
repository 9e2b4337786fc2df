"""Share of the requests' service time with the card idle, at the fixed
rate below capacity (``readers.device_idle_pct``)."""
from portbench.readers import device_idle_pct as read  # noqa: F401
