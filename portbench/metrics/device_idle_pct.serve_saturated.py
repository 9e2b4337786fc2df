"""Share of the requests' service time with the card idle, above capacity
(``readers.device_idle_pct``)."""
from portbench.readers import device_idle_pct as read  # noqa: F401
