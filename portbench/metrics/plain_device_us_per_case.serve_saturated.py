"""Device us a case in kernels the port's libraries did not launch, above
capacity (``readers.plain_device_us_per_case``)."""
from portbench.readers import plain_device_us_per_case as read  # noqa: F401
