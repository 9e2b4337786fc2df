"""Host ms from a request's start to its last launch enqueued, above
capacity (``readers.engine_host_ms``)."""
from portbench.readers import engine_host_ms as read  # noqa: F401
