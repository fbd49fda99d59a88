"""Work units of the window's completed calls over the whole window."""
from benchmark.core.readers import units_per_s as read  # noqa: F401
