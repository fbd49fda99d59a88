"""The share of the traced window with no operation on the device."""
from benchmark.core.readers import idle_share_pct as read  # noqa: F401
