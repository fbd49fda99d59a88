"""Host and device building blocks of the port's fused path."""
