"""The port's ``engine.device`` span per call, ms: the device path to
its synchronising fetch."""
from benchmark.core.readers import mean_timing_ms


def read(run):
    return mean_timing_ms(run, "device_s")
