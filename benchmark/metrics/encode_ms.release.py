"""The port's ``engine.encode`` span per call, ms."""
from benchmark.core.readers import mean_timing_ms


def read(run):
    return mean_timing_ms(run, "host_encode_s")
