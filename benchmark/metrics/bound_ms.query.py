"""Device ms per call of the operations the port launched inside its
``engine.bound`` span (the bounding's sorts, run scans and masks): the
union of their device intervals."""
from benchmark.core import program

program.install()


def read(run):
    p = program.program_of(run)
    if p is None or not p.ops or not p.has("engine.bound"):
        return None
    return program.per_call_ms(run, p.device_s("engine.bound"))
