"""Device idle ms per call inside the port's ``engine.device`` span: the
idle gaps whose midpoint lies inside it, as the breakdown names gaps."""
from benchmark.core import program

program.install()


def read(run):
    p = program.program_of(run)
    if p is None or not p.ops or not p.has("engine.device"):
        return None
    return program.per_call_ms(run, p.idle_s("engine.device"))
