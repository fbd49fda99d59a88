"""Device ms per call of the host-to-device copies the port launched
inside its ``engine.put`` span."""
from benchmark.core import program

program.install()


def read(run):
    p = program.program_of(run)
    if p is None or not p.ops or not p.has("engine.put"):
        return None
    return program.per_call_ms(run, p.copy_s("engine.put", "HtoD"))
