"""Device ms per call of the host-to-device copies the port launched
inside its ``ingest.copy`` spans: each batch's staged columns."""
from benchmark.core import program

program.install()


def read(run):
    p = program.program_of(run)
    if p is None or not p.ops or not p.has("ingest.copy"):
        return None
    return program.per_call_ms(run, p.copy_s("ingest.copy", "HtoD"))
