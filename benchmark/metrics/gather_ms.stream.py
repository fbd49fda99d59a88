"""Host ms per call of the port's ``ingest.gather`` spans: the gather of
each batch's rows into its staging set, on the stager thread."""
from benchmark.core import program

program.install()


def read(run):
    p = program.program_of(run)
    if p is None or not p.has("ingest.gather"):
        return None
    return program.per_call_ms(run, p.host_s(("ingest.gather",)))
