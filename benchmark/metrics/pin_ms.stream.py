"""Host ms per call of the port's ``ingest.pin`` spans: the allocation
of the stream's pinned staging sets."""
from benchmark.core import program

program.install()


def read(run):
    p = program.program_of(run)
    if p is None or not p.has("ingest.pin"):
        return None
    return program.per_call_ms(run, p.host_s(("ingest.pin",)))
