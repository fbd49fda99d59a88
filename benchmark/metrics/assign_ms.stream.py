"""Host ms per call of the port's ``ingest.assign`` span: the stream's
batch assignment (the privacy-id hash and the stable grouping of the
rows by batch)."""
from benchmark.core import program

program.install()


def read(run):
    p = program.program_of(run)
    if p is None or not p.has("ingest.assign"):
        return None
    return program.per_call_ms(run, p.host_s(("ingest.assign",)))
