"""Host ms per call of the port's ``encode.pk`` and ``encode.pid`` spans:
the factorisation of the partition keys and the privacy-unit ids."""
from benchmark.core import program

program.install()

SPANS = ("encode.pk", "encode.pid")


def read(run):
    p = program.program_of(run)
    if p is None or not any(p.has(s) for s in SPANS):
        return None
    return program.per_call_ms(run, p.host_s(SPANS))
