"""Process start to the first timed call: imports, the kernel libraries
(built on a checkout's first run), the table from the seed, warm-up."""


def read(run):
    return run.setup_s
