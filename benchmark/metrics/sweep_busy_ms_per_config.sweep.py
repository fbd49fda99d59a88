"""Device busy ms of the traced window per configuration evaluated."""


def read(run):
    configs = sum(c.units for c in run.calls if not c.failed)
    if run.trace is None or run.trace.busy_s <= 0 or not configs:
        return None
    return 1e3 * run.trace.busy_s / configs
