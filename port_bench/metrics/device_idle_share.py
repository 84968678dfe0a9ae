"""The device's idle share over one profiler session (the process's
first) of a fixed count of back-to-back calls: one less the union of its
records over the session's wall time, read only where every launch and
copy of the session has its device record."""


def read(run):
    p = run.profiled
    if p is None or not p.session.complete:
        return None
    return 100.0 * (1.0 - p.busy_s / p.wall_s)
