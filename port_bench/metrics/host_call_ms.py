"""Mean host milliseconds per call of the entry over the window (pack,
cold start, launch, result), host clock, no synchronize."""


def read(run):
    return 1e3 * run.host_call_s / run.n_eval
