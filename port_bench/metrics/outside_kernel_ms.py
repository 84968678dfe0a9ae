"""Window milliseconds per evaluation less the mean kernel span: the
device-side time of the entry outside its hand kernel (and any idle)."""


def read(run):
    span = run.mean_span_ms()
    if span is None:
        return None
    return 1e3 * run.window_s / run.n_eval - span
