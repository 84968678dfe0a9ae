"""Sum of the kernel spans over the window, as a share of its time."""


def read(run):
    if not run.spans_ms:
        return None
    return 100.0 * sum(run.spans_ms) / (1e3 * run.window_s)
