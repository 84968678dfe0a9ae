"""The device's idle share over the timed window, from the card's own
durations: 100 (1 - evaluations x busy ms a call / window ms), where
busy a call is the median device time of ``ddmpc.kernel`` (tracer pass)
plus the profiled session's device ms a call of the records issued
outside ``ddmpc.kernel``. The profiler's slowing of the host lengthens
neither; where the host paces, the kernel span also holds the card's
wait for the launch (tens of microseconds), so the share reads low."""

from port_bench import program_spans


def read(run):
    r = program_spans.read(run)
    kernel = r.device_ms.get(program_spans.KERNEL) if r else None
    if kernel is None or r.outside_kernel_device_ms is None:
        return None
    busy = run.n_eval * (kernel + r.outside_kernel_device_ms)
    return 100.0 * (1.0 - busy / (1e3 * run.window_s))
