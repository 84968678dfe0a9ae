"""The device's idle share in steady state: over the profiled session
from the first device record issued inside the second ``ddmpc.call`` to
the session's end, so that neither the profiler's start nor the first
call's empty queue is in it; read only where the session is complete."""

from port_bench import program_spans


def read(run):
    r = program_spans.read(run)
    return r.steady_idle_share if r else None
