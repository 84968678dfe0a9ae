"""Median host milliseconds a call of the program's ``ddmpc.rollout`` span,
the kernel wrapper (its checks, plan, cached operator pack, output
allocations and the launch call): ``time.perf_counter_ns`` at its ends,
in the tracer pass of ``port_bench/program_spans.py``. Where the host
paces the evaluations, the entry's time goes to these spans. It holds
the recording of the ``ddmpc.kernel`` span inside it (a stream lookup
and two CUDA events)."""

from port_bench import program_spans


def read(run):
    return program_spans.host_ms(run, "ddmpc.rollout")
