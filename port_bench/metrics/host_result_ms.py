"""Median host milliseconds a call of the program's ``ddmpc.result`` span,
the result's assembly: ``time.perf_counter_ns`` at its ends, in the
tracer pass of ``port_bench/program_spans.py``. Where the host paces the
evaluations, the entry's time goes to these spans."""

from port_bench import program_spans


def read(run):
    return program_spans.host_ms(run, "ddmpc.result")
