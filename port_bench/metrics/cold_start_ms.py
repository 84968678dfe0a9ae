"""Median device milliseconds a call of the program's ``ddmpc.cold_start``
span: the ADMM entry's cold start (the zero state and the ``cold_iters``
plain iterations before the kernel); CUDA events around it in the tracer
pass of ``port_bench/program_spans.py``."""

from port_bench import program_spans


def read(run):
    return program_spans.device_ms(run, "ddmpc.cold_start")
