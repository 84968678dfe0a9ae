"""Median device milliseconds a call of the program's ``ddmpc.result`` span:
the result's assembly (the final state's shift, the slices, the costs
and ``converged``, the ``ClosedLoopResult``); CUDA events around it in
the tracer pass of ``port_bench/program_spans.py``."""

from port_bench import program_spans


def read(run):
    return program_spans.device_ms(run, "ddmpc.result")
