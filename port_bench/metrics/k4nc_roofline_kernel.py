"""Kernel K4's share of its roofline in its NON_CONVEX mode against the
kernel alone: the least time of its work (``port_bench.work_nonconvex.
k4nc``) over the median device time of the program's ``ddmpc.kernel``
span (the tracer pass of ``port_bench/program_spans.py``)."""

from port_bench import program_spans


def read(run):
    return program_spans.kernel_roofline(run, "K4nc")
