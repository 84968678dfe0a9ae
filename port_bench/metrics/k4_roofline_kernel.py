"""Kernel K4's share of its roofline against the kernel alone: the least
time of its work (``port_bench.work.k4``, at 495 TFLOP/s and 3.35 TB/s)
over the median device time of the program's ``ddmpc.kernel`` span (CUDA
events around the library's launch call alone, in the tracer pass of
``port_bench/program_spans.py``). Unlike ``k4_roofline``, no host time
of the wrapper is in the span."""

from port_bench import program_spans


def read(run):
    return program_spans.kernel_roofline(run, "K4")
