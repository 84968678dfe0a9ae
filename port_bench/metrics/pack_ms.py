"""Median device milliseconds a call of the program's ``ddmpc.pack`` span:
the pack of the inputs (K1: ``_center_and_pack``; K4: the plant window,
the theta maps of solve 0, the noise's pad and reshape, the carry made
contiguous); CUDA events around it in the tracer pass of
``port_bench/program_spans.py``."""

from port_bench import program_spans


def read(run):
    return program_spans.device_ms(run, "ddmpc.pack")
