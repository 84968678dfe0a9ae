"""Kernel K1's share of its roofline: the least time of its work
(``port_bench.work.k1``, at 495 TFLOP/s and 3.35 TB/s) over the mean
kernel span."""

from port_bench import work


def read(run):
    return work.roofline_share(run, "K1")
