"""Kernel K4's share of its roofline in its NON_CONVEX mode: the least
time of its work (``port_bench.work_nonconvex.k4nc``, at 495 TFLOP/s and
3.35 TB/s) over the mean kernel span."""

from port_bench import work


def read(run):
    return work.roofline_share(run, "K4nc")
