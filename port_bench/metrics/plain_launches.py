"""Kernel launches a call of the plain PyTorch operations around the hand
kernel: in the profiled session, the host's launch records (never lost)
inside a ``ddmpc.call`` range and outside ``ddmpc.kernel``, over the
calls. A count, the same from run to run."""

from port_bench import program_spans


def read(run):
    r = program_spans.read(run)
    return r.plain_launches if r else None
