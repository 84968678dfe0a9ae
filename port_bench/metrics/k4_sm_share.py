"""The share of the card's SMs that kernel K4's grid reaches, in %: the
program's counters ``fused_admm.sms_reached`` over
``fused_admm.sms_total`` (host integers to which each resident launch of
K4 adds ``min(blocks, SMs)`` and the card's SMs), read after the tracer
pass of ``port_bench/program_spans.py``. Every launch of a run has the
same batch, so the share over the process's launches is each launch's.
None outside a traced run of K4, before any launch, and for a program
without the counters."""

from port_bench import program_spans


def read(run):
    if not run.trace or run.kernel != "K4":
        return None
    program_spans.read(run)
    from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa

    reached = getattr(fa.fused_admm, "sms_reached", None)
    total = getattr(fa.fused_admm, "sms_total", None)
    if reached is None or not total:
        return None
    return 100.0 * reached / total
