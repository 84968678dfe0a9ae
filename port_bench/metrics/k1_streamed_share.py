"""Kernel K1's share of its operator's slices that its product streams,
in %: the program's counters ``fused_rollout.slices_streamed`` over
``fused_rollout.slices_dense`` (host integers to which each launch adds
its pack's totals: the slices of ``D`` one row block streams over all
column tiles and passes, and the slices it would stream without the
slice lists), read after the tracer pass of
``port_bench/program_spans.py``. Every launch of a run adds the same
pack's totals, so the share over the process's launches is the tracer
pass's. None outside a traced run of K1, before any launch, and for a
program without the counters."""

from port_bench import program_spans


def read(run):
    if not run.trace or run.kernel != "K1":
        return None
    program_spans.read(run)
    from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr

    streamed = getattr(fr.fused_rollout, "slices_streamed", None)
    dense = getattr(fr.fused_rollout, "slices_dense", None)
    if streamed is None or not dense:
        return None
    return 100.0 * streamed / dense
