"""The share of K4's time in its NON_CONVEX mode spent on the bound
update, in %: the program's counters ``bound_cycles`` over
``kernel_cycles`` (``ops.fused_admm.fused_admm_counters``: ``clock64``
cycles that the warps owning scenarios spent in the alpha product, its
1-norm and the new bound, over all their cycles, summed over the
launches made under ``profiling.collect()``, which are the tracer pass's
of ``port_bench/program_spans.py``). None outside a traced run of the
NON_CONVEX mode and for a program without the counters."""

from port_bench import program_spans


def read(run):
    if not run.trace or run.kernel != "K4nc":
        return None
    program_spans.read(run)
    from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa

    counters = getattr(fa, "fused_admm_counters", None)
    c = counters(run.device) if counters else {}
    if not c.get("kernel_cycles"):
        return None
    return 100.0 * c["bound_cycles"] / c["kernel_cycles"]
