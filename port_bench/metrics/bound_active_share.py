"""The share of scenario-solves whose Eq. 6d bound is active, in %: the
program's counters ``bound_active`` (solves whose final
``||sigma_pred||_inf`` lies within 1e-4 relative of their bound) over
``nonconvex_solves`` (``ops.fused_admm.fused_admm_counters``, the
launches of the tracer pass of ``port_bench/program_spans.py``). None
outside a traced run of the NON_CONVEX mode and for a program without
the counters."""

from port_bench import program_spans


def read(run):
    if not run.trace or run.kernel != "K4nc":
        return None
    program_spans.read(run)
    from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa

    counters = getattr(fa, "fused_admm_counters", None)
    c = counters(run.device) if counters else {}
    if not c.get("nonconvex_solves"):
        return None
    return 100.0 * c["bound_active"] / c["nonconvex_solves"]
