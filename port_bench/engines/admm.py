"""Slack CONVEX: over-relaxed ADMM on the slack box, the whole closed
loop run by ``ops/fused_admm.py::make_fused_admm_rollout`` (kernel K4),
cold-started on every call."""

from __future__ import annotations

from port_bench import reference, work as _work
from port_bench.engines import Program, controller, plant

LIBRARY = "fused_admm"


def work(config, B, T):
    return _work.k4(config, B, T)


def build(config: dict, data, T: int, device, wrap) -> Program:
    """The ADMM operator from ``compute_admm_operator_np`` at the
    configuration's rho and alpha, and the entry with its iteration
    schedule and ``rollout=wrap(fused_admm)``."""
    from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa
    from direct_data_driven_mpc_tpu_torch.qp.admm import (
        compute_admm_operator_np,
    )

    s = config["solver"]
    ctrl = controller(config, data)
    op = compute_admm_operator_np(ctrl.spec, rho=s["rho"], alpha=s["alpha"])
    run = fa.make_fused_admm_rollout(
        plant(config), op, ctrl.n, ctrl.m, ctrl.p, T,
        n_mpc_step=ctrl.n_mpc_step, iters=tuple(s["iters"]),
        cold_iters=s["cold_iters"], tol=s["tol"], device=device,
        rollout=wrap(fa.fused_admm),
    )
    return Program(run, lambda: fa.fused_admm.launches,
                   lambda: fa.fused_admm.wide_launches)


def reference_run(config: dict, data, W, control: bool = False) -> dict:
    s = config["solver"]
    qp = reference.RobustQP(data.u_d, data.y_d, config["controller"])
    solver = dict(rho=s["rho"], alpha=s["alpha"], n_iter=sum(s["iters"]),
                  cold_iters=s["cold_iters"], tol=s["tol"])
    return reference.closed_loop(config["model"],
                                 reference.admm_maps(qp, s["rho"]), solver,
                                 data.x0, data.u_past, data.y_past, W,
                                 control=control)
