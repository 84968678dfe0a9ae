"""Slack NON_CONVEX, the paper's own Eq. 6d: the convex-concave fixed
point of ``qp/nonconvex.py`` (bound updates after blocks of over-relaxed
ADMM iterations on the slack box), the whole closed loop run by
``ops/fused_admm.py::make_fused_admm_rollout`` in its NON_CONVEX mode
(kernel K4), from ``nonconvex_initial_state`` on every call."""

from __future__ import annotations

import numpy as np

from port_bench import reference, reference_nonconvex, work_nonconvex
from port_bench.engines import Program, plant

LIBRARY = "fused_admm"


def work(config, B, T):
    return work_nonconvex.k4nc(config, B, T)


def controller(config: dict, data):
    """The program's Robust controller as ``engines.controller`` builds
    it, with the NON_CONVEX slack (``slack_var_constraint_type`` 2)
    opted in (``allow_nonconvex_slack``)."""
    from direct_data_driven_mpc_tpu_torch.control.controller import (
        DirectDataDrivenMPCController,
    )
    from direct_data_driven_mpc_tpu_torch.qp.spec import (
        DataDrivenMPCType,
        SlackVarConstraintTypes,
    )

    c = config["controller"]
    if c["slack_var_constraint_type"] != 2:
        raise ValueError("the nonconvex engine takes "
                         "slack_var_constraint_type 2 (NonConvex)")
    m, p, L, eps = data.u_d.shape[1], data.y_d.shape[1], c["L"], \
        c["epsilon_bar"]
    return DirectDataDrivenMPCController(
        n=c["n"], m=m, p=p, u_d=data.u_d, y_d=data.y_d, L=L,
        Q=c["Q_scalar"] * np.eye(p * L), R=c["R_scalar"] * np.eye(m * L),
        u_s=np.asarray(c["u_s"], np.float64).reshape(-1, 1),
        y_s=np.asarray(c["y_s"], np.float64).reshape(-1, 1),
        eps_max=eps, lamb_alpha=c["lambda_alpha_epsilon_bar"] / eps,
        lamb_sigma=c["lambda_sigma"], c=c["c"],
        slack_var_constraint_type=SlackVarConstraintTypes.NON_CONVEX,
        controller_type=DataDrivenMPCType(c["controller_type"]),
        n_mpc_step=c["n_mpc_step"], solve_path="numpy",
        allow_nonconvex_slack=True,
    )


def build(config: dict, data, T: int, device, wrap) -> Program:
    """The Eq. 6d operator from ``compute_nonconvex_operator_np`` at the
    configuration's rho and alpha, and the entry with its iteration
    schedule and ``rollout=wrap(fused_admm)``. An entry without the
    NON_CONVEX mode refuses ``outer_iters`` with a TypeError here, at
    build."""
    from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa
    from direct_data_driven_mpc_tpu_torch.qp.nonconvex import (
        compute_nonconvex_operator_np,
    )

    s = config["solver"]
    ctrl = controller(config, data)
    op = compute_nonconvex_operator_np(ctrl.spec, rho=s["rho"],
                                       alpha=s["alpha"])
    run = fa.make_fused_admm_rollout(
        plant(config), op, ctrl.n, ctrl.m, ctrl.p, T,
        n_mpc_step=ctrl.n_mpc_step, iters=tuple(s["iters"]),
        cold_iters=s["cold_iters"], tol=s["tol"], device=device,
        rollout=wrap(fa.fused_admm), outer_iters=s["outer_iters"],
        outer_tol=s["outer_tol"],
    )
    return Program(run, lambda: fa.fused_admm.launches,
                   lambda: fa.fused_admm.wide_launches)


def reference_run(config: dict, data, W, control: bool = False) -> dict:
    s = config["solver"]
    qp = reference.RobustQP(data.u_d, data.y_d, config["controller"])
    solver = dict(rho=s["rho"], alpha=s["alpha"], inner=sum(s["iters"]),
                  outer=s["outer_iters"], tol=s["tol"],
                  outer_tol=s["outer_tol"])
    return reference_nonconvex.closed_loop(
        config["model"], reference_nonconvex.nonconvex_maps(qp, s["rho"]),
        solver, data.x0, data.u_past, data.y_past, W, control=control)
