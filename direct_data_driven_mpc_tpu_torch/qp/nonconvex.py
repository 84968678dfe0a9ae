"""Solver for the NON_CONVEX slack-constrained Robust variant (the
paper's Eq. 6d).

The slack bound scales with the size of the Hankel combination
coefficients,

    || sigma[0, L-1] ||_inf  <=  c * eps_max * (1 + ||alpha||_1),

which couples two decision variables and makes the feasible set
non-convex; the reference raises ``NotImplementedError`` for it
(direct_data_driven_mpc_controller.py:666-670). It is solved as a
convex-concave fixed point over the pre-factorised ADMM of
``qp.admm``:

    bound_0 = c * eps_max                     (the CONVEX box)
    repeat:  solve the box QP ||sigma_pred||_inf <= bound_k by ADMM,
             bound_{k+1} = c * eps_max * (1 + ||alpha_k||_1)

Every outer iteration reuses the same z-step operator: the bound enters
only the clip. Since every bound_k >= c * eps_max, each outer iterate's
box contains the CONVEX box, so the objective never exceeds the CONVEX
solution's. ``converged`` asks for the inner residuals at the
tolerance, a stationary bound and a final iterate feasible for the
non-convex constraint.

Counterpart of ``direct_data_driven_mpc_tpu/qp/nonconvex.py``. The
device solve takes a batch of windows, the scenario axis leading, with
one bound per scenario.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from direct_data_driven_mpc_tpu_torch.device import resolve_device
from direct_data_driven_mpc_tpu_torch.ops.precision import ieee_float32
from direct_data_driven_mpc_tpu_torch.qp.admm import (
    ADMMSolver,
    admm_extract,
    admm_iterations,
    admm_solve_np,
    compute_admm_operator_np,
    per_row,
)
from direct_data_driven_mpc_tpu_torch.qp.solution_map import (
    _to_device,
    matvec,
)
from direct_data_driven_mpc_tpu_torch.qp.spec import (
    QPSpec,
    SlackVarConstraintTypes,
)


class NonConvexADMMSolver(NamedTuple):
    """The Eq. 6d operator as tensors on one device.

    ``base`` is the box-QP ADMM operator (its ``bound`` holds the base
    coefficient ``c * eps_max``; the solve replaces it with the current
    outer bound). ``alpha = a_c + A_theta theta + A_s (s - w)`` is the
    alpha block of the z-step solution.
    """

    base: ADMMSolver
    a_c: torch.Tensor  # (n_alpha,)
    A_theta: torch.Tensor  # (n_alpha, n_theta)
    A_s: torch.Tensor  # (n_alpha, nbox)
    c_eps: torch.Tensor  # () base coefficient c * eps_max


class NonConvexState(NamedTuple):
    """Warm-start state carried across closed-loop steps."""

    s: Any  # (B, nbox)
    w: Any  # (B, nbox)
    bound: Any  # (B,) current outer bound


class NonConvexStats(NamedTuple):
    primal_residual: Any  # (B,) inner ADMM ||Ez - s||_inf at exit
    dual_residual: Any  # (B,) inner ADMM dual residual at exit
    bound_delta: Any  # (B,) relative bound change at exit
    constraint_violation: Any  # (B,) max(0, ||sigma_pred||_inf - bound)
    bound: Any  # (B,) final bound c * eps_max * (1 + ||alpha||_1)
    converged: Any  # (B,) bool


def _check_spec(spec: QPSpec) -> None:
    if spec.slack_var_constraint_type != SlackVarConstraintTypes.NON_CONVEX:
        raise ValueError(
            "nonconvex solver requires a spec built with "
            "slack_var_constraint_type=NON_CONVEX "
            "(and allow_nonconvex_slack=True)."
        )
    if spec.sigma_bound is None:
        raise ValueError("spec is missing the base bound c * eps_max.")


def compute_nonconvex_operator_np(
    spec: QPSpec, rho: float | None = None, alpha: float = 1.6
) -> dict:
    """Host float64 operator: the box-QP ADMM operator plus the alpha
    maps and the base coefficient ``c_eps``."""
    _check_spec(spec)
    op = compute_admm_operator_np(
        spec, rho=rho, alpha=alpha, return_alpha_maps=True
    )
    op["c_eps"] = np.float64(spec.sigma_bound)
    return op


def compute_nonconvex_admm_solver(
    spec: QPSpec,
    rho: float | None = None,
    alpha: float = 1.6,
    device=None,
    dtype=torch.float32,
) -> NonConvexADMMSolver:
    """The Eq. 6d operator (host float64) as a
    :class:`NonConvexADMMSolver` on ``device`` (None: the CUDA card) in
    ``dtype``; without a card it raises before the host build."""
    device = resolve_device(device)
    op = compute_nonconvex_operator_np(spec, rho=rho, alpha=alpha)
    return NonConvexADMMSolver(
        base=ADMMSolver(**_to_device(op, ADMMSolver._fields, device,
                                     dtype)),
        **_to_device(op, NonConvexADMMSolver._fields[1:], device, dtype),
    )


def nonconvex_initial_state(solver: NonConvexADMMSolver,
                            B: int) -> NonConvexState:
    """Cold start of ``B`` scenarios: zeroed ADMM state, the bound at
    the CONVEX box (the tightest any iterate can have)."""
    v_c = solver.base.v_c
    zeros = torch.zeros((B, v_c.shape[-1]), dtype=v_c.dtype,
                        device=v_c.device)
    return NonConvexState(s=zeros, w=zeros,
                          bound=solver.c_eps.expand(B).clone())


@ieee_float32()
def nonconvex_admm_solve(
    solver: NonConvexADMMSolver,
    theta: torch.Tensor,
    outer_iters: int = 8,
    inner_iters: int = 30,
    state: Optional[NonConvexState] = None,
    tol: float = 1e-8,
    outer_tol: float = 1e-6,
):
    """Solve the Eq. 6d program for a batch of past windows ``theta (B,
    n_theta)``: ``outer_iters`` bound updates, each after
    ``inner_iters`` ADMM iterations (fixed trip counts), warm-started
    from ``state`` (the ADMM multipliers and each scenario's bound).

    Returns ``(u (B, L*m), cost (B,), NonConvexState,
    NonConvexStats)``.
    """
    base = solver.base
    Bsz = theta.shape[0]
    dtype, device = theta.dtype, theta.device
    if state is None:
        state = nonconvex_initial_state(solver, Bsz)
    s, w, bound = state.s, state.w, state.bound
    vc = base.v_c + matvec(base.V_theta, theta)
    a_theta = matvec(solver.A_theta, theta)
    alpha = per_row(base.alpha)
    delta = torch.full((Bsz,), float("inf"), dtype=dtype, device=device)
    r_prim = r_dual = torch.zeros(Bsz, dtype=dtype, device=device)
    inner_conv = torch.zeros(Bsz, dtype=torch.bool, device=device)
    for _ in range(outer_iters):
        col = bound[:, None]
        s, w, r_prim, r_dual = admm_iterations(
            vc, base.V_s, s, w, -col, col, alpha, base.rho, inner_iters
        )
        inner_conv = (r_prim <= tol) & (r_dual <= tol)
        alpha_vec = solver.a_c + a_theta + matvec(solver.A_s, s - w)
        bound_new = solver.c_eps * (1.0 + alpha_vec.abs().sum(-1))
        delta = (bound_new - bound).abs() / (solver.c_eps + bound_new)
        bound = bound_new

    t = s - w
    u, cost = admm_extract(base, theta, t)
    v = vc + matvec(base.V_s, t)
    # Feasibility of the final iterate for the non-convex constraint
    # (sigma_pred = v), judged at the dtype's resolution.
    viol = torch.clamp(v.abs().amax(-1) - bound, min=0.0)
    feas_tol = 10.0 * torch.finfo(dtype).eps * (1.0 + bound)
    converged = (
        inner_conv
        & (delta <= outer_tol)
        & (viol <= torch.clamp(feas_tol, min=tol))
    )
    stats = NonConvexStats(
        primal_residual=r_prim,
        dual_residual=r_dual,
        bound_delta=delta,
        constraint_violation=viol,
        bound=bound,
        converged=converged,
    )
    return u, cost, NonConvexState(s=s, w=w, bound=bound), stats


def nonconvex_admm_solve_np(
    op: dict,
    theta: np.ndarray,
    outer_iters: int = 20,
    inner_iters: int = 100,
    state: tuple | None = None,
    tol: float = 1e-10,
    outer_tol: float = 1e-9,
) -> tuple:
    """Host float64 twin of :func:`nonconvex_admm_solve` for one window,
    with an early exit on a stationary bound: the controller's per-step
    solve.

    Returns ``(u, cost, (s, w, bound), (r_prim, r_dual, delta, viol,
    bound, converged))``.
    """
    nbox = op["v_c"].shape[0]
    c_eps = float(op["c_eps"])
    if state is not None:
        s, w, bound = state
    else:
        s, w, bound = np.zeros(nbox), np.zeros(nbox), c_eps
    a_theta = op["A_theta"] @ theta
    r_prim = r_dual = delta = np.inf
    op_k = dict(op)
    for _ in range(outer_iters):
        op_k["bound"] = bound
        _, _, (s, w), (r_prim, r_dual, _) = admm_solve_np(
            op_k, theta, num_iters=inner_iters, state=(s, w), tol=tol
        )
        t = s - w
        alpha_vec = op["a_c"] + a_theta + op["A_s"] @ t
        bound_new = c_eps * (1.0 + float(np.abs(alpha_vec).sum()))
        delta = abs(bound_new - bound) / (c_eps + bound_new)
        bound = bound_new
        if delta <= outer_tol and r_prim <= tol and r_dual <= tol:
            break
    t = s - w
    u = op["u_c"] + op["U_theta"] @ theta + op["U_s"] @ t
    v = op["v_c"] + op["V_theta"] @ theta + op["V_s"] @ t
    tt = np.concatenate([theta, t])
    cost = float(tt @ op["cost_P"] @ tt + op["cost_q"] @ tt + op["cost_r"])
    viol = max(float(np.abs(v).max(initial=0.0)) - bound, 0.0)
    converged = bool(
        r_prim <= tol and r_dual <= tol and delta <= outer_tol
        and viol <= max(tol, 1e-12 * (1.0 + bound))
    )
    return (
        u,
        cost,
        (s, w, bound),
        (r_prim, r_dual, delta, viol, bound, converged),
    )
