"""General box constraints via ADMM: input, output and slack bounds
(host, float64).

Beyond the reference, whose only inequality is the CONVEX slack box
(direct_data_driven_mpc_controller.py:658-675): actuator saturation
``u_min <= u <= u_max`` and output corridors. The ADMM splitting of
``qp/admm.py`` generalises to any coordinate box over rows of z: E
selects the bounded rows, the z-step's KKT matrix ``[[H + rho E^T E,
A^T], [A, 0]]`` is constant per ``rho`` and solved once, and each
iteration is one ``(nbox, nbox)`` matvec plus an asymmetric clip.

The best penalty depends on the active set (a loose box wants rho near
the input rows' curvature, a saturated one rho near 1), so the z-step
is pre-factorised for a geometric ladder of penalties; a fixed ``rho``
gives a single rung, which is what the fused engine
(``ops.fused_admm``) takes.

The device solver (:func:`box_admm_solve`) balances the residuals
between rungs every ``chunk`` iterations, each scenario on its own rung:
if the primal residual dominates it steps up (rescaling the scaled dual
``w`` by rho_old / rho_new, which keeps the unscaled multiplier), if the
dual dominates it steps down. The rung rides in the warm-start state.
Each scenario exits on its own once both residuals are at the
tolerance, as a ``while_loop`` under ``vmap`` does in the JAX package.

Counterpart of ``direct_data_driven_mpc_tpu/qp/box.py``
(``BoxADMMSolver``, ``BoxADMMState``, ``compute_box_admm_operator_np``,
``compute_box_admm_solver``, ``box_initial_state``, ``box_admm_solve``).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from direct_data_driven_mpc_tpu_torch.device import resolve_device
from direct_data_driven_mpc_tpu_torch.ops.precision import ieee_float32
from direct_data_driven_mpc_tpu_torch.qp.admm import (
    ADMMStats,
    admm_iterations,
)
from direct_data_driven_mpc_tpu_torch.qp.solution_map import (
    _to_device,
    kkt_multi_solve,
    matvec,
    vecdot,
)
from direct_data_driven_mpc_tpu_torch.qp.spec import (
    QPSpec,
    SlackVarConstraintTypes,
)


class BoxADMMSolver(NamedTuple):
    """The general-box ADMM operator as tensors on one device, every
    per-rung field stacked over the ``R`` rungs of the ladder (R = 1 for
    a fixed ``rho``). At rung ``i``, with ``t = s - w``::

        v    = v_c[i] + V_theta[i] theta + V_s[i] t
        u    = u_c[i] + U_theta[i] theta + U_s[i] t
        cost = [theta; t]^T cost_P[i] [theta; t] + cost_q[i] . [theta; t]
               + cost_r[i]
    """

    v_c: torch.Tensor  # (R, nbox)
    V_theta: torch.Tensor  # (R, nbox, n_theta)
    V_s: torch.Tensor  # (R, nbox, nbox)
    u_c: torch.Tensor  # (R, L*m)
    U_theta: torch.Tensor  # (R, L*m, n_theta)
    U_s: torch.Tensor  # (R, L*m, nbox)
    cost_P: torch.Tensor  # (R, n_theta + nbox, n_theta + nbox)
    cost_q: torch.Tensor  # (R, n_theta + nbox)
    cost_r: torch.Tensor  # (R,)
    lo: torch.Tensor  # (nbox,) lower bounds
    hi: torch.Tensor  # (nbox,) upper bounds
    u_lo: torch.Tensor  # (L*m,) input bounds in u coordinates, +-inf
    u_hi: torch.Tensor  # (L*m,) where unboxed: the extracted u is
    # clipped to them, so a capped, unconverged solve still respects
    # the actuator box
    rhos: torch.Tensor  # (R,) the penalty ladder
    alpha: torch.Tensor  # () over-relaxation, in (0, 2)


class BoxADMMState(NamedTuple):
    s: Any  # (nbox,) or (B, nbox): box-projected copy of the bounded rows
    w: Any  # (nbox,) or (B, nbox): scaled dual
    rho_idx: Any  # current ladder rung, () or (B,) int32 (warm-started)


def _channel_bounds(bounds, width: int, L: int, name: str):
    """Tile per-channel ``(lo, hi)`` over an ``L``-step segment.
    Accepts scalars or length-``width`` arrays; None means unbounded on
    that side (+-inf)."""
    lo, hi = bounds
    lo = -np.inf if lo is None else np.asarray(lo, dtype=np.float64)
    hi = np.inf if hi is None else np.asarray(hi, dtype=np.float64)
    lo = np.broadcast_to(np.atleast_1d(lo), (width,))
    hi = np.broadcast_to(np.atleast_1d(hi), (width,))
    if np.any(lo > hi):
        raise ValueError(f"{name}: lower bound exceeds upper bound.")
    return np.tile(lo, L), np.tile(hi, L)


def _box_rows_and_bounds(
    spec: QPSpec, u_bounds, y_bounds, include_slack_box: bool
):
    """Bounded rows of z, their ``(lo, hi)``, and the input bounds in
    ``ubar[0, L-1]`` coordinates (+-inf where unboxed)."""
    d = spec.dims
    rows = []
    lo_parts, hi_parts = [], []
    # With the terminal constraint the last n prediction blocks are
    # pinned to the setpoint by equalities; boxing them too would make
    # any bound tighter than the setpoint infeasible. The box covers
    # the free steps k = 0 .. L-n-1, where the applied inputs lie.
    n_pin = d.n if spec.use_terminal_constraint else 0
    if u_bounds is not None:
        sl = spec.u_pred_slice
        rows.append(np.arange(sl.start, sl.stop - n_pin * d.m))
        lo, hi = _channel_bounds(u_bounds, d.m, d.L - n_pin, "u_bounds")
        lo_parts.append(lo)
        hi_parts.append(hi)
    if y_bounds is not None:
        sl = spec.y_pred_slice
        rows.append(np.arange(sl.start, sl.stop - n_pin * d.p))
        lo, hi = _channel_bounds(y_bounds, d.p, d.L - n_pin, "y_bounds")
        lo_parts.append(lo)
        hi_parts.append(hi)
    if include_slack_box and spec.sigma_bound is not None:
        sl = spec.sigma_pred_slice
        rows.append(np.arange(sl.start, sl.stop))
        b = float(spec.sigma_bound)
        lo_parts.append(np.full(sl.stop - sl.start, -b))
        hi_parts.append(np.full(sl.stop - sl.start, b))
    if not rows:
        raise ValueError(
            "no box constraints given: pass u_bounds and/or y_bounds "
            "(or use a CONVEX-slack spec)."
        )
    # The extracted u is clipped to these, so the applied input respects
    # the hard box even from a capped, unconverged solve.
    u_lo = np.full(d.L * d.m, -np.inf)
    u_hi = np.full(d.L * d.m, np.inf)
    if u_bounds is not None:
        k = (d.L - n_pin) * d.m
        u_lo[:k], u_hi[:k] = lo_parts[0], hi_parts[0]
    return (
        np.concatenate(rows),
        np.concatenate(lo_parts),
        np.concatenate(hi_parts),
        u_lo,
        u_hi,
    )


def compute_box_admm_operator_np(
    spec: QPSpec,
    u_bounds: Optional[Tuple] = None,
    y_bounds: Optional[Tuple] = None,
    include_slack_box: bool = True,
    rho: Optional[float] = None,
    n_ladder: int = 7,
    ladder_step: float = 10.0,
    alpha: float = 1.6,
) -> dict:
    """Host float64 pre-factorization of the general-box z-step over
    the penalty ladder.

    Args:
        spec: assembled QP spec (any controller; slack NONE or CONVEX).
        u_bounds: optional ``(u_min, u_max)`` -- scalars or per-channel
            ``(m,)`` arrays -- on the free predicted inputs.
        y_bounds: optional ``(y_min, y_max)`` on the free predicted
            outputs.
        include_slack_box: keep the spec's CONVEX slack box (if any)
            as additional rows of the same projection.
        rho: a fixed penalty (single-rung ladder). Default None builds
            ``median_curvature * ladder_step**i, i = 0..n_ladder-1``.
        n_ladder, ladder_step: ladder geometry (ignored with ``rho``).
        alpha: over-relaxation.

    Every per-rung field is stacked on a leading rung axis ``R``.
    """
    if not 0.0 < alpha < 2.0:
        raise ValueError(
            f"over-relaxation alpha must be in (0, 2), got {alpha}"
        )
    if (
        spec.slack_var_constraint_type
        == SlackVarConstraintTypes.NON_CONVEX
    ):
        # The NON_CONVEX slack bound is state-dependent; boxing sigma
        # at its base coefficient would over-constrain.
        raise ValueError(
            "box constraints with the NON_CONVEX slack variant are not "
            "supported (its slack bound is state-dependent)."
        )
    rows, lo, hi, u_lo, u_hi = _box_rows_and_bounds(
        spec, u_bounds, y_bounds, include_slack_box
    )
    nbox = rows.size
    H, g, A = spec.H, spec.g, spec.A
    nz, nc = spec.nz, spec.nc

    if rho is not None:
        rhos = np.array([float(rho)])
    else:
        # Ladder base: the bounded rows' own curvature (the best penalty
        # when the box is inactive); higher rungs serve active sets.
        diag = np.diag(H)[rows]
        pos = diag[diag > 0]
        base = float(np.median(pos)) if pos.size else 1.0
        rhos = base * ladder_step ** np.arange(n_ladder)

    E = np.zeros((nbox, nz))
    E[np.arange(nbox), rows] = 1.0

    n_theta = spec.S.shape[1]
    u_sl = spec.u_pred_slice
    stacked = {
        k: []
        for k in (
            "v_c", "V_theta", "V_s", "u_c", "U_theta", "U_s",
            "cost_P", "cost_q", "cost_r",
        )
    }
    for rho_i in rhos:
        K = np.zeros((nz + nc, nz + nc))
        K[:nz, :nz] = H + rho_i * E.T @ E
        K[:nz, nz:] = A.T
        K[nz:, :nz] = A
        RHS = np.zeros((nz + nc, 1 + n_theta + nbox))
        RHS[:, 0] = np.concatenate([-g, spec.b_const])
        RHS[nz:, 1 : 1 + n_theta] = spec.S
        RHS[:nz, 1 + n_theta :] = rho_i * E.T
        X = kkt_multi_solve(K, RHS)
        z_c = X[:nz, 0]
        Z_theta = X[:nz, 1 : 1 + n_theta]
        Z_s = X[:nz, 1 + n_theta :]
        Z_full = np.concatenate([Z_theta, Z_s], axis=1)
        cost_P = 0.5 * Z_full.T @ (H @ Z_full)
        cost_P = 0.5 * (cost_P + cost_P.T)
        stacked["v_c"].append(E @ z_c)
        stacked["V_theta"].append(E @ Z_theta)
        stacked["V_s"].append(E @ Z_s)
        stacked["u_c"].append(z_c[u_sl])
        stacked["U_theta"].append(Z_theta[u_sl])
        stacked["U_s"].append(Z_s[u_sl])
        stacked["cost_P"].append(cost_P)
        stacked["cost_q"].append(Z_full.T @ (H @ z_c + g))
        stacked["cost_r"].append(
            0.5 * z_c @ H @ z_c + g @ z_c + spec.r0
        )

    return {
        **{k: np.stack(v) for k, v in stacked.items()},
        "lo": lo,
        "hi": hi,
        "u_lo": u_lo,
        "u_hi": u_hi,
        "rhos": rhos,
        "alpha": np.float64(alpha),
        "box_rows": rows,  # host-side diagnostic (not a solver field)
    }


def compute_box_admm_solver(
    spec: QPSpec,
    u_bounds: Optional[Tuple] = None,
    y_bounds: Optional[Tuple] = None,
    include_slack_box: bool = True,
    rho: Optional[float] = None,
    n_ladder: int = 7,
    ladder_step: float = 10.0,
    alpha: float = 1.6,
    device=None,
    dtype=torch.float32,
) -> BoxADMMSolver:
    """The general-box operator (host float64, see
    :func:`compute_box_admm_operator_np`) as a :class:`BoxADMMSolver` on
    ``device`` (None: the CUDA card) in ``dtype``; without a card it
    raises before the host build."""
    device = resolve_device(device)
    op = compute_box_admm_operator_np(
        spec, u_bounds=u_bounds, y_bounds=y_bounds,
        include_slack_box=include_slack_box, rho=rho, n_ladder=n_ladder,
        ladder_step=ladder_step, alpha=alpha,
    )
    return BoxADMMSolver(
        **_to_device(op, BoxADMMSolver._fields, device, dtype)
    )


def box_initial_state(solver: BoxADMMSolver, B: int) -> BoxADMMState:
    """Cold start of ``B`` scenarios: zeros, every scenario on the
    middle rung ``R // 2`` (the balancer reaches any rung within about
    R / 2 chunks)."""
    kw = dict(dtype=solver.v_c.dtype, device=solver.v_c.device)
    zeros = torch.zeros((B, solver.v_c.shape[1]), **kw)
    R = solver.rhos.shape[0]
    return BoxADMMState(
        s=zeros, w=zeros,
        rho_idx=torch.full((B,), R // 2, dtype=torch.int32,
                           device=solver.v_c.device),
    )


@ieee_float32()
def box_admm_solve(
    solver: BoxADMMSolver,
    theta: torch.Tensor,
    num_iters: int = 100,
    state: Optional[BoxADMMState] = None,
    tol: float = 1e-8,
    chunk: int = 10,
    balance_ratio: float = 10.0,
):
    """Up to ``num_iters`` over-relaxed ADMM iterations for a batch of
    past windows ``theta (B, n_theta)``, in chunks of ``chunk``, with the
    penalty rung balanced after each chunk.

    Per scenario, as the JAX package's ``while_loop`` under ``vmap``:
    whole chunks run until the scenario's iteration count reaches
    ``num_iters`` or both of its residuals are at or below ``tol`` (they
    start at infinity, so at least one chunk runs). A scenario that has
    exited keeps its ``s``, ``w``, rung and residuals while the others go
    on. Each scenario's operator is the one of its own rung (a gathered,
    batched product); with a single rung (fixed ``rho``) the operator is
    shared and no balancing runs. Balancing is relative (OSQP-style):
    the primal residual over the largest of ``|s|`` and ``|w|``, the
    dual over ``rho |w|``, each floored at 1e-12.

    Returns ``(u (B, L*m), cost (B,), BoxADMMState, ADMMStats)``: u is
    clipped to the input box and u and the cost are taken at each
    scenario's final rung.
    """
    Bsz = theta.shape[0]
    R = solver.rhos.shape[0]
    if state is None:
        state = box_initial_state(solver, Bsz)
    s, w = state.s, state.w
    idx = state.rho_idx.to(torch.int32).expand(Bsz)
    dtype, device = s.dtype, s.device
    ladder = R > 1
    if not ladder:
        vc = solver.v_c[0] + matvec(solver.V_theta[0], theta)
        V_s, rho = solver.V_s[0], solver.rhos[0]
    it = torch.zeros(Bsz, dtype=torch.int64, device=device)
    r_prim = torch.full((Bsz,), float("inf"), dtype=dtype, device=device)
    r_dual = r_prim
    while True:
        active = (it < num_iters) & ((r_prim > tol) | (r_dual > tol))
        if not bool(active.any()):
            break
        if ladder:
            i = idx.long()
            vc = solver.v_c[i] + matvec(solver.V_theta[i], theta)
            V_s, rho = solver.V_s[i], solver.rhos[i]
        s1, w1, rp, rd = admm_iterations(
            vc, V_s, s, w, solver.lo, solver.hi, solver.alpha, rho, chunk
        )
        idx1 = idx
        if ladder:
            rp_rel = rp / torch.maximum(
                s1.abs().amax(-1), w1.abs().amax(-1)
            ).clamp(min=1e-12)
            rd_rel = rd / (rho * w1.abs().amax(-1)).clamp(min=1e-12)
            up = (rp_rel > balance_ratio * rd_rel) & (idx < R - 1)
            down = (rd_rel > balance_ratio * rp_rel) & (idx > 0)
            idx1 = idx + up.to(torch.int32) - down.to(torch.int32)
            w1 = w1 * (solver.rhos[i] / solver.rhos[idx1.long()])[:, None]
        row = active[:, None]
        s = torch.where(row, s1, s)
        w = torch.where(row, w1, w)
        idx = torch.where(active, idx1, idx)
        it = torch.where(active, it + chunk, it)
        r_prim = torch.where(active, rp, r_prim)
        r_dual = torch.where(active, rd, r_dual)

    t = s - w
    i = idx.long() if ladder else 0
    u = solver.u_c[i] + matvec(solver.U_theta[i], theta) + matvec(
        solver.U_s[i], t
    )
    u = torch.clamp(u, solver.u_lo, solver.u_hi)
    tt = torch.cat([theta, t], -1)
    cost = (
        (matvec(solver.cost_P[i], tt) * tt).sum(-1)
        + vecdot(solver.cost_q[i], tt)
        + solver.cost_r[i]
    )
    stats = ADMMStats(r_prim, r_dual, (r_prim <= tol) & (r_dual <= tol))
    return u, cost, BoxADMMState(s=s, w=w, rho_idx=idx), stats
