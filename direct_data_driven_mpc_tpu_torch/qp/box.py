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

Counterpart of ``direct_data_driven_mpc_tpu/qp/box.py``
(``BoxADMMState``, ``_channel_bounds``, ``_box_rows_and_bounds``,
``compute_box_admm_operator_np``). The device solver with the ladder's
residual balancing (``box_admm_solve``) is not ported yet.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np

from direct_data_driven_mpc_tpu_torch.qp.solution_map import kkt_multi_solve
from direct_data_driven_mpc_tpu_torch.qp.spec import (
    QPSpec,
    SlackVarConstraintTypes,
)


class BoxADMMState(NamedTuple):
    s: Any  # (nbox,) box-projected copy of the bounded rows
    w: Any  # (nbox,) scaled dual
    rho_idx: Any  # current ladder rung (warm-started)


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
