"""Exact affine per-step solution operator (host, float64).

For the slack-``NONE`` variants the per-step problem

    min_z  z^T (H/2) z + g^T z      s.t.  A z = b_const + S theta

has a KKT matrix that is constant over the whole closed loop; only
``theta = [u_past; y_past]`` changes. Solving the KKT system once for
the constant and the ``theta`` columns gives the affine map
``z*(theta) = z_base + Z theta``, and with it the optimal input
``u*(theta) = u_base + U_gain theta`` and the optimal cost as an
explicit quadratic in ``theta``.

Counterpart of ``direct_data_driven_mpc_tpu/qp/solution_map.py``
(``kkt_multi_solve``, ``compute_solution_operator_np``,
``kkt_residuals``). Everything here is numpy float64; the device
engines receive the operator through the condensed block map.
"""

from __future__ import annotations

import numpy as np

from direct_data_driven_mpc_tpu_torch.qp.spec import QPSpec

#: Keys of the operator dict that the condensed engine reads.
SOLUTION_OPERATOR_KEYS = (
    "z_base", "Z", "u_base", "U_gain", "cost_P", "cost_q", "cost_r",
)


def kkt_multi_solve(K: np.ndarray, RHS: np.ndarray) -> np.ndarray:
    """Solve ``K X = RHS`` for a (possibly singular) symmetric KKT
    matrix: LU first, verified by its residual; the pseudoinverse
    (minimum-norm KKT point) when the matrix is singular (NOMINAL
    variants) or the LU solution is untrustworthy."""
    scale = max(np.abs(RHS).max(initial=0.0), 1.0)
    try:
        X = np.linalg.solve(K, RHS)
        resid = np.abs(K @ X - RHS).max(initial=0.0) / scale
        if np.isfinite(resid) and resid < 1e-8:
            return X
    except np.linalg.LinAlgError:
        pass
    return np.linalg.pinv(K) @ RHS


def compute_solution_operator_np(spec: QPSpec) -> dict:
    """Host float64 affine solution operator of ``spec``.

    Keys: ``z_base, Z, u_base, U_gain, cost_P, cost_q, cost_r`` plus the
    feasibility certificate ``feasible, primal_residual_const,
    primal_residual_gain``.
    """
    H, g, A = spec.H, spec.g, spec.A
    nz, nc = spec.nz, spec.nc

    K = np.zeros((nz + nc, nz + nc))
    K[:nz, :nz] = H
    K[:nz, nz:] = A.T
    K[nz:, :nz] = A

    RHS = np.zeros((nz + nc, 1 + spec.S.shape[1]))
    RHS[:, 0] = np.concatenate([-g, spec.b_const])
    RHS[nz:, 1:] = spec.S
    X = kkt_multi_solve(K, RHS)
    z_base = X[:nz, 0]
    Z = X[:nz, 1:]

    # Feasibility certificate: a rank-deficient constraint matrix makes
    # the pseudoinverse return a least-squares point that may violate
    # A z = b. The residual (A z_base - b_const) + (A Z - S) theta must
    # vanish for every theta.
    scale = max(1.0, np.abs(spec.b_const).max(initial=0.0))
    res_const = float(
        np.abs(A @ z_base - spec.b_const).max(initial=0.0)
    ) / scale
    res_gain = float(np.abs(A @ Z - spec.S).max(initial=0.0))
    feasible = res_const < 1e-7 and res_gain < 1e-7

    # cost(theta) = 0.5 z^T H z + g^T z + r0 at z = z_base + Z theta.
    Hz = H @ Z
    cost_P = 0.5 * Z.T @ Hz
    cost_P = 0.5 * (cost_P + cost_P.T)
    cost_q = Z.T @ (H @ z_base + g)
    cost_r = 0.5 * z_base @ H @ z_base + g @ z_base + spec.r0

    u_sl = spec.u_pred_slice
    return {
        "z_base": z_base,
        "Z": Z,
        "u_base": z_base[u_sl],
        "U_gain": Z[u_sl],
        "cost_P": cost_P,
        "cost_q": cost_q,
        "cost_r": np.float64(cost_r),
        "feasible": feasible,
        "primal_residual_const": res_const,
        "primal_residual_gain": res_gain,
    }


def solution_operator_from_numpy(arrays: dict) -> dict:
    """An operator dict built elsewhere (for instance by the JAX
    package), as float64 numpy arrays this package's condensed engine
    accepts. Raises ``KeyError`` naming a missing key."""
    missing = [k for k in SOLUTION_OPERATOR_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"solution operator lacks keys {missing}")
    op = {
        k: np.array(arrays[k], dtype=np.float64)
        for k in SOLUTION_OPERATOR_KEYS
    }
    op["cost_r"] = np.float64(op["cost_r"])
    return op


def setpoint_channels_np(spec: QPSpec):
    """Host float64 derivation of the QP's setpoint channels: ``g(r) =
    Gamma r``, ``b_const(r) = S_r r``, ``r0(r) = r' R0 r`` for ``r =
    [u_s; y_s]`` (``qp/assembly.py``: both g and b_const vanish at
    r = 0). Each channel is checked against the baked ``spec.g`` /
    ``spec.b_const`` / ``spec.r0`` at the spec's own setpoints, so a
    wrong derivation raises. Returns ``(Gamma, S_r, R0, r_bar)``."""
    d = spec.dims
    n, m, p, L = d.n, d.m, d.p, d.L
    nz, nc = spec.nz, spec.nc
    if spec.u_s is None or spec.y_s is None:
        raise ValueError(
            "spec does not carry its baked setpoints; the setpoint "
            "channels cannot be checked."
        )
    r_bar = np.concatenate([spec.u_s, spec.y_s])

    up, yp = spec.u_pred_slice, spec.y_pred_slice
    T_u = np.tile(np.eye(m), (L, 1))  # u_sL = T_u @ u_s
    T_y = np.tile(np.eye(p), (L, 1))

    # g(r) = Gamma @ r  (assembly: g[up] = -H[up,up] @ T_u u_s, ...)
    Gamma = np.zeros((nz, m + p))
    Gamma[up, :m] = -spec.H[up, up.start : up.stop] @ T_u
    Gamma[yp, m:] = -spec.H[yp, yp.start : yp.stop] @ T_y
    if not np.allclose(Gamma @ r_bar, spec.g, atol=1e-12):
        raise AssertionError(
            "setpoint-linearity derivation of g does not reproduce the "
            "assembled spec.g"
        )

    # b(theta, r) = S theta + S_r r (terminal rows tile the setpoints).
    S_r = np.zeros((nc, m + p))
    if spec.use_terminal_constraint:
        t0 = nc - n * (m + p)
        S_r[t0 : t0 + n * m, :m] = np.tile(np.eye(m), (n, 1))
        S_r[t0 + n * m :, m:] = np.tile(np.eye(p), (n, 1))
    if not np.allclose(S_r @ r_bar, spec.b_const, atol=1e-12):
        raise AssertionError(
            "setpoint-linearity derivation of b_const does not "
            "reproduce the assembled spec.b_const"
        )

    # r0(r) = r^T R0 r.
    R0 = np.zeros((m + p, m + p))
    R0[:m, :m] = 0.5 * T_u.T @ spec.H[up, up.start : up.stop] @ T_u
    R0[m:, m:] = 0.5 * T_y.T @ spec.H[yp, yp.start : yp.stop] @ T_y
    if not np.isclose(r_bar @ R0 @ r_bar, spec.r0, atol=1e-10):
        raise AssertionError(
            "setpoint-quadratic derivation of r0 does not reproduce "
            "the assembled spec.r0"
        )
    return Gamma, S_r, R0, r_bar


def kkt_residuals(spec: QPSpec, z: np.ndarray, theta: np.ndarray) -> dict:
    """Stationarity and primal residuals of a candidate solution (an
    exact KKT point of a convex QP is its optimum)."""
    H, g, A = spec.H, spec.g, spec.A
    b = spec.b_const + spec.S @ theta
    primal = A @ z - b
    grad = H @ z + g
    nu, *_ = np.linalg.lstsq(A.T, -grad, rcond=None)
    stationarity = grad + A.T @ nu
    return {
        "primal_inf": float(np.abs(primal).max(initial=0.0)),
        "stationarity_inf": float(np.abs(stationarity).max(initial=0.0)),
    }
