"""Exact affine per-step solution operator (host, float64).

For the slack-``NONE`` variants the per-step problem

    min_z  z^T (H/2) z + g^T z      s.t.  A z = b_const + S theta

has a KKT matrix that is constant over the whole closed loop; only
``theta = [u_past; y_past]`` changes. Solving the KKT system once for
the constant and the ``theta`` columns gives the affine map
``z*(theta) = z_base + Z theta``, and with it the optimal input
``u*(theta) = u_base + U_gain theta`` and the optimal cost as an
explicit quadratic in ``theta``.

The QP is also linear in the setpoints ``r = [u_s; y_s]`` (its g-vector
and terminal rows), so one KKT multi-solve over ``[theta; r]`` gives the
setpoint-parametric operator ``u*(theta, r) = U_theta theta + U_r r``
with the joint cost ``xi' P xi``, ``xi = [theta; r]``
(:func:`compute_tracking_operator_np`): a controller retargets without
a rebuild.

Counterpart of ``direct_data_driven_mpc_tpu/qp/solution_map.py``. The
operators are derived in numpy float64 on the host;
:class:`SolutionMap` and :class:`TrackingMap` carry them as tensors on
one device for the generic closed loop (``control.loop``), whose solve
functions here take a batch of windows ``(B, n_theta)`` as well as one
``(n_theta,)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from direct_data_driven_mpc_tpu_torch.device import resolve_device
from direct_data_driven_mpc_tpu_torch.ops.precision import ieee_float32
from direct_data_driven_mpc_tpu_torch.qp.spec import QPSpec

#: Keys of the operator dict that the condensed engine reads.
SOLUTION_OPERATOR_KEYS = (
    "z_base", "Z", "u_base", "U_gain", "cost_P", "cost_q", "cost_r",
)


class SolutionMap(NamedTuple):
    """The affine solution operator as tensors on one device.

    ``z*(theta) = z_base + Z theta``; ``u*(theta) = u_base + U_gain
    theta`` (the ``ubar[0, L-1]`` segment); ``cost(theta) = theta' P
    theta + q . theta + r``.
    """

    z_base: torch.Tensor  # (nz,)
    Z: torch.Tensor  # (nz, n_theta)
    u_base: torch.Tensor  # (L*m,)
    U_gain: torch.Tensor  # (L*m, n_theta)
    cost_P: torch.Tensor  # (n_theta, n_theta)
    cost_q: torch.Tensor  # (n_theta,)
    cost_r: torch.Tensor  # ()


class TrackingMap(NamedTuple):
    """The setpoint-parametric operator as tensors on one device.

    The optimum is jointly linear in ``(theta, r)``, ``r = [u_s; y_s]``,
    with no constant term (g and b_const vanish at ``r = 0``)::

        u*(theta, r)  = U_theta theta + U_r r
        cost(theta, r) = xi' cost_P xi,   xi = [theta; r]
    """

    U_theta: torch.Tensor  # (L*m, n_theta)
    U_r: torch.Tensor  # (L*m, m+p)
    cost_P: torch.Tensor  # (n_theta+m+p, n_theta+m+p)


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


def tracking_map_from_numpy(arrays, device, dtype=torch.float32
                            ) -> TrackingMap:
    """A :class:`TrackingMap` from arrays built elsewhere (a dict, or the
    JAX package's ``TrackingMap`` as numpy), cast onto ``device`` in
    ``dtype``. Raises ``KeyError`` naming a missing field."""
    if not isinstance(arrays, dict):
        arrays = arrays._asdict()
    missing = [k for k in TrackingMap._fields if k not in arrays]
    if missing:
        raise KeyError(f"tracking map lacks fields {missing}")
    return TrackingMap(**_to_device(arrays, TrackingMap._fields, device,
                                    dtype))


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


def compute_tracking_operator_np(spec: QPSpec) -> dict:
    """Host float64 setpoint-parametric operator (setpoint channels from
    :func:`setpoint_channels_np`): one KKT multi-solve over ``xi =
    [theta; r]``.

    Keys: ``U_theta, U_r, cost_P`` (joint in ``xi``), the full ``Z``,
    the certificate ``feasible, primal_residual_gain``, and the spec's
    baked setpoints ``u_s, y_s``, on which the tracking block map
    centers its setpoint channel.
    """
    d = spec.dims
    m, p = d.m, d.p
    nz, nc, nt = spec.nz, spec.nc, d.n_theta
    Gamma, S_r, R0, _ = setpoint_channels_np(spec)

    K = np.zeros((nz + nc, nz + nc))
    K[:nz, :nz] = spec.H
    K[:nz, nz:] = spec.A.T
    K[nz:, :nz] = spec.A
    RHS = np.zeros((nz + nc, nt + m + p))
    RHS[:nz, nt:] = -Gamma
    RHS[nz:, :nt] = spec.S
    RHS[nz:, nt:] = S_r
    Z = kkt_multi_solve(K, RHS)[:nz]

    res_gain = float(
        np.abs(spec.A @ Z - np.concatenate([spec.S, S_r], axis=1)).max(
            initial=0.0
        )
    )

    # cost(xi) = 0.5 xi' Z'HZ xi + r' Gamma' Z xi + r' R0 r.
    cost_P = 0.5 * Z.T @ (spec.H @ Z)
    C = Gamma.T @ Z  # (m+p, nt+m+p)
    cost_P[nt:, :] += 0.5 * C
    cost_P[:, nt:] += 0.5 * C.T
    cost_P[nt:, nt:] += R0
    cost_P = 0.5 * (cost_P + cost_P.T)

    u_sl = spec.u_pred_slice
    return {
        "U_theta": Z[u_sl, :nt],
        "U_r": Z[u_sl, nt:],
        "cost_P": cost_P,
        "Z": Z,
        "feasible": res_gain < 1e-7,
        "primal_residual_gain": res_gain,
        "u_s": np.asarray(spec.u_s, np.float64),
        "y_s": np.asarray(spec.y_s, np.float64),
    }


def _check_dtype_supported(dtype) -> None:
    """The operators go to the device in float32 or float64 only, and
    in the type asked for: a float64 request stays float64, and a
    narrower type, which would silently degrade the parity-bound paths,
    raises."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(
            f"operators are held in torch.float32 or torch.float64; got "
            f"{dtype}"
        )


def _to_device(op: dict, fields, device, dtype) -> dict:
    _check_dtype_supported(dtype)
    device = resolve_device(device)
    return {
        k: torch.as_tensor(np.array(op[k]), dtype=dtype, device=device)
        for k in fields
    }


def compute_solution_map(spec: QPSpec, device=None,
                         dtype=torch.float32) -> SolutionMap:
    """The affine operator of ``spec`` (host float64) as a
    :class:`SolutionMap` on ``device`` (None: the CUDA card) in
    ``dtype``."""
    return SolutionMap(**_to_device(compute_solution_operator_np(spec),
                                    SolutionMap._fields, device, dtype))


def compute_tracking_map(spec: QPSpec, device=None,
                         dtype=torch.float32) -> TrackingMap:
    """The setpoint-parametric operator of ``spec`` (host float64) as a
    :class:`TrackingMap` on ``device`` (None: the CUDA card) in
    ``dtype``."""
    return TrackingMap(**_to_device(compute_tracking_operator_np(spec),
                                    TrackingMap._fields, device, dtype))


def matvec(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``M x`` for each row of ``x``: ``M (j, k)`` shared by every row
    of ``x (..., k)``, or ``M (B, j, k)``, one per scenario of ``x (B,
    k)`` (operators stacked by ``parallel.batch.stack_solution_maps``)."""
    if M.ndim == 2:
        return x @ M.T
    return torch.matmul(M, x.unsqueeze(-1)).squeeze(-1)


def vecdot(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``q . x`` for each row of ``x``: ``q (k,)`` shared, or ``(B, k)``
    one per scenario."""
    if q.ndim == 1:
        return x @ q
    return (q * x).sum(-1)


@ieee_float32()
def solve_full(sol_map: SolutionMap, theta: torch.Tensor) -> torch.Tensor:
    """Full optimal decision vector ``z*(theta)``: ``(nz,)`` or, for a
    batch of windows ``(B, n_theta)``, ``(B, nz)``."""
    return sol_map.z_base + matvec(sol_map.Z, theta)


@ieee_float32()
def solve_u(sol_map: SolutionMap, theta: torch.Tensor) -> torch.Tensor:
    """Optimal input sequence ``ubar*[0, L-1]`` flattened, ``(L*m,)``
    (``(B, L*m)`` for a batch of windows)."""
    return sol_map.u_base + matvec(sol_map.U_gain, theta)


@ieee_float32()
def optimal_cost(sol_map: SolutionMap, theta: torch.Tensor
                 ) -> torch.Tensor:
    """Optimal objective value at ``theta`` (a scalar, or ``(B,)``)."""
    return (
        (matvec(sol_map.cost_P.mT, theta) * theta).sum(-1)
        + vecdot(sol_map.cost_q, theta)
        + sol_map.cost_r
    )


@ieee_float32()
def solve_u_tracking(tm: TrackingMap, theta: torch.Tensor,
                     r: torch.Tensor) -> torch.Tensor:
    """Optimal input sequence at past window ``theta`` and setpoints ``r
    = [u_s; y_s]``, flattened ``(L*m,)`` (``(B, L*m)`` for a batch of
    windows; ``r`` is ``(m+p,)`` or ``(B, m+p)``)."""
    return theta @ tm.U_theta.T + r @ tm.U_r.T


@ieee_float32()
def tracking_cost(tm: TrackingMap, theta: torch.Tensor,
                  r: torch.Tensor) -> torch.Tensor:
    """Optimal objective value at ``(theta, r)`` (a scalar, or
    ``(B,)``)."""
    xi = torch.cat([theta, r.expand(*theta.shape[:-1], r.shape[-1])], -1)
    return ((xi @ tm.cost_P) * xi).sum(-1)


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
