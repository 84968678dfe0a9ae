"""ADMM for the CONVEX slack-constrained variant (host, float64).

The Robust scheme with ``SlackVarConstraintTypes.CONVEX`` adds one
inequality to the otherwise equality-constrained QP (reference
direct_data_driven_mpc_controller.py:658-675, paper Remark 3):

    || sigma[0, L-1] ||_inf <= c * eps_max

a per-coordinate box on the prediction segment of sigma. ADMM on the
splitting ``s = E z`` (E selects the sigma_pred rows), ``s in Box``:

    z-step: min_z z^T(H/2)z + g^T z + (rho/2)||Ez - s + w||^2  s.t. Az=b
    relax:  v_hat = alpha * Ez + (1 - alpha) * s
    s-step: s = clip(v_hat + w, -bound, +bound)
    w-step: w += v_hat - s

The z-step's KKT matrix is constant (rho fixed), so it is solved once
at construction for the constant, ``theta`` and ``s - w`` columns, and
each iteration is one ``(nbox, nbox)`` matvec in the projected space
``v = E z`` plus a clip.

Counterpart of ``direct_data_driven_mpc_tpu/qp/admm.py``: the host
operator (``compute_admm_operator_np``, with the NON_CONVEX alpha maps
and the setpoint maps) and its float64 solve (``admm_solve_np``), and
the device solver (``ADMMSolver``, ``compute_admm_solver``,
``admm_solve``) on a batch of windows, the scenario axis leading, for
the generic closed loop (``control.loop``). The fused closed loop runs
through ``ops.fused_admm``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from direct_data_driven_mpc_tpu_torch.device import resolve_device
from direct_data_driven_mpc_tpu_torch.ops.precision import ieee_float32
from direct_data_driven_mpc_tpu_torch.qp.solution_map import (
    _to_device,
    kkt_multi_solve,
    matvec,
    setpoint_channels_np,
    vecdot,
)
from direct_data_driven_mpc_tpu_torch.qp.spec import QPSpec


class ADMMSolver(NamedTuple):
    """The ADMM operator as tensors on one device.

    Reduced-space iteration map (``v = E z``, ``t = s - w``)::

        v    = v_c + V_theta theta + V_s t
        u    = u_c + U_theta theta + U_s t
        cost = [theta; t]^T cost_P [theta; t] + cost_q . [theta; t] + r

    Stacked per scenario (``parallel.batch.stack_solution_maps``), every
    field gains a leading scenario axis.
    """

    v_c: torch.Tensor  # (nbox,)
    V_theta: torch.Tensor  # (nbox, n_theta)
    V_s: torch.Tensor  # (nbox, nbox)
    u_c: torch.Tensor  # (L*m,)
    U_theta: torch.Tensor  # (L*m, n_theta)
    U_s: torch.Tensor  # (L*m, nbox)
    cost_P: torch.Tensor  # (n_theta + nbox, n_theta + nbox)
    cost_q: torch.Tensor  # (n_theta + nbox,)
    cost_r: torch.Tensor  # ()
    bound: torch.Tensor  # () box half-width c * eps_max
    rho: torch.Tensor  # () penalty
    alpha: torch.Tensor  # () over-relaxation, in (0, 2)


class ADMMState(NamedTuple):
    """Warm-start state: numpy ``(nbox,)`` vectors on the host path,
    ``(B, nbox)`` tensors on the device."""

    s: Any  # box-projected copy of the bounded rows
    w: Any  # scaled dual


class ADMMStats(NamedTuple):
    """Exit residuals: floats on the host path, ``(B,)`` tensors (one
    per scenario) on the device."""

    primal_residual: Any  # ||Ez - s||_inf at the last iteration
    dual_residual: Any  # rho * ||s - s_prev||_inf at the last iteration
    converged: Any  # both residuals at or below the tolerance


def compute_admm_operator_np(
    spec: QPSpec,
    rho: float | None = None,
    alpha: float = 1.6,
    return_alpha_maps: bool = False,
    return_setpoint_maps: bool = False,
) -> dict:
    """Host float64 pre-factorization of the ADMM z-step.

    Reduced-space maps, with ``t = s - w``::

        v    = v_c + V_theta theta + V_s t
        u    = u_c + U_theta theta + U_s t
        cost = [theta; t]^T cost_P [theta; t] + cost_q . [theta; t] + r

    With ``return_alpha_maps=True`` the dict also carries the affine
    maps of the z-step's alpha block (``a_c``, ``A_theta``, ``A_s``),
    whose 1-norm the NON_CONVEX bound update needs (``qp.nonconvex``).

    With ``return_setpoint_maps=True`` the dict also carries the
    setpoint-delta channels (``dr = r - r_bar``, ``r = [u_s; y_s]``):
    ``V_r`` / ``U_r`` for the box and input rows, and the cost over the
    extended features ``[theta; t; dr]`` (``cost_P_ext``,
    ``cost_q_ext``, PSD because the stage cost is jointly convex in
    ``(z, r)``), centred on ``r_bar``.
    """
    if spec.sigma_bound is None:
        raise ValueError(
            "ADMM solver requires a CONVEX slack constraint (sigma_bound)."
        )
    if not 0.0 < alpha < 2.0:
        raise ValueError(
            f"over-relaxation alpha must be in (0, 2), got {alpha}"
        )
    H, g, A = spec.H, spec.g, spec.A
    nz, nc = spec.nz, spec.nc
    box = spec.sigma_pred_slice
    nbox = box.stop - box.start

    if rho is None:
        # The curvature of the sigma block (Hessian 2*lamb_sigma) keeps
        # the ADMM spectral ratio well-scaled for this family.
        rho = float(np.median(np.diag(H)[box.start : box.stop]))
        rho = max(rho, 1.0)

    E = np.zeros((nbox, nz))
    E[np.arange(nbox), np.arange(box.start, box.stop)] = 1.0

    K = np.zeros((nz + nc, nz + nc))
    K[:nz, :nz] = H + rho * E.T @ E
    K[:nz, nz:] = A.T
    K[nz:, :nz] = A

    n_theta = spec.S.shape[1]
    RHS = np.zeros((nz + nc, 1 + n_theta + nbox))
    RHS[:, 0] = np.concatenate([-g, spec.b_const])
    RHS[nz:, 1 : 1 + n_theta] = spec.S
    RHS[:nz, 1 + n_theta :] = rho * E.T
    X = kkt_multi_solve(K, RHS)
    z_c = X[:nz, 0]
    Z_theta = X[:nz, 1 : 1 + n_theta]
    Z_s = X[:nz, 1 + n_theta :]

    u_sl = spec.u_pred_slice

    # Cost as a quadratic in [theta; t].
    Z_full = np.concatenate([Z_theta, Z_s], axis=1)
    cost_P = 0.5 * Z_full.T @ (H @ Z_full)
    cost_P = 0.5 * (cost_P + cost_P.T)
    cost_q = Z_full.T @ (H @ z_c + g)
    cost_r = 0.5 * z_c @ H @ z_c + g @ z_c + spec.r0

    out_alpha = {}
    if return_alpha_maps:
        a_sl = spec.alpha_slice
        out_alpha = {
            "a_c": z_c[a_sl],
            "A_theta": Z_theta[a_sl],
            "A_s": Z_s[a_sl],
        }

    out_setpoint = {}
    if return_setpoint_maps:
        Gamma, S_r, R0, r_bar = setpoint_channels_np(spec)
        mp = Gamma.shape[1]
        RHS_r = np.zeros((nz + nc, mp))
        RHS_r[:nz] = -Gamma
        RHS_r[nz:] = S_r
        Z_r = kkt_multi_solve(K, RHS_r)[:nz]
        # Joint cost over zhat = [z; dr]: 0.5 zhat' Hhat zhat + ghat'
        # zhat + cost_r, composed with the affine zhat(theta, t, dr).
        Hhat = np.zeros((nz + mp, nz + mp))
        Hhat[:nz, :nz] = H
        Hhat[:nz, nz:] = Gamma
        Hhat[nz:, :nz] = Gamma.T
        Hhat[nz:, nz:] = 2.0 * R0
        ghat = np.concatenate([g, 2.0 * R0 @ r_bar])
        Zhat = np.zeros((nz + mp, n_theta + nbox + mp))
        Zhat[:nz, : n_theta + nbox] = Z_full
        Zhat[:nz, n_theta + nbox :] = Z_r
        Zhat[nz:, n_theta + nbox :] = np.eye(mp)
        zhat_c = np.concatenate([z_c, np.zeros(mp)])
        cost_P_ext = 0.5 * Zhat.T @ (Hhat @ Zhat)
        cost_P_ext = 0.5 * (cost_P_ext + cost_P_ext.T)
        cost_q_ext = Zhat.T @ (Hhat @ zhat_c + ghat)
        # Self-check: restricted to dr = 0 the extended quadratic is the
        # base one.
        nb_ = n_theta + nbox
        if not (
            np.allclose(cost_P_ext[:nb_, :nb_], cost_P, atol=1e-10)
            and np.allclose(cost_q_ext[:nb_], cost_q, atol=1e-10)
        ):
            raise AssertionError(
                "extended setpoint cost does not reduce to the base cost "
                "at dr = 0"
            )
        out_setpoint = {
            "V_r": E @ Z_r,
            "U_r": Z_r[u_sl],
            "cost_P_ext": cost_P_ext,
            "cost_q_ext": cost_q_ext,
            "r_bar": r_bar,
        }

    return {
        **out_alpha,
        **out_setpoint,
        "v_c": E @ z_c,
        "V_theta": E @ Z_theta,
        "V_s": E @ Z_s,
        "u_c": z_c[u_sl],
        "U_theta": Z_theta[u_sl],
        "U_s": Z_s[u_sl],
        "cost_P": cost_P,
        "cost_q": cost_q,
        "cost_r": np.float64(cost_r),
        "bound": np.float64(spec.sigma_bound),
        "rho": np.float64(rho),
        "alpha": np.float64(alpha),
    }


def admm_solve_np(
    op: dict,
    theta: np.ndarray,
    num_iters: int = 100,
    state: tuple | None = None,
    tol: float = 1e-8,
) -> tuple:
    """Host float64 over-relaxed ADMM, warm-started from ``state``, with
    an early exit once both residuals are at or below ``tol``.

    Returns ``(u, cost, ADMMState(s, w), ADMMStats(r_prim, r_dual,
    converged))``.
    """
    nbox = op["v_c"].shape[0]
    s, w = state if state is not None else (np.zeros(nbox), np.zeros(nbox))
    v_theta = op["V_theta"] @ theta
    bound = float(op["bound"])
    rho = float(op["rho"])
    alpha = float(op.get("alpha", 1.0))
    r_prim = r_dual = np.inf
    for _ in range(num_iters):
        v = op["v_c"] + v_theta + op["V_s"] @ (s - w)
        v_hat = alpha * v + (1.0 - alpha) * s
        s_new = np.clip(v_hat + w, -bound, bound)
        w = w + v_hat - s_new
        r_prim = float(np.abs(v - s_new).max(initial=0.0))
        r_dual = rho * float(np.abs(s_new - s).max(initial=0.0))
        s = s_new
        if r_prim <= tol and r_dual <= tol:
            break
    t = s - w
    u = op["u_c"] + op["U_theta"] @ theta + op["U_s"] @ t
    tt = np.concatenate([theta, t])
    cost = float(tt @ op["cost_P"] @ tt + op["cost_q"] @ tt + op["cost_r"])
    converged = bool(r_prim <= tol and r_dual <= tol)
    return u, cost, ADMMState(s, w), ADMMStats(r_prim, r_dual, converged)


def compute_admm_solver(spec: QPSpec, rho: float | None = None,
                        alpha: float = 1.6, device=None,
                        dtype=torch.float32) -> ADMMSolver:
    """The ADMM operator of ``spec`` (host float64) as an
    :class:`ADMMSolver` on ``device`` (None: the CUDA card) in
    ``dtype``; without a card it raises before the host build."""
    device = resolve_device(device)
    op = compute_admm_operator_np(spec, rho=rho, alpha=alpha)
    return ADMMSolver(**_to_device(op, ADMMSolver._fields, device, dtype))


def per_row(a: torch.Tensor) -> torch.Tensor:
    """A scalar operand as is, or one value per scenario ``(B,)`` as a
    column ``(B, 1)`` that broadcasts over a row of ``(B, nbox)``."""
    return a[:, None] if a.ndim == 1 else a


def admm_iterations(vc, V_s, s, w, lo, hi, alpha, rho, n: int):
    """``n`` over-relaxed ADMM iterations on a batch ``(B, nbox)``:
    ``v = vc + V_s (s - w)``, ``v_hat = alpha v + (1 - alpha) s``, ``s =
    clip(v_hat + w, lo, hi)``, ``w += v_hat - s``. ``V_s`` is shared
    ``(nbox, nbox)`` or per scenario ``(B, nbox, nbox)``; ``lo``, ``hi``
    and ``alpha`` broadcast over ``(B, nbox)``, ``rho`` over ``(B,)``.
    Returns ``s``, ``w`` and the last iteration's residuals ``(B,)``
    (zeros when ``n == 0``), which are all a caller reads, so no other
    iteration computes them."""
    r_prim = torch.zeros(s.shape[0], dtype=s.dtype, device=s.device)
    r_dual = r_prim
    beta = 1.0 - alpha
    V_sT = V_s.mT
    for k in range(n):
        if V_s.ndim == 2:
            v = torch.addmm(vc, s - w, V_sT)
        else:
            v = vc + matvec(V_s, s - w)
        v_hat = alpha * v + beta * s
        s_new = torch.clamp(v_hat + w, lo, hi)
        w = w + v_hat - s_new
        if k == n - 1:
            r_prim = (v - s_new).abs().amax(-1)
            r_dual = rho * (s_new - s).abs().amax(-1)
        s = s_new
    return s, w, r_prim, r_dual


def admm_extract(solver: ADMMSolver, theta, t):
    """``u (B, L*m)`` and ``cost (B,)`` at ``t = s - w``."""
    u = solver.u_c + matvec(solver.U_theta, theta) + matvec(solver.U_s, t)
    tt = torch.cat([theta, t], -1)
    cost = (
        (matvec(solver.cost_P, tt) * tt).sum(-1)
        + vecdot(solver.cost_q, tt)
        + solver.cost_r
    )
    return u, cost


@ieee_float32()
def admm_solve(solver: ADMMSolver, theta: torch.Tensor,
               num_iters: int = 100, state: ADMMState | None = None,
               tol: float = 1e-8):
    """``num_iters`` ADMM iterations (no early exit) for a batch of past
    windows ``theta (B, n_theta)``, warm-started from ``state`` (zeros
    by default).

    Returns ``(u (B, L*m), cost (B,), ADMMState, ADMMStats)``: each
    scenario's residuals at the last iteration, and ``converged`` where
    both are at or below ``tol``.
    """
    if state is None:
        nbox = solver.v_c.shape[-1]
        zeros = torch.zeros((theta.shape[0], nbox), dtype=theta.dtype,
                            device=theta.device)
        state = ADMMState(zeros, zeros)
    bound = per_row(solver.bound)
    s, w, r_prim, r_dual = admm_iterations(
        solver.v_c + matvec(solver.V_theta, theta), solver.V_s, state.s,
        state.w, -bound, bound, per_row(solver.alpha), solver.rho,
        num_iters,
    )
    u, cost = admm_extract(solver, theta, s - w)
    stats = ADMMStats(r_prim, r_dual, (r_prim <= tol) & (r_dual <= tol))
    return u, cost, ADMMState(s, w), stats
