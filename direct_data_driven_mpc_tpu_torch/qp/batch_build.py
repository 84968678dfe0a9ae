"""Batched construction of per-realization solution operators.

A heterogeneous Monte-Carlo sweep gives every scenario its own Hankel
data realization, so its own affine solution operator. Built one by one
(:func:`build_solution_operators_fallback`), each costs a dense KKT
factorization on the host. For the ROBUST slack-NONE family with
diagonal Q/R (the standard configuration) the Hessian is diagonal, and
:func:`build_batched_solution_operators` replaces that loop by one
structured batched elimination on a device:

1. Selection-pinned variables (internal-state rows pin ubar/ybar's
   first n blocks to theta; terminal rows pin the last n blocks to the
   tiled setpoints) are eliminated symbolically: their values are affine
   in theta by inspection.
2. The remaining free variables have strictly positive diagonal
   curvature (alpha/sigma ridges, prediction-segment R/Q), so the
   dynamics-row multipliers solve a Schur system

       S_c = (1/h_alpha) G G^T + diag(c),   G = [H_u; H_y],

   one batched ``(B, n_dyn, n_alpha)`` product and one batched
   ``(B, n_dyn, n_dyn)`` solve per chunk, in float64.

Non-diagonal weights or NOMINAL controllers (singular Hessian) take the
serial fallback. :func:`stacked_solution_map` casts a batch of operators
into a :class:`~direct_data_driven_mpc_tpu_torch.qp.solution_map.\
SolutionMap` with a leading scenario axis, the input of
``parallel.batch.heterogeneous_closed_loop``.

Counterpart of ``direct_data_driven_mpc_tpu/qp/batch_build.py``, whose
batched build runs in numpy on the host; here it runs in torch float64
on the entry point's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from direct_data_driven_mpc_tpu_torch.device import resolve_device
from direct_data_driven_mpc_tpu_torch.qp.solution_map import (
    SolutionMap,
    _check_dtype_supported,
)
from direct_data_driven_mpc_tpu_torch.qp.spec import (
    DataDrivenMPCType,
    QPDims,
    SlackVarConstraintTypes,
)

#: Keys of a batch of operators, each with a leading realization axis.
BATCHED_OPERATOR_KEYS = (
    "z_base", "Z", "u_base", "U_gain", "cost_P", "cost_q", "cost_r",
    "feasible",
)


def _is_diagonal(M: np.ndarray) -> bool:
    return bool(
        np.abs(M - np.diag(np.diag(M))).max(initial=0.0)
        <= 1e-12 * max(1.0, np.abs(M).max(initial=0.0))
    )


def build_batched_solution_operators(
    HLn_ud,
    HLn_yd,
    dims: QPDims,
    Q: np.ndarray,
    R: np.ndarray,
    u_s: np.ndarray,
    y_s: np.ndarray,
    eps_max: float,
    lamb_alpha: float,
    lamb_sigma: float,
    use_terminal_constraint: bool = True,
    chunk: int = 512,
    device=None,
) -> dict:
    """Build B solution operators from batched Hankel data in one
    structured batched factorization on ``device`` (None: the CUDA
    card).

    Args:
        HLn_ud: ``(B, (L+n)m, n_alpha)`` input Hankel matrices (numpy or
            a tensor).
        HLn_yd: ``(B, (L+n)p, n_alpha)`` output Hankel matrices.
        dims, Q, R, u_s, y_s, eps_max, lamb_alpha, lamb_sigma,
        use_terminal_constraint: as in ``assembly.build_qp_spec``
        (ROBUST, slack NONE implied -- see module docstring).
        chunk: realizations per batched solve (memory knob).

    Returns:
        dict of float64 tensors on ``device`` with the keys of
        ``solution_map.compute_solution_operator_np`` (leading batch
        axis) plus the feasibility certificate ``feasible``, bool of
        shape ``(B,)``.

    Raises:
        NotImplementedError: non-diagonal Q/R (use the serial fallback).
        ValueError: NOMINAL weights (eps_max, lamb_alpha or lamb_sigma
            not positive), or Hankel batches of the wrong shape.
    """
    Q = np.asarray(Q, dtype=np.float64)
    R = np.asarray(R, dtype=np.float64)
    if not (_is_diagonal(Q) and _is_diagonal(R)):
        raise NotImplementedError(
            "Batched operator construction requires diagonal Q/R "
            "weighting blocks; use build_solution_operators_fallback."
        )
    if min(float(eps_max), float(lamb_alpha), float(lamb_sigma)) <= 0:
        raise ValueError(
            "Batched construction covers the ROBUST family "
            "(eps_max, lamb_alpha, lamb_sigma > 0); NOMINAL operators "
            "(singular Hessian) use the serial fallback."
        )
    device = resolve_device(device)
    f64 = torch.float64

    n, m, p, L = dims.n, dims.m, dims.p, dims.L
    na, n_u, n_y = dims.n_alpha, dims.n_u, dims.n_y
    n_theta = dims.n_theta
    HLn_ud = torch.as_tensor(HLn_ud, dtype=f64, device=device)
    HLn_yd = torch.as_tensor(HLn_yd, dtype=f64, device=device)
    B = HLn_ud.shape[0]
    if (tuple(HLn_ud.shape) != (B, n_u, na)
            or tuple(HLn_yd.shape) != (B, n_y, na)):
        raise ValueError(
            f"Hankel batches must be {(B, n_u, na)} / {(B, n_y, na)}; "
            f"got {tuple(HLn_ud.shape)} / {tuple(HLn_yd.shape)}."
        )
    u_s = np.asarray(u_s, dtype=np.float64).reshape(-1)
    y_s = np.asarray(y_s, dtype=np.float64).reshape(-1)

    # --- Layout (matches assembly.build_qp_spec) ----------------------
    # The realization-independent pieces are built on the host in
    # float64, as the JAX package builds them, then moved once.
    nz = na + n_u + 2 * n_y
    a0, u0, y0, s0 = 0, na, na + n_u, na + n_u + n_y
    n_dyn = n_u + n_y
    nm, npp = n * m, n * p
    u_sL, y_sL = np.tile(u_s, L), np.tile(y_s, L)

    # Diagonal Hessian d and gradient g.
    h_alpha = 2.0 * float(lamb_alpha) * float(eps_max)
    h_sigma = 2.0 * float(lamb_sigma)
    d = np.zeros(nz)
    g = np.zeros(nz)
    d[a0:u0] = h_alpha
    d[u0 + nm : u0 + n_u] = 2.0 * np.diag(R)
    d[y0 + npp : y0 + n_y] = 2.0 * np.diag(Q)
    d[s0:] = h_sigma
    g[u0 + nm : u0 + n_u] = -2.0 * np.diag(R) * u_sL
    g[y0 + npp : y0 + n_y] = -2.0 * np.diag(Q) * y_sL
    r0 = float(u_sL @ (np.diag(R) * u_sL) + y_sL @ (np.diag(Q) * y_sL))

    # Pinned variables: value = pin_base + pin_theta @ theta. Internal
    # rows pin ubar[:nm] = theta_u, ybar[:np] = theta_y; terminal rows
    # pin the last n blocks to the tiled setpoints.
    pinned = np.zeros(nz, dtype=bool)
    pin_base = np.zeros(nz)
    pin_theta = np.zeros((nz, n_theta))
    pinned[u0 : u0 + nm] = True
    pin_theta[u0 : u0 + nm, 0:nm] = np.eye(nm)
    pinned[y0 : y0 + npp] = True
    pin_theta[y0 : y0 + npp, nm : nm + npp] = np.eye(npp)
    if use_terminal_constraint:
        pinned[u0 + L * m : u0 + n_u] = True
        pin_base[u0 + L * m : u0 + n_u] = np.tile(u_s, n)
        pinned[y0 + L * p : y0 + n_y] = True
        pin_base[y0 + L * p : y0 + n_y] = np.tile(y_s, n)

    u_pin = pinned[u0 : u0 + n_u]  # per dynamics-u row
    y_pin = pinned[y0 : y0 + n_y]  # per dynamics-y row
    d_u = d[u0 : u0 + n_u]
    d_y = d[y0 : y0 + n_y]
    g_u = g[u0 : u0 + n_u]
    g_y = g[y0 : y0 + n_y]

    # Constant diagonal of the Schur complement (free-identity columns
    # of the dynamics rows): free ubar_i adds 1/d_u_i to row i; free
    # ybar_j adds 1/d_y_j; sigma_j always adds 1/h_sigma to row n_u+j.
    c0 = np.zeros(n_dyn)
    c0[:n_u] = np.where(u_pin, 0.0, 1.0 / np.where(u_pin, 1.0, d_u))
    c0[n_u:] = (
        np.where(y_pin, 0.0, 1.0 / np.where(y_pin, 1.0, d_y))
        + 1.0 / h_sigma
    )

    # Multi-RHS columns: [base | theta_1 .. theta_n_theta].
    ncol = 1 + n_theta
    # Stationarity contribution A_dF D^-1 w (w = -g, col 0 only; the
    # alpha and sigma gradients are zero).
    r1 = np.zeros((n_dyn, ncol))
    r1[:n_u, 0] = np.where(u_pin, 0.0, -g_u / np.where(u_pin, 1.0, d_u))
    r1[n_u:, 0] = np.where(y_pin, 0.0, -g_y / np.where(y_pin, 1.0, d_y))
    # Constraint RHS: dynamics rows read 0 = A_dF z_F + v_pinned, so
    # b_reduced = -v_pinned(theta) at pinned rows.
    b_red = np.zeros((n_dyn, ncol))
    b_red[:n_u, 0] = -pin_base[u0 : u0 + n_u]
    b_red[:n_u, 1:] = -pin_theta[u0 : u0 + n_u]
    b_red[n_u:, 0] = -pin_base[y0 : y0 + n_y]
    b_red[n_u:, 1:] = -pin_theta[y0 : y0 + n_y]

    # Stationarity RHS per column for the free-variable recovery (w = -g
    # in the base column only; theta columns carry zero w), divided by
    # the curvature, and the free rows' masks.
    safe_du = np.where(u_pin, 1.0, d_u)
    safe_dy = np.where(y_pin, 1.0, d_y)
    w_u = np.zeros((n_u, ncol))
    w_u[:, 0] = -g_u
    w_y = np.zeros((n_y, ncol))
    w_y[:, 0] = -g_y

    def dev(a):
        return torch.as_tensor(a, dtype=f64, device=device)

    c0_t, rhs_const = dev(c0), dev(r1 - b_red)
    free_u = torch.as_tensor(~u_pin, device=device)[:, None]
    free_y = torch.as_tensor(~y_pin, device=device)[:, None]
    w_u_t, w_y_t = dev(w_u), dev(w_y)
    safe_du_t, safe_dy_t = dev(safe_du)[:, None], dev(safe_dy)[:, None]
    pin_idx = torch.as_tensor(np.flatnonzero(pinned), device=device)
    pin_base_t = dev(pin_base[pinned])
    pin_theta_t = dev(pin_theta[pinned])
    d_t, g_t = dev(d), dev(g)
    scale = max(1.0, np.abs(u_s).max(initial=0.0),
                np.abs(y_s).max(initial=0.0))
    diag = torch.arange(n_dyn, device=device)

    z_out = torch.zeros((B, nz, ncol), dtype=f64, device=device)
    feasible = torch.zeros(B, dtype=torch.bool, device=device)

    for lo in range(0, B, chunk):
        hi = min(lo + chunk, B)
        G = torch.cat([HLn_ud[lo:hi], HLn_yd[lo:hi]], 1)  # (Bc, n_dyn, na)
        Gt = G.transpose(1, 2)
        # Schur complement: one batched product + constant diagonal.
        S_c = (G @ Gt) / h_alpha
        S_c[:, diag, diag] += c0_t
        nu = torch.linalg.solve(S_c, rhs_const.expand(hi - lo, -1, -1))

        # Free-variable recovery: z_F = D^-1 (w - A_dF^T nu).
        z = z_out[lo:hi]
        z[:, a0:u0] = (Gt @ nu) / h_alpha
        nu_u, nu_y = nu[:, :n_u], nu[:, n_u:]
        z[:, u0 : u0 + n_u] = torch.where(
            free_u, (w_u_t - nu_u) / safe_du_t, 0.0
        )
        z[:, y0 : y0 + n_y] = torch.where(
            free_y, (w_y_t - nu_y) / safe_dy_t, 0.0
        )
        z[:, s0:] = -nu_y / h_sigma
        # Pinned rows (affine in theta by construction).
        z[:, pin_idx, 0] += pin_base_t
        z[:, pin_idx, 1:] += pin_theta_t

        # Feasibility certificate: the dynamics identities must hold
        # for every theta column (selection rows hold by construction).
        res_u = z[:, u0 : u0 + n_u] - G[:, :n_u] @ z[:, a0:u0]
        res_y = z[:, y0 : y0 + n_y] + z[:, s0:] - G[:, n_u:] @ z[:, a0:u0]
        res = torch.maximum(res_u.abs().amax((1, 2)),
                            res_y.abs().amax((1, 2)))
        feasible[lo:hi] = res < 1e-7 * scale

    z_base = z_out[:, :, 0]
    Z = z_out[:, :, 1:]

    # Cost as a quadratic in theta (the formulas of
    # compute_solution_operator_np; H is diagonal here).
    Zt = Z.transpose(1, 2)
    cost_P = 0.5 * (Zt @ (d_t[:, None] * Z))
    cost_P = 0.5 * (cost_P + cost_P.transpose(1, 2))
    cost_q = (Zt @ (d_t * z_base + g_t)[:, :, None])[:, :, 0]
    cost_r = (
        0.5 * (z_base * (d_t * z_base)).sum(1)
        + z_base @ g_t
        + r0
    )

    u_pred = slice(u0 + nm, u0 + n_u)
    return {
        "z_base": z_base,
        "Z": Z,
        "u_base": z_base[:, u_pred],
        "U_gain": Z[:, u_pred],
        "cost_P": cost_P,
        "cost_q": cost_q,
        "cost_r": cost_r,
        "feasible": feasible,
    }


def build_solution_operators_fallback(
    HLn_ud: np.ndarray,
    HLn_yd: np.ndarray,
    dims: QPDims,
    Q: np.ndarray,
    R: np.ndarray,
    u_s: np.ndarray,
    y_s: np.ndarray,
    controller_type: DataDrivenMPCType = DataDrivenMPCType.ROBUST,
    eps_max: Optional[float] = None,
    lamb_alpha: Optional[float] = None,
    lamb_sigma: Optional[float] = None,
    c: Optional[float] = None,
    use_terminal_constraint: bool = True,
) -> dict:
    """Serial per-realization construction on the host (any weights,
    NOMINAL included): ``qp.assembly.build_qp_spec`` and
    ``compute_solution_operator_np`` per realization, stacked to float64
    numpy arrays with the keys of
    :func:`build_batched_solution_operators`."""
    from direct_data_driven_mpc_tpu_torch.qp.assembly import build_qp_spec
    from direct_data_driven_mpc_tpu_torch.qp.solution_map import (
        compute_solution_operator_np,
    )

    ops = []
    for Hu, Hy in zip(np.asarray(HLn_ud), np.asarray(HLn_yd)):
        spec = build_qp_spec(
            Hu, Hy, dims, Q, R, u_s, y_s,
            controller_type=controller_type,
            eps_max=eps_max, lamb_alpha=lamb_alpha,
            lamb_sigma=lamb_sigma, c=c,
            slack_var_constraint_type=SlackVarConstraintTypes.NONE,
            use_terminal_constraint=use_terminal_constraint,
        )
        ops.append(compute_solution_operator_np(spec))
    return {k: np.stack([np.asarray(op[k]) for op in ops])
            for k in BATCHED_OPERATOR_KEYS}


def stacked_solution_map(ops: dict, dtype=None,
                         device=None) -> SolutionMap:
    """A :class:`SolutionMap` with a leading scenario axis on ``device``
    (None: the CUDA card) in ``dtype`` (None: float32, as in the JAX
    package), from a batch of operators (tensors or numpy arrays) -- the
    direct input to ``parallel.batch.heterogeneous_closed_loop``."""
    if dtype is None:
        dtype = torch.float32
    _check_dtype_supported(dtype)
    device = resolve_device(device)
    return SolutionMap(**{
        k: torch.as_tensor(ops[k], dtype=dtype, device=device)
        for k in SolutionMap._fields
    })
