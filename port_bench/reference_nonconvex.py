"""Plain reference of the Robust scheme with the paper's own slack
constraint, Eq. (6d) of Berberich et al. (IEEE TAC 2021):

    ||sigma_k(t)||_inf  <=  c eps_bar (1 + ||alpha(t)||_1),

in closed loop with its LTI plant. Written from the paper, and imports
nothing of the program: the QP and the z-step of over-relaxed ADMM on
the slack box are ``port_bench/reference.py``'s (``RobustQP``,
``admm_maps``), by import, and alpha is the first ``n_alpha`` rows of the
same z-step solution, solved here again from ``RobustQP.solve``.

The non-convex constraint is solved by the fixed point the configuration
states: the bound starts at ``c eps_bar`` (the Convex box, before the
first solve); each solve runs ``outer`` blocks of ``inner`` iterations
clipped at ``+-bound``, each block followed by ``bound = c eps_bar (1 +
||alpha(theta, s - w)||_1)``; the bound, like ``s`` and ``w``, carries
to the next solve. ``converged``: the last iteration's residuals at
``tol``, the last update's relative step ``|bound' - bound| / (c eps_bar
+ bound')`` at ``outer_tol``, and the final iterate feasible:
``max |sigma_pred| - bound`` at most ``max(tol, FEAS_REL (1 + bound))``,
``sigma_pred`` the box rows at the final ``t = s - w``.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench import reference

#: The feasibility floor of the fixed point's rule: 10 float32 eps, the
#: violation that one rounding of the box rows can leave at the
#: configuration's precision (float32).
FEAS_REL = 10 * float(np.finfo(np.float32).eps)


def nonconvex_maps(qp: reference.RobustQP, rho: float) -> dict:
    """``admm_maps`` with the alpha rows of the same z-step: ``alpha =
    a_c + A f`` over ``f = [theta; t]``, and ``c_eps = c eps_bar``."""
    maps = reference.admm_maps(qp, rho)
    nt, nb, nx = qp.n_theta, qp.E.shape[0], qp.H.shape[0]
    rhs_x = np.concatenate(
        [-qp.g[:, None], np.zeros((nx, nt)), rho * qp.E.T], 1)
    rhs_c = np.concatenate(
        [qp.b0[:, None], qp.Bt, np.zeros((qp.Bt.shape[0], nb))], 1)
    sol = qp.solve(qp.H + rho * qp.E.T @ qp.E, rhs_x, rhs_c)
    # x = [alpha; sigma], sigma (L + n) p long: the L p box rows and the
    # n p of the initial window.
    n_alpha = nx - nb - qp.n * qp.p
    maps["a_c"], maps["A"] = sol[:n_alpha, 0], sol[:n_alpha, 1:]
    maps["c_eps"] = qp.bound
    return maps


def closed_loop(plant: dict, maps: dict, solver: dict, x0, u_past, y_past,
                W, dtype=torch.float64, control: bool = False) -> dict:
    """Every scenario's closed loop over the noise ``W (R, T, p)`` (its
    device is used), as ``reference.closed_loop`` runs the Convex one,
    with the Eq. 6d fixed point of ``solver = dict(rho, alpha, inner,
    outer, tol, outer_tol)``. Returns float64 numpy arrays as
    ``reference.closed_loop`` does, with ``solver_state (R, 2 nbox + 1)``
    ``[s | w | bound]`` and ``residual (R, T)``, the larger residual of
    each solve over ``tol``; ``control`` computes in float32 with every
    product's operands in TF32."""
    dev = W.device
    if control:
        dtype = torch.float32
    mm = reference.make_matmul(control)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    A, B, C, D = (t(plant[k]).T.contiguous() for k in "ABCD")
    R, T, p = W.shape
    n, m = np.asarray(u_past).shape
    nt = n * (m + p)
    W = W.to(dtype)
    x = t(x0).expand(R, -1).contiguous()
    up = t(u_past).expand(R, n, m).contiguous()
    yp = t(y_past).expand(R, n, p).contiguous()
    U_T = t(maps["U"]).T.contiguous()
    P, q, r = t(maps["P"]), t(maps["q"]), float(maps["r"])
    u_c = t(maps["u_c"])
    Vt_T = t(maps["V"][:, :nt]).T.contiguous()
    Vs_T = t(maps["V"][:, nt:]).T.contiguous()
    v_c = t(maps["v_c"])
    A_T, a_c = t(maps["A"]).T.contiguous(), t(maps["a_c"])
    c_eps = float(maps["c_eps"])
    rho, a = float(solver["rho"]), float(solver["alpha"])
    tol = float(solver["tol"])
    nbox = Vs_T.shape[0]
    s = torch.zeros((R, nbox), dtype=dtype, device=dev)
    w = torch.zeros_like(s)
    bound = torch.full((R,), c_eps, dtype=dtype, device=dev)
    out_u = torch.empty((R, T, m), dtype=dtype, device=dev)
    out_y = torch.empty((R, T, p), dtype=dtype, device=dev)
    costs = torch.empty((R, T), dtype=dtype, device=dev)
    resid = torch.empty((R, T), dtype=dtype, device=dev)
    conv = torch.empty((R, T), dtype=torch.bool, device=dev)
    for k in range(T):
        theta = torch.cat([up.reshape(R, -1), yp.reshape(R, -1)], 1)
        vc = v_c + mm(theta, Vt_T)
        for _ in range(int(solver["outer"])):
            lim = bound[:, None]
            for _ in range(int(solver["inner"])):
                v = mm(s - w, Vs_T) + vc
                vh = a * v + (1 - a) * s
                s_prev, s = s, torch.clamp(vh + w, -lim, lim)
                w = w + vh - s
            alpha = a_c + mm(torch.cat([theta, s - w], 1), A_T)
            new = c_eps * (1 + alpha.abs().sum(1))
            step = (new - bound).abs() / (c_eps + new)
            bound = new
        rp = (v - s).abs().amax(1)
        rd = rho * (s - s_prev).abs().amax(1)
        f = torch.cat([theta, s - w], 1)
        sigma = mm(s - w, Vs_T) + vc
        viol = torch.clamp(sigma.abs().amax(1) - bound, min=0)
        feas = torch.clamp(FEAS_REL * (1 + bound), min=tol)
        conv[:, k] = ((rp <= tol) & (rd <= tol)
                      & (step <= float(solver["outer_tol"])) & (viol <= feas))
        resid[:, k] = torch.maximum(rp, rd) / tol
        u = u_c + mm(f, U_T)
        costs[:, k] = (mm(f, P) * f).sum(1) + mm(f, q[:, None])[:, 0] + r
        y = mm(x, C) + mm(u, D) + W[:, k]
        x = mm(x, A) + mm(u, B)
        out_u[:, k], out_y[:, k] = u, y
        up = torch.cat([up[:, 1:], u[:, None]], 1)
        yp = torch.cat([yp[:, 1:], y[:, None]], 1)
    res = dict(u=out_u, y=out_y, costs=costs, x_final=x, u_past=up,
               y_past=yp, converged=conv, residual=resid,
               solver_state=torch.cat([s, w, bound[:, None]], 1))
    return {k: v.cpu().numpy().astype(np.float64) if v.dtype != torch.bool
            else v.cpu().numpy() for k, v in res.items()}
