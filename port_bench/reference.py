"""Plain reference of the benchmark's deployments: the Robust
data-driven MPC of Berberich et al. (IEEE TAC 2021, Sec. V) in closed
loop with its LTI plant.

Written from the paper, not from the program, and imports nothing of
it. The QP is posed in the variables ``x = [alpha; sigma]`` alone
(``ubar = H_u alpha``, ``ybar = H_y alpha - sigma`` substituted), so its
matrices share no code or layout with the program's host build; the
optimum, and so every input applied, is the same.

Host build, float64 numpy: Hankel matrices, the QP, and its affine maps
over the past window ``theta = [u_past; y_past]`` (slack NONE: the
exact solution map) or over ``[theta; t]`` with ``t = s - w`` (CONVEX:
the z-step of over-relaxed ADMM on the slack box). Closed loop, torch in
any dtype on any device: ``matmul`` is plain, or rounds both operands to
TF32 first (:func:`tf32`), which is the control of the output check.
"""

from __future__ import annotations

import numpy as np
import torch


def hankel(x: np.ndarray, depth: int) -> np.ndarray:
    """Block Hankel matrix of depth ``depth`` of a ``(N, d)`` sequence:
    column j is ``x[j : j + depth]`` stacked time-major."""
    N, d = x.shape
    cols = N - depth + 1
    return np.stack([x[j : j + depth].reshape(-1) for j in range(cols)], 1)


def simulate(A, B, C, D, u, w, x0):
    """``(y, x_final)`` of ``x' = A x + B u``, ``y = C x + D u + w`` over
    the rows of ``u`` and ``w`` (float64 numpy)."""
    x = np.array(x0, dtype=np.float64)
    y = np.empty((u.shape[0], C.shape[0]))
    for k in range(u.shape[0]):
        y[k] = C @ x + D @ u[k] + w[k]
        x = A @ x + B @ u[k]
    return y, x


class RobustQP:
    """The Robust scheme's QP at one data set, in ``x = [alpha; sigma]``:
    ``min 1/2 x'Hx + g'x + r0`` subject to ``Aeq x = b0 + Bt theta``
    (initial window and terminal setpoint rows) and, for the CONVEX
    slack, ``|sigma_k| <= c eps_bar`` over the L predicted blocks."""

    def __init__(self, u_d, y_d, ctrl: dict):
        if (ctrl["controller_type"], ctrl["n_mpc_step"]) != (1, 1):
            raise NotImplementedError(
                "the reference models the Robust scheme with one input "
                "applied per solve")
        n, L = ctrl["n"], ctrl["L"]
        u_s = np.asarray(ctrl["u_s"], np.float64)
        y_s = np.asarray(ctrl["y_s"], np.float64)
        m, p = u_s.size, y_s.size
        eps = float(ctrl["epsilon_bar"])
        Hu = hankel(np.asarray(u_d, np.float64), L + n)
        Hy = hankel(np.asarray(y_d, np.float64), L + n)
        na, ns = Hu.shape[1], (L + n) * p
        nx = na + ns
        sig = np.zeros((ns, nx))
        sig[:, na:] = np.eye(ns)
        alp = np.zeros((na, nx))
        alp[:, :na] = np.eye(na)
        ubar = np.concatenate([Hu, np.zeros((Hu.shape[0], ns))], 1)
        ybar = np.concatenate([Hy, np.zeros((Hy.shape[0], ns))], 1) - sig
        pu = slice(n * m, (n + L) * m)  # predicted blocks k = 0 .. L-1
        py = slice(n * p, (n + L) * p)
        # Cost as weighted residuals sum_i w_i ||M_i x - c_i||^2.
        terms = [
            (float(ctrl["R_scalar"]), ubar[pu], np.tile(u_s, L)),
            (float(ctrl["Q_scalar"]), ybar[py], np.tile(y_s, L)),
            (float(ctrl["lambda_alpha_epsilon_bar"]), alp, np.zeros(na)),
            (float(ctrl["lambda_sigma"]), sig, np.zeros(ns)),
        ]
        self.H = sum(2 * w * M.T @ M for w, M, _ in terms)
        self.g = sum(-2 * w * M.T @ c for w, M, c in terms)
        self.r0 = float(sum(w * c @ c for w, _, c in terms))
        n_theta = n * (m + p)
        self.Aeq = np.concatenate(
            [ubar[: n * m], ybar[: n * p], ubar[L * m :], ybar[L * p :]], 0)
        self.b0 = np.concatenate([np.zeros(n_theta), np.tile(u_s, n),
                                  np.tile(y_s, n)])
        self.Bt = np.zeros((self.Aeq.shape[0], n_theta))
        self.Bt[:n_theta] = np.eye(n_theta)
        self.E = sig[py]  # the slack box's rows
        self.u0 = ubar[n * m : (n + 1) * m]  # the first applied input
        self.bound = float(ctrl["c"]) * eps
        self.n, self.m, self.p, self.n_theta = n, m, p, n_theta

    def solve(self, P: np.ndarray, rhs_x: np.ndarray, rhs_c: np.ndarray):
        """``x`` of the KKT system ``[P Aeq'; Aeq 0] [x; nu] = [rhs_x;
        rhs_c]`` for each column of the right-hand sides."""
        nx, nc = P.shape[0], self.Aeq.shape[0]
        K = np.zeros((nx + nc, nx + nc))
        K[:nx, :nx] = P
        K[:nx, nx:] = self.Aeq.T
        K[nx:, :nx] = self.Aeq
        return np.linalg.solve(K, np.concatenate([rhs_x, rhs_c], 0))[:nx]

    def cost_form(self, xc: np.ndarray, X: np.ndarray):
        """``(P, q, r)`` of the objective at ``x = xc + X f``, as
        ``f'Pf + q'f + r``."""
        P = 0.5 * X.T @ self.H @ X
        return (0.5 * (P + P.T), X.T @ (self.H @ xc + self.g),
                float(0.5 * xc @ self.H @ xc + self.g @ xc + self.r0))


def solution_maps(qp: RobustQP) -> dict:
    """Slack NONE: the exact optimum ``x(theta) = xc + X theta``, the
    applied input ``u = u_c + U theta`` and the optimal cost over
    ``theta``."""
    nt = qp.n_theta
    rhs_x = np.concatenate([-qp.g[:, None], np.zeros((qp.H.shape[0], nt))],
                           1)
    rhs_c = np.concatenate([qp.b0[:, None], qp.Bt], 1)
    sol = qp.solve(qp.H, rhs_x, rhs_c)
    xc, X = sol[:, 0], sol[:, 1:]
    P, q, r = qp.cost_form(xc, X)
    return dict(u_c=qp.u0 @ xc, U=qp.u0 @ X, P=P, q=q, r=r)


def admm_maps(qp: RobustQP, rho: float) -> dict:
    """CONVEX: the ADMM z-step ``x(theta, t) = argmin 1/2 x'Hx + g'x +
    rho/2 ||E x - t||^2`` subject to the equalities, as affine maps over
    ``f = [theta; t]``: the box rows ``v = E x``, the applied input and
    the objective at ``x``."""
    nt, nb, nx = qp.n_theta, qp.E.shape[0], qp.H.shape[0]
    rhs_x = np.concatenate(
        [-qp.g[:, None], np.zeros((nx, nt)), rho * qp.E.T], 1)
    rhs_c = np.concatenate(
        [qp.b0[:, None], qp.Bt, np.zeros((qp.Bt.shape[0], nb))], 1)
    sol = qp.solve(qp.H + rho * qp.E.T @ qp.E, rhs_x, rhs_c)
    xc, X = sol[:, 0], sol[:, 1:]
    P, q, r = qp.cost_form(xc, X)
    return dict(v_c=qp.E @ xc, V=qp.E @ X, u_c=qp.u0 @ xc, U=qp.u0 @ X,
                P=P, q=q, r=r, bound=qp.bound)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest
    even, as the tensor cores read a float32 operand."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def make_matmul(control: bool):
    """``a @ b``, or with ``control`` on both operands rounded to TF32
    (float32 accumulation)."""
    if control:
        return lambda a, b: tf32(a) @ tf32(b)
    return torch.matmul


def closed_loop(plant: dict, maps: dict, solver, x0, u_past, y_past, W,
                dtype=torch.float64, control: bool = False) -> dict:
    """Every scenario's closed loop over the noise ``W (R, T, p)`` (a
    tensor, whose device is used), from the plant state ``x0 (ns,)`` and
    the windows ``u_past (n, m)``, ``y_past (n, p)`` (numpy).

    ``solver`` None: the exact solution map. Else ``dict(rho, alpha,
    n_iter, cold_iters, tol)``: over-relaxed ADMM on the slack box with
    ``t = s - w``, ``cold_iters`` iterations from zero before the first
    solve, ``n_iter`` per solve warm-started from the last, then the
    input and cost at the z-step of the final ``t``; the residuals of
    the last iteration (primal ``max |v - s|``, dual ``rho max |s -
    s_prev|``) against ``tol`` give ``converged``.

    Returns float64 numpy arrays ``u (R, T, m)``, ``y (R, T, p)``,
    ``costs (R, T)``, ``x_final (R, ns)``, ``u_past (R, n, m)``,
    ``y_past (R, n, p)``, the boolean ``converged (R, T)`` (the exact
    map: a finite cost) and, with ADMM, the final ``solver_state (R, 2
    nbox)`` (``[s | w]``) and ``residual (R, T)``, the larger residual
    of each solve over ``tol``. ``control`` computes in float32 with
    every product's operands in TF32."""
    dev = W.device
    if control:
        dtype = torch.float32
    mm = make_matmul(control)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    A, B, C, D = (t(plant[k]).T.contiguous() for k in "ABCD")
    R, T, p = W.shape
    n, m = np.asarray(u_past).shape
    W = W.to(dtype)
    x = t(x0).expand(R, -1).contiguous()
    up = t(u_past).expand(R, n, m).contiguous()
    yp = t(y_past).expand(R, n, p).contiguous()
    U_T = t(maps["U"]).T.contiguous()
    P, q, r = t(maps["P"]), t(maps["q"]), float(maps["r"])
    u_c = t(maps["u_c"])
    out_u = torch.empty((R, T, m), dtype=dtype, device=dev)
    out_y = torch.empty((R, T, p), dtype=dtype, device=dev)
    costs = torch.empty((R, T), dtype=dtype, device=dev)
    resid = None
    if solver is not None:
        nt = n * (m + p)
        Vt_T = t(maps["V"][:, :nt]).T.contiguous()
        Vs_T = t(maps["V"][:, nt:]).T.contiguous()
        v_c, bound = t(maps["v_c"]), float(maps["bound"])
        rho, a = float(solver["rho"]), float(solver["alpha"])
        nbox = Vs_T.shape[0]
        s = torch.zeros((R, nbox), dtype=dtype, device=dev)
        w = torch.zeros_like(s)
        resid = torch.empty((R, T), dtype=dtype, device=dev)
        conv = torch.empty((R, T), dtype=torch.bool, device=dev)

        def iterate(s, w, vc, k):
            v = s_prev = s
            for _ in range(k):
                v = mm(s - w, Vs_T) + vc
                vh = a * v + (1 - a) * s
                s_prev, s = s, torch.clamp(vh + w, -bound, bound)
                w = w + vh - s
            return s, w, v, s_prev

    for k in range(T):
        theta = torch.cat([up.reshape(R, -1), yp.reshape(R, -1)], 1)
        if solver is None:
            f = theta
            u = u_c + mm(theta, U_T)
        else:
            vc = v_c + mm(theta, Vt_T)
            if k == 0:
                s, w, _, _ = iterate(s, w, vc, int(solver["cold_iters"]))
            s, w, v, s_prev = iterate(s, w, vc, int(solver["n_iter"]))
            rp = (v - s).abs().amax(1)
            rd = rho * (s - s_prev).abs().amax(1)
            conv[:, k] = (rp <= solver["tol"]) & (rd <= solver["tol"])
            resid[:, k] = torch.maximum(rp, rd) / solver["tol"]
            f = torch.cat([theta, s - w], 1)
            u = u_c + mm(f, U_T)
        costs[:, k] = (mm(f, P) * f).sum(1) + mm(f, q[:, None])[:, 0] + r
        y = mm(x, C) + mm(u, D) + W[:, k]
        x = mm(x, A) + mm(u, B)
        out_u[:, k], out_y[:, k] = u, y
        up = torch.cat([up[:, 1:], u[:, None]], 1)
        yp = torch.cat([yp[:, 1:], y[:, None]], 1)
    res = dict(u=out_u, y=out_y, costs=costs, x_final=x, u_past=up,
               y_past=yp, converged=torch.isfinite(costs))
    if resid is not None:
        res["converged"] = conv
        res["residual"] = resid
        res["solver_state"] = torch.cat([s, w], 1)
    return {k: v.cpu().numpy().astype(np.float64) if v.dtype != torch.bool
            else v.cpu().numpy() for k, v in res.items()}
