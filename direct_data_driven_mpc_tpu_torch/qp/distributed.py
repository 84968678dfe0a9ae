"""Distributed iterative KKT solver: alpha-sharded PMINRES over a mesh.

Counterpart of ``direct_data_driven_mpc_tpu/qp/distributed.py`` on
``torch.distributed``. The direct solution operator (``qp.solution_map``)
factorises the KKT system on one host; when a single QP outgrows one
device (a wide Hankel, ``N - L - n + 1`` columns), the KKT system itself
is sharded:

- The alpha block (the Hankel columns) is split over the mesh's
  ``model`` dim: each rank holds a column shard of ``H_u`` / ``H_y`` and
  the matching slice of alpha, padded to a multiple of the dim's size
  (padded lanes carry zero data and preconditioner 1, so they stay 0).
- One MINRES iteration is local block products plus three collectives
  over ``model``: one ``all_reduce`` of the stacked ``(n_u + n_y)``
  vector ``[H_u; H_y] alpha`` (JAX's two ``psum``s) and one of the alpha
  part of each of the two inner products.
- MINRES (Paige-Saunders recurrences) takes the symmetric indefinite,
  and for NOMINAL singular but consistent, KKT matrix; a diagonal
  preconditioner ``M = sqrt(diag(K^2))`` (the KKT rows' 2-norms)
  equilibrates the block scales (R ~ 1e-4 against lamb_sigma ~ 1e3).
- The iteration exits on the preconditioned residual estimate; the true
  relative residual is computed at exit (one more product), and
  ``refine`` restarts push float32 below its stagnation floor.

Scenarios run batched, the scenario axis leading every tensor, as JAX's
``vmap`` of a one-scenario ``while_loop`` runs them: a scenario that has
met its tolerance keeps its whole carry (``torch.where``) while the others
go on, and the loop ends when none is left, checked on the host once per
chunk of iterations. The exit decision reads only all-reduced quantities
(and the replicated blocks, computed alike on every rank), so every rank
of a ``model`` group runs the same number of collectives; ranks of
different ``data`` coordinates may stop at different iterations. Every
product runs in IEEE float32 (``ops.precision``), as JAX pins
``"highest"``.

Solves ``min z'(H/2)z + g'z`` s.t. ``A z = b(theta)`` for the slack-NONE
variants, ``b(theta) = b_const + S theta`` assembled on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from direct_data_driven_mpc_tpu_torch.control.loop import (
    ClosedLoopResult,
    closed_loop_rollout,
)
from direct_data_driven_mpc_tpu_torch.device import resolve_device
from direct_data_driven_mpc_tpu_torch.ops.precision import ieee_float32
from direct_data_driven_mpc_tpu_torch.parallel.collectives import (
    all_reduce_sum,
)
from direct_data_driven_mpc_tpu_torch.parallel.mesh import mesh_layout
from direct_data_driven_mpc_tpu_torch.qp.spec import (
    DataDrivenMPCType,
    QPSpec,
    SlackVarConstraintTypes,
)

#: Iterations between the host's checks for a scenario still running.
CHUNK = 10


class ShardedKKTOperand(NamedTuple):
    """The KKT operand as tensors on one device. From
    :func:`build_sharded_kkt` the alpha-indexed leaves are whole and
    padded; a rank's solver keeps its own column shard of them."""

    Hu: torch.Tensor  # (n_u, n_alpha_pad) column shard
    Hy: torch.Tensor  # (n_y, n_alpha_pad)
    h_alpha_diag: torch.Tensor  # () ridge 2*lamb_alpha*eps_max (0 nominal)
    h_u_diag: torch.Tensor  # (n_u,) diagonal of the ubar cost block
    h_y_diag: torch.Tensor  # (n_y,)
    h_sigma_diag: torch.Tensor  # () ridge 2*lamb_sigma (0 if no sigma)
    pc_alpha: torch.Tensor  # (n_alpha_pad,) Jacobi diag, alpha rows
    pc_rest: torch.Tensor  # (n_rest,) Jacobi diag, replicated rows
    g_u: torch.Tensor  # (n_u,) gradient, ubar block
    g_y: torch.Tensor  # (n_y,)
    b_const: torch.Tensor  # (nc,) constant part of b(theta)
    S: torch.Tensor  # (nc, n_theta) theta -> b map
    r0: torch.Tensor  # () constant cost term


def _extract_blocks(spec: QPSpec):
    """Pull the structured blocks out of a slack-NONE QPSpec (the
    Hessian is diagonal per variable block; constraints are the
    dynamics + selection rows)."""
    if spec.slack_var_constraint_type == SlackVarConstraintTypes.CONVEX:
        raise ValueError(
            "The distributed solver covers the equality-constrained "
            "(slack-NONE) variants."
        )
    d = spec.dims
    robust = spec.controller_type == DataDrivenMPCType.ROBUST
    asl, usl, ysl = spec.alpha_slice, spec.ubar_slice, spec.ybar_slice
    Hu = -spec.A[0 : d.n_u, asl]
    Hy = -spec.A[d.n_u : d.n_u + d.n_y, asl]
    # The sharded product models the ubar/ybar Hessian blocks as
    # diagonals; anything else (cross-weighted Q/R) would be silently
    # truncated, so reject it outright.
    for name, sl in (("R", usl), ("Q", ysl)):
        block = spec.H[sl, sl]
        if np.abs(block - np.diag(np.diag(block))).max() > 1e-12 * max(
            1.0, np.abs(block).max()
        ):
            raise NotImplementedError(
                f"The distributed solver currently supports diagonal "
                f"{name} weighting blocks only."
            )
    h_alpha = float(spec.H[asl, asl][0, 0]) if robust else 0.0
    h_u = np.diag(spec.H[usl, usl]).copy()
    h_y = np.diag(spec.H[ysl, ysl]).copy()
    if robust:
        ssl = spec.sigma_slice
        h_sigma = float(spec.H[ssl, ssl][0, 0])
    else:
        h_sigma = 0.0
    return Hu, Hy, h_alpha, h_u, h_y, h_sigma, robust


def _jacobi_diag(spec: QPSpec, robust: bool):
    """M = sqrt(diag(K^2)): row 2-norms of the symmetric KKT matrix --
    a positive Jacobi-type preconditioner valid for indefinite K (the
    plain diag is zero on the multiplier rows). Host float64, built
    once. Returns (d_alpha (n_alpha,), d_rest laid out as the solver's
    replicated block [u; y; (sigma); nu])."""
    H, A = spec.H, spec.A
    hdiag = np.diag(H)
    col_norms2 = (A * A).sum(axis=0)  # per z column
    row_norms2 = (A * A).sum(axis=1)  # per constraint row
    d_z = np.sqrt(hdiag**2 + col_norms2)
    d_nu = np.sqrt(row_norms2)
    floor = 1e-12 * max(d_z.max(initial=0.0), d_nu.max(initial=0.0), 1.0)
    d_z = np.maximum(d_z, floor)
    d_nu = np.maximum(d_nu, floor)
    d_alpha = d_z[spec.alpha_slice]
    parts = [d_z[spec.ubar_slice], d_z[spec.ybar_slice]]
    if robust:
        parts.append(d_z[spec.sigma_slice])
    parts.append(d_nu)
    return d_alpha, np.concatenate(parts)


def build_sharded_kkt(
    spec: QPSpec,
    mesh,
    axis: str = "model",
    dtype=torch.float32,
    precondition: bool = True,
    device=None,
) -> Tuple[ShardedKKTOperand, dict]:
    """The operand, alpha columns padded to a multiple of the mesh dim
    ``axis``'s size, on ``device`` (None: the card), plus static
    metadata."""
    Hu, Hy, h_alpha, h_u, h_y, h_sigma, robust = _extract_blocks(spec)
    n_dev = mesh_layout(mesh)[0][axis]
    n_alpha = Hu.shape[1]
    pad = (-n_alpha) % n_dev
    if precondition:
        d_alpha, d_rest = _jacobi_diag(spec, robust)
    else:
        d_alpha = np.ones(n_alpha)
        n_rest = (
            spec.dims.n_u + spec.dims.n_y + (spec.dims.n_y if robust else 0)
            + spec.nc
        )
        d_rest = np.ones(n_rest)
    if pad:
        Hu = np.pad(Hu, ((0, 0), (0, pad)))
        Hy = np.pad(Hy, ((0, 0), (0, pad)))
        # Padding alpha lanes carry zero data; preconditioner 1.0 keeps
        # them inert (their residual/search components stay zero).
        d_alpha = np.concatenate([d_alpha, np.ones(pad)])
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    operand = ShardedKKTOperand(
        Hu=t(Hu), Hy=t(Hy), h_alpha_diag=t(h_alpha), h_u_diag=t(h_u),
        h_y_diag=t(h_y), h_sigma_diag=t(h_sigma), pc_alpha=t(d_alpha),
        pc_rest=t(d_rest), g_u=t(spec.g[spec.ubar_slice]),
        g_y=t(spec.g[spec.ybar_slice]), b_const=t(spec.b_const),
        S=t(spec.S), r0=t(spec.r0),
    )
    meta = {
        "robust": robust,
        "n_alpha": n_alpha,
        "n_alpha_pad": n_alpha + pad,
        "dims": spec.dims,
        "use_terminal": spec.use_terminal_constraint,
        "nc": spec.nc,
    }
    return operand, meta


def _shard(operand: ShardedKKTOperand, mesh, axis: str
           ) -> ShardedKKTOperand:
    """This rank's column shard of the alpha-indexed leaves."""
    sizes, coord = mesh_layout(mesh)
    cols = operand.pc_alpha.shape[0] // sizes[axis]
    mine = slice(coord[axis] * cols, (coord[axis] + 1) * cols)
    return operand._replace(
        Hu=operand.Hu[:, mine].contiguous(),
        Hy=operand.Hy[:, mine].contiguous(),
        pc_alpha=operand.pc_alpha[mine].contiguous(),
    )


def _make_local_solver(
    meta: dict, group, tol: float, max_iters: int, dtype,
    refine: int = 0,
):
    """The per-rank solve: the sharded KKT product, the global inner
    product and preconditioned MINRES with a tolerance exit per scenario.
    Returns ``(local_solve, layout)``; ``local_solve(op, rhs_alpha,
    rhs_rest) -> (x_alpha, x_rest, rel_residual, iters)``, each led by
    the scenario axis, ``op`` this rank's shard.

    The product is JAX's block structure in the card's terms: the
    replicated block (the diagonal cost blocks, the constraint rows and
    ``A^T nu`` on the u/y/sigma rows; 372 x 372 at the four-tank) is
    one dense product, assembled once per solve from its structured form
    (:func:`rest_product` of the identity), and the alpha coupling is the
    shard's ``[H_u; H_y]`` columns, whose Hankel-alpha partial sums are
    the one ``all_reduce`` of the product. The carry is stacked (the six
    alpha-part vectors, the six replicated ones, the eight scalars per
    scenario), so each iteration is a few dozen launches. A ``model``
    group of one rank sums over nothing, so its collectives are dropped,
    as XLA drops a ``psum`` over an axis of size 1.

    ``refine``: number of iterative-refinement restarts. Float32 MINRES
    stagnates near its roundoff floor with the SOLUTION error still
    ~kappa x the residual (the JAX package measured, on the four-tank
    KKT, res 5.8e-6 but max|du| 5.4e-4 against the float64 map). Each
    restart re-solves K dx = rhs - K x from a fresh Krylov space, whose
    exit test is relative to the (small) restart RHS. The reported
    ``iters`` include the restart passes."""
    d = meta["dims"]
    robust = meta["robust"]
    n_u, n_y = d.n_u, d.n_y

    # Replicated-block layout inside `rest`.
    u0, y0 = 0, n_u
    s0 = y0 + n_y
    v0 = s0 + (n_y if robust else 0)

    # Constraint-row layout inside nu.
    n_dyn = n_u + n_y
    n_int_u = d.n * d.m
    n_int_y = d.n * d.p
    dyn = slice(v0, v0 + n_dyn)  # the dynamics rows of nu, in `rest`

    if dist.get_world_size(group) > 1:
        reduce = all_reduce_sum
    else:
        def reduce(tensor, group):
            return tensor

    def rest_product(op, rest):
        """The replicated block of the KKT product (alpha = 0): H z and
        A^T nu on the [ubar; ybar; (sigma)] rows, A z on the nu rows
        without the Hankel-alpha terms. Linear in ``rest (B, n_rest)``."""
        ubar = rest[:, u0:y0]
        ybar = rest[:, y0:s0]
        nu = rest[:, v0:]
        out_u = op.h_u_diag * ubar + nu[:, :n_u]
        out_y = op.h_y_diag * ybar + nu[:, n_u:n_dyn]
        out_u[:, :n_int_u] += nu[:, n_dyn : n_dyn + n_int_u]
        out_y[:, :n_int_y] += nu[:, n_dyn + n_int_u : n_dyn + n_int_u
                                 + n_int_y]
        if meta["use_terminal"]:
            t0 = n_dyn + n_int_u + n_int_y
            out_u[:, n_u - n_int_u :] += nu[:, t0 : t0 + n_int_u]
            out_y[:, n_y - n_int_y :] += nu[:, t0 + n_int_u : t0 + n_int_u
                                            + n_int_y]
        rest_out = [out_u, out_y]
        out_dyn_y = ybar
        if robust:
            sigma = rest[:, s0:v0]
            rest_out.append(op.h_sigma_diag * sigma + nu[:, n_u:n_dyn])
            out_dyn_y = ybar + sigma
        out_nu = [ubar, out_dyn_y, ubar[:, :n_int_u], ybar[:, :n_int_y]]
        if meta["use_terminal"]:
            out_nu += [ubar[:, n_u - n_int_u :], ybar[:, n_y - n_int_y :]]
        return torch.cat(rest_out + out_nu, 1)

    def blocks(op):
        """``([H_u; H_y] shard, the replicated block's matrix (transposed,
        for ``rest @ K``), h_alpha)``."""
        eye = torch.eye(op.pc_rest.shape[0], dtype=op.pc_rest.dtype,
                        device=op.pc_rest.device)
        return (torch.cat([op.Hu, op.Hy], 0), rest_product(op, eye),
                float(op.h_alpha_diag))

    def kkt_matvec(op, blk, alpha_s, rest):
        """One sharded KKT product. alpha_s: (B, shard_cols) local;
        rest: replicated. Returns (alpha_out_local, rest_out)."""
        HuHy, K_rest, h_alpha = blk
        # The dynamics rows' Hankel-alpha products are partial sums per
        # shard: THE all_reduce (the KKT residual block reduction).
        H_a = reduce(alpha_s @ HuHy.T, group)
        rest_out = rest @ K_rest
        rest_out[:, dyn] -= H_a
        # The alpha rows: H alpha - [H_u; H_y]^T nu_dyn, local columns.
        return (torch.addmm(alpha_s, rest[:, dyn], HuHy, beta=h_alpha,
                            alpha=-1.0), rest_out)

    def dot(a_s1, r1, a_s2, r2):
        """Global inner product per scenario: all_reduce the alpha part;
        the replicated part computed alike on every rank."""
        part = torch.bmm(a_s1.unsqueeze(1), a_s2.unsqueeze(2)).view(-1)
        return reduce(part, group) + torch.bmm(
            r1.unsqueeze(1), r2.unsqueeze(2)).view(-1)

    tiny = 1e-30

    def _minres_core(op, blk, rhs_alpha, rhs_rest):
        """Preconditioned MINRES (Paige-Saunders recurrences with M =
        diag Jacobi) on the symmetric (possibly singular, consistent) KKT
        system, per scenario. A scenario stops when its preconditioned
        residual estimate phibar drops below tol * beta1 or after
        ``max_iters``. Returns ``(x_alpha, x_rest, iters)``."""
        y_a, y_r = rhs_alpha / op.pc_alpha, rhs_rest / op.pc_rest
        beta1 = dot(rhs_alpha, rhs_rest, y_a, y_r).clamp_min(0.0).sqrt()
        safe_b1 = beta1.clamp_min(tiny)
        stop = tol * safe_b1
        z_a, z_r, zero = (torch.zeros_like(t)
                          for t in (rhs_alpha, rhs_rest, beta1))
        # Carry, stacked: vectors x, r1, r2, y, w, w2 (alpha part, then
        # the replicated part; r2 starts equal to r1, w and w2 at zero)
        # and scalars oldb, beta, dbar, epsln, phibar, cs, sn, k.
        A = torch.stack([z_a, rhs_alpha, rhs_alpha, y_a, z_a, z_a], 1)
        R = torch.stack([z_r, rhs_rest, rhs_rest, y_r, z_r, z_r], 1)
        S = torch.stack([zero, safe_b1, zero, zero, beta1, zero - 1.0,
                         zero, zero], 1)

        def active(S):
            return (S[:, 4] > stop) & (S[:, 7] < max_iters)

        def body(A, R, S):
            x_a, r1_a, r2_a, y_a, w_a, w2_a = A.unbind(1)
            x_r, r1_r, r2_r, y_r, w_r, w2_r = R.unbind(1)
            oldb, beta, dbar, epsln, phibar, cs, sn, k = S.unbind(1)
            b = beta[:, None]
            v_a, v_r = y_a / b, y_r / b
            yk_a, yk_r = kkt_matvec(op, blk, v_a, v_r)
            coef = torch.where(k > 0, beta / oldb.clamp_min(tiny),
                               0.0)[:, None]
            yk_a = torch.addcmul(yk_a, coef, r1_a, value=-1.0)
            yk_r = torch.addcmul(yk_r, coef, r1_r, value=-1.0)
            alfa = dot(v_a, v_r, yk_a, yk_r)
            ab = (alfa / beta)[:, None]
            yk_a = torch.addcmul(yk_a, ab, r2_a, value=-1.0)
            yk_r = torch.addcmul(yk_r, ab, r2_r, value=-1.0)
            y_a, y_r = yk_a / op.pc_alpha, yk_r / op.pc_rest
            beta_new = dot(yk_a, yk_r, y_a, y_r).clamp_min(0.0).sqrt()

            delta = torch.addcmul(cs * dbar, sn, alfa)
            gbar = torch.addcmul(sn * dbar, cs, alfa, value=-1.0)
            gamma = torch.hypot(gbar, beta_new).clamp_min(tiny)
            cs_new, sn_new = gbar / gamma, beta_new / gamma
            phi = cs_new * phibar

            g = gamma[:, None]
            oe, de = epsln[:, None], delta[:, None]
            wn_a = torch.addcmul(torch.addcmul(v_a, oe, w2_a, value=-1.0),
                                 de, w_a, value=-1.0) / g
            wn_r = torch.addcmul(torch.addcmul(v_r, oe, w2_r, value=-1.0),
                                 de, w_r, value=-1.0) / g
            p = phi[:, None]
            return (
                torch.stack([torch.addcmul(x_a, p, wn_a), r2_a, yk_a, y_a,
                             wn_a, w_a], 1),
                torch.stack([torch.addcmul(x_r, p, wn_r), r2_r, yk_r, y_r,
                             wn_r, w_r], 1),
                torch.stack([beta, beta_new.clamp_min(tiny),
                             -(cs * beta_new), sn * beta_new,
                             sn_new * phibar, cs_new, sn_new, k + 1.0], 1),
            )

        # The exit reads phibar and k alone, the same on every rank of
        # the group, so the group runs the same chunks.
        while bool(active(S).any()):
            for _ in range(CHUNK):
                go = active(S)
                A_new, R_new, S_new = body(A, R, S)
                A = torch.where(go[:, None, None], A_new, A)
                R = torch.where(go[:, None, None], R_new, R)
                S = torch.where(go[:, None], S_new, S)
        return A[:, 0], R[:, 0], S[:, 7].to(torch.int32)

    def local_solve(op, rhs_alpha, rhs_rest):
        blk = blocks(op)
        x_a, x_r, iters = _minres_core(op, blk, rhs_alpha, rhs_rest)
        for _ in range(refine):
            Ax_a, Ax_r = kkt_matvec(op, blk, x_a, x_r)
            dx_a, dx_r, it2 = _minres_core(
                op, blk, rhs_alpha - Ax_a, rhs_rest - Ax_r
            )
            x_a = x_a + dx_a
            x_r = x_r + dx_r
            iters = iters + it2
        # TRUE residual at exit (one extra product; phibar is the
        # preconditioned estimate).
        Ax_a, Ax_r = kkt_matvec(op, blk, x_a, x_r)
        r_a = rhs_alpha - Ax_a
        r_r = rhs_rest - Ax_r
        bn = dot(rhs_alpha, rhs_rest, rhs_alpha, rhs_rest).clamp_min(0.0)
        res = (dot(r_a, r_r, r_a, r_r).clamp_min(0.0).sqrt()
               / bn.sqrt().clamp_min(tiny))
        return x_a, x_r, res, iters

    layout = {"u0": u0, "y0": y0, "s0": s0, "v0": v0}
    return local_solve, layout


def _rhs_rest(op, meta, theta, dtype):
    """Device-side RHS assembly per scenario: ``[-g_u; -g_y; (0);
    b_const + S theta]`` for ``theta (B, n_theta)``."""
    b = op.b_const + theta.to(dtype) @ op.S.T
    Bsz = theta.shape[0]
    parts = [(-op.g_u).expand(Bsz, -1), (-op.g_y).expand(Bsz, -1)]
    if meta["robust"]:
        parts.append(b.new_zeros((Bsz, meta["dims"].n_y)))
    parts.append(b)
    return torch.cat(parts, 1)


def _default_tol(tol, dtype) -> float:
    """Dtype-aware default: 1e-8 is reachable in f64 but below f32's
    roundoff floor (eps ~ 1.2e-7); pick per precision when unset."""
    if tol is not None:
        return tol
    return 1e-8 if dtype == torch.float64 else 1e-5


def _solver_parts(spec, mesh, axis, tol, max_iters, dtype, precondition,
                  refine, device):
    operand, meta = build_sharded_kkt(spec, mesh, axis, dtype=dtype,
                                      precondition=precondition,
                                      device=device)
    op = _shard(operand, mesh, axis)
    local_solve, layout = _make_local_solver(
        meta, mesh.get_group(axis), tol, max_iters, dtype, refine=refine
    )
    return op, meta, local_solve, layout


def make_distributed_kkt_solver(
    spec: QPSpec,
    mesh,
    axis: str = "model",
    tol: float | None = None,
    max_iters: int = 1000,
    dtype=torch.float32,
    precondition: bool = True,
    refine: int = 0,
    device=None,
):
    """Build ``solve(theta) -> (u_opt, residual, iterations)``:
    preconditioned MINRES on the KKT system with the alpha dimension
    sharded over the mesh dim ``axis``, b(theta) assembled on the device
    (None: the card), and a tolerance exit (``tol=None`` -> 1e-8 in
    float64, 1e-5 in float32). ``refine``: iterative-refinement restarts
    (see :func:`_make_local_solver`); pass 1 to push the float32 solution
    error well below the stagnated-residual floor.

    ``theta`` is one window ``(n_theta,)`` or a batch ``(B, n_theta)``;
    the results have the same leading shape. ``u_opt`` is the flattened
    ``ubar*[0, L-1]``. Every rank of the ``axis`` group calls ``solve``
    with the same ``theta``."""
    tol = _default_tol(tol, dtype)
    op, meta, local_solve, layout = _solver_parts(
        spec, mesh, axis, tol, max_iters, dtype, precondition, refine,
        device,
    )
    d = meta["dims"]

    @ieee_float32()
    def solve(theta):
        theta = torch.as_tensor(theta, dtype=dtype, device=op.S.device)
        batch = theta.reshape(-1, theta.shape[-1])
        rhs_rest = _rhs_rest(op, meta, batch, dtype)
        rhs_alpha = rhs_rest.new_zeros((batch.shape[0],
                                        op.pc_alpha.shape[0]))
        _, x_r, res, iters = local_solve(op, rhs_alpha, rhs_rest)
        u_opt = x_r[:, layout["u0"] + d.n * d.m : layout["y0"]]
        if theta.ndim == 1:
            return u_opt[0], res[0], iters[0]
        return u_opt, res, iters

    return solve


def make_distributed_closed_loop(
    mesh,
    plant,
    spec: QPSpec,
    n_steps: int,
    n_mpc_step: int = 1,
    axis: str = "model",
    tol: float | None = None,
    max_iters: int = 1000,
    dtype=torch.float32,
    precondition: bool = True,
    refine: int = 0,
    device=None,
):
    """The closed loop whose per-step QP solve is the alpha-sharded
    PMINRES solver: this rank's scenarios (its ``data`` shard) batched,
    each solve's Hankel-alpha reductions over ``axis``.

    Returns ``run(x0s, u_pasts, y_pasts, Ws) -> ClosedLoopResult`` for
    this rank's shard, in ``dtype`` on ``device`` (None: the card);
    ``converged`` is ``residual <= 10 * tol`` with ``u`` finite, per
    solve. The cost per solve comes from the solution blocks, ``0.5 z'H
    z + g'z + r0`` with the structured diagonal H, whose alpha ridge
    needs the global ``||alpha||^2`` (one more ``all_reduce``)."""
    tol = _default_tol(tol, dtype)
    op, meta, local_solve, layout = _solver_parts(
        spec, mesh, axis, tol, max_iters, dtype, precondition, refine,
        device,
    )
    d = meta["dims"]
    robust = meta["robust"]
    u0, y0, s0v, v0 = (layout[k] for k in ("u0", "y0", "s0", "v0"))
    m = d.m
    group = mesh.get_group(axis)

    def solve_fn(theta, state):
        rhs_rest = _rhs_rest(op, meta, theta, dtype)
        rhs_alpha = rhs_rest.new_zeros((theta.shape[0],
                                        op.pc_alpha.shape[0]))
        x_a, x_r, res, _ = local_solve(op, rhs_alpha, rhs_rest)
        ubar = x_r[:, u0:y0]
        ybar = x_r[:, y0:s0v]
        a2 = all_reduce_sum((x_a * x_a).sum(-1), group)
        cost = 0.5 * (
            op.h_alpha_diag * a2
            + (op.h_u_diag * ubar * ubar).sum(-1)
            + (op.h_y_diag * ybar * ybar).sum(-1)
        )
        if robust:
            sigma = x_r[:, s0v:v0]
            cost = cost + 0.5 * op.h_sigma_diag * (sigma * sigma).sum(-1)
        cost = cost + ubar @ op.g_u + ybar @ op.g_y + op.r0
        u_seq = ubar[:, d.n * m :].reshape(theta.shape[0], -1, m)
        ok = (res <= 10.0 * tol) & torch.isfinite(u_seq).all(-1).all(-1)
        return u_seq, cost, state, ok

    def run(x0s, u_pasts, y_pasts, Ws) -> ClosedLoopResult:
        ins = (torch.as_tensor(a, dtype=dtype, device=op.S.device)
               for a in (x0s, u_pasts, y_pasts, Ws))
        return closed_loop_rollout(plant, (solve_fn, None), *ins,
                                   n_steps=n_steps, n_mpc_step=n_mpc_step)

    return run
