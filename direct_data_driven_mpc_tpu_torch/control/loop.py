"""Generic closed-loop engine for the affine solvers, and the result type
shared by every engine.

Every ``n_mpc_step`` steps the controller solves its QP from the past
window ``theta = [u_past; y_past]``, then applies the first
``n_mpc_step`` inputs of the solution, stepping the plant and shifting
the window after each (the paper's Algorithms 1 and 2). The solve is the
exact affine map of a :class:`~direct_data_driven_mpc_tpu_torch.qp.\
solution_map.SolutionMap` or, to retarget the controller along a
per-solve setpoint schedule, of a :class:`~direct_data_driven_mpc_tpu_\
torch.qp.solution_map.TrackingMap`. The batch of scenarios leads every
tensor, so each solve and each plant step is one batched product. A
trailing partial block is run and trimmed, as in the reference.

This engine is the reference the condensed engines are held against
(``control.linear_engine``, ``ops.fused_rollout``). Counterpart of
``direct_data_driven_mpc_tpu/control/loop.py`` (``ClosedLoopResult``,
``make_solve_fn``, ``closed_loop_rollout``, ``build_closed_loop``) for
the affine solvers; its iterative solvers (ADMM, box ADMM, NON_CONVEX)
are not ported yet (ROADMAP.md queue 1, item 3).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams
from direct_data_driven_mpc_tpu_torch.qp.solution_map import (
    SolutionMap,
    TrackingMap,
    optimal_cost,
    solve_u,
    solve_u_tracking,
    tracking_cost,
)

#: Where the generic loop's iterative solvers stand.
_ITERATIVE_SOLVERS = (
    "the generic loop takes the affine solvers (SolutionMap, "
    "TrackingMap) only: its iterative solvers (ADMM, box ADMM and "
    "NON_CONVEX operators) are ROADMAP.md queue 1, item 3, not ported "
    "yet; run CONVEX and box operators through ops.fused_admm or "
    "ops.fused_ladder"
)


class ClosedLoopResult(NamedTuple):
    """Outputs of a batched closed-loop rollout (batch leads, then
    time)."""

    u_sys: torch.Tensor  # (B, n_steps, m) applied inputs
    y_sys: torch.Tensor  # (B, n_steps, p) measured outputs
    costs: torch.Tensor  # (B, n_solves) optimal QP cost per solve
    converged: torch.Tensor  # (B, n_solves) solver convergence lane (bool)
    x_final: torch.Tensor  # (B, ns) final plant state
    u_past: torch.Tensor  # (B, n, m) final past-input window
    y_past: torch.Tensor  # (B, n, p) final past-output window
    solver_state: Optional[Any] = None  # final iterative-solver
    # warm-start state (``qp.admm.ADMMState`` of (B, nbox) tensors for
    # the ADMM engines; None for exact affine solvers): feed it back as
    # ``solver_state0`` so a segmented run continues the uninterrupted one


def make_solve_fn(solver, m: int):
    """``(solve, state0)``: ``solve(theta, state) -> (u_seq (B, L, m),
    cost (B,), state, ok (B,))`` for a batch of windows ``theta (B,
    n_theta)``, and the solver's initial state (None: the exact affine
    map carries none; its ``ok`` lane is finiteness). Iterative
    operators (the dicts of ``qp.admm`` and ``qp.box``) raise
    ``NotImplementedError`` naming the ROADMAP item that ports them."""
    if isinstance(solver, SolutionMap):

        def solve(theta, state):
            u_seq = solve_u(solver, theta).reshape(theta.shape[0], -1, m)
            cost = optimal_cost(solver, theta)
            ok = torch.isfinite(u_seq).all(-1).all(-1) & torch.isfinite(cost)
            return u_seq, cost, state, ok

        return solve, None
    if isinstance(solver, dict):
        raise NotImplementedError(_ITERATIVE_SOLVERS)
    raise TypeError(f"Unsupported solver type: {type(solver)!r}")


def setpoint_schedule(setpoints, rows: int, n_r: int, Bsz: int, dtype,
                      device, shape_error: str) -> torch.Tensor:
    """A setpoint schedule as ``(B or 1, rows, n_r)`` on ``device`` in
    ``dtype``: constant ``(n_r,)``, one row per solve or outer block
    ``(rows, n_r)``, or per scenario ``(B, rows, n_r)``; any other shape
    raises ``ValueError(shape_error)`` with the shape it got."""
    R = torch.as_tensor(setpoints, dtype=dtype, device=device)
    shape = tuple(R.shape)
    if R.ndim in (1, 2) and shape == (rows, n_r)[2 - R.ndim :]:
        R = R.expand(1, rows, n_r)
    if tuple(R.shape) not in ((1, rows, n_r), (Bsz, rows, n_r)):
        raise ValueError(f"{shape_error}; got {shape}")
    return R


def closed_loop_rollout(
    plant: LTIParams,
    solver,
    x0: torch.Tensor,
    u_past: torch.Tensor,
    y_past: torch.Tensor,
    W: torch.Tensor,
    n_steps: int,
    n_mpc_step: int = 1,
    setpoints=None,
) -> ClosedLoopResult:
    """Run a batch of closed loops for ``n_steps`` with noise ``W``.

    Args:
        plant: LTI plant matrices (the simulated system), moved to the
            device and dtype of ``u_past``.
        solver: a :class:`SolutionMap` or a :class:`TrackingMap` (which
            takes ``setpoints``), on the device of the inputs.
        x0: ``(B, ns)`` initial plant states.
        u_past: ``(B, n, m)`` past-input windows.
        y_past: ``(B, n, p)`` past-output windows.
        W: ``(B, n_steps, p)`` measurement noise.
        n_steps: closed-loop length.
        n_mpc_step: inputs applied per solve.
        setpoints: TrackingMap only: ``r = [u_s; y_s]`` per solve,
            constant ``(m+p,)``, ``(n_blocks, m+p)`` with row ``i`` for
            solve ``i`` (``n_blocks = ceil(n_steps / n_mpc_step)``), or
            ``(B, n_blocks, m+p)`` per scenario.

    Returns:
        :class:`ClosedLoopResult` (``solver_state`` None).
    """
    Bsz, _, m = u_past.shape
    p = y_past.shape[2]
    dtype, device = u_past.dtype, u_past.device
    A, Bm, C, D = (a.T for a in LTIParams(*plant).to(device, dtype))
    n_blocks = math.ceil(n_steps / n_mpc_step)

    if isinstance(solver, TrackingMap):
        if setpoints is None:
            raise ValueError(
                "a TrackingMap solver requires a `setpoints` schedule "
                f"(constant ({m + p},), per-solve ({n_blocks}, {m + p}) or "
                f"per scenario ({Bsz}, {n_blocks}, {m + p}))"
            )
        R = setpoint_schedule(
            setpoints, n_blocks, m + p, Bsz, dtype, device,
            f"setpoints must have shape ({m + p},), ({n_blocks}, {m + p}) "
            f"or ({Bsz}, {n_blocks}, {m + p})",
        )

        def solve(theta, i):
            r = R[:, i].expand(Bsz, m + p)
            u_seq = solve_u_tracking(solver, theta, r).reshape(Bsz, -1, m)
            cost = tracking_cost(solver, theta, r)
            ok = torch.isfinite(u_seq).all(-1).all(-1) & torch.isfinite(cost)
            return u_seq, cost, ok
    else:
        if setpoints is not None:
            raise ValueError(
                "`setpoints` schedules require a TrackingMap solver "
                "(controller.tracking_map())"
            )
        solve_fn, _ = make_solve_fn(solver, m)

        def solve(theta, i):
            u_seq, cost, _, ok = solve_fn(theta, None)
            return u_seq, cost, ok

    x = x0.to(dtype)
    up, yp = u_past, y_past.to(dtype)
    U = torch.empty((Bsz, n_blocks * n_mpc_step, m), dtype=dtype,
                    device=device)
    Y = torch.empty((Bsz, n_blocks * n_mpc_step, p), dtype=dtype,
                    device=device)
    costs = torch.empty((Bsz, n_blocks), dtype=dtype, device=device)
    oks = torch.empty((Bsz, n_blocks), dtype=torch.bool, device=device)
    Wd = W.to(dtype)
    for i in range(n_blocks):
        theta = torch.cat([up.reshape(Bsz, -1), yp.reshape(Bsz, -1)], 1)
        u_seq, costs[:, i], oks[:, i] = solve(theta, i)
        for k in range(n_mpc_step):
            t = i * n_mpc_step + k
            u = u_seq[:, k]
            y = x @ C + u @ D
            if t < n_steps:
                y = y + Wd[:, t]
            x = x @ A + u @ Bm
            up = torch.cat([up[:, 1:], u[:, None]], 1)
            yp = torch.cat([yp[:, 1:], y[:, None]], 1)
            U[:, t], Y[:, t] = u, y
    return ClosedLoopResult(
        u_sys=U[:, :n_steps],
        y_sys=Y[:, :n_steps],
        costs=costs,
        converged=oks,
        x_final=x,
        u_past=up,
        y_past=yp,
    )


def build_closed_loop(
    plant: LTIParams,
    solver,
    n_steps: int,
    n_mpc_step: int = 1,
    setpoints=None,
) -> Callable[..., ClosedLoopResult]:
    """``run(x0, u_past, y_past, W) -> ClosedLoopResult`` over a batch
    (see :func:`closed_loop_rollout`); a TrackingMap's ``setpoints`` are
    fixed here."""

    def run(x0, u_past, y_past, W):
        return closed_loop_rollout(
            plant, solver, x0, u_past, y_past, W, n_steps=n_steps,
            n_mpc_step=n_mpc_step, setpoints=setpoints,
        )

    return run
