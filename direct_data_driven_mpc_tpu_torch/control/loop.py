"""Generic closed-loop engine, and the result type shared by every
engine.

Every ``n_mpc_step`` steps the controller solves its QP from the past
window ``theta = [u_past; y_past]``, then applies the first
``n_mpc_step`` inputs of the solution, stepping the plant and shifting
the window after each (the paper's Algorithms 1 and 2). The solve is the
exact affine map of a :class:`~direct_data_driven_mpc_tpu_torch.qp.\
solution_map.SolutionMap` or, to retarget the controller along a
per-solve setpoint schedule, of a :class:`~direct_data_driven_mpc_tpu_\
torch.qp.solution_map.TrackingMap`; or an iterative solve, warm-started
across the loop's solves: ADMM for the CONVEX slack box
(``qp.admm``), the general-box ADMM with a fixed penalty or the
penalty ladder (``qp.box``), and the NON_CONVEX fixed point
(``qp.nonconvex``). The batch of scenarios leads every tensor, so each
solve and each plant step is one batched product; plants and operators
stacked per scenario (``parallel.batch``) take batched products. A
trailing partial block is run and trimmed, as in the reference. Every
product runs in IEEE float32 (``ops.precision``).

This engine is the reference the condensed and fused engines are held
against (``control.linear_engine``, ``ops.fused_rollout``,
``ops.fused_admm``, ``ops.fused_ladder``). Counterpart of
``direct_data_driven_mpc_tpu/control/loop.py`` (``ClosedLoopResult``,
``make_solve_fn``, ``closed_loop_rollout``, ``build_closed_loop``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams
from direct_data_driven_mpc_tpu_torch.ops.precision import ieee_float32
from direct_data_driven_mpc_tpu_torch.qp.admm import (
    ADMMSolver,
    ADMMState,
    admm_solve,
)
from direct_data_driven_mpc_tpu_torch.qp.box import (
    BoxADMMSolver,
    box_admm_solve,
    box_initial_state,
)
from direct_data_driven_mpc_tpu_torch.qp.nonconvex import (
    NonConvexADMMSolver,
    nonconvex_admm_solve,
    nonconvex_initial_state,
)
from direct_data_driven_mpc_tpu_torch.qp.solution_map import (
    SolutionMap,
    TrackingMap,
    matvec,
    optimal_cost,
    solve_u,
    solve_u_tracking,
    tracking_cost,
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
    # warm-start state, batch leading (``qp.admm.ADMMState``,
    # ``qp.box.BoxADMMState`` or ``qp.nonconvex.NonConvexState``; None
    # for exact affine solvers): feed it back as ``solver_state0`` so a
    # segmented run continues the uninterrupted one


def make_solve_fn(solver, m: int, admm_iters: int = 100,
                  admm_tol: float = 1e-6):
    """``(solve, state0)``: ``solve(theta, state) -> (u_seq (B, L, m),
    cost (B,), state, ok (B,))`` for a batch of windows ``theta (B,
    n_theta)``, and the solver's cold-start state for one scenario (a
    leading axis of 1, which the loop broadcasts over the batch; None
    for the exact affine map, whose ``ok`` lane is finiteness).

    The iterative solvers run ``admm_iters`` iterations per solve (the
    box ADMM's cap; the NON_CONVEX solve's inner iterations, under 4
    bound updates) at tolerance ``admm_tol``, and their ``ok`` lane is
    each scenario's convergence. A ``(solve_fn, init_state)`` pair is
    passed through as is; its ``init_state`` is a NamedTuple of tensors
    led by a scenario axis of 1 or B, like the others."""
    if isinstance(solver, SolutionMap):

        def solve(theta, state):
            u_seq = solve_u(solver, theta).reshape(theta.shape[0], -1, m)
            cost = optimal_cost(solver, theta)
            ok = torch.isfinite(u_seq).all(-1).all(-1) & torch.isfinite(cost)
            return u_seq, cost, state, ok

        return solve, None

    if isinstance(solver, ADMMSolver):
        zeros = solver.v_c.new_zeros((1, solver.v_c.shape[-1]))

        def solve(theta, state):
            u, cost, new_state, stats = admm_solve(
                solver, theta, num_iters=admm_iters, state=state,
                tol=admm_tol,
            )
            return (u.reshape(theta.shape[0], -1, m), cost, new_state,
                    stats.converged)

        return solve, ADMMState(s=zeros, w=zeros)

    if isinstance(solver, BoxADMMSolver):
        # General input/output/slack boxes, with the penalty rung
        # carried across the loop's solves.

        def solve(theta, state):
            u, cost, new_state, stats = box_admm_solve(
                solver, theta, num_iters=admm_iters, state=state,
                tol=admm_tol,
            )
            return (u.reshape(theta.shape[0], -1, m), cost, new_state,
                    stats.converged)

        return solve, box_initial_state(solver, 1)

    if isinstance(solver, NonConvexADMMSolver):
        # Warm-started along a trajectory, the bound's fixed point is
        # stationary after 1-2 updates; 4 covers the cold first solve.

        def solve(theta, state):
            u, cost, new_state, stats = nonconvex_admm_solve(
                solver, theta, outer_iters=4, inner_iters=admm_iters,
                state=state, tol=admm_tol,
            )
            return (u.reshape(theta.shape[0], -1, m), cost, new_state,
                    stats.converged)

        return solve, nonconvex_initial_state(solver, 1)

    if isinstance(solver, tuple) and len(solver) == 2 and callable(solver[0]):
        # A custom solve function and its initial state.
        return solver

    raise TypeError(f"Unsupported solver type: {type(solver)!r}")


def _broadcast_state(state, Bsz: int):
    """A solver state whose tensors have one row, repeated for ``Bsz``
    scenarios; a batched state as it is."""
    if state is None:
        return None
    return type(state)(*(
        x.expand(Bsz, *x.shape[1:]) if x.shape[0] == 1 else x
        for x in state
    ))


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


@ieee_float32()
def closed_loop_rollout(
    plant: LTIParams,
    solver,
    x0: torch.Tensor,
    u_past: torch.Tensor,
    y_past: torch.Tensor,
    W: torch.Tensor,
    n_steps: int,
    n_mpc_step: int = 1,
    admm_iters: int = 100,
    solver_state0=None,
    setpoints=None,
) -> ClosedLoopResult:
    """Run a batch of closed loops for ``n_steps`` with noise ``W``.

    Args:
        plant: LTI plant matrices (the simulated system), moved to the
            device and dtype of ``u_past``; ``(ns, ns)``-shaped and so on
            for one plant, or stacked per scenario ``(B, ns, ns)``
            (``parallel.batch.stack_plants``).
        solver: a :class:`SolutionMap`, a :class:`TrackingMap` (which
            takes ``setpoints``), an :class:`~direct_data_driven_mpc_\
tpu_torch.qp.admm.ADMMSolver`, a :class:`~direct_data_driven_mpc_tpu_\
torch.qp.box.BoxADMMSolver`, a :class:`~direct_data_driven_mpc_tpu_\
torch.qp.nonconvex.NonConvexADMMSolver` or a ``(solve_fn, state0)``
            pair (see :func:`make_solve_fn`), on the device of the
            inputs.
        x0: ``(B, ns)`` initial plant states.
        u_past: ``(B, n, m)`` past-input windows.
        y_past: ``(B, n, p)`` past-output windows.
        W: ``(B, n_steps, p)`` measurement noise.
        n_steps: closed-loop length.
        n_mpc_step: inputs applied per solve.
        admm_iters: iterations per solve of the iterative solvers (see
            :func:`make_solve_fn`; the tolerance is its 1e-6).
        solver_state0: the iterative solver's warm-start state, batch
            leading: a previous segment's ``result.solver_state`` makes a
            segmented run continue the uninterrupted one. Default: the
            solver's cold start.
        setpoints: TrackingMap only: ``r = [u_s; y_s]`` per solve,
            constant ``(m+p,)``, ``(n_blocks, m+p)`` with row ``i`` for
            solve ``i`` (``n_blocks = ceil(n_steps / n_mpc_step)``), or
            ``(B, n_blocks, m+p)`` per scenario.

    Returns:
        :class:`ClosedLoopResult`, with the iterative solver's final
        ``solver_state`` (None for the affine maps).
    """
    Bsz, _, m = u_past.shape
    p = y_past.shape[2]
    dtype, device = u_past.dtype, u_past.device
    A, Bm, C, D = LTIParams(*plant).to(device, dtype)
    n_blocks = math.ceil(n_steps / n_mpc_step)

    state = None
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

        def solve(theta, i, state):
            r = R[:, i].expand(Bsz, m + p)
            u_seq = solve_u_tracking(solver, theta, r).reshape(Bsz, -1, m)
            cost = tracking_cost(solver, theta, r)
            ok = torch.isfinite(u_seq).all(-1).all(-1) & torch.isfinite(cost)
            return u_seq, cost, state, ok
    else:
        if setpoints is not None:
            raise ValueError(
                "`setpoints` schedules require a TrackingMap solver "
                "(controller.tracking_map())"
            )
        solve_fn, state0 = make_solve_fn(solver, m, admm_iters=admm_iters)
        state = _broadcast_state(
            state0 if solver_state0 is None else solver_state0, Bsz
        )

        def solve(theta, i, state):
            return solve_fn(theta, state)

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
        u_seq, costs[:, i], state, oks[:, i] = solve(theta, i, state)
        for k in range(n_mpc_step):
            t = i * n_mpc_step + k
            u = u_seq[:, k]
            y = matvec(C, x) + matvec(D, u)
            if t < n_steps:
                y = y + Wd[:, t]
            x = matvec(A, x) + matvec(Bm, u)
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
        solver_state=state,
    )


def build_closed_loop(
    plant: LTIParams,
    solver,
    n_steps: int,
    n_mpc_step: int = 1,
    admm_iters: int = 100,
    setpoints=None,
) -> Callable[..., ClosedLoopResult]:
    """``run(x0, u_past, y_past, W) -> ClosedLoopResult`` over a batch
    (see :func:`closed_loop_rollout`); a TrackingMap's ``setpoints`` are
    fixed here."""

    def run(x0, u_past, y_past, W):
        return closed_loop_rollout(
            plant, solver, x0, u_past, y_past, W, n_steps=n_steps,
            n_mpc_step=n_mpc_step, admm_iters=admm_iters,
            setpoints=setpoints,
        )

    return run
