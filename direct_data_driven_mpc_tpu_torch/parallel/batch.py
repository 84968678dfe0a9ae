"""Monte-Carlo scenario batches: measurement noise, and the closed loop
over a batch whose plants and operators may differ per scenario.

Counterpart of ``direct_data_driven_mpc_tpu/parallel/batch.py``. The
JAX package ``vmap``s a one-scenario loop; the port's generic loop
(``control.loop``) is batched already, the scenario axis leading, so
:func:`batched_closed_loop` and :func:`make_batched_rollout` call it as
they are. With plants and operators stacked per scenario
(:func:`stack_plants`, :func:`stack_solution_maps`, or
``qp.batch_build.stacked_solution_map`` for one operator per data
realisation), each product of :func:`heterogeneous_closed_loop` is
batched, one matrix per scenario.

The noise comes from an explicit ``torch.Generator`` on the device, not
from JAX's threefry, so the two packages give different numbers for the
same seed: parity tests feed both the same numpy noise instead. The
classic engine draws its noise inside its block loop
(:func:`draw_block_noise`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from direct_data_driven_mpc_tpu_torch.control.loop import (
    ClosedLoopResult,
    closed_loop_rollout,
)
from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams
from direct_data_driven_mpc_tpu_torch.qp.admm import ADMMSolver
from direct_data_driven_mpc_tpu_torch.qp.solution_map import SolutionMap


def draw_noise_batch(
    generator: torch.Generator,
    B: int,
    T: int,
    p: int,
    eps_max: float,
    device,
    dtype=torch.float32,
) -> torch.Tensor:
    """Bounded uniform measurement noise ``eps_max * U[-1, 1]`` of shape
    ``(B, T, p)`` on ``device``; ``generator`` must live on the same
    device."""
    return draw_block_noise(generator, B, T * p, eps_max, device,
                            dtype).view(B, T, p)


def draw_block_noise(
    generator: torch.Generator,
    B: int,
    width: int,
    eps_max: float,
    device,
    dtype=torch.float32,
) -> torch.Tensor:
    """One outer block's noise, ``eps_max * U[-1, 1]`` of shape ``(B,
    width)``: the classic engine draws it inside its block loop, so
    ``n_outer`` calls on a generator seeded alike give the same noise
    for an explicit-noise run."""
    w = torch.empty((B, width), device=device, dtype=dtype)
    w.uniform_(-1.0, 1.0, generator=generator)
    return w.mul_(eps_max)


def batched_closed_loop(
    plant: LTIParams,
    solver,
    x0s: torch.Tensor,  # (B, ns)
    u_pasts: torch.Tensor,  # (B, n, m)
    y_pasts: torch.Tensor,  # (B, n, p)
    Ws: torch.Tensor,  # (B, n_steps, p)
    n_steps: int,
    n_mpc_step: int = 1,
    admm_iters: int = 100,
    solver_state0=None,
) -> ClosedLoopResult:
    """Every scenario shares one plant and one solver operator (the same
    Hankel data); the initial states, windows and noise are batched.
    ``solver_state0``: an iterative solver's warm start, batch leading,
    such as a previous segment's ``result.solver_state``."""
    return closed_loop_rollout(
        plant, solver, x0s, u_pasts, y_pasts, Ws, n_steps=n_steps,
        n_mpc_step=n_mpc_step, admm_iters=admm_iters,
        solver_state0=solver_state0,
    )


def make_batched_rollout(
    plant: LTIParams,
    solver,
    n_steps: int,
    n_mpc_step: int = 1,
    admm_iters: int = 100,
) -> Callable[..., ClosedLoopResult]:
    """``run(x0s, u_pasts, y_pasts, Ws) -> ClosedLoopResult`` (see
    :func:`batched_closed_loop`)."""

    def run(x0s, u_pasts, y_pasts, Ws):
        return batched_closed_loop(
            plant, solver, x0s, u_pasts, y_pasts, Ws, n_steps=n_steps,
            n_mpc_step=n_mpc_step, admm_iters=admm_iters,
        )

    return run


def stack_solution_maps(sol_maps):
    """Per-scenario operators of one type (:class:`SolutionMap` or
    :class:`~direct_data_driven_mpc_tpu_torch.qp.admm.ADMMSolver`), on
    one device, stacked field by field on a leading scenario axis for
    :func:`heterogeneous_closed_loop`."""
    sol_maps = list(sol_maps)
    kind = type(sol_maps[0])
    if kind not in (SolutionMap, ADMMSolver) or any(
        type(s) is not kind for s in sol_maps
    ):
        raise TypeError(
            "stack_solution_maps takes SolutionMaps or ADMMSolvers, all "
            f"of one type; got {sorted({type(s).__name__ for s in sol_maps})}"
        )
    return kind(*(torch.stack(fields) for fields in zip(*sol_maps)))


def stack_plants(plants) -> LTIParams:
    """Per-scenario plant matrices stacked on a leading scenario axis
    (host float64, as :class:`LTIParams` keeps them)."""
    return LTIParams(*(np.stack([np.asarray(a) for a in mats])
                       for mats in zip(*plants)))


def heterogeneous_closed_loop(
    plants: LTIParams,
    solvers,
    x0s: torch.Tensor,
    u_pasts: torch.Tensor,
    y_pasts: torch.Tensor,
    Ws: torch.Tensor,
    n_steps: int,
    n_mpc_step: int = 1,
    admm_iters: int = 100,
) -> ClosedLoopResult:
    """A scenario batch in which every axis varies per scenario: the
    noise, the data realisation (so the solution operator) and the plant.
    ``plants`` (:func:`stack_plants`) and ``solvers``
    (:func:`stack_solution_maps`) carry a leading scenario axis, and
    each of their products is batched, one matrix per scenario. One
    operator per data realisation comes from
    ``qp.batch_build.build_batched_solution_operators`` (one batched
    factorisation on the device) and ``stacked_solution_map``, or from
    maps built one by one and stacked."""
    if not isinstance(solvers, (SolutionMap, ADMMSolver)):
        raise TypeError(
            "heterogeneous_closed_loop takes stacked SolutionMaps or "
            f"ADMMSolvers; got {type(solvers).__name__}"
        )
    Bsz = x0s.shape[0]
    for name, a in zip(LTIParams._fields, plants):
        if np.ndim(a) != 3 or np.shape(a)[0] != Bsz:
            raise ValueError(
                f"plant matrix {name} must be stacked per scenario "
                f"({Bsz}, ., .); got {np.shape(a)}"
            )
    if solvers[0].shape[0] != Bsz:
        raise ValueError(
            f"solvers are stacked for {solvers[0].shape[0]} scenarios, "
            f"the batch has {Bsz}"
        )
    return closed_loop_rollout(
        plants, solvers, x0s, u_pasts, y_pasts, Ws, n_steps=n_steps,
        n_mpc_step=n_mpc_step, admm_iters=admm_iters,
    )
