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

Scenario ``i``'s measurement noise is a pure function of ``(seed, i)``
(:func:`draw_noise_batch`), as JAX's ``fold_in(key, i)`` makes it: a
counter-based hash of ``(seed, global scenario index, element)`` in
32-bit integer arithmetic, the same bits on the CPU and on the card, so
growing the batch or splitting it over ranks (``first_index``) never
changes a scenario's draw. It is not JAX's threefry, so the two packages
give different numbers for the same seed: parity tests feed both the
same numpy noise instead. The classic engine draws its noise inside its
block loop from a ``torch.Generator`` (:func:`draw_block_noise`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from direct_data_driven_mpc_tpu_torch.control.loop import (
    ClosedLoopResult,
    closed_loop_rollout,
)
from direct_data_driven_mpc_tpu_torch.device import resolve_device
from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams
from direct_data_driven_mpc_tpu_torch.qp.admm import ADMMSolver
from direct_data_driven_mpc_tpu_torch.qp.solution_map import SolutionMap


_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for int64 ``h`` in ``[0, 2**32)`` and a
    constant ``c``, split at 16 bits so no product leaves int64's range
    (no signed overflow, so the CPU and the card agree)."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finaliser, a bijection of ``[0, 2**32)``."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _scenario_keys(seed: int, index: torch.Tensor, stream: int):
    """A 32-bit key per global scenario index, hashed with the 64-bit
    seed and a stream number."""
    h = _fmix32(torch.full_like(index, (seed & _M32) ^ 0x9E3779B9))
    h = _fmix32(h ^ ((seed >> 32) & _M32))
    h = _fmix32(h ^ stream)
    h = _fmix32(h ^ (index & _M32))
    return _fmix32(h ^ (index >> 32))


def draw_noise_batch(
    seed: int,
    B: int,
    T: int,
    p: int,
    eps_max: float,
    device=None,
    dtype=torch.float32,
    first_index: int = 0,
) -> torch.Tensor:
    """Bounded uniform measurement noise ``eps_max * U[-1, 1)`` of shape
    ``(B, T, p)`` for the global scenarios ``first_index`` to
    ``first_index + B - 1``, on ``device`` (None: the card).

    Scenario ``i``'s row depends only on ``(seed, i)`` and element ``(t,
    j)`` only on ``(seed, i, t p + j)``: a shard's draw (``first_index``
    its first global scenario) is the same rows of the whole batch's, and
    a longer draw extends a shorter one. Each element is two rounds of a
    32-bit hash of the scenario's keys and its element counter, whose top
    24 bits give ``u`` in ``[-1, 1)`` exactly in float32; the last
    rounding is the product with ``eps_max``, so the CPU and the card
    give the same bits."""
    device = resolve_device(device)
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    index = torch.arange(first_index, first_index + B, dtype=torch.int64,
                         device=device)
    k1 = _scenario_keys(seed, index, 1)[:, None]
    k2 = _scenario_keys(seed, index, 2)[:, None]
    e = torch.arange(T * p, dtype=torch.int64, device=device)[None, :]
    h = _fmix32((k1 + _mul32(e, 0x9E3779B9)) & _M32)
    h = _fmix32(h ^ k2)
    u = ((h >> 8) - (1 << 23)).to(dtype) * 2.0**-23
    return (u * eps_max).view(B, T, p)


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
