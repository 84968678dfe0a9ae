"""Segmented, checkpointable closed-loop execution.

Splits a long batched rollout into fixed-length segments. Between
segments the full rollout state (plant states, measurement windows, the
iterative solver's warm start, the segment index and the base seed) is a
:class:`SegmentState` that can be checkpointed
(``utils.checkpoint``) and resumed deterministically: segment ``i``'s
noise is ``parallel.batch.draw_noise_batch`` under a seed that is a
fixed function of ``(seed, i)`` (:func:`segment_noise`), so however a
run is split into calls it draws the same noise, and a run resumed from
a checkpoint continues the uninterrupted one bit for bit; each
scenario's noise is its own, whatever the batch size. The solver
state is carried across segments, so no segment cold-starts an
iterative solver.

Counterpart of ``direct_data_driven_mpc_tpu/control/segmented.py``,
where the base seed is a JAX key and segment ``i`` draws from
``fold_in(key, i)``; the two packages draw different numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from direct_data_driven_mpc_tpu_torch.control.loop import ClosedLoopResult
from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams
from direct_data_driven_mpc_tpu_torch.parallel.batch import (
    batched_closed_loop,
    draw_noise_batch,
)
from direct_data_driven_mpc_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)


@dataclasses.dataclass
class SegmentState:
    """Resumable rollout state."""

    x: torch.Tensor  # (B, ns) plant states
    u_past: torch.Tensor  # (B, n, m)
    y_past: torch.Tensor  # (B, n, p)
    segment: int  # next segment index to run
    seed: int  # base seed (never advanced; combined with each segment)
    solver_state: object = None  # batched iterative-solver warm start
    # (ADMMState, BoxADMMState or NonConvexState with (B, ...) leaves;
    # None for the exact affine map and for a cold first segment). To
    # resume a run that carries one from a checkpoint, the template
    # passed to resume_from_checkpoint carries a zero-filled state of
    # the same type, shapes and dtypes.


def segment_noise(seed: int, segment: int, B: int, segment_steps: int,
                  p: int, eps_max: float, device,
                  dtype=torch.float32) -> torch.Tensor:
    """Segment ``segment``'s measurement noise ``(B, segment_steps, p)``
    on ``device``: ``parallel.batch.draw_noise_batch`` under a seed that
    is a fixed function of ``(seed, segment)``, so scenario ``i``'s rows
    depend on ``(seed, segment, i)`` alone."""
    state = np.random.SeedSequence((seed, segment)).generate_state(
        1, np.uint64
    )
    return draw_noise_batch(int(state[0]), B, segment_steps, p, eps_max,
                            device, dtype)


def run_segmented(
    plant: LTIParams,
    solver,
    state: SegmentState,
    eps_max: float,
    segment_steps: int,
    n_segments: int,
    n_mpc_step: int = 1,
    admm_iters: int = 100,
    checkpoint_path: Optional[str] = None,
    dtype=torch.float32,
) -> Tuple[SegmentState, ClosedLoopResult]:
    """Run ``n_segments`` segments from ``state`` on its device,
    checkpointing after each when ``checkpoint_path`` is given. Returns
    the advanced state and the concatenated results (time axis) of the
    segments run here."""
    if segment_steps % n_mpc_step:
        # The loop advances the plant through the padded steps of a
        # trailing partial solve block (outputs are trimmed, but the
        # carried state is post-padding), so resumable segments must
        # align with the solve cadence.
        raise ValueError(
            f"segment_steps={segment_steps} must be a multiple of "
            f"n_mpc_step={n_mpc_step} for exact resume semantics."
        )
    B, _, p = state.y_past.shape
    parts = []
    for _ in range(n_segments):
        W = segment_noise(state.seed, state.segment, B, segment_steps, p,
                          eps_max, state.x.device, dtype)
        result = batched_closed_loop(
            plant, solver, state.x, state.u_past, state.y_past, W,
            n_steps=segment_steps, n_mpc_step=n_mpc_step,
            admm_iters=admm_iters, solver_state0=state.solver_state,
        )
        state = SegmentState(
            x=result.x_final,
            u_past=result.u_past,
            y_past=result.y_past,
            segment=state.segment + 1,
            seed=state.seed,
            solver_state=result.solver_state,
        )
        parts.append(result)
        if checkpoint_path is not None:
            save_checkpoint(checkpoint_path, state,
                            metadata={"segment": state.segment})

    def cat(name):
        return torch.cat([getattr(r, name) for r in parts], 1)

    combined = ClosedLoopResult(
        u_sys=cat("u_sys"),
        y_sys=cat("y_sys"),
        costs=cat("costs"),
        converged=cat("converged"),
        x_final=state.x,
        u_past=state.u_past,
        y_past=state.y_past,
        solver_state=state.solver_state,
    )
    return state, combined


def resume_from_checkpoint(
    checkpoint_path: str, template: SegmentState
) -> SegmentState:
    """Load a :class:`SegmentState` checkpoint (the template supplies the
    structure, shapes, dtypes and device)."""
    state, _ = load_checkpoint(checkpoint_path, template)
    return state
