"""Result type shared by the closed-loop engines.

Counterpart of ``direct_data_driven_mpc_tpu/control/loop.py::
ClosedLoopResult``. The generic per-step engine is not ported yet.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch


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
