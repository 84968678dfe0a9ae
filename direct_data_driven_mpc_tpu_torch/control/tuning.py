"""Differentiable closed-loop tuning of the robust MPC regularization.

The paper's robust scheme has two hyperparameters that trade tracking
performance against noise robustness: the ridge products
``lambda_alpha * eps_max`` (the YAML key ``lambda_alpha_epsilon_bar``)
and ``lambda_sigma``. For ROBUST slack-``NONE`` controllers the QP
Hessian depends on them as

    H(a, s) = H_stage + 2*a*I_alpha + 2*s*I_sigma,
    a = lambda_alpha * eps_max,   s = lambda_sigma,

with everything else (A, b, S, g) constant. The KKT system is solved by
``torch.linalg.solve`` as a function of ``(a, s)``, so autograd carries
the gradient of any closed-loop objective through the affine solution
operator, the generic loop (``control.loop``) and the scenario batch
back to the two weights, and they can be tuned by gradient descent on
the closed-loop objective itself (expected tracking error under
measurement noise).

Counterpart of ``direct_data_driven_mpc_tpu/control/tuning.py``; the
JAX package ``vmap``s a one-scenario loop where the port's loop is
batched, the scenario axis leading, and ``optax.adam`` becomes
``torch.optim.Adam`` (the same update at its defaults). Runs in float64.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from direct_data_driven_mpc_tpu_torch.control.loop import closed_loop_rollout
from direct_data_driven_mpc_tpu_torch.device import resolve_device
from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams
from direct_data_driven_mpc_tpu_torch.qp.solution_map import (
    SolutionMap,
    _check_dtype_supported,
)
from direct_data_driven_mpc_tpu_torch.qp.spec import (
    DataDrivenMPCType,
    QPSpec,
    SlackVarConstraintTypes,
)


class _KKTPieces(NamedTuple):
    """The constant parts of the ridge-parametric KKT system, on one
    device."""

    K_stage: torch.Tensor  # (nz+nc, nz+nc) KKT matrix without the ridges
    e_alpha: torch.Tensor  # (nz+nc,) alpha-block indicator
    e_sigma: torch.Tensor  # (nz+nc,) sigma-block indicator
    RHS: torch.Tensor  # (nz+nc, 1+n_theta) [base | theta columns]
    g: torch.Tensor  # (nz,)
    r0: float
    nz: int
    u_pred_slice: slice


def _kkt_pieces(spec: QPSpec, dtype, device) -> _KKTPieces:
    """Host float64 constants of the ridge-parametric KKT system, cast
    onto ``device``: in the assembled spec the alpha block of the
    Hessian is exactly ``2*lamb_alpha*eps_max*I`` and the sigma block
    exactly ``2*lamb_sigma*I`` (``qp/assembly.py``), so zeroing those
    diagonals recovers the stage-cost-only Hessian without the original
    weights."""
    if spec.controller_type != DataDrivenMPCType.ROBUST:
        raise ValueError(
            "differentiable tuning requires a ROBUST controller (the "
            "NOMINAL KKT system is singular; its solution operator is "
            "not a differentiable function of ridge weights it does "
            "not have)."
        )
    if spec.slack_var_constraint_type != SlackVarConstraintTypes.NONE:
        raise ValueError(
            "differentiable tuning supports the slack-NONE variant "
            "(the exact affine solution path); CONVEX/NON_CONVEX "
            "solves are iterative."
        )
    _check_dtype_supported(dtype)
    nz, nc = spec.nz, spec.nc
    e_alpha = np.zeros(nz + nc)
    e_alpha[spec.alpha_slice] = 1.0
    e_sigma = np.zeros(nz + nc)
    e_sigma[spec.sigma_slice] = 1.0
    K = np.zeros((nz + nc, nz + nc))
    K[:nz, :nz] = spec.H
    K[:nz, nz:] = spec.A.T
    K[nz:, :nz] = spec.A
    ridges = np.diag_indices(nz)
    K[ridges] -= K[ridges] * (e_alpha + e_sigma)[:nz]
    RHS = np.zeros((nz + nc, 1 + spec.S.shape[1]))
    RHS[:nz, 0] = -spec.g
    RHS[nz:, 0] = spec.b_const
    RHS[nz:, 1:] = spec.S

    def cast(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return _KKTPieces(
        K_stage=cast(K), e_alpha=cast(e_alpha), e_sigma=cast(e_sigma),
        RHS=cast(RHS), g=cast(spec.g), r0=float(spec.r0), nz=nz,
        u_pred_slice=spec.u_pred_slice,
    )


def _solution_map(pieces: _KKTPieces, alpha_reg, sigma_reg) -> SolutionMap:
    """The affine operator at ridge weights ``(alpha_reg, sigma_reg)``,
    differentiable in both."""
    nz = pieces.nz
    ridge = 2.0 * alpha_reg * pieces.e_alpha + 2.0 * sigma_reg * pieces.e_sigma
    K = pieces.K_stage + torch.diag(ridge)
    X = torch.linalg.solve(K, pieces.RHS)
    z_base = X[:nz, 0]
    Z = X[:nz, 1:]

    H = K[:nz, :nz]
    g = pieces.g
    cost_P = 0.5 * (Z.T @ (H @ Z))
    cost_P = 0.5 * (cost_P + cost_P.T)
    cost_q = Z.T @ (H @ z_base + g)
    cost_r = 0.5 * z_base @ (H @ z_base) + g @ z_base + pieces.r0

    u_sl = pieces.u_pred_slice
    return SolutionMap(
        z_base=z_base,
        Z=Z,
        u_base=z_base[u_sl],
        U_gain=Z[u_sl],
        cost_P=cost_P,
        cost_q=cost_q,
        cost_r=cost_r,
    )


def differentiable_solution_map(
    spec: QPSpec,
    alpha_reg,
    sigma_reg,
    dtype=torch.float64,
    device=None,
) -> SolutionMap:
    """Affine solution operator as a differentiable function of the
    ridge products ``alpha_reg = lambda_alpha * eps_max`` and
    ``sigma_reg = lambda_sigma`` (floats, or tensors on ``device`` that
    may require grad), on ``device`` (None: the CUDA card) in ``dtype``.

    The same KKT system and operator fields as
    ``qp.solution_map.compute_solution_operator_np``, solved by
    ``torch.linalg.solve``, so autograd flows through the returned
    operator and any closed-loop rollout built from it.

    Unlike the host path (which checks its residual and falls back to the
    pseudoinverse), the solve does not detect a singular KKT matrix: it
    may yield non-finite values. ROBUST controllers with persistently
    exciting data are nonsingular by construction;
    :func:`tune_regularization` probes the initial objective and fails
    fast otherwise.
    """
    pieces = _kkt_pieces(spec, dtype, resolve_device(device))
    return _solution_map(pieces, alpha_reg, sigma_reg)


def make_closed_loop_objective(
    spec: QPSpec,
    plant: LTIParams,
    x0s,  # (B, ns)
    u_pasts,  # (B, n, m)
    y_pasts,  # (B, n, p)
    Ws,  # (B, n_steps, p)
    n_steps: int,
    n_mpc_step: int = 1,
    u_weight: float = 0.0,
    device=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``loss(log_regs) -> scalar``: the Monte-Carlo mean squared
    closed-loop tracking error (plus ``u_weight`` times the input
    deviation) over a batch of noise realizations, as a function of
    ``log_regs = [log alpha_reg, log sigma_reg]`` (log space keeps the
    ridge weights positive under unconstrained gradient steps).

    The batch (numpy arrays or tensors) and the KKT constants go to
    ``device`` (None: the CUDA card) in float64 once, here; ``log_regs``
    may live on any device and is moved there. The returned function is
    differentiable by autograd: pair it with any ``torch.optim``
    optimizer, or use :func:`tune_regularization`.
    """
    device = resolve_device(device)
    dtype = torch.float64
    pieces = _kkt_pieces(spec, dtype, device)

    def cast(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    x0s, u_pasts, y_pasts, Ws = map(cast, (x0s, u_pasts, y_pasts, Ws))
    y_s = cast(np.asarray(spec.y_s, np.float64))
    u_s = cast(np.asarray(spec.u_s, np.float64))

    def loss(log_regs: torch.Tensor) -> torch.Tensor:
        regs = torch.exp(log_regs.to(device, dtype))
        sol = _solution_map(pieces, regs[0], regs[1])
        res = closed_loop_rollout(
            plant, sol, x0s, u_pasts, y_pasts, Ws,
            n_steps=n_steps, n_mpc_step=n_mpc_step,
        )
        track = ((res.y_sys - y_s) ** 2).mean((1, 2))
        effort = ((res.u_sys - u_s) ** 2).mean((1, 2))
        return (track + u_weight * effort).mean()

    return loss


def tune_regularization(
    loss: Callable[[torch.Tensor], torch.Tensor],
    alpha_reg0: float,
    sigma_reg0: float,
    steps: int = 50,
    learning_rate: float = 0.3,
    verbose: bool = False,
    optimizer: Optional[Callable] = None,
) -> dict:
    """Gradient-descend the ridge weights against a closed-loop
    objective from :func:`make_closed_loop_objective`.

    The two log weights are a float64 leaf tensor on the host (the loss
    moves them to its device). ``optimizer`` is a factory ``params ->
    torch.optim.Optimizer``; by default ``torch.optim.Adam(params,
    lr=learning_rate)``. Returns a dict with the tuned (best seen)
    ``alpha_reg``/``sigma_reg``, the loss history, and the initial and
    final (best) losses.
    """
    params = torch.log(torch.tensor([alpha_reg0, sigma_reg0],
                                    dtype=torch.float64)).requires_grad_()
    make_opt = optimizer or (
        lambda ps: torch.optim.Adam(ps, lr=learning_rate)
    )
    opt = make_opt([params])

    # Fail fast on a singular KKT system (rank-deficient data): the solve
    # does not raise, it yields non-finite values -- so probe the
    # initial loss first.
    with torch.no_grad():
        v0 = loss(params)
    if not bool(torch.isfinite(v0)):
        raise ValueError(
            "closed-loop objective is non-finite at the initial ridge "
            "weights -- the KKT system is likely singular (check "
            "persistent excitation of the data; NOMINAL controllers "
            "are rejected for this reason)."
        )

    history = []
    best = (float("inf"), params.detach().clone())
    for i in range(steps):
        opt.zero_grad()
        value = loss(params)
        value.backward()
        history.append(float(value.detach()))
        if history[-1] < best[0]:
            best = (history[-1], params.detach().clone())
        if verbose:
            a, s = torch.exp(params.detach()).tolist()
            print(
                f"  step {i:3d}: loss {history[-1]:.6e}  "
                f"alpha_reg {a:.4e}  sigma_reg {s:.4e}",
                flush=True,
            )
        opt.step()
    with torch.no_grad():
        final = float(loss(params))
    if final < best[0]:
        best = (final, params.detach().clone())
    history.append(final)
    alpha_reg, sigma_reg = torch.exp(best[1]).tolist()
    return {
        "alpha_reg": alpha_reg,
        "sigma_reg": sigma_reg,
        "loss_history": history,
        "initial_loss": history[0],
        "final_loss": best[0],
    }
