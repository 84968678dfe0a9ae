"""Initial-state estimation and equilibrium pairs on tensors.

The observability and input-output Toeplitz matrices, the
least-squares initial-state observer and the DC-gain equilibrium pair,
each in the dtype of its first matrix, on that matrix's device when it
is a tensor, else on ``device`` (None: the card), in IEEE float32
whatever the caller set (``ops.precision``). They run when a
plant or controller is built, not in a closed loop. Counterpart of
``direct_data_driven_mpc_tpu/ops/estimation.py``; the float64 numpy
versions are in ``ops.host``.
"""

from __future__ import annotations

import torch

from direct_data_driven_mpc_tpu_torch.device import as_device_tensor
from direct_data_driven_mpc_tpu_torch.ops.precision import ieee_float32


def _like(ref: torch.Tensor, *arrays):
    return [torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
            for a in arrays]


def _a_powers(A: torch.Tensor, t: int) -> torch.Tensor:
    """``[I, A, ..., A^(t-1)]`` as ``(t, n, n)``."""
    pows = [torch.eye(A.shape[0], dtype=A.dtype, device=A.device)]
    for _ in range(t - 1):
        pows.append(pows[-1] @ A)
    return torch.stack(pows)


@ieee_float32()
def observability_matrix(A, C, device=None) -> torch.Tensor:
    """``vstack(C A^i, i = 0..n-1)`` with ``n = A.shape[0]``."""
    A = as_device_tensor(A, device)
    (C,) = _like(A, C)
    n = A.shape[0]
    return (C @ _a_powers(A, n)).reshape(n * C.shape[0], n)


@ieee_float32()
def toeplitz_input_output_matrix(A, B, C, D, t: int,
                                 device=None) -> torch.Tensor:
    """The block lower-triangular Toeplitz map from ``t`` inputs to ``t``
    outputs: block ``(i, j)`` is ``D`` for ``i == j``, ``C A^(i-j-1) B``
    for ``j < i`` and zero above the diagonal, in ``p x m`` blocks."""
    t = int(t)
    if t <= 0:
        raise ValueError("The number of time steps t must be positive.")
    A = as_device_tensor(A, device)
    B, C, D = _like(A, B, C, D)
    m, p = B.shape[1], C.shape[0]
    # Markov parameters: G[0] = D, G[k] = C A^(k-1) B for k >= 1.
    G = torch.cat([D[None], C @ _a_powers(A, t)[: t - 1] @ B])
    k = (torch.arange(t, device=A.device)[:, None]
         - torch.arange(t, device=A.device)[None, :])
    blocks = G[k.clamp(min=0)] * (k >= 0)[:, :, None, None].to(A.dtype)
    return blocks.permute(0, 2, 1, 3).reshape(t * p, t * m)


@ieee_float32()
def estimate_initial_state(Ot, Tt, U, Y, device=None) -> torch.Tensor:
    """The least-squares observer ``x0 = pinv(Ot) (Y - Tt U)``, with
    ``U`` and ``Y`` the stacked input and output histories ``(t m,)``
    and ``(t p,)``."""
    Ot = as_device_tensor(Ot, device)
    Tt, U, Y = _like(Ot, Tt, U, Y)
    if Ot.shape[0] != Y.shape[0]:
        raise ValueError(
            f"Dimension mismatch: Ot has {Ot.shape[0]} rows but Y has "
            f"{Y.shape[0]} rows."
        )
    if Tt.shape[0] != Y.shape[0]:
        raise ValueError(
            f"Dimension mismatch: Tt has {Tt.shape[0]} rows but Y has "
            f"{Y.shape[0]} rows."
        )
    if Tt.shape[1] != U.shape[0]:
        raise ValueError(
            f"Dimension mismatch: Tt has {Tt.shape[1]} columns but U has "
            f"{U.shape[0]} rows."
        )
    return torch.linalg.pinv(Ot) @ (Y - Tt @ U)


@ieee_float32()
def dc_gain(A, B, C, D, device=None) -> torch.Tensor:
    """The steady-state gain ``C (I - A)^-1 B + D``."""
    A = as_device_tensor(A, device)
    B, C, D = _like(A, B, C, D)
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return C @ torch.linalg.solve(eye - A, B) + D


@ieee_float32()
def calculate_equilibrium_output_from_input(A, B, C, D, u_eq, device=None
                                            ) -> torch.Tensor:
    """``y_eq = M u_eq`` with the DC gain ``M``."""
    M = dc_gain(A, B, C, D, device)
    return M @ _like(M, u_eq)[0]


@ieee_float32()
def calculate_equilibrium_input_from_output(A, B, C, D, y_eq, device=None
                                            ) -> torch.Tensor:
    """``u_eq = pinv(M) y_eq`` with the DC gain ``M``."""
    M = dc_gain(A, B, C, D, device)
    return torch.linalg.pinv(M) @ _like(M, y_eq)[0]
