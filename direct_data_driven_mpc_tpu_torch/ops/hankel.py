"""Hankel matrices and the persistent-excitation check on tensors.

:func:`hankel_matrix` is one gather on the device of its input;
:func:`matrix_rank` the SVD rank with numpy's default threshold, stated
explicitly. :func:`evaluate_persistent_excitation` delegates to the
float64 host check (``ops.host``), as the JAX package's does.
Counterpart of ``direct_data_driven_mpc_tpu/ops/hankel.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from direct_data_driven_mpc_tpu_torch.device import as_device_tensor
from direct_data_driven_mpc_tpu_torch.ops.host import (
    evaluate_persistent_excitation_np,
)


def hankel_matrix(X, L: int, device=None) -> torch.Tensor:
    """The block-Hankel matrix of window length ``L`` of ``X`` (``(N,
    n)``): shape ``(L * n, N - L + 1)``, column ``i`` being
    ``X[i : i + L]`` flattened row by row, in ``X``'s dtype, on ``X``'s
    device when it is a tensor, else on ``device`` (None: the card).
    Raises ``ValueError`` unless ``X`` is 2-D with ``N >= L``."""
    X = as_device_tensor(X, device)
    if X.ndim != 2:
        raise ValueError(
            f"X must be 2-D (N, n); got shape {tuple(X.shape)}."
        )
    N, n = X.shape
    L = int(L)
    if N < L:
        raise ValueError("N must be greater than or equal to L.")
    # unfold: windows[i, j, l] = X[i + l, j]; H[l n + j, i] is that.
    return X.unfold(0, L, 1).permute(2, 1, 0).reshape(L * n, N - L + 1)


def matrix_rank(M, tol: float | None = None, device=None) -> torch.Tensor:
    """The numerical rank of ``M`` (a 0-d tensor on its device, or on
    ``device`` when ``M`` is not a tensor): the singular values above
    ``tol``, by default numpy's threshold ``S.max() * max(M.shape) *
    eps(dtype)``."""
    M = as_device_tensor(M, device)
    s = torch.linalg.svdvals(M)
    if tol is None:
        tol_val = s.max() * max(M.shape) * torch.finfo(M.dtype).eps
    else:
        tol_val = torch.as_tensor(tol, dtype=s.dtype, device=s.device)
    return (s > tol_val).sum()


def evaluate_persistent_excitation(
    X, order: int, tol: float | None = None
) -> Tuple[int, bool]:
    """``(rank, is_persistently_exciting)`` of ``X`` (``(N, n)``) of
    order ``order``: whether its order-``order`` Hankel matrix has rank
    ``n * order``. Computed in float64 on the host: the rank of float32
    data, whose rounding is far above the float64 threshold, would make
    rank-deficient data look exciting."""
    if isinstance(X, torch.Tensor):
        X = X.detach().cpu().numpy()
    X_np = np.asarray(X, dtype=np.float64)
    if X_np.ndim != 2:
        raise ValueError(f"X must be 2-D (N, n); got shape {X_np.shape}.")
    return evaluate_persistent_excitation_np(X_np, order, tol=tol)
