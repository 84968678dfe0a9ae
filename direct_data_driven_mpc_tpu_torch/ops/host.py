"""Float64 numpy host operations used at build time.

Hankel matrices, the persistent-excitation check, the sequential plant
rollout, and the observability / Toeplitz / equilibrium helpers that
``models.lti_model.LTIModel`` uses. Counterpart of
``direct_data_driven_mpc_tpu/ops/host.py``; this package keeps its own
copy because importing the JAX package imports ``jax``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def hankel_matrix_np(X: np.ndarray, L: int) -> np.ndarray:
    """Float64 Hankel matrix; each column is one window of ``L`` samples."""
    X = np.asarray(X, dtype=np.float64)
    N, n = X.shape
    if N < L:
        raise ValueError("N must be greater than or equal to L.")
    n_cols = N - L + 1
    starts = np.arange(L)[:, None] + np.arange(n_cols)[None, :]
    windows = X[starts]  # (L, n_cols, n)
    return windows.transpose(0, 2, 1).reshape(L * n, n_cols)


def evaluate_persistent_excitation_np(
    X: np.ndarray, order: int, tol: float | None = None
) -> Tuple[int, bool]:
    """Float64 persistent-excitation check of ``order``: returns the
    rank of the order-``order`` Hankel matrix and whether it is full."""
    X = np.asarray(X, dtype=np.float64)
    n = X.shape[1]
    H = hankel_matrix_np(X, order)
    rank = int(np.linalg.matrix_rank(H, tol=tol))
    return rank, bool(rank == n * order)


def lti_rollout_np(
    A: np.ndarray,
    B: np.ndarray,
    C: np.ndarray,
    D: np.ndarray,
    x0: np.ndarray,
    U: np.ndarray,
    W: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sequential float64 plant rollout (output before state update)."""
    A, B, C, D = (np.asarray(a, dtype=np.float64) for a in (A, B, C, D))
    x = np.asarray(x0, dtype=np.float64).copy()
    U = np.asarray(U, dtype=np.float64)
    W = np.asarray(W, dtype=np.float64)
    T = U.shape[0]
    Y = np.zeros((T, C.shape[0]))
    for k in range(T):
        Y[k] = C @ x + D @ U[k] + W[k]
        x = A @ x + B @ U[k]
    return x, Y


def observability_matrix_np(A: np.ndarray, C: np.ndarray) -> np.ndarray:
    """``vstack(C A^i, i=0..n-1)`` in float64."""
    A = np.asarray(A, dtype=np.float64)
    C = np.asarray(C, dtype=np.float64)
    n = A.shape[0]
    blocks = []
    Ak = np.eye(n)
    for _ in range(n):
        blocks.append(C @ Ak)
        Ak = Ak @ A
    return np.vstack(blocks)


def toeplitz_input_output_matrix_np(
    A: np.ndarray, B: np.ndarray, C: np.ndarray, D: np.ndarray, t: int
) -> np.ndarray:
    """Block lower-triangular Toeplitz I/O map in float64."""
    if t <= 0:
        raise ValueError("The number of time steps t must be positive.")
    A, B, C, D = (np.asarray(a, dtype=np.float64) for a in (A, B, C, D))
    m = B.shape[1]
    p = C.shape[0]
    # Markov parameters G[0] = D, G[k] = C A^(k-1) B.
    G = [D]
    Ak = np.eye(A.shape[0])
    for _ in range(t - 1):
        G.append(C @ Ak @ B)
        Ak = Ak @ A
    Tt = np.zeros((p * t, m * t))
    for i in range(t):
        for j in range(i + 1):
            Tt[i * p : (i + 1) * p, j * m : (j + 1) * m] = G[i - j]
    return Tt


def estimate_initial_state_np(
    Ot: np.ndarray, Tt: np.ndarray, U: np.ndarray, Y: np.ndarray
) -> np.ndarray:
    """``x0 = pinv(Ot) (Y - Tt U)`` in float64 with shape checks."""
    Ot = np.asarray(Ot, dtype=np.float64)
    Tt = np.asarray(Tt, dtype=np.float64)
    U = np.asarray(U, dtype=np.float64).reshape(-1)
    Y = np.asarray(Y, dtype=np.float64).reshape(-1)
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
    return np.linalg.pinv(Ot) @ (Y - Tt @ U)


def dc_gain_np(
    A: np.ndarray, B: np.ndarray, C: np.ndarray, D: np.ndarray
) -> np.ndarray:
    A, B, C, D = (np.asarray(a, dtype=np.float64) for a in (A, B, C, D))
    n = A.shape[0]
    return C @ np.linalg.solve(np.eye(n) - A, B) + D


def equilibrium_output_from_input_np(A, B, C, D, u_eq) -> np.ndarray:
    return dc_gain_np(A, B, C, D) @ np.asarray(u_eq, dtype=np.float64)


def equilibrium_input_from_output_np(A, B, C, D, y_eq) -> np.ndarray:
    return np.linalg.pinv(dc_gain_np(A, B, C, D)) @ np.asarray(
        y_eq, dtype=np.float64
    )
