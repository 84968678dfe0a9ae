"""Operations and bytes of the benchmark's kernels, from the
configuration's own dimensions, and the card's peaks.

The counts never read a kernel's plan (its solves per block, tiles or
rung groups), so every implementation of the same closed loop is held to
the same work. Each input byte is counted read once and each output
byte written once.
"""

from __future__ import annotations

import numpy as np

#: NVIDIA H100 SXM, published dense peaks at 700 W: TF32 on the tensor
#: cores (the fastest rate at which the card multiplies float32
#: operands, so no float32-grade route can pass it), float32 FMA outside
#: them, and HBM3 bandwidth.
TF32_FLOP_PER_S = 495e12
FP32_FMA_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
FLOAT = 4


def dims(config: dict) -> dict:
    """The closed loop's sizes: plant order ``ns``, inputs ``m``,
    outputs ``p``, controller order ``n``, horizon ``L``, the window
    ``n_theta = n (m + p)`` and the carried state ``S = ns + n_theta``."""
    A = np.asarray(config["model"]["A"])
    C = np.asarray(config["model"]["C"])
    Bm = np.asarray(config["model"]["B"])
    ns, m, p = A.shape[0], Bm.shape[1], C.shape[0]
    n, L = config["controller"]["n"], config["controller"]["L"]
    n_theta = n * (m + p)
    return dict(ns=ns, m=m, p=p, n=n, L=L, n_theta=n_theta,
                S=ns + n_theta)


def k1(config: dict, B: int, T: int) -> tuple:
    """``(flops, bytes)`` of one closed loop through the exact solution
    map: per solve, one affine step of the carried state ``S`` driven by
    the ``p`` noise values, giving the next state, the ``m`` inputs, the
    ``p`` outputs and the cost through the cost factor (rank
    ``n_theta``: a square per column, and the linear part). Bytes: the
    noise read, the inputs, outputs and costs written, the initial and
    final state, the one-step operator."""
    d = dims(config)
    rows = d["p"] + d["S"]
    cols = d["S"] + d["m"] + d["p"] + d["n_theta"] + 1
    per_solve = 2 * rows * cols + 2 * d["n_theta"]
    nbytes = FLOAT * (B * T * (d["p"] + d["m"] + d["p"] + 1)
                      + 2 * B * d["S"] + rows * cols)
    return per_solve * B * T, nbytes


def k4(config: dict, B: int, T: int) -> tuple:
    """``(flops, bytes)`` of one closed loop through fused over-relaxed
    ADMM on the slack box of ``nbox = p L`` rows: per solve, the
    iterations' ``nbox x nbox`` products, the extraction of the input,
    cost and next maps from ``t = s - w``, and the plant step with the
    next solve's maps. Bytes: the noise, carries and operators read
    once, the outputs (inputs, outputs, cost and two residuals per solve,
    the final state and ADMM state) written once."""
    d = dims(config)
    s = config["solver"]
    n_iter = sum(s["iters"])
    nbox = d["p"] * d["L"]
    nbm, nbp, S = d["m"], d["p"], d["S"]
    Mw = nbm + 1
    nxi = d["n_theta"] + nbox
    W1 = Mw + nxi
    D2 = S + nbm + nbp
    W2 = S + nbm + nbp + 1 + nbox + nxi
    per_solve = 2 * (n_iter * nbox ** 2 + nbox * W1 + D2 * W2)
    carry = S + Mw + nbox + nxi + 2 * nbox
    out = (nbm + nbp + 3) * T + S + 2 * nbox
    operators = nbox * nbox + nbox * W1 + D2 * W2 + W2
    nbytes = FLOAT * (B * (nbp * T + carry + out) + operators)
    return per_solve * B * T, nbytes


def bound_ms(flops: float, nbytes: float,
             flop_per_s: float = TF32_FLOP_PER_S) -> tuple:
    """``(ms, "operations" or "bytes")``: the least time for the work,
    the larger of its operations at ``flop_per_s`` and its bytes at the
    HBM rate, and which of the two sets it."""
    t_ops = flops / flop_per_s * 1e3
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def roofline_share(run, kernel: str):
    """``kernel``'s share of its roofline in ``run``, in %: the least time
    of its work (``run.bound_ms``) over the mean kernel span; None in a
    cell of another kernel, or with no spans (an untraced run)."""
    span = run.mean_span_ms()
    if run.kernel != kernel or span is None:
        return None
    return 100.0 * run.bound_ms / span
