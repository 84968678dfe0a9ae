"""Fused batched ADMM closed loop: the operators, the kernel's wrapper,
its plain PyTorch version and the batched entry points.

The iterative solver variants (the CONVEX slack box of the reference,
direct_data_driven_mpc_controller.py:658-675, and the single-rung
input/output box of ``qp/box.py``) run the whole closed loop as one
kernel: per solve, ``n_iter`` warm-started over-relaxed ADMM iterations
on the ``(nbox, nbox)`` operator, the extraction of the applied input,
the cost and the residuals, and one fused product that takes the plant
step and builds the next solve's theta-side maps::

    v  = (s - w) @ Vop + vc;  vh = alpha v + (1 - alpha) s
    s  = clip(vh + w, lo, hi);  w += vh - s                  (n_iter times)
    m1 = (s - w) @ M1          -> u = clip(pre_u + m1_u), cost, rp, rd
    [s_flat | u | w_noise] @ M2 + b2 -> [s' | u_theta' | y | q_theta' |
                                         vc' | z_theta']

Everything a solve carries stays on the chip between solves. The rollout
runs as the hand-written CUDA kernel ``csrc/fused_admm.cu`` on CUDA
tensors (:func:`fused_admm`) and as :func:`fused_admm_reference` on CPU
tensors and in comparisons. The kernel has two bodies, and the plan picks
one, with no option: the resident body (:func:`admm_plan`) holds the
operators in shared memory and ``s``, ``w`` in registers, 64 scenarios a
block, or 32 where the batch is too small for the 64-scenario grid to
fill the card (the same bits); where that does
not fit (``nbox`` above 192, or operators too large for one block, as at
``bench.py``'s ``large_plant``) the wide body (:func:`admm_wide_plan`)
holds every scenario's state in shared memory and streams the operators
(rows padded to a multiple of four floats, :func:`wide_operators`) from
global memory (L2) through an mbarrier ring of row panels that a
producer warp fills.

Counterpart of ``direct_data_driven_mpc_tpu/ops/pallas_admm.py``
(``_normalize_admm_op``, ``_openloop_block_rows``, ``FusedADMMDims``,
``build_fused_admm_operator``, ``compute_setpoint_adds``, the block math
of ``_make_block_math``/``_make_iter_extract``/``_make_plant_step``,
``_make_admm_kernel``, ``make_fused_admm_rollout`` and the amortized
loop of ``bench.py``). Differences from the TPU layout, on purpose:

- no scenario packing: the operators are per scenario (``Vop = V_s^T``
  is ``nbox x nbox``), where the TPU packed ``128 // seg`` scenarios per
  row through block-diagonal operators to fill its 128-lane matrix unit;
- batch-major inputs and outputs ``(B, n_blocks, ...)`` instead of the
  TPU's batch-minor tiles;
- one float32 precision. The TPU schedule ``iters = (n1, n3, n6)`` ran
  its tiers as 1-pass bf16, 3-pass bf16 and 6-pass matrix products;
  here all ``n1 + n3 + n6`` iterations, the cold start and every
  extraction and plant product run in float32 (TF32 off). The tuple is
  kept so a caller finds the counterpart.

This engine takes one penalty; a multi-rung box operator (the adaptive
ladder, kernel K5) goes to ``ops.fused_ladder``, whose kernel is the
ladder instantiation of the same ``csrc/fused_admm.cu`` body.

The NON_CONVEX slack (the paper's Eq. 6d, ``qp.nonconvex``) is a mode of
the same engine and of K4's resident body: given the operator of
``compute_nonconvex_operator_np`` (its ``c_eps`` and alpha maps), each
scenario clips at its own bound, and a solve runs ``outer_iters`` blocks
of ``n_iter`` iterations, each followed by the bound update::

    alpha = a_c + [theta; s - w] @ G,  G = [A_theta^T; A_s^T]
    bound = c_eps (1 + ||alpha||_1)

as ``qp.nonconvex.nonconvex_admm_solve`` runs it, the bound carried
from solve to solve with ``s`` and ``w``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from direct_data_driven_mpc_tpu_torch.control.loop import ClosedLoopResult
from direct_data_driven_mpc_tpu_torch.device import resolve_device
from direct_data_driven_mpc_tpu_torch.ops.precision import ieee_float32
from direct_data_driven_mpc_tpu_torch.qp.admm import ADMMState
from direct_data_driven_mpc_tpu_torch.qp.nonconvex import NonConvexState
from direct_data_driven_mpc_tpu_torch.utils import profiling
from direct_data_driven_mpc_tpu_torch.utils.profiling import span

_OP_KEYS = ("v_c", "V_theta", "V_s", "u_c", "U_theta", "U_s", "cost_P",
            "cost_q", "cost_r")
#: Opt-in shared memory of one thread block (bytes), as in the .cu.
_SMEM_LIMIT = 232448
#: K4's half-height tile (``SMALL_TB`` of the .cu): scenarios a block,
#: 4 a warp, where its grid puts at most one block on each SM.
SMALL_TILE = 32
#: The widest box the resident body takes: three 64-column register
#: tiles per lane (the wide body takes any box its plan fits).
_MAX_NBOX = 192
#: The wide body's windows: at most this many 4 x 4 output tiles (one
#: 32-tile slot a consumer warp); a ring stage holds at least
#: ``_WIDE_MIN_PANEL`` rows of the widest window; ``WIDE_STAGES`` stages
#: after a 128-byte head of mbarriers (``WIDE_STAGES`` of the .cu: two
#: measured faster than three or four).
_WIDE_TILES = 512
_WIDE_MIN_PANEL = 4
WIDE_STAGES = 2
_WIDE_HEAD_FLOATS = 32


def _normalize_admm_op(op: dict) -> dict:
    """Accept both ``qp.admm`` (CONVEX slack) and single-rung
    ``qp.box`` operator dicts (from this package or the JAX one);
    return a uniform float64 dict."""
    out = {}
    if np.asarray(op["V_s"]).ndim == 3:  # box ladder: require one rung
        if op["V_s"].shape[0] != 1:
            raise ValueError(
                "the fused ADMM engine needs a SINGLE-rung operator "
                "(build the box operator with a fixed rho, or run the "
                "adaptive ladder through ops.fused_ladder)."
            )
        for k in _OP_KEYS:
            out[k] = np.asarray(op[k], np.float64)[0]
        for k in ("lo", "hi", "u_lo", "u_hi"):
            out[k] = np.asarray(op[k], np.float64)
        out["rho"] = float(np.asarray(op["rhos"]).ravel()[0])
    else:
        for k in _OP_KEYS:
            out[k] = np.asarray(op[k], np.float64)
        # Optional setpoint-delta channels (return_setpoint_maps=True).
        for k in ("V_r", "U_r", "cost_P_ext", "cost_q_ext", "r_bar"):
            if k in op:
                out[k] = np.asarray(op[k], np.float64)
        # NON_CONVEX (compute_nonconvex_operator_np): the alpha maps and
        # the base coefficient of the bound.
        if "c_eps" in op and "A_s" in op:
            out["nc"] = {k: np.asarray(op[k], np.float64)
                         for k in ("a_c", "A_theta", "A_s", "c_eps")}
        nbox = out["v_c"].shape[0]
        b = float(op["bound"])
        out["lo"] = np.full(nbox, -b)
        out["hi"] = np.full(nbox, b)
        nu = out["u_c"].shape[0]
        out["u_lo"] = np.full(nu, -np.inf)
        out["u_hi"] = np.full(nu, np.inf)
        out["rho"] = float(op["rho"])
    out["alpha"] = float(op["alpha"])
    return out


def _openloop_block_rows(plant, n: int, m: int, p: int, nb: int):
    """Open-loop Algorithm-2 solve block as row operators on the
    homogeneous vector ``[s; 1; u_blk; w_blk]`` (float64 host): ``nb``
    plant steps with the applied input as an input channel. Returns
    ``(SP, OutY)``: the next condensed state ``s' = [x'; u_past';
    y_past']`` and the measured outputs."""
    A = np.asarray(plant.A, np.float64)
    B = np.asarray(plant.B, np.float64)
    C = np.asarray(plant.C, np.float64)
    D = np.asarray(plant.D, np.float64)
    ns = A.shape[0]
    n_theta = n * (m + p)
    S = ns + n_theta
    Dfull = S + 1 + nb * m + nb * p
    X = np.zeros((ns, Dfull))
    X[:, :ns] = np.eye(ns)
    TH = np.zeros((n_theta, Dfull))
    TH[:, ns:S] = np.eye(n_theta)
    out_y = np.zeros((nb * p, Dfull))
    for j in range(nb):
        Uj = np.zeros((m, Dfull))
        Uj[:, S + 1 + j * m : S + 1 + (j + 1) * m] = np.eye(m)
        Wj = np.zeros((p, Dfull))
        off = S + 1 + nb * m + j * p
        Wj[:, off : off + p] = np.eye(p)
        Yj = C @ X + D @ Uj + Wj
        X = A @ X + B @ Uj
        TH = np.concatenate(
            [TH[m : n * m], Uj, TH[n * m + p :], Yj], axis=0
        )
        out_y[j * p : (j + 1) * p] = Yj
    SP = np.concatenate([X, TH], axis=0)
    return SP, out_y


class FusedADMMDims(NamedTuple):
    """Sizes of one fused ADMM engine. ``Mw = nb*m + 1`` is the width of
    ``pre = [u_theta | q_theta]``; ``nxi`` the cost features ``[theta;
    t]`` (``+ m + p`` with tracking); ``D2 = S + nb*m + nb*p`` the plant
    product's input ``[s | u | w]``; ``W2`` its output ``[s' |
    u_theta' | y | q_theta' | vc' | z_theta']``."""

    ns: int
    n: int
    m: int
    p: int
    nb: int
    S: int
    n_theta: int
    nbox: int
    nxi: int
    Mw: int
    D2: int
    W2: int
    rho: float
    alpha: float
    n_alpha: int = 0  # NON_CONVEX: alpha's width (0: the box modes)


class NonConvexMaps(NamedTuple):
    """The NON_CONVEX mode's bound update on one device: ``G = [A_theta^T;
    A_s^T]`` ``(n_theta + nbox, lda)`` and ``a_c`` ``(lda,)``, zero past
    ``n_alpha`` up to ``lda``, a multiple of four floats (the kernel reads
    four columns as one float4); ``c_eps`` the base coefficient ``c
    eps_max`` rounded to float32, as a Python float."""

    G: torch.Tensor
    a_c: torch.Tensor
    c_eps: float


class FusedADMMOperator(NamedTuple):
    """The fused operators on one device (per scenario, unpacked).

    ``Gpre`` ``(S, Mw + nbox + nxi)`` maps the initial state to the first
    solve's ``[pre | vc | z_theta]``; ``Vop`` ``(nbox, nbox)`` is the
    iteration operator; ``M1`` ``(nbox, Mw + nxi)`` maps ``t = s - w`` to
    ``[u | q | z]`` additions; ``M2`` ``(D2, W2)`` with bias ``b2`` is the
    plant step and next-solve maps. ``track`` holds the host float64
    setpoint channels (None without tracking)."""

    Gpre: torch.Tensor
    bpre: torch.Tensor
    Vop: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    M1: torch.Tensor
    M2: torch.Tensor
    b2: torch.Tensor
    u_lo: torch.Tensor
    u_hi: torch.Tensor
    track: Optional[dict]
    nc: Optional[NonConvexMaps] = None  # the NON_CONVEX mode's maps


class ADMMCarry(NamedTuple):
    """What the engine carries from one solve to the next, batch-major:
    the plant window ``s (B, S)``, the theta-side maps ``pre (B, Mw)``,
    ``vc (B, nbox)``, ``zth (B, nxi)`` and the ADMM state ``sa``, ``wa``
    ``(B, nbox)``."""

    s: torch.Tensor
    pre: torch.Tensor
    vc: torch.Tensor
    zth: torch.Tensor
    sa: torch.Tensor
    wa: torch.Tensor


def build_fused_admm_operator(
    plant,
    admm_op: dict,
    n: int,
    m: int,
    p: int,
    n_mpc_step: int = 1,
    track: bool = False,
    device=None,
    dtype=torch.float32,
) -> Tuple[FusedADMMOperator, FusedADMMDims]:
    """Host float64 assembly of the fused-engine operators, cast once at
    the end to ``dtype`` on ``device``.

    ``plant`` is an ``LTIParams`` (host matrices); ``admm_op`` a float64
    dict from ``qp.admm.compute_admm_operator_np`` or a single-rung
    ``qp.box.compute_box_admm_operator_np`` (of this package or the JAX
    one), or from ``qp.nonconvex.compute_nonconvex_operator_np``, whose
    alpha maps become ``ops.nc`` (:class:`NonConvexMaps`; no tracking).
    ``track=True`` (needs an operator built with
    ``return_setpoint_maps=True``) extends the cost features to
    ``[theta; t; dr]`` so a per-block setpoint delta enters as three
    additive channels on the carried maps (:func:`compute_setpoint_adds`);
    the iteration operator does not depend on the setpoint. ``device``
    None means the CUDA card (raises without one).
    """
    device = resolve_device(device)
    op = _normalize_admm_op(admm_op)
    ns = np.asarray(plant.A).shape[0]
    nb = n_mpc_step
    n_theta = n * (m + p)
    S = ns + n_theta
    nbox = op["v_c"].shape[0]
    nbm, nbp = nb * m, nb * p
    nxi = n_theta + nbox + ((m + p) if track else 0)
    Mw = nbm + 1
    if op["V_theta"].shape[1] != n_theta:
        raise ValueError(
            f"operator theta width {op['V_theta'].shape[1]} != "
            f"n*(m+p) = {n_theta}"
        )
    if nbm > op["u_c"].shape[0]:
        raise ValueError(
            f"n_mpc_step ({nb}) exceeds the optimized horizon."
        )
    if track and "V_r" not in op:
        raise ValueError(
            "setpoint tracking needs the dr channels: build the "
            "operator with compute_admm_operator_np("
            "return_setpoint_maps=True)."
        )
    if track and "nc" in op:
        raise ValueError("the NON_CONVEX mode has no setpoint tracking")

    V_theta, V_s, v_c = op["V_theta"], op["V_s"], op["v_c"]
    U_theta, U_s, u_c = op["U_theta"], op["U_s"], op["u_c"]
    if track:
        cost_P, cost_q = op["cost_P_ext"], op["cost_q_ext"]
    else:
        cost_P, cost_q = op["cost_P"], op["cost_q"]
    cost_r = float(op["cost_r"])
    # PSD factor of the joint cost quadratic: P = Lc Lc^T.
    evals, V = np.linalg.eigh(0.5 * (cost_P + cost_P.T))
    Lc = V * np.sqrt(np.clip(evals, 0.0, None))  # (nxi, nxi)
    Lc_th = Lc[:n_theta]
    Lc_t = Lc[n_theta : n_theta + nbox]
    q_th = cost_q[:n_theta]
    q_t = cost_q[n_theta : n_theta + nbox]

    # Gpre: s (S) -> [u_theta (nbm) | q_theta (1) | vc (nbox) | zth (nxi)].
    TH0 = np.zeros((n_theta, S))
    TH0[:, ns:] = np.eye(n_theta)
    Gpre = np.concatenate(
        [(U_theta[:nbm] @ TH0).T, (q_th @ TH0)[:, None],
         (V_theta @ TH0).T, (Lc_th.T @ TH0).T], axis=1,
    )
    bpre = np.concatenate(
        [u_c[:nbm], [cost_r], v_c, np.zeros(nxi)]
    )

    # M1: t (nbox) -> [u add (nbm) | q add (1) | z add (nxi)].
    M1 = np.concatenate([U_s[:nbm].T, q_t[:, None], Lc_t], axis=1)

    # M2: [s (S) | u (nbm) | w (nbp)] -> [s' | u_theta' | y | q_theta' |
    # vc' | zth'], from affine rows on [s; 1; u; w].
    SP, OutY = _openloop_block_rows(plant, n, m, p, nb)
    th_rows = SP[ns:]  # theta after the block

    def derived(mat, const):
        rows = mat @ th_rows
        rows[:, S] += const
        return rows

    rows = np.concatenate(
        [
            SP,
            derived(U_theta[:nbm], u_c[:nbm]),
            OutY,
            derived(q_th[None, :], np.array([cost_r])),
            derived(V_theta, v_c),
            derived(Lc_th.T, np.zeros(nxi)),
        ],
        axis=0,
    )
    M2 = np.concatenate([rows[:, :S], rows[:, S + 1 :]], axis=1).T
    b2 = rows[:, S]

    nc = op.get("nc")
    dims = FusedADMMDims(
        ns=ns, n=n, m=m, p=p, nb=nb, S=S, n_theta=n_theta, nbox=nbox,
        nxi=nxi, Mw=Mw, D2=S + nbm + nbp, W2=M2.shape[1],
        rho=float(op["rho"]), alpha=float(op["alpha"]),
        n_alpha=nc["a_c"].shape[0] if nc else 0,
    )
    tk = None
    if track:
        # Host float64 dr-channel maps for compute_setpoint_adds.
        tk = {
            "V_r": op["V_r"],
            "U_r_nb": op["U_r"][:nbm],
            "q_dr": cost_q[n_theta + nbox :],
            "Lc_dr": Lc[n_theta + nbox :],
            "r_bar": op["r_bar"],
        }

    def dev(a):
        return torch.as_tensor(
            np.ascontiguousarray(a), dtype=dtype, device=device
        )

    nc_maps = None
    if nc:
        lda = _ceil4(dims.n_alpha)
        G = np.zeros((n_theta + nbox, lda))
        G[:, : dims.n_alpha] = np.concatenate([nc["A_theta"].T,
                                               nc["A_s"].T])
        a_c = np.zeros(lda)
        a_c[: dims.n_alpha] = nc["a_c"]
        nc_maps = NonConvexMaps(dev(G), dev(a_c),
                                float(np.float32(nc["c_eps"])))
    ops = FusedADMMOperator(
        Gpre=dev(Gpre), bpre=dev(bpre), Vop=dev(V_s.T), lo=dev(op["lo"]),
        hi=dev(op["hi"]), M1=dev(M1), M2=dev(M2), b2=dev(b2),
        u_lo=dev(op["u_lo"][:nbm]), u_hi=dev(op["u_hi"][:nbm]), track=tk,
        nc=nc_maps,
    )
    return ops, dims


def compute_setpoint_adds(ops: FusedADMMOperator, dims: FusedADMMDims,
                          setpoints) -> torch.Tensor:
    """Per-block additive channels for a setpoint schedule (host float64,
    cast to the operators' dtype and device): row t is ``[pre add (Mw) |
    vc add (nbox) | zth add (nxi)]`` for ``dr_t = r_t - r_bar``. The
    cross and pure dr terms of the cost ride the extended z features
    (``zth add = Lc_dr' dr``) plus one scalar (``q_dr . dr``), so the
    per-solve cost stays the same factored quadratic."""
    tk = ops.track
    if tk is None:
        raise ValueError("operators were built without track=True")
    sp = np.asarray(setpoints, np.float64)
    if sp.ndim == 1:
        sp = sp[None]
    dr = sp - tk["r_bar"]
    adds = np.concatenate(
        [dr @ tk["U_r_nb"].T, (dr @ tk["q_dr"])[:, None],
         dr @ tk["V_r"].T, dr @ tk["Lc_dr"]], axis=1,
    )
    return torch.as_tensor(adds, dtype=ops.Vop.dtype, device=ops.Vop.device)


def alpha_l1(theta: torch.Tensor, t: torch.Tensor,
             nc: NonConvexMaps, n_alpha: int) -> torch.Tensor:
    """``||alpha||_1`` per row of ``alpha = a_c + [theta; t] @ G``, summed
    in the kernel's order: lane ``cg`` of a row group takes the columns
    ``4 cg + 64 j + c`` in the order ``(j, c)``, one rounding at a time,
    and the group adds its 16 partial sums by the xor butterfly (offsets
    8, 4, 2, 1), so the bound is the kernel's to the bit wherever the
    product is."""
    a = torch.cat([theta, t], 1) @ nc.G[:, :n_alpha] + nc.a_c[:n_alpha]
    nj = -(-n_alpha // 64)
    a = torch.nn.functional.pad(a.abs(), (0, 64 * nj - n_alpha))
    a = a.reshape(-1, nj, 16, 4).transpose(1, 2).reshape(-1, 16, 4 * nj)
    part = torch.zeros_like(a[:, :, 0])
    for k in range(4 * nj):
        part = part + a[:, :, k]
    for half in (8, 4, 2, 1):
        part = part[:, :half] + part[:, half : 2 * half]
    return part[:, 0]


@ieee_float32()
def fused_admm_reference(ops: FusedADMMOperator, dims: FusedADMMDims,
                         carry: ADMMCarry, W: torch.Tensor, n_iter: int,
                         adds: Optional[torch.Tensor] = None,
                         bound: Optional[torch.Tensor] = None,
                         n_outer: int = 1):
    """Plain PyTorch version of the kernel, in the dtype of ``ops``: one
    solve block per step of a Python loop, the same math and iteration
    count as the kernel.

    ``W`` is the noise ``(B, n_blocks, nb*p)``; ``adds`` the optional
    setpoint channels ``(n_blocks, Mw + nbox + nxi)``. Returns ``U (B,
    n_blocks, nb*m)``, ``Y (B, n_blocks, nb*p)``, the cost ``C``, the
    primal and dual residuals ``RP``, ``RD`` (each ``(B, n_blocks)``)
    and the final ``s (B, S)``, ``sa``, ``wa`` ``(B, nbox)``.

    In the NON_CONVEX mode (``ops.nc`` set) ``bound`` ``(B,)`` is each
    scenario's bound at the start; every solve runs ``n_outer`` blocks of
    ``n_iter`` iterations clipped at ``+-bound``, each followed by the
    bound update (:func:`alpha_l1`), and then ``sigma_pred = (s - w) @
    Vop + vc``. Four more outputs follow: per solve the last update's
    relative step ``DL = |bound' - bound| / (c_eps + bound')``, ``GP =
    max |sigma_pred| - bound`` and the bound ``BD`` (each ``(B,
    n_blocks)``), and the final bound ``(B,)``.

    The products are split at the cost features (``M1``'s z columns,
    ``M2``'s zth' columns), so u, y and the carried state do not depend
    on the width of the cost features: a tracked run at ``dr = 0``
    reproduces the untracked one bit for bit.
    """
    Bsz, n_blocks, _ = W.shape
    S, nbox, Mw = dims.S, dims.nbox, dims.Mw
    nbm, nbp = dims.nb * dims.m, dims.nb * dims.p
    alpha, beta, rho = dims.alpha, 1.0 - dims.alpha, dims.rho
    Wc = S + nbm + nbp + 1 + nbox  # M2 columns before zth'
    M1u = ops.M1[:, :Mw].contiguous()
    M1z = ops.M1[:, Mw:].contiguous()
    M2c, b2c = ops.M2[:, :Wc].contiguous(), ops.b2[:Wc]
    M2z, b2z = ops.M2[:, Wc:].contiguous(), ops.b2[Wc:]
    kw = dict(dtype=ops.Vop.dtype, device=ops.Vop.device)
    U = torch.empty((Bsz, n_blocks, nbm), **kw)
    Y = torch.empty((Bsz, n_blocks, nbp), **kw)
    C = torch.empty((Bsz, n_blocks), **kw)
    RP = torch.empty((Bsz, n_blocks), **kw)
    RD = torch.empty((Bsz, n_blocks), **kw)
    s_flat, pre, vc, zth, s, w = carry
    nc = ops.nc
    lo, hi = ops.lo, ops.hi
    if nc is not None:
        DL, GP, BD = (torch.empty((Bsz, n_blocks), **kw) for _ in range(3))
        n_theta = dims.n_theta
    else:
        n_outer = 1
    for t in range(n_blocks):
        if adds is not None:
            pre = pre + adds[t, :Mw]
            vc = vc + adds[t, Mw : Mw + nbox]
            zth = zth + adds[t, Mw + nbox :]
        v_last = torch.zeros_like(s)
        s_prev = torch.zeros_like(s)
        for _ in range(n_outer):
            if nc is not None:
                lo, hi = -bound[:, None], bound[:, None]
            for _ in range(n_iter):
                v = (s - w) @ ops.Vop + vc
                vh = alpha * v + beta * s
                s_new = torch.clamp(vh + w, lo, hi)
                w = w + vh - s_new
                v_last, s_prev, s = v, s, s_new
            if nc is not None:
                l1 = alpha_l1(s_flat[:, S - n_theta :], s - w, nc,
                              dims.n_alpha)
                bound_new = nc.c_eps * (1.0 + l1)
                DL[:, t] = (bound_new - bound).abs() / (nc.c_eps + bound_new)
                bound = bound_new
        if nc is not None:
            sigma = (s - w) @ ops.Vop + vc
            GP[:, t] = sigma.abs().amax(1) - bound
            BD[:, t] = bound
        RP[:, t] = (v_last - s).abs().amax(1)
        RD[:, t] = rho * (s - s_prev).abs().amax(1)
        tv = s - w
        m1 = tv @ M1u
        u = torch.clamp(pre[:, :nbm] + m1[:, :nbm], ops.u_lo, ops.u_hi)
        z = zth + tv @ M1z
        C[:, t] = (z * z).sum(1) + (pre[:, nbm] + m1[:, nbm])
        U[:, t] = u
        in2 = torch.cat([s_flat, u, W[:, t]], dim=1)
        out = in2 @ M2c + b2c
        s_flat = out[:, :S]
        pre = torch.cat(
            [out[:, S : S + nbm], out[:, S + nbm + nbp : Wc - nbox]], dim=1
        )
        Y[:, t] = out[:, S + nbm : S + nbm + nbp]
        vc = out[:, Wc - nbox :]
        zth = in2 @ M2z + b2z
    if nc is not None:
        return (U, Y, C, RP, RD, s_flat.contiguous(), s, w, DL, GP, BD,
                bound)
    return U, Y, C, RP, RD, s_flat.contiguous(), s, w


def _check_kernel_inputs(ops, dims, carry, W, adds):
    dev = carry.s.device
    Bsz, n_blocks = W.shape[:2]
    nbm, nbp = dims.nb * dims.m, dims.nb * dims.p
    S, nbox, nxi, Mw = dims.S, dims.nbox, dims.nxi, dims.Mw
    shapes = [
        ("Vop", ops.Vop, (nbox, nbox)),
        ("lo", ops.lo, (nbox,)),
        ("hi", ops.hi, (nbox,)),
        ("M1", ops.M1, (nbox, Mw + nxi)),
        ("M2", ops.M2, (dims.D2, dims.W2)),
        ("b2", ops.b2, (dims.W2,)),
        ("u_lo", ops.u_lo, (nbm,)),
        ("u_hi", ops.u_hi, (nbm,)),
        ("s", carry.s, (Bsz, S)),
        ("pre", carry.pre, (Bsz, Mw)),
        ("vc", carry.vc, (Bsz, nbox)),
        ("zth", carry.zth, (Bsz, nxi)),
        ("sa", carry.sa, (Bsz, nbox)),
        ("wa", carry.wa, (Bsz, nbox)),
        ("W", W, (Bsz, n_blocks, nbp)),
    ]
    if adds is not None:
        shapes.append(("adds", adds, (n_blocks, Mw + nbox + nxi)))
    for name, t, shape in shapes:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be float32 on {dev}; got {t.dtype} on "
                f"{t.device}"
            )
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Bsz < 1 or n_blocks < 1:
        raise ValueError(f"empty batch or rollout: W {tuple(W.shape)}")


def _ceil4(x: int) -> int:
    return (x + 3) & ~3


def _ceil32(x: int) -> int:
    return (x + 31) & ~31


def _op_floats(dims: FusedADMMDims) -> int:
    """Shared-memory floats of one operator set (``Vop``, ``M1``, ``M2``,
    ``b2``) and the bounds, rows padded to a multiple of 4 floats, as
    ``csrc/fused_admm.cu`` lays them out (``op_floats``)."""
    nbm, nbp = dims.nb * dims.m, dims.nb * dims.p
    S, nbox, nxi, Mw = dims.S, dims.nbox, dims.nxi, dims.Mw
    D2 = S + nbm + nbp
    W1, W2 = Mw + nxi, D2 + 1 + nbox + nxi
    ldv, ld1, ld2, ldu = _ceil4(nbox), _ceil4(W1), _ceil4(W2), _ceil4(nbm)
    return nbox * ldv + nbox * ld1 + D2 * ld2 + ld2 + 2 * ldv + 2 * ldu


def nonconvex_plan(dims: FusedADMMDims) -> Tuple[int, int]:
    """``(rows, bytes)``: K4's scenarios per thread block and its shared
    memory in the NON_CONVEX mode (``nonconvex_tile_rows`` and
    ``nonconvex_smem_bytes`` of the .cu): K4's block and ``a_c``, ``lda``
    floats (G is read from L2); ``(0, bytes of the 4-row block)`` when
    none fits or ``nbox`` is above 192, which :func:`fused_admm` refuses
    before the launch (the wide body has no NON_CONVEX mode). 64
    scenarios, 112,640 bytes at four-tank (n_alpha 367): two blocks
    share an SM."""
    lda = _ceil4(dims.n_alpha)
    D2 = dims.S + dims.nb * (dims.m + dims.p)
    rows_per = D2 + dims.Mw + dims.nbox + dims.nxi + max(dims.nbox, dims.S)
    for rows in (64, 32, 16, 8, 4):
        nbytes = 4 * (_op_floats(dims) + rows_per * (rows + 4) + lda)
        if nbytes <= _SMEM_LIMIT and dims.nbox <= _MAX_NBOX:
            return rows, nbytes
    return 0, nbytes


def admm_plan(dims: FusedADMMDims, B: Optional[int] = None,
              sms: int = 0) -> Tuple[int, int]:
    """``(rows, bytes)``: kernel K4's scenarios per thread block and its
    shared memory, as ``csrc/fused_admm.cu`` plans them
    (``fused_admm_tile_rows`` and ``fused_admm_smem_bytes``): the largest
    of 64, 32, 16, 8, 4 scenarios whose block fits, so the most warps
    own scenarios, 8 a warp; ``(0, bytes of the 4-row block)`` when none
    fits or ``nbox`` is above 192, where :func:`fused_admm` takes the
    wide body (:func:`admm_wide_plan`). A block holds the operators, the
    carry rows ``[s | u | w]``, ``pre``, ``vc``, ``zth`` and ``d = s -
    w``, over which ``s_next`` is laid (``max(nbox, S)`` rows); ``s`` and
    ``w`` live in registers. 111,168 bytes for 64 scenarios at
    ``four_tank_convex``, so two blocks share an SM.

    With a batch of ``B`` scenarios on a card of ``sms`` SMs
    (:func:`sm_count`), the 64-scenario tile is halved where a grid of
    :data:`SMALL_TILE`-scenario blocks would put at most one on each SM
    (``ceil(B / 32) <= sms``): 32 scenarios a block, 4 a warp, twice the
    blocks (82,624 bytes at ``four_tank_convex``, taken up to B = 4224 on
    a 132-SM H100). Without ``B`` the plan is the full batch's. The
    library decides the tile (:func:`fused_admm` takes its
    ``fused_admm_tile_rows``); this mirror is what the tests hold it to."""
    D2 = dims.S + dims.nb * (dims.m + dims.p)
    rows_per = D2 + dims.Mw + dims.nbox + dims.nxi + max(dims.nbox, dims.S)
    for rows in (64, 32, 16, 8, 4):
        nbytes = 4 * (_op_floats(dims) + rows_per * (rows + 4))
        if nbytes <= _SMEM_LIMIT and dims.nbox <= _MAX_NBOX:
            if rows == 64 and B is not None and -(-B // SMALL_TILE) <= sms:
                rows = SMALL_TILE
                nbytes = 4 * (_op_floats(dims) + rows_per * (rows + 4))
            return rows, nbytes
    return 0, nbytes


def _wide_state_floats(dims: FusedADMMDims, rows: int,
                       frozen: bool = True) -> int:
    """Floats of the wide body's state at ``rows`` scenarios per block:
    the first layout, with ``s`` and ``w`` (``wide_state_floats`` in the
    .cu, which sizes the frozen tile rule), or, with ``frozen=False``,
    the layout the body has now, whose ``s`` and ``w`` live in registers
    (``wide_layout_floats``)."""
    nbm, nbp = dims.nb * dims.m, dims.nb * dims.p
    S, nbox, nxi, Mw = dims.S, dims.nbox, dims.nxi, dims.Mw
    per = (S + nbm + nbp + Mw + nxi + (3 if frozen else 1) * nbox
           + max(nbox, S))
    return (2 * _ceil4(nbox) + 2 * _ceil4(nbm) + per * (rows + 4)
            + 4 * rows)


def _wide_widest(dims: FusedADMMDims, rows: int) -> int:
    """The widest window of the three products at ``rows`` (padded to
    four floats; ``wide_widest`` in the .cu)."""
    window = 4 * (_WIDE_TILES // (rows // 4))
    return max(_ceil4(min(n, window)) for n in (dims.nbox, dims.Mw + dims.nxi,
                                                 _wide_W2(dims)))


def _wide_W2(dims: FusedADMMDims) -> int:
    """``M2``'s width from the sizes, as ``make_shape`` in the .cu."""
    return (dims.S + dims.nb * (dims.m + dims.p) + 1 + dims.nbox
            + dims.nxi)


def wide_group_rows(dims: FusedADMMDims) -> int:
    """The wide bodies' scenarios per block (``wide_group_rows`` of the
    .cu): the largest of 64, 32, 16, 8, 4 whose iteration product is one
    window of 512 tiles (``ceil4(nbox) <= 8192 / rows``) and whose state
    leaves two ring stages of at least four rows of the widest window;
    0 when none does. It is the rule of the body's first plan, frozen:
    K5w's rung group is part of its result."""
    limit = _SMEM_LIMIT // 4
    for rows in (64, 32, 16, 8, 4):
        window = 4 * (_WIDE_TILES // (rows // 4))
        state = _wide_state_floats(dims, rows)
        if _ceil4(dims.nbox) > window or state >= limit:
            continue
        stage = ((limit - state) // 2) & ~3
        if stage >= _WIDE_MIN_PANEL * _wide_widest(dims, rows):
            return rows
    return 0


class WidePlan(NamedTuple):
    """The wide body's plan (``wide_plan`` of the .cu), K4w's and K5w's."""
    rows: int     # scenarios per block (0: none fits)
    stage: int    # floats of one of the WIDE_STAGES ring stages
    bytes: int    # dynamic shared memory of a block
    ldv: int      # padded row of Vop
    ld1: int      # padded row of M1
    ld2: int      # padded row of M2


def wide_plan(dims: FusedADMMDims) -> WidePlan:
    """The wide bodies' plan, as ``wide_plan`` in ``csrc/fused_admm.cu``
    computes it (``fused_wide_tile_rows``, ``fused_wide_stage_floats``,
    ``fused_wide_smem_bytes``): :func:`wide_group_rows` scenarios per
    block; after a 128-byte head of mbarriers and the state (``s`` and
    ``w`` in registers; rounded up to 128 bytes), ``WIDE_STAGES`` ring
    stages that share the rest, each a multiple of 32 floats holding four
    rows of the widest window; the operators' rows padded to a multiple
    of four floats. On a shape without a tile, ``rows`` and ``stage``
    are 0 and ``bytes`` what the 4-row block would need."""
    pads = (_ceil4(dims.nbox), _ceil4(dims.Mw + dims.nxi),
            _ceil4(_wide_W2(dims)))
    rows = wide_group_rows(dims)
    limit = _SMEM_LIMIT // 4
    if rows:
        head = _WIDE_HEAD_FLOATS + _ceil32(
            _wide_state_floats(dims, rows, frozen=False))
        stage = (max(limit - head, 0) // WIDE_STAGES) & ~31
        if stage >= _WIDE_MIN_PANEL * _wide_widest(dims, rows):
            return WidePlan(rows, stage, 4 * (head + WIDE_STAGES * stage),
                            *pads)
    need = 4 * (_WIDE_HEAD_FLOATS + _wide_state_floats(dims, 4, False)
                + WIDE_STAGES * _WIDE_MIN_PANEL * _wide_widest(dims, 4))
    return WidePlan(0, 0, need, *pads)


def admm_wide_plan(dims: FusedADMMDims) -> Tuple[int, int]:
    """``(rows, bytes)``: the wide body's scenarios per thread block and
    its shared memory (:func:`wide_plan`; ``fused_wide_tile_rows`` and
    ``fused_wide_smem_bytes`` of the .cu, shared by the ladder's wide
    kernel). A block holds every scenario's carry, scenario-minor: the
    rows ``[s | u | w]``, ``pre``, ``vc``, ``zth`` and ``d = s - w`` with
    ``s_next`` laid over it, and four row maxima (``s`` and ``w`` stay in
    the registers of the thread that owns their iteration tile); the rest
    of the block is the ring through which the operators stream in row
    panels. 16 scenarios at ``large_plant`` with CONVEX slack
    (nbox 300), 32 on its input box (nbox 200), each with a ring of
    ``WIDE_STAGES`` stages up to the 232,448 bytes a block may opt in
    to."""
    plan = wide_plan(dims)
    return plan.rows, plan.bytes


def wide_operators(Vop: torch.Tensor, M1: torch.Tensor, M2: torch.Tensor):
    """New copies of ``Vop``, ``M1`` and ``M2`` (one operator, or the
    ladder's stack of rungs) with each row padded with zeros to a
    multiple of four floats, as the wide bodies take them, so every panel
    row is a 16-byte aligned run. The wrappers pad at each wide launch
    (a few MB, against a rollout of seconds); the plain versions and the
    resident body take the operators as built."""
    return tuple(
        torch.nn.functional.pad(t, (0, _ceil4(t.shape[-1]) - t.shape[-1]))
        .contiguous() for t in (Vop, M1, M2))


def _card(device) -> str:
    """``device`` named with its index (``"cuda"`` is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def sm_count(device) -> int:
    """The SMs of ``device`` (``torch.cuda.get_device_properties``), read
    once per card: the ``sms`` of :func:`admm_plan`."""
    key = _card(device)
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(
            torch.device(key)).multi_processor_count
    return _SMS[key]


_SMS: dict = {}


def _count_grid(device, B: int, rows: int, small: bool) -> None:
    """Add a resident launch's grid to K4's counters: the SMs its
    ``ceil(B / rows)`` blocks can reach, ``min(blocks, SMs)``, to
    ``fused_admm.sms_reached``, the card's SMs to ``fused_admm.sms_total``,
    and one to ``fused_admm.small_tile_launches`` on the half-height
    tile."""
    sms = sm_count(device)
    fused_admm.sms_reached += min(-(-B // rows), sms)
    fused_admm.sms_total += sms
    fused_admm.small_tile_launches += int(small)


def _nonconvex_counters(device) -> torch.Tensor:
    """The card's NON_CONVEX counters (4 x int64, made zero once)."""
    key = _card(device)
    if key not in _NC_COUNTERS:
        _NC_COUNTERS[key] = torch.zeros(4, dtype=torch.int64, device=device)
    return _NC_COUNTERS[key]


#: K4's NON_CONVEX counters on each card, added to by the launches made
#: under ``utils.profiling.collect()``.
_NC_COUNTERS: dict = {}
NC_COUNTER_NAMES = ("bound_cycles", "kernel_cycles", "bound_active",
                    "nonconvex_solves")


def fused_admm_counters(device=None) -> dict:
    """K4's NON_CONVEX counters on ``device`` (None: every card), summed
    over the launches :func:`fused_admm` made under
    ``utils.profiling.collect()`` (one wait for the card): ``clock64``
    cycles the warps that own scenarios spent in the bound update
    (``bound_cycles``) and in all (``kernel_cycles``), and the
    scenario-solves whose final ``||sigma_pred||_inf`` lies within 1e-4
    relative of their bound (``bound_active``) of all
    (``nonconvex_solves``). Launches outside ``collect()`` pass no
    buffer and count nothing."""
    total = [0] * len(NC_COUNTER_NAMES)
    for key, buf in _NC_COUNTERS.items():
        if device is None or key == _card(device):
            total = [a + b for a, b in zip(total, buf.tolist())]
    return dict(zip(NC_COUNTER_NAMES, total))


def _launch_nonconvex(lib, ops, dims, carry, W, n_iter, bound, n_outer,
                      outs):
    """K4's NON_CONVEX launch (checked by :func:`fused_admm`); returns
    the library's error code."""
    if tuple(bound.shape) != (W.shape[0],) or bound.dtype != torch.float32 \
            or bound.device != carry.s.device or not bound.is_contiguous():
        raise ValueError(
            f"bound must be a contiguous float32 ({W.shape[0]},) tensor on "
            f"{carry.s.device}; got {bound.dtype} {tuple(bound.shape)} on "
            f"{bound.device}")
    if n_iter < 1 or n_outer < 1:
        raise ValueError(f"the NON_CONVEX mode needs n_iter >= 1 and "
                         f"n_outer >= 1; got {n_iter}, {n_outer}")
    counters = (_nonconvex_counters(carry.s.device).data_ptr()
                if profiling.collecting() else None)
    Bsz, n_blocks, nbp = W.shape
    args = (
        ops.Vop.data_ptr(), ops.M1.data_ptr(), ops.M2.data_ptr(),
        ops.b2.data_ptr(), ops.lo.data_ptr(), ops.hi.data_ptr(),
        ops.u_lo.data_ptr(), ops.u_hi.data_ptr(),
        *(c.data_ptr() for c in carry), W.data_ptr(), ops.nc.G.data_ptr(),
        ops.nc.a_c.data_ptr(), bound.data_ptr(),
        *(o.data_ptr() for o in outs), counters,
        Bsz, dims.S, dims.nb * dims.m, nbp, dims.nbox, dims.nxi, n_blocks,
        int(n_iter), dims.n_alpha, int(n_outer),
        dims.alpha, 1.0 - dims.alpha, dims.rho, ops.nc.c_eps,
        torch.cuda.current_stream().cuda_stream,
    )
    with span("ddmpc.kernel", True):
        return lib.fused_admm_nonconvex_launch(*args)


def fused_admm(ops: FusedADMMOperator, dims: FusedADMMDims,
               carry: ADMMCarry, W: torch.Tensor, n_iter: int,
               adds: Optional[torch.Tensor] = None,
               bound: Optional[torch.Tensor] = None, n_outer: int = 1):
    """The fused ADMM rollout (same contract as
    :func:`fused_admm_reference`, the NON_CONVEX mode included).

    CPU tensors run the plain version. CUDA tensors launch kernel K4
    (``csrc/fused_admm.cu``, float32, contiguous): its resident body
    ``fused_admm_kernel`` where :func:`admm_plan` gives rows, adding one
    to ``fused_admm.launches`` (and to ``fused_admm.small_tile_launches``
    on the half-height tile that the library's ``fused_admm_tile_rows``
    takes for a batch too small to fill the card, as :func:`admm_plan`
    mirrors it; each resident launch adds its grid's SMs to
    ``fused_admm.sms_reached`` and the card's to ``fused_admm.sms_total``),
    else its wide body
    ``fused_admm_wide_kernel`` (K4w) where :func:`admm_wide_plan` does,
    on the operators of :func:`wide_operators`, adding one to
    ``fused_admm.wide_launches``; the launch call alone is the span
    ``ddmpc.kernel`` (``utils.profiling``). The NON_CONVEX mode (``ops.nc``
    set) launches the resident body's NON_CONVEX instantiation at
    :func:`nonconvex_plan`, adding one to ``fused_admm.launches``, and,
    under ``utils.profiling.collect()``, adds to the card's counters
    (:func:`fused_admm_counters`). Anything the kernel does not take
    (dtype, shape, contiguity, operators too large for both plans or
    for the NON_CONVEX block, tracking adds in the NON_CONVEX mode)
    raises before the launch; a failed launch raises after it."""
    if carry.s.device.type == "cpu":
        return fused_admm_reference(ops, dims, carry, W, n_iter, adds,
                                    bound, n_outer)
    if carry.s.device.type != "cuda":
        raise ValueError(f"no fused ADMM rollout for device "
                         f"{carry.s.device}")
    _check_kernel_inputs(ops, dims, carry, W, adds)
    if n_iter < 0:
        raise ValueError(f"n_iter={n_iter} must be >= 0")
    if ops.nc is not None:
        rows, nbytes = nonconvex_plan(dims)
        if rows == 0 or adds is not None or bound is None:
            raise ValueError(
                "the NON_CONVEX mode takes a bound per scenario, no "
                "tracking adds, and operators that fit its resident block "
                f"(S={dims.S}, nbox={dims.nbox}, n_alpha={dims.n_alpha}: "
                f"{nbytes} bytes at 4 scenarios per block, nbox at most "
                f"{_MAX_NBOX}, against one block's {_SMEM_LIMIT})")
        from direct_data_driven_mpc_tpu_torch.ops import _kernels

        lib = _kernels.load("fused_admm").lib
        Bsz, n_blocks, nbp = W.shape
        kw = dict(dtype=torch.float32, device=carry.s.device)
        outs = (torch.empty((Bsz, n_blocks, dims.nb * dims.m), **kw),
                torch.empty((Bsz, n_blocks, nbp), **kw),
                *(torch.empty((Bsz, n_blocks), **kw) for _ in range(3)),
                torch.empty((Bsz, dims.S), **kw),
                *(torch.empty((Bsz, dims.nbox), **kw) for _ in range(2)),
                *(torch.empty((Bsz, n_blocks), **kw) for _ in range(3)),
                torch.empty((Bsz,), **kw))
        with torch.cuda.device(carry.s.device):
            err = _launch_nonconvex(lib, ops, dims, carry, W, n_iter, bound,
                                    n_outer, outs)
        if err != 0:
            raise RuntimeError(f"fused_admm NON_CONVEX kernel launch "
                               f"failed: CUDA error {err}")
        fused_admm.launches += 1
        _count_grid(carry.s.device, Bsz, rows, False)
        return outs

    full_rows, nbytes = admm_plan(dims)
    wide = full_rows == 0
    wide_rows, wide_bytes = admm_wide_plan(dims)
    if wide and wide_rows == 0:
        raise ValueError(
            f"operators too large for both of the kernel's shared-memory "
            f"plans (S={dims.S}, nbox={dims.nbox}, nxi={dims.nxi}): the "
            f"resident body needs {nbytes} bytes at 4 scenarios per block "
            f"and nbox at most {_MAX_NBOX}, the wide body {wide_bytes} "
            f"bytes at 4 scenarios per block and its iteration in one "
            f"window, against one block's {_SMEM_LIMIT}"
        )
    from direct_data_driven_mpc_tpu_torch.ops import _kernels

    lib = _kernels.load("fused_admm").lib
    launch = lib.fused_admm_wide_launch if wide else lib.fused_admm_launch
    Vop, M1, M2 = (wide_operators(ops.Vop, ops.M1, ops.M2) if wide
                   else (ops.Vop, ops.M1, ops.M2))
    Bsz, n_blocks, nbp = W.shape
    nbm = dims.nb * dims.m
    sizes = (dims.S, nbm, nbp, dims.nbox, dims.nxi)
    kw = dict(dtype=torch.float32, device=carry.s.device)
    U = torch.empty((Bsz, n_blocks, nbm), **kw)
    Y = torch.empty((Bsz, n_blocks, nbp), **kw)
    C, RP, RD = (torch.empty((Bsz, n_blocks), **kw) for _ in range(3))
    s_fin = torch.empty((Bsz, dims.S), **kw)
    sa_fin = torch.empty((Bsz, dims.nbox), **kw)
    wa_fin = torch.empty((Bsz, dims.nbox), **kw)
    with torch.cuda.device(carry.s.device):
        if not wide:  # the library's tile for this batch on this card
            rows = lib.fused_admm_tile_rows(*sizes, Bsz)
        stream = torch.cuda.current_stream().cuda_stream
        args = (
            Vop.data_ptr(), M1.data_ptr(), M2.data_ptr(),
            ops.b2.data_ptr(), ops.lo.data_ptr(), ops.hi.data_ptr(),
            ops.u_lo.data_ptr(), ops.u_hi.data_ptr(),
            *(c.data_ptr() for c in carry), W.data_ptr(),
            adds.data_ptr() if adds is not None else None,
            U.data_ptr(), Y.data_ptr(), C.data_ptr(), RP.data_ptr(),
            RD.data_ptr(), s_fin.data_ptr(), sa_fin.data_ptr(),
            wa_fin.data_ptr(),
            Bsz, *sizes, n_blocks, int(n_iter),
            dims.alpha, 1.0 - dims.alpha, dims.rho, stream,
        )
        with span("ddmpc.kernel", True):
            err = launch(*args)
    if err != 0:
        raise RuntimeError(
            f"fused_admm {'wide ' if wide else ''}kernel launch failed: "
            f"CUDA error {err}"
        )
    if wide:
        fused_admm.wide_launches += 1
    else:
        fused_admm.launches += 1
        _count_grid(carry.s.device, Bsz, rows, rows != full_rows)
    return U, Y, C, RP, RD, s_fin, sa_fin, wa_fin


#: Launches of the resident body (K4) made by :func:`fused_admm` in this
#: process, and of the wide body (K4w); of the resident launches, those
#: on the half-height tile, and the totals of the SMs their grids reach
#: and of the card's SMs (:func:`_count_grid`).
fused_admm.launches = 0
fused_admm.wide_launches = 0
fused_admm.small_tile_launches = 0
fused_admm.sms_reached = 0
fused_admm.sms_total = 0


def make_fused_admm_rollout(
    plant,
    admm_op: dict,
    n: int,
    m: int,
    p: int,
    n_steps: int,
    n_mpc_step: int = 1,
    iters: Tuple[int, int, int] = (0, 10, 2),
    cold_iters: Optional[int] = None,
    tol: float = 1e-5,
    setpoints=None,
    device=None,
    dtype=torch.float32,
    rollout=fused_admm,
    outer_iters: int = 4,
    outer_tol: float = 1e-6,
):
    """Build the fused batched ADMM closed-loop rollout.

    Args:
        plant: LTI plant matrices (``LTIParams``, the simulated system).
        admm_op: float64 operator dict from ``compute_admm_operator_np``
            (CONVEX slack), a single-rung ``compute_box_admm_operator_np``
            (fixed rho), or ``qp.nonconvex.compute_nonconvex_operator_np``
            (NON_CONVEX slack, recognised by its ``c_eps`` and ``A_s``).
        n, m, p: controller model order / input / output dims.
        n_steps: closed-loop length (ragged: the last solve block is
            cut to the remaining steps).
        n_mpc_step: plant steps per solve (Algorithm 2).
        iters: per-solve iteration schedule ``(n1, n3, n6)`` of the JAX
            engine; every tier runs in float32 here, so only the sum
            ``n1 + n3 + n6`` matters. Convergence is reported per solve
            (``converged = (rp <= tol) & (rd <= tol)``), not assumed.
        cold_iters: iterations run before the kernel (plain PyTorch, on
            the same device) when no warm-start state is given; None: 24.
            The NON_CONVEX mode takes None or 0: its cold start is
            ``qp.nonconvex.nonconvex_initial_state``'s (zero ADMM state,
            the bound at ``c eps_max``), as the generic loop's.
        tol: residual tolerance of the ``converged`` lanes.
        setpoints: optional schedule of absolute ``[u_s; y_s]`` rows,
            ``(n_blocks, m + p)`` (one per solve block) or ``(m + p,)``
            (constant); needs ``admm_op`` built with
            ``return_setpoint_maps=True``. Enters as per-block additive
            channels; the ADMM state warm-starts across changes.
        device, dtype: where and in which dtype the operators live; the
            inputs of ``run`` must be there too. None means the CUDA
            card (raises without one); ``"cpu"`` runs the plain version.
        rollout: :func:`fused_admm` (the kernel on CUDA tensors) or
            :func:`fused_admm_reference` (the plain version anywhere).
        outer_iters, outer_tol: NON_CONVEX only: bound updates per
            solve, each after ``sum(iters)`` iterations, and the
            tolerance of the last update's relative step in
            ``converged``, which follows
            ``qp.nonconvex.nonconvex_admm_solve``: the inner residuals
            at ``tol``, the step at ``outer_tol``, and ``max(0,
            ||sigma_pred||_inf - bound)`` at most ``max(tol, 10 eps (1
            + bound))`` (eps of float32).

    Returns ``run(x0s, u_pasts, y_pasts, Ws, solver_state0=None) ->
    ClosedLoopResult`` with ``solver_state = ADMMState(s, w)`` of shape
    ``(B, nbox)`` (NON_CONVEX: ``NonConvexState(s, w, bound)``, the bound
    ``(B,)``); pass it back as ``solver_state0`` to continue a segmented
    run. Each call is the span ``ddmpc.call``
    (``utils.profiling``) holding ``ddmpc.pack`` (the plant window, the
    theta maps of solve 0, the noise, the carry), ``ddmpc.cold_start``
    (without ``solver_state0``), ``ddmpc.rollout`` (the ``rollout``
    call) and ``ddmpc.result``.
    """
    track = setpoints is not None
    ops, dims = build_fused_admm_operator(
        plant, admm_op, n, m, p, n_mpc_step=n_mpc_step, track=track,
        device=device, dtype=dtype,
    )
    nb, S, ns, nbox, Mw = dims.nb, dims.S, dims.ns, dims.nbox, dims.Mw
    n_blocks = math.ceil(n_steps / nb)
    pad = n_blocks * nb - n_steps
    n_iter = int(sum(iters))
    nonconvex = ops.nc is not None
    if nonconvex and cold_iters:
        raise ValueError(
            "the NON_CONVEX mode starts from nonconvex_initial_state (no "
            f"cold iterations); got cold_iters={cold_iters}")
    if cold_iters is None:
        cold_iters = 0 if nonconvex else 24
    feas_floor = 10.0 * torch.finfo(dtype).eps
    adds = None
    if track:
        sp = np.asarray(setpoints, np.float64)
        if sp.ndim == 1:
            sp = np.tile(sp[None], (n_blocks, 1))
        if sp.shape != (n_blocks, m + p):
            raise ValueError(
                f"setpoints shape {sp.shape} != ({n_blocks}, {m + p}) "
                f"(one [u_s; y_s] row per solve block)"
            )
        adds = compute_setpoint_adds(ops, dims, sp)
    # Split at the cost features, as in the plain version, so the first
    # solve's u and vc do not depend on the tracking width.
    Gc = ops.Gpre[:, : Mw + nbox].contiguous()
    Gz = ops.Gpre[:, Mw + nbox :].contiguous()
    alpha, beta = dims.alpha, 1.0 - dims.alpha
    cuda = ops.Vop.is_cuda

    def run(x0s, u_pasts, y_pasts, Ws, solver_state0=None):
        with span("ddmpc.call"), ieee_float32():
            with span("ddmpc.pack", cuda):
                Bsz = x0s.shape[0]
                s0 = torch.cat(
                    [x0s.reshape(Bsz, -1), u_pasts.reshape(Bsz, -1),
                     y_pasts.reshape(Bsz, -1)], dim=1,
                ).to(dtype)
                # Theta-side maps of solve 0.
                pv = s0 @ Gc + ops.bpre[: Mw + nbox]
                zth0 = s0 @ Gz + ops.bpre[Mw + nbox :]
                pre0, vc0 = pv[:, :Mw], pv[:, Mw:]
                W = Ws.to(dtype)
                if pad:
                    W = torch.cat(
                        [W, torch.zeros((Bsz, pad, dims.p), dtype=dtype,
                                        device=W.device)], dim=1,
                    )
                W = W.reshape(Bsz, n_blocks, nb * dims.p).contiguous()
                carry0 = [c.contiguous() for c in (s0, pre0, vc0, zth0)]
                if solver_state0 is not None:
                    state = [c.to(dtype).contiguous() for c in solver_state0]
                    if len(state) != 2 + nonconvex:
                        raise ValueError(
                            f"solver_state0 has {len(state)} tensors; this "
                            f"engine carries {2 + nonconvex} (s, w"
                            f"{', bound' if nonconvex else ''})")
            if solver_state0 is None:
                with span("ddmpc.cold_start", cuda):
                    sa0 = torch.zeros((Bsz, nbox), dtype=dtype,
                                      device=s0.device)
                    wa0 = torch.zeros_like(sa0)
                    if nonconvex:
                        bound0 = torch.full((Bsz,), ops.nc.c_eps,
                                            dtype=dtype, device=s0.device)
                    # Cold start outside the kernel, at the first block's
                    # setpoint (the engine adds block 0's channels itself,
                    # so vc0 passes through unmodified).
                    vc_cold = (vc0 if adds is None
                               else vc0 + adds[0, Mw : Mw + nbox])
                    for _ in range(cold_iters):
                        v = (sa0 - wa0) @ ops.Vop + vc_cold
                        vh = alpha * v + beta * sa0
                        s_new = torch.clamp(vh + wa0, ops.lo, ops.hi)
                        wa0 = wa0 + vh - s_new
                        sa0 = s_new
                    state = [sa0.contiguous(), wa0.contiguous()]
                    if nonconvex:
                        state.append(bound0)
            carry = ADMMCarry(*carry0, *state[:2])
            with span("ddmpc.rollout"):
                if nonconvex:
                    (U, Y, C, RP, RD, s_fin, sa, wa, DL, GP, BD,
                     bd) = rollout(ops, dims, carry, W, n_iter, None,
                                   bound=state[2], n_outer=outer_iters)
                else:
                    U, Y, C, RP, RD, s_fin, sa, wa = rollout(
                        ops, dims, carry, W, n_iter, adds
                    )
            with span("ddmpc.result", cuda):
                converged = (RP <= tol) & (RD <= tol)
                if nonconvex:
                    feas = torch.clamp(feas_floor * (1.0 + BD), min=tol)
                    converged &= (DL <= outer_tol) & (
                        torch.clamp(GP, min=0.0) <= feas)
                    solver_state = NonConvexState(s=sa, w=wa, bound=bd)
                else:
                    solver_state = ADMMState(s=sa, w=wa)
                return ClosedLoopResult(
                    u_sys=U.reshape(Bsz, -1, dims.m)[:, :n_steps],
                    y_sys=Y.reshape(Bsz, -1, dims.p)[:, :n_steps],
                    costs=C,
                    converged=converged,
                    x_final=s_fin[:, :ns],
                    u_past=s_fin[:, ns : ns + n * m].reshape(Bsz, n, m),
                    y_past=s_fin[:, ns + n * m :].reshape(Bsz, n, p),
                    solver_state=solver_state,
                )

    return run


def make_amortized_admm_run(plant, admm_op: dict, n: int, m: int, p: int,
                            n_steps: int, **kwargs):
    """Throughput harness (the amortized loop of ``bench.py``):
    ``run(x0s, u_pasts, y_pasts, Ws, R) -> (checksum, ok)`` runs ``R``
    back-to-back rollouts, repetition ``i`` on the noise rolled by ``i``
    steps (``torch.roll`` along time). Every repetition's last-solve
    costs, u and y fold into a float32 checksum carried on the device,
    and ``ok`` is true only if the checksum is finite and every solve of
    every repetition converged, so no repetition's work is dead.
    ``kwargs`` go to :func:`make_fused_admm_rollout` (``rollout=`` picks
    the kernel or the plain version)."""
    rollout_fn = make_fused_admm_rollout(
        plant, admm_op, n, m, p, n_steps, **kwargs
    )

    @ieee_float32()
    def run(x0s, u_pasts, y_pasts, Ws, R):
        checksum = torch.zeros((), dtype=torch.float32, device=x0s.device)
        ok = torch.ones((), dtype=torch.bool, device=x0s.device)
        for i in range(R):
            res = rollout_fn(x0s, u_pasts, y_pasts, torch.roll(Ws, i, dims=1))
            checksum = checksum + (
                res.costs[:, -1].sum() + res.u_sys.sum() + res.y_sys.sum()
            ).float()
            ok = ok & res.converged.all()
        return checksum, ok & torch.isfinite(checksum)

    return run
