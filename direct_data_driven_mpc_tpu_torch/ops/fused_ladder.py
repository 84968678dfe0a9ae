"""Fused batched box-ADMM closed loop with the adaptive penalty ladder:
the stacked operators, the kernel's wrapper, its plain PyTorch version
and the batched entry points.

``qp/box.py`` pre-factorises the box z-step for a ladder of R penalties
(its default); this engine runs that ladder inside the closed loop. Per
solve, a *rung group* of scenarios runs the fixed-penalty engine's
iterations and extraction (``ops.fused_admm``) at the group's current
rung, then balances the rung on the group's residuals (the OSQP-style
relative rule of ``qp/box.py``)::

    rp_blk = max rp,  rd_blk = (max rd) / rho[ri],
    rp_rel = rp_blk / max(max|s|, max|w|, 1e-12)
    rd_rel = rd_blk / max(max|w|, 1e-12)
    ri' = ri + [rp_rel > ratio rd_rel and ri < R-1]
             - [rd_rel > ratio rp_rel and ri > 0]

(maxima over the group's scenarios and box lanes, keeping a NaN;
``ratio`` is ``balance_ratio``, 10 by default as in ``qp/box.py``,
rounded to float32 as the kernel takes it), scales
the dual by ``rho[ri] / rho[ri']`` and takes the plant step with rung
``ri'``'s maps. Every rung's fixed point is the same optimum, so a
converged solve is exact whatever the rung path; the per-scenario
residual lanes report the rest.

**Rung groups.** ``rung_group`` consecutive scenarios share one rung (the
last group may be short): the group is part of the result, not a tiling
detail. The plain version takes any ``rung_group >= 1``; the kernel's
group is its tile (``ladder_tile_rows``: 64 scenarios at
``four_tank_ladder``; where that rule gives none, the wide body's tile,
``ladder_wide_group``: 32 at ``large_plant``), and its wrapper refuses
any other. So ``make_fused_ladder_rollout(rung_group=None)`` means the
kernel's tile for these sizes, on the CPU as on the card.

**One rung resident.** The kernel keeps only its group's current rung in
shared memory (41 KB at ``four_tank_ladder``; all seven rungs would be
287 KB, more than a block may hold). The stack stays in global memory,
where it lives in L2, and a block whose rung moved re-stages its
operators between the balancer and the plant step. Each warp owns eight
of the group's scenarios, whose ``s`` and ``w`` stay in its registers
for the whole rollout, so two blocks share an SM
(:func:`ladder_kernel_smem_bytes`); the group is still sized by the
rule the kernel had before (:func:`ladder_smem_bytes`). Where no group
of that rule fits (nbox above 170 always, since one rung's operators
alone then outgrow a block), the wide body (K5w) runs instead: every
scenario's carry in shared memory and the current rung's operators
streamed from global memory in row panels by a producer warp, so a rung
move only moves a pointer.

**Warm restart.** ``solver_state0.rho_idx`` carries every row's rung;
each group resumes at the rung its rows carry (its ``w`` is scaled for
that rung). Rows of one group that disagree, or an explicit
``init_rung`` that contradicts a group's rung, raise.

Counterpart of ``direct_data_driven_mpc_tpu/ops/pallas_admm.py``
(``build_fused_ladder_operator``, ``_make_ladder_step``,
``_make_ladder_twin``, ``_make_ladder_kernel``,
``make_fused_ladder_rollout``) and of the ladder branch of ``bench.py``'s
amortized loop. Differences on purpose: the group is explicit (the TPU
kernel shared a rung per batch block, its twin across the whole
batch), the restart checks every group (the reference checks row 0
only), and there is no tracking, as in the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from direct_data_driven_mpc_tpu_torch.control.loop import ClosedLoopResult
from direct_data_driven_mpc_tpu_torch.device import resolve_device
from direct_data_driven_mpc_tpu_torch.ops.fused_admm import (
    _SMEM_LIMIT,
    ADMMCarry,
    FusedADMMDims,
    _op_floats,
    build_fused_admm_operator,
    wide_group_rows,
    wide_operators,
)
from direct_data_driven_mpc_tpu_torch.ops.precision import ieee_float32
from direct_data_driven_mpc_tpu_torch.qp.box import BoxADMMState

#: The balancer's default ratio (``qp/box.py``'s, and ``bench.py``'s
#: ladder); any other is the ``balance_ratio`` argument.
BALANCE_RATIO = 10.0
#: Solves of the rung walk's transient that the amortized run's ``ok``
#: does not require to converge (``bench.py``'s ``conv_from``).
CONVERGED_FROM = 10
_STACKED_KEYS = ("v_c", "V_theta", "V_s", "u_c", "U_theta", "U_s",
                 "cost_P", "cost_q", "cost_r")


class FusedLadderOperator(NamedTuple):
    """The fused operators of every rung, stacked on a leading rung axis
    (the per-rung shapes of :class:`~.fused_admm.FusedADMMOperator`):
    ``Gpre (R, S, Mw + nbox + nxi)``, ``bpre``, ``Vop (R, nbox, nbox)``,
    ``M1``, ``M2``, ``b2``; the shared bounds ``lo``, ``hi``, ``u_lo``,
    ``u_hi``; the penalties ``rhos (R,)``."""

    Gpre: torch.Tensor
    bpre: torch.Tensor
    Vop: torch.Tensor
    M1: torch.Tensor
    M2: torch.Tensor
    b2: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    u_lo: torch.Tensor
    u_hi: torch.Tensor
    rhos: torch.Tensor


def build_fused_ladder_operator(
    plant,
    ladder_op: dict,
    n: int,
    m: int,
    p: int,
    n_mpc_step: int = 1,
    device=None,
    dtype=torch.float32,
) -> Tuple[FusedLadderOperator, FusedADMMDims]:
    """One :func:`~.fused_admm.build_fused_admm_operator` per rung (host
    float64, cast once to ``dtype`` on ``device``; None means the CUDA
    card), stacked. ``ladder_op`` is a ``compute_box_admm_operator_np``
    dict (of this package or the JAX one). The dims are rung 0's; only
    their ``rho`` differs between rungs."""
    device = resolve_device(device)
    rhos = np.asarray(ladder_op["rhos"], np.float64)
    per_rung = []
    dims = None
    for r in range(rhos.shape[0]):
        op_r = {k: np.asarray(ladder_op[k], np.float64)[r : r + 1]
                for k in _STACKED_KEYS}
        for k in ("lo", "hi", "u_lo", "u_hi", "alpha"):
            op_r[k] = ladder_op[k]
        op_r["rhos"] = rhos[r : r + 1]
        ops_r, dims_r = build_fused_admm_operator(
            plant, op_r, n, m, p, n_mpc_step=n_mpc_step, device=device,
            dtype=dtype,
        )
        per_rung.append(ops_r)
        dims = dims if dims is not None else dims_r
    first = per_rung[0]

    def stack(name):
        return torch.stack([getattr(o, name) for o in per_rung]).contiguous()

    ops = FusedLadderOperator(
        Gpre=stack("Gpre"), bpre=stack("bpre"), Vop=stack("Vop"),
        M1=stack("M1"), M2=stack("M2"), b2=stack("b2"), lo=first.lo,
        hi=first.hi, u_lo=first.u_lo, u_hi=first.u_hi,
        rhos=torch.as_tensor(rhos, dtype=dtype, device=device),
    )
    return ops, dims


def ladder_smem_bytes(dims: FusedADMMDims, tile: int) -> int:
    """The rung-group rule: the bytes by which :func:`ladder_tile_rows`
    sizes a group of ``tile`` scenarios (``rung_group_bytes`` in the
    .cu). It is the layout both ADMM kernels had before their redesigns
    (one rung's operators; the carry with ``s``, ``w`` and a
    double-buffered ``s - w``; the residual bits and the balancer
    maxima), kept so the groups, which are part of the result, do not
    move. The kernel's own block is :func:`ladder_kernel_smem_bytes`."""
    nbm, nbp = dims.nb * dims.m, dims.nb * dims.p
    S, nbox, nxi, Mw = dims.S, dims.nbox, dims.nxi, dims.Mw
    carry_rows = S + nbm + nbp + S + Mw + nbox + nxi + 4 * nbox
    return 4 * (_op_floats(dims) + carry_rows * (tile + 4) + 2 * tile + 4)


def ladder_kernel_smem_bytes(dims: FusedADMMDims, tile: int) -> int:
    """Shared memory of one ladder kernel block of ``tile`` scenarios,
    as ``csrc/fused_admm.cu`` lays it out (``fused_ladder_smem_bytes``):
    one rung's operators, the carry rows ``[s | u | w]``, ``s_next``,
    ``pre``, ``vc``, ``zth`` and ``d = s - w`` (``s`` and ``w`` live in
    registers), and four group maxima per warp. 100,736 bytes at
    ``four_tank_ladder``, so two blocks share an SM."""
    nbm, nbp = dims.nb * dims.m, dims.nb * dims.p
    S, nbox, nxi, Mw = dims.S, dims.nbox, dims.nxi, dims.Mw
    carry_rows = S + nbm + nbp + S + Mw + nbox + nxi + nbox
    return 4 * (_op_floats(dims) + carry_rows * (tile + 4) + 4 * 8)


def ladder_tile_rows(dims: FusedADMMDims) -> int:
    """Scenarios per thread block of the ladder kernel for these sizes
    (the largest of 64, 32, 16, 8, 4 whose group rule,
    :func:`ladder_smem_bytes`, fits one block's shared memory; 0 when
    none does): the default rung group. Mirrors ``fused_ladder_tile_rows``
    of the ``.cu``, so the CPU and the card group alike without a card
    at hand."""
    for tile in (64, 32, 16, 8, 4):
        if ladder_smem_bytes(dims, tile) <= _SMEM_LIMIT:
            return tile
    return 0


def ladder_wide_group(dims: FusedADMMDims) -> int:
    """The default rung group where :func:`ladder_tile_rows` gives 0: the
    wide ladder kernel's (K5w) scenarios per block, the tile rule it
    shares with K4w (:func:`~.fused_admm.wide_group_rows`,
    ``fused_wide_tile_rows`` of the ``.cu``), frozen at the plan the wide
    body first had: the largest of 64, 32, 16, 8, 4 scenarios whose state
    in that layout (the carry rows, ``s``, ``w``, ``d`` under ``s_next``,
    four row maxima) leaves a two-stage ring of at least four rows of the
    widest window of ``Vop``, ``M1``, ``M2``, with the iteration product
    one window (``ceil4(nbox) <= 8192 / rows``); 0 when none does. 32 at
    ``large_plant`` (nbox 200). Mirrored here so the CPU and the card
    group alike without a card at hand."""
    return wide_group_rows(dims)


def _per_rung(fn, row_rung: torch.Tensor, present):
    """``fn(r)`` (a ``(B, w)`` tensor) taken, row by row, at each row's
    rung. Each product runs over the whole batch, so a row's result does
    not depend on which rows share its rung."""
    out = fn(present[0])
    for r in present[1:]:
        out = torch.where((row_rung == r)[:, None], fn(r), out)
    return out


def _ratio32(balance_ratio: float) -> float:
    """The balance ratio as the kernel takes it, rounded to float32
    (its product with a float32 residual ratio is then the kernel's
    ``__fmul_rn``, also at a ratio float32 cannot hold exactly)."""
    return float(np.float32(balance_ratio))


@ieee_float32()
def fused_ladder_reference(ops: FusedLadderOperator, dims: FusedADMMDims,
                           carry: ADMMCarry, W: torch.Tensor, n_iter: int,
                           rung0: torch.Tensor, rung_group: int,
                           balance_ratio: float = BALANCE_RATIO):
    """Plain PyTorch version of the ladder kernel, in the dtype of
    ``ops``: per solve block, the fixed-penalty solve at each group's
    rung, the balancer at ``balance_ratio`` (rounded to float32), and
    the plant step at the new rung.

    ``W`` is the noise ``(B, n_blocks, nb*p)``; ``rung0`` the first rung
    of each of the ``ceil(B / rung_group)`` groups. Returns ``U``,
    ``Y``, ``C``, ``RP``, ``RD`` as :func:`~.fused_admm.
    fused_admm_reference` does, the post-balance rung of every solve
    ``RUNG (B, n_blocks)`` (int32) and the final ``s``, ``sa``, ``wa``.
    """
    Bsz, n_blocks, _ = W.shape
    S, nbox, Mw = dims.S, dims.nbox, dims.Mw
    nbm, nbp = dims.nb * dims.m, dims.nb * dims.p
    alpha, beta = dims.alpha, 1.0 - dims.alpha
    R = ops.Vop.shape[0]
    G = int(rung_group)
    n_groups = -(-Bsz // G)
    pad = n_groups * G - Bsz
    Wc = S + nbm + nbp + 1 + nbox  # M2 columns before zth'
    M1u, M1z = ops.M1[:, :, :Mw], ops.M1[:, :, Mw:]
    M2c, b2c = ops.M2[:, :, :Wc], ops.b2[:, :Wc]
    M2z, b2z = ops.M2[:, :, Wc:], ops.b2[:, Wc:]
    dev = ops.Vop.device
    kw = dict(dtype=ops.Vop.dtype, device=dev)
    U = torch.empty((Bsz, n_blocks, nbm), **kw)
    Y = torch.empty((Bsz, n_blocks, nbp), **kw)
    C = torch.empty((Bsz, n_blocks), **kw)
    RP = torch.empty((Bsz, n_blocks), **kw)
    RD = torch.empty((Bsz, n_blocks), **kw)
    RUNG = torch.empty((Bsz, n_blocks), dtype=torch.int32, device=dev)
    tiny = torch.tensor(1e-12, **kw)
    ratio = _ratio32(balance_ratio)
    rung = rung0.to(device=dev, dtype=torch.int64)
    if rung.shape != (n_groups,):
        raise ValueError(f"rung0 has shape {tuple(rung.shape)}, expected "
                         f"({n_groups},) for rung_group={G}")

    def group_max(x):  # (B,) non-negative -> (n_groups,), keeps a NaN
        return F.pad(x, (0, pad)).view(n_groups, G).amax(1)

    s_flat, pre, vc, zth, s, w = carry
    for t in range(n_blocks):
        rows = rung.repeat_interleave(G)[:Bsz]
        present = sorted(set(rung.tolist()))
        v_last = torch.zeros_like(s)
        s_prev = torch.zeros_like(s)
        for _ in range(n_iter):
            d = s - w
            v = _per_rung(lambda r: d @ ops.Vop[r], rows, present) + vc
            vh = alpha * v + beta * s
            s_new = torch.clamp(vh + w, ops.lo, ops.hi)
            w = w + vh - s_new
            v_last, s_prev, s = v, s, s_new
        rho = ops.rhos[rows]
        RP[:, t] = (v_last - s).abs().amax(1)
        RD[:, t] = rho * (s - s_prev).abs().amax(1)
        tv = s - w
        m1 = _per_rung(lambda r: tv @ M1u[r], rows, present)
        u = torch.clamp(pre[:, :nbm] + m1[:, :nbm], ops.u_lo, ops.u_hi)
        z = zth + _per_rung(lambda r: tv @ M1z[r], rows, present)
        C[:, t] = (z * z).sum(1) + (pre[:, nbm] + m1[:, nbm])
        U[:, t] = u

        # Balance each group's rung.
        s_mag = group_max(s.abs().amax(1))
        w_mag = group_max(w.abs().amax(1))
        rp_rel = group_max(RP[:, t]) / torch.maximum(
            torch.maximum(s_mag, w_mag), tiny
        )
        rd_rel = (group_max(RD[:, t]) / ops.rhos[rung]) / torch.maximum(
            w_mag, tiny
        )
        up = (rp_rel > ratio * rd_rel) & (rung < R - 1)
        down = (rd_rel > ratio * rp_rel) & (rung > 0)
        new = rung + up.long() - down.long()
        w = w * (ops.rhos[rung] / ops.rhos[new]).repeat_interleave(G)[
            :Bsz, None
        ]
        rung = new
        rows = rung.repeat_interleave(G)[:Bsz]
        present = sorted(set(rung.tolist()))
        RUNG[:, t] = rows.to(torch.int32)

        in2 = torch.cat([s_flat, u, W[:, t]], dim=1)
        out = _per_rung(lambda r: in2 @ M2c[r] + b2c[r], rows, present)
        s_flat = out[:, :S]
        pre = torch.cat(
            [out[:, S : S + nbm], out[:, S + nbm + nbp : Wc - nbox]], dim=1
        )
        Y[:, t] = out[:, S + nbm : S + nbm + nbp]
        vc = out[:, Wc - nbox :]
        zth = _per_rung(lambda r: in2 @ M2z[r] + b2z[r], rows, present)
    return U, Y, C, RP, RD, RUNG, s_flat.contiguous(), s, w


def _check_kernel_inputs(ops, dims, carry, W, rung0, n_groups):
    dev = carry.s.device
    Bsz, n_blocks = W.shape[:2]
    nbm, nbp = dims.nb * dims.m, dims.nb * dims.p
    S, nbox, nxi, Mw = dims.S, dims.nbox, dims.nxi, dims.Mw
    R = ops.Vop.shape[0]
    shapes = [
        ("Vop", ops.Vop, (R, nbox, nbox)),
        ("M1", ops.M1, (R, nbox, Mw + nxi)),
        ("M2", ops.M2, (R, dims.D2, dims.W2)),
        ("b2", ops.b2, (R, dims.W2)),
        ("lo", ops.lo, (nbox,)),
        ("hi", ops.hi, (nbox,)),
        ("u_lo", ops.u_lo, (nbm,)),
        ("u_hi", ops.u_hi, (nbm,)),
        ("rhos", ops.rhos, (R,)),
        ("s", carry.s, (Bsz, S)),
        ("pre", carry.pre, (Bsz, Mw)),
        ("vc", carry.vc, (Bsz, nbox)),
        ("zth", carry.zth, (Bsz, nxi)),
        ("sa", carry.sa, (Bsz, nbox)),
        ("wa", carry.wa, (Bsz, nbox)),
        ("W", W, (Bsz, n_blocks, nbp)),
        ("rung0", rung0, (n_groups,)),
    ]
    for name, t, shape in shapes:
        want = torch.int32 if name == "rung0" else torch.float32
        if t.device != dev or t.dtype != want:
            raise ValueError(
                f"{name} must be {want} on {dev}; got {t.dtype} on "
                f"{t.device}"
            )
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Bsz < 1 or n_blocks < 1:
        raise ValueError(f"empty batch or rollout: W {tuple(W.shape)}")


def fused_ladder(ops: FusedLadderOperator, dims: FusedADMMDims,
                 carry: ADMMCarry, W: torch.Tensor, n_iter: int,
                 rung0: torch.Tensor, rung_group: int,
                 balance_ratio: float = BALANCE_RATIO):
    """The ladder rollout (same contract as
    :func:`fused_ladder_reference`; the kernel takes ``balance_ratio``
    at run time, as a float32).

    CUDA tensors launch kernel K5 (``csrc/fused_admm.cu``, float32,
    contiguous, ``rung0`` int32): its resident body where the group rule
    gives a tile (:func:`ladder_tile_rows`), adding one to
    ``fused_ladder.launches``, else its wide body (K5w) where
    :func:`ladder_wide_group` gives one, on every rung's operators padded
    by :func:`~.fused_admm.wide_operators`, adding one to
    ``fused_ladder.wide_launches``. A ``rung_group`` other than the
    route's tile, a rung outside the ladder, or anything else the kernel
    does not take raises; so does a failed launch. CPU tensors run the
    plain version."""
    if carry.s.device.type == "cpu":
        return fused_ladder_reference(ops, dims, carry, W, n_iter, rung0,
                                      rung_group, balance_ratio)
    if carry.s.device.type != "cuda":
        raise ValueError(f"no fused ladder rollout for device "
                         f"{carry.s.device}")
    if n_iter < 0:
        raise ValueError(f"n_iter={n_iter} must be >= 0")
    from direct_data_driven_mpc_tpu_torch.ops import _kernels

    lib = _kernels.load("fused_admm").lib
    Bsz, n_blocks, nbp = W.shape
    nbm = dims.nb * dims.m
    R = ops.Vop.shape[0]
    sizes = (dims.S, nbm, nbp, dims.nbox, dims.nxi)
    tile = lib.fused_ladder_tile_rows(*sizes)
    wide = tile == 0
    if wide:
        tile = lib.fused_wide_tile_rows(*sizes)
        if tile == 0:
            raise ValueError(
                f"operators too large for both of the ladder kernel's "
                f"shared-memory plans (S={dims.S}, nbox={dims.nbox}, "
                f"nxi={dims.nxi})"
            )
    if rung_group != tile:
        raise ValueError(
            f"rung_group={rung_group}: the ladder kernel's "
            f"{'wide' if wide else 'resident'} body shares a rung per "
            f"thread block of {tile} scenarios (its tile at these sizes)"
        )
    n_groups = -(-Bsz // tile)
    _check_kernel_inputs(ops, dims, carry, W, rung0, n_groups)
    lo_r, hi_r = (int(x) for x in torch.aminmax(rung0))
    if lo_r < 0 or hi_r >= R:
        raise ValueError(f"rung0 outside the ladder [0, {R})")
    kw = dict(dtype=torch.float32, device=carry.s.device)
    U = torch.empty((Bsz, n_blocks, nbm), **kw)
    Y = torch.empty((Bsz, n_blocks, nbp), **kw)
    C, RP, RD = (torch.empty((Bsz, n_blocks), **kw) for _ in range(3))
    RUNG = torch.empty((Bsz, n_blocks), dtype=torch.int32,
                       device=carry.s.device)
    s_fin = torch.empty((Bsz, dims.S), **kw)
    sa_fin = torch.empty((Bsz, dims.nbox), **kw)
    wa_fin = torch.empty((Bsz, dims.nbox), **kw)
    with torch.cuda.device(carry.s.device):
        stream = torch.cuda.current_stream().cuda_stream
        launch = (lib.fused_ladder_wide_launch if wide
                  else lib.fused_ladder_launch)
        Vop, M1, M2 = (wide_operators(ops.Vop, ops.M1, ops.M2) if wide
                       else (ops.Vop, ops.M1, ops.M2))
        err = launch(
            Vop.data_ptr(), M1.data_ptr(), M2.data_ptr(),
            ops.b2.data_ptr(), ops.lo.data_ptr(), ops.hi.data_ptr(),
            ops.u_lo.data_ptr(), ops.u_hi.data_ptr(), ops.rhos.data_ptr(),
            rung0.data_ptr(), *(c.data_ptr() for c in carry), W.data_ptr(),
            U.data_ptr(), Y.data_ptr(), C.data_ptr(), RP.data_ptr(),
            RD.data_ptr(), RUNG.data_ptr(), s_fin.data_ptr(),
            sa_fin.data_ptr(), wa_fin.data_ptr(),
            Bsz, *sizes, n_blocks, int(n_iter), R,
            dims.alpha, 1.0 - dims.alpha, _ratio32(balance_ratio), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_ladder {'wide ' if wide else ''}kernel launch failed: "
            f"CUDA error {err}"
        )
    if wide:
        fused_ladder.wide_launches += 1
    else:
        fused_ladder.launches += 1
    return U, Y, C, RP, RD, RUNG, s_fin, sa_fin, wa_fin


#: Launches of the resident body (K5) made by :func:`fused_ladder` in
#: this process, and of the wide body (K5w).
fused_ladder.launches = 0
fused_ladder.wide_launches = 0


def _group_rungs(solver_state0, Bsz: int, G: int, R: int,
                 init_rung: Optional[int], default: int) -> torch.Tensor:
    """Each group's first rung (int64 on the host): ``default`` for a
    cold start or a state without rungs, else the rung its rows carry."""
    n_groups = -(-Bsz // G)
    idx = None
    if solver_state0 is not None:
        idx = getattr(solver_state0, "rho_idx", None)
        if idx is None and len(solver_state0) > 2:
            idx = solver_state0[2]
    if idx is None:
        return torch.full((n_groups,), default, dtype=torch.int64)
    idx = torch.as_tensor(idx).detach().to("cpu", torch.int64).reshape(-1)
    if idx.numel() != Bsz:
        raise ValueError(f"solver_state0.rho_idx has {idx.numel()} rows, "
                         f"expected {Bsz}")
    pad = n_groups * G - Bsz
    rows = torch.cat([idx, idx[-1:].expand(pad)]).view(n_groups, G)
    if bool((rows != rows[:, :1]).any()):
        raise ValueError(
            f"solver_state0.rho_idx differs inside a group of "
            f"rung_group={G} scenarios: the state was made with another "
            f"rung_group"
        )
    rung = rows[:, 0].contiguous()
    if bool(((rung < 0) | (rung >= R)).any()):
        raise ValueError(f"solver_state0.rho_idx outside the ladder "
                         f"[0, {R})")
    if init_rung is not None and bool((rung != init_rung).any()):
        bad = int(rung[rung != init_rung][0])
        raise ValueError(
            f"solver_state0 was produced at rung {bad} (its w is scaled "
            f"for that rung) but init_rung={init_rung}; pass "
            f"init_rung=None to resume every group at its own rung"
        )
    return rung


def make_fused_ladder_rollout(
    plant,
    ladder_op: dict,
    n: int,
    m: int,
    p: int,
    n_steps: int,
    n_mpc_step: int = 1,
    iters: Tuple[int, int, int] = (0, 14, 4),
    cold_iters: int = 60,
    tol: float = 1e-5,
    init_rung: Optional[int] = None,
    rung_group: Optional[int] = None,
    device=None,
    dtype=torch.float32,
    rollout=fused_ladder,
    balance_ratio: float = BALANCE_RATIO,
):
    """Build the fused batched closed-loop rollout with the adaptive
    penalty ladder (``qp/box.py``'s default box solver) in the loop.

    Args:
        plant: LTI plant matrices (``LTIParams``, the simulated system).
        ladder_op: float64 dict of ``compute_box_admm_operator_np`` (any
            number of rungs).
        n, m, p, n_steps, n_mpc_step, cold_iters, tol: as in
            :func:`~.fused_admm.make_fused_admm_rollout`; the cold start
            runs at the first rung, outside the kernel.
        iters: the JAX engine's schedule ``(n1, n3, n6)``; only the sum
            matters here (every iteration runs in float32).
        init_rung: the first rung (default ``R // 2``). With
            ``solver_state0`` it must agree with every group's rung, or
            be None to resume each group at its own.
        rung_group: scenarios that share one rung; None means the
            kernel's tile for these sizes (:func:`ladder_tile_rows`, or
            :func:`ladder_wide_group` where that gives 0).
        balance_ratio: the balancer's ratio (module docstring), passed
            to ``rollout``; the JAX package's default, 10.
        device, dtype: where and in which dtype the operators live (None
            means the CUDA card; ``"cpu"`` runs the plain version).
        rollout: :func:`fused_ladder` (the kernel on CUDA tensors) or
            :func:`fused_ladder_reference` (the plain version anywhere).

    Returns ``run(x0s, u_pasts, y_pasts, Ws, solver_state0=None) ->
    ClosedLoopResult`` whose ``solver_state`` is a
    ``BoxADMMState(s, w, rho_idx)`` with ``rho_idx (B,)`` each row's
    final (post-balance) rung; pass it back to continue a segmented run.
    """
    ops, dims = build_fused_ladder_operator(
        plant, ladder_op, n, m, p, n_mpc_step=n_mpc_step, device=device,
        dtype=dtype,
    )
    R = ops.Vop.shape[0]
    rung_first = R // 2 if init_rung is None else int(init_rung)
    if not 0 <= rung_first < R:
        raise ValueError(f"init_rung {rung_first} outside ladder [0, {R})")
    if rung_group is None:
        G = ladder_tile_rows(dims) or ladder_wide_group(dims)
    else:
        G = int(rung_group)
    if G < 1:
        raise ValueError(
            f"rung_group={rung_group}: no kernel tile fits these sizes; "
            f"pass rung_group explicitly for the plain version"
        )
    nb, S, ns, nbox, Mw = dims.nb, dims.S, dims.ns, dims.nbox, dims.Mw
    n_blocks = math.ceil(n_steps / nb)
    pad = n_blocks * nb - n_steps
    n_iter = int(sum(iters))
    Gc = ops.Gpre[:, :, : Mw + nbox]
    Gz = ops.Gpre[:, :, Mw + nbox :]
    bc, bz = ops.bpre[:, : Mw + nbox], ops.bpre[:, Mw + nbox :]
    alpha, beta = dims.alpha, 1.0 - dims.alpha

    @ieee_float32()
    def run(x0s, u_pasts, y_pasts, Ws, solver_state0=None):
        Bsz = x0s.shape[0]
        rung_g = _group_rungs(solver_state0, Bsz, G, R, init_rung,
                              rung_first)
        s0 = torch.cat(
            [x0s.reshape(Bsz, -1), u_pasts.reshape(Bsz, -1),
             y_pasts.reshape(Bsz, -1)], dim=1,
        ).to(dtype)
        # Theta-side maps of solve 0, at each group's rung.
        rows = rung_g.to(s0.device).repeat_interleave(G)[:Bsz]
        present = sorted(set(rung_g.tolist()))
        pv = _per_rung(lambda r: s0 @ Gc[r] + bc[r], rows, present)
        zth0 = _per_rung(lambda r: s0 @ Gz[r] + bz[r], rows, present)
        pre0, vc0 = pv[:, :Mw], pv[:, Mw:]
        if solver_state0 is None:
            # Cold start outside the kernel, at the first rung.
            sa0 = torch.zeros((Bsz, nbox), dtype=dtype, device=s0.device)
            wa0 = torch.zeros_like(sa0)
            Vop0 = ops.Vop[rung_first]
            for _ in range(cold_iters):
                v = (sa0 - wa0) @ Vop0 + vc0
                vh = alpha * v + beta * sa0
                s_new = torch.clamp(vh + wa0, ops.lo, ops.hi)
                wa0 = wa0 + vh - s_new
                sa0 = s_new
        else:
            sa0 = solver_state0[0].to(dtype)
            wa0 = solver_state0[1].to(dtype)
        W = Ws.to(dtype)
        if pad:
            W = torch.cat(
                [W, torch.zeros((Bsz, pad, dims.p), dtype=dtype,
                                device=W.device)], dim=1,
            )
        W = W.reshape(Bsz, n_blocks, nb * dims.p)
        carry = ADMMCarry(*(c.contiguous() for c in
                            (s0, pre0, vc0, zth0, sa0, wa0)))
        U, Y, C, RP, RD, RUNG, s_fin, sa, wa = rollout(
            ops, dims, carry, W.contiguous(), n_iter,
            rung_g.to(device=s0.device, dtype=torch.int32), G,
            balance_ratio,
        )
        return ClosedLoopResult(
            u_sys=U.reshape(Bsz, -1, dims.m)[:, :n_steps],
            y_sys=Y.reshape(Bsz, -1, dims.p)[:, :n_steps],
            costs=C,
            converged=(RP <= tol) & (RD <= tol),
            x_final=s_fin[:, :ns],
            u_past=s_fin[:, ns : ns + n * m].reshape(Bsz, n, m),
            y_past=s_fin[:, ns + n * m :].reshape(Bsz, n, p),
            solver_state=BoxADMMState(s=sa, w=wa, rho_idx=RUNG[:, -1]),
        )

    run.rung_group = G
    return run


def make_amortized_ladder_run(plant, ladder_op: dict, n: int, m: int,
                              p: int, n_steps: int, **kwargs):
    """Throughput harness (the ladder branch of ``bench.py``'s amortized
    loop): ``run(x0s, u_pasts, y_pasts, Ws, R) -> (checksum, ok)`` runs
    ``R`` rollouts, repetition ``i`` on the noise rolled by ``i`` steps.
    The checksum folds every repetition's last-solve costs, u and y;
    ``ok`` is true only if it is finite and every solve from index
    ``CONVERGED_FROM`` on converged in every repetition (the first
    solves are the rung walk's transient). ``kwargs`` go to
    :func:`make_fused_ladder_rollout`."""
    rollout_fn = make_fused_ladder_rollout(
        plant, ladder_op, n, m, p, n_steps, **kwargs
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
            ok = ok & res.converged[:, CONVERGED_FROM:].all()
        return checksum, ok & torch.isfinite(checksum)

    return run
