"""Fused condensed closed-loop rollout: the operator, the kernel's
wrapper, its plain PyTorch version and the batched entry points.

The condensed recursion of ``control.linear_engine`` is fused into one
operator ``G`` so that each outer time block is a single product

    out = [w | s] @ G + bias,   columns [s_next | u | y | Z | q-part]

with the per-solve cost ``theta P theta + q . theta + r`` factored on
the host as ``P = L L^T`` and folded into ``G``: the block emits
``Z_k = L^T theta_k`` and ``q . theta_k + r``, and the cost of solve k
is ``||Z_k||^2 + qpart_k``. The rollout runs as the hand-written CUDA
kernel ``csrc/fused_rollout.cu`` on CUDA tensors (:func:`fused_rollout`)
and as :func:`fused_rollout_reference` on CPU tensors and in
comparisons.

``cost_mode="post"`` drops the cost columns from the operator (columns
``[s_next | u | y]`` only; kernel K3, :func:`fused_rollout_nocost`) and
rebuilds each solve's cost afterwards from the emitted trajectories: the
past window of solve k is rows ``k*nb .. k*nb + n - 1`` of the
trajectory with the initial window prepended, so the factored cost
``||L^T theta||^2 + q . theta + r`` is one stride-``nb`` convolution
over it (:func:`_make_post_cost_fn`). For large plants the ``K *
n_theta`` cost columns would dominate the operator; without them it
stays ``D x (S + Ku + Kp)``.

Counterpart of ``direct_data_driven_mpc_tpu/ops/pallas_rollout.py``
(``suggest_solves_per_block``, ``build_theta_operator``,
``_build_fused_operator``, ``_make_post_cost_fn``, ``_center_and_pack``,
``_make_xla_rollout_from_fused``, ``make_fused_batched_rollout``,
``pallas_batched_rollout``, ``make_amortized_pallas_run``). Differences
from the TPU layout: no 128-lane column padding, no segment-sum matrix,
and noise and outputs are batch-major ``(B, n_outer, width)``.

A tracking map (``block_map.n_r > 0``) takes a setpoint schedule: its
deltas ``dr = r - r_bar`` are ``n_r`` more input rows after each block's
noise (``_center_and_pack``), and each solve's cost coordinates are
``xi_k = [theta_k; dr]``, factored through the joint cost quadratic, so
the kernel runs it unchanged. ``cost_mode="post"`` takes no tracking
map, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
    AffineBlockMap,
)
from direct_data_driven_mpc_tpu_torch.control.loop import (
    ClosedLoopResult,
    setpoint_schedule,
)
from direct_data_driven_mpc_tpu_torch.ops.precision import (
    check_precision,
    ieee_float32,
)
from direct_data_driven_mpc_tpu_torch.utils.profiling import span

#: Opt-in shared memory of one thread block (bytes), as in the .cu.
_SMEM_LIMIT = 232448


def build_theta_operator(block_map: AffineBlockMap, ns: int):
    """The solve-time theta rows of the state-stack operator (rows are
    k-major: ``[x_k; theta_k]`` per solve), as float64 numpy:
    ``(OtS_T, otc, OtW_T, K)``."""
    S = block_map.M_T.shape[0]
    K = block_map.os_c.shape[0] // S
    idx = np.concatenate(
        [np.arange(k * S + ns, (k + 1) * S) for k in range(K)]
    )

    def f64(t):
        return t.detach().cpu().numpy().astype(np.float64)

    return (
        f64(block_map.OsS_T)[:, idx],
        f64(block_map.os_c)[idx],
        f64(block_map.OsW_T)[:, idx],
        K,
    )


def suggest_solves_per_block(
    ns: int, n: int, m: int, p: int, n_mpc_step: int = 1,
    n_steps: int | None = None, n_r: int = 0,
) -> int:
    """Solves per block of the TPU kernel's tuning: the largest K whose
    operand ``[w | s]`` fits one 128-lane contraction (``K*nb*p + n_r +
    S <= 128``; ``n_r = m + p`` setpoint lanes for a tracking map),
    preferring a K that divides the rollout into whole outer blocks. The
    CUDA kernel is correct for any K; its own choice is still to be
    measured on the H100."""
    S = ns + n * (m + p)
    K = max((128 - S - n_r) // (n_mpc_step * p), 1)
    if n_steps:
        spb = n_mpc_step * p  # noise lanes per solve
        for cand in range(K, 0, -1):
            n_outer = -(-n_steps // (cand * n_mpc_step))
            if n_outer * cand * n_mpc_step == n_steps:
                # accept up to ~6% fewer lanes to avoid time padding
                if (K - cand) * spb <= 8:
                    return cand
    return K


class FusedOperator(NamedTuple):
    """The fused operator on one device.

    ``G`` is ``(nw + S, S + Ku + Kp + K*rank + K)`` with rows ``[w; s]``
    and column groups ``[s_next | u | y | Z | q-part]``; ``bias`` has
    one entry per column (``r`` is folded into the q-part). Without
    cost columns (``cost_mode="post"``) ``K = rank = 0``. For a tracking
    map ``nw`` counts the ``n_r`` setpoint rows after the noise."""

    G: torch.Tensor
    bias: torch.Tensor
    S: int
    nw: int
    Ku: int
    Kp: int
    K: int
    rank: int


def _build_fused_operator(block_map: AffineBlockMap,
                          include_cost: bool = True,
                          cost_rank_rtol: float = 0.0) -> FusedOperator:
    """Assemble the fused operator on the host in float64 and cast it
    to the block map's device and dtype. ``include_cost=False`` keeps
    the column groups ``[s_next | u | y]`` only; ``cost_rank_rtol > 0``
    drops the cost factor's eigenvalues below that fraction of the
    largest. A tracking map's cost coordinates per solve are ``xi_k =
    [theta_k; dr]``, dr being the last ``n_r`` rows of ``[w; s]``."""

    def f64(t):
        return t.detach().cpu().numpy().astype(np.float64)

    M_T = f64(block_map.M_T)
    N_T = f64(block_map.N_T)
    S = M_T.shape[0]
    nw = N_T.shape[0]
    P = f64(block_map.cost_P)
    n_r = block_map.n_r
    n_theta = P.shape[0] - n_r
    ns = S - n_theta
    OtS_T, otc, OtW_T, K = build_theta_operator(block_map, ns)
    Ku = block_map.ou_c.shape[0]
    Kp = block_map.oy_c.shape[0]

    # Cost coordinates per solve: xi_k = theta_k, or [theta_k; dr] for
    # a tracking map (identity on the last n_r rows of the W channel).
    nxi = n_theta + n_r
    if n_r:
        def expand(Ot):  # (rows, K*n_theta) -> (rows, K*nxi)
            Oxi = np.zeros((Ot.shape[0], K, nxi))
            Oxi[:, :, :n_theta] = Ot.reshape(-1, K, n_theta)
            return Oxi.reshape(-1, K * nxi)

        OtS_T, OtW_T = expand(OtS_T), expand(OtW_T)
        OtW_T.reshape(nw, K, nxi)[nw - n_r :, :, n_theta:] = np.eye(
            n_r
        )[:, None, :]
        otc = expand(otc[None])[0]

    # Factor the PSD cost quadratic form P = L L^T (tiny negative
    # eigenvalues from rounding are clipped to zero).
    evals, V = np.linalg.eigh(P)
    if cost_rank_rtol > 0.0:
        keep = evals > cost_rank_rtol * max(float(evals.max()), 1e-300)
        V, evals = V[:, keep], evals[keep]
    L = V * np.sqrt(np.clip(evals, 0.0, None))
    rank = L.shape[1]
    q = f64(block_map.cost_q)
    r = float(f64(block_map.cost_r))

    def blockwise_L(Ot):  # (rows, K*nxi) -> (rows, K*rank)
        rows = Ot.shape[0]
        return (Ot.reshape(rows, K, nxi) @ L).reshape(rows, K * rank)

    # Row order [w-rows; s-rows] matches sw = [w | s].
    cols = [
        np.concatenate([N_T, M_T], axis=0),
        np.concatenate([f64(block_map.OuW_T), f64(block_map.OuS_T)]),
        np.concatenate([f64(block_map.OyW_T), f64(block_map.OyS_T)]),
    ]
    biases = [f64(block_map.c), f64(block_map.ou_c), f64(block_map.oy_c)]
    if include_cost:
        cols += [
            np.concatenate([blockwise_L(OtW_T), blockwise_L(OtS_T)]),
            np.concatenate(
                [OtW_T.reshape(nw, K, nxi) @ q,
                 OtS_T.reshape(S, K, nxi) @ q]
            ),
        ]
        biases += [
            (otc.reshape(K, nxi) @ L).reshape(K * rank),
            otc.reshape(K, nxi) @ q + r,
        ]
    else:
        K = rank = 0
    G = np.concatenate(cols, axis=1)
    bias = np.concatenate(biases)
    dev, dt = block_map.M_T.device, block_map.M_T.dtype
    return FusedOperator(
        G=torch.as_tensor(G, dtype=dt, device=dev).contiguous(),
        bias=torch.as_tensor(bias, dtype=dt, device=dev).contiguous(),
        S=S, nw=nw, Ku=Ku, Kp=Kp, K=K, rank=rank,
    )


def _make_post_cost_fn(block_map: AffineBlockMap, n_mpc_step: int,
                       rank_rtol: float = 1e-6):
    """Per-solve costs rebuilt from the trajectories
    (``cost_mode="post"``).

    The window quadratic ``theta P theta + q . theta + r`` with ``P = L
    L^T`` is a 1-D convolution over time: window offset j of solve k is
    time index ``k*nb + j`` of the past-prepended trajectory, so ``[L^T
    theta_k; q . theta_k]`` is one stride-``nb`` ``F.conv1d`` with a
    ``(rank + 1, m + p, n)`` kernel, q riding as the extra output
    channel. It runs in the block map's dtype, with TF32 off, over batch
    chunks that keep the ``(cb, rank + 1, n_solves)`` transient under
    1 GB.

    As in the JAX package, L keeps the eigenvalues of P above
    ``rank_rtol`` of the largest (98 of 200 at ``large_plant``), so
    these costs equal the in-kernel ones of an operator built with
    ``cost_rank_rtol=rank_rtol``. At ``large_plant`` the truncation is
    not negligible: each cost there is a small difference of terms near
    1e3, and the dropped curvature moves the costs by up to 11 against
    the untruncated ones.

    Returns ``cost_fn(u_past, y_past, u_sys, y_sys) -> (B, n_solves)``
    for time-leading ``(B, T, m or p)`` trajectories."""
    if block_map.n_r:
        raise NotImplementedError(
            "cost_mode='post' does not support tracking maps yet; use "
            "cost_mode='inkernel'"
        )

    def f64(t):
        return t.detach().cpu().numpy().astype(np.float64)

    P = f64(block_map.cost_P)
    evals, V = np.linalg.eigh(0.5 * (P + P.T))
    keep = evals > rank_rtol * max(float(evals.max()), 1e-300)
    L = V[:, keep] * np.sqrt(np.clip(evals[keep], 0.0, None))
    Lq = np.concatenate([L, f64(block_map.cost_q)[:, None]], axis=1)
    rank = L.shape[1]
    dev, dt = block_map.M_T.device, block_map.M_T.dtype
    r = float(f64(block_map.cost_r))
    nb = n_mpc_step
    weights = {}

    @ieee_float32()
    def cost_fn(u_past, y_past, u_sys, y_sys):
        Bsz, n, m = u_past.shape
        p = y_past.shape[2]
        if (n, m, p) not in weights:
            Kz = np.concatenate(
                [Lq[: n * m].reshape(n, m, rank + 1),
                 Lq[n * m :].reshape(n, p, rank + 1)], axis=1,
            )  # (n, m + p, rank + 1)
            weights[n, m, p] = torch.as_tensor(
                np.ascontiguousarray(Kz.transpose(2, 1, 0)), dtype=dt,
                device=dev,
            )
        weight = weights[n, m, p]
        n_solves = -(-u_sys.shape[1] // nb)
        x = torch.cat(
            [torch.cat([u_past.to(dt), u_sys], dim=1),
             torch.cat([y_past.to(dt), y_sys], dim=1)], dim=2,
        )[:, : (n_solves - 1) * nb + n].transpose(1, 2)
        cb = Bsz
        while cb > 8 and cb * n_solves * rank * 4 > 1e9:
            cb //= 2
        costs = torch.empty((Bsz, n_solves), dtype=dt, device=x.device)
        for c0 in range(0, Bsz, cb):
            z = F.conv1d(x[c0 : c0 + cb], weight, stride=nb)
            costs[c0 : c0 + cb] = (
                (z[:, :rank] * z[:, :rank]).sum(1) + z[:, rank] + r
            )
        return costs

    return cost_fn


@ieee_float32()
def fused_rollout_reference(op: FusedOperator, s0: torch.Tensor,
                            W: torch.Tensor, w_off: int = 0):
    """Plain PyTorch version of the kernel, in the dtype of ``op``.

    ``s0`` is the centered initial state ``(B, S)``; ``W`` the packed
    noise ``(B, n_outer, nw)``; block t reads noise block ``(t + w_off)
    mod n_outer``. Returns ``U (B, n_outer, Ku)``, ``Y (B, n_outer,
    Kp)``, ``C (B, n_outer, K)`` and the final carry ``s_fin (B, S)``.
    """
    Bsz, n_outer, _ = W.shape
    S, Ku, Kp, K, rank = op.S, op.Ku, op.Kp, op.K, op.rank
    offY = S + Ku
    offZ = offY + Kp
    offQ = offZ + K * rank
    kw = dict(dtype=op.G.dtype, device=op.G.device)
    U = torch.empty((Bsz, n_outer, Ku), **kw)
    Y = torch.empty((Bsz, n_outer, Kp), **kw)
    C = torch.empty((Bsz, n_outer, K), **kw)
    s = s0
    for t in range(n_outer):
        sw = torch.cat([W[:, (t + w_off) % n_outer], s], dim=1)
        out = sw @ op.G + op.bias
        U[:, t] = out[:, S:offY]
        Y[:, t] = out[:, offY:offZ]
        z = out[:, offZ:offQ].reshape(Bsz, K, rank)
        C[:, t] = (z * z).sum(-1) + out[:, offQ:]
        s = out[:, :S]
    return U, Y, C, s.contiguous()


def _check_kernel_inputs(op: FusedOperator, s0: torch.Tensor,
                         W: torch.Tensor, w_off: int) -> None:
    if s0.device.type != "cuda":
        raise ValueError(f"no fused rollout for device {s0.device}")
    Bsz, n_outer, nw = W.shape
    S = op.S
    for name, t, shape in (
        ("G", op.G, (op.nw + S, S + op.Ku + op.Kp + op.K * op.rank + op.K)),
        ("bias", op.bias, (op.G.shape[1],)),
        ("s0", s0, (Bsz, S)),
        ("W", W, (Bsz, n_outer, op.nw)),
    ):
        if t.device != s0.device or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be float32 on {s0.device}; got {t.dtype} "
                f"on {t.device}"
            )
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 <= w_off < n_outer:
        raise ValueError(f"w_off={w_off} outside [0, {n_outer})")


class RolloutPlan(NamedTuple):
    """Kernel K1's plan at one shape, as ``csrc/fused_rollout.cu`` makes
    it (``fused_rollout_plan``): the state pass's scenarios per block,
    threads and shared memory (two ``[w | s]`` tiles, transposed at a row
    stride of 17 floats and rounded up to whole 16-byte pieces, and G's
    state columns, up to 64 at a time), and
    the product's rows ``(b, t)`` per block, slots, columns per slot and
    shared memory (a ring of 6 slices of 8 rows of ``D``: 128 rows of A
    at a stride of 12 floats, and 8 slots of 20 floats for each row and
    for the bias)."""

    state_rows: int
    state_threads: int
    state_bytes: int
    rows: int
    slots: int
    slot_columns: int
    bytes: int

    @property
    def fits(self) -> bool:
        return max(self.state_bytes, self.bytes) <= _SMEM_LIMIT


#: K1's product: columns per slot, their stride in the packed operator,
#: slots per column tile, the depth of a ring slice and the ring's
#: slices (as in the .cu).
_SLOT_COLUMNS, _SLOT_STRIDE, _SLOTS, _DEPTH, _STAGES = 17, 20, 8, 8, 6
#: Slot kinds of the slot table: store columns of [U | Y]; add one
#: solve's squares (and, last, its q-part) to its cost.
_SLOT_STORE, _SLOT_COST = 1, 2


def rollout_plan(S: int, nw: int) -> RolloutPlan:
    """K1's plan at a state of ``S`` and ``nw`` noise rows (it does not
    depend on the columns: those are the slot table's)."""
    groups = -(-S // 4)
    return RolloutPlan(
        state_rows=16, state_threads=32 * min(-(-groups // 2), 8),
        state_bytes=4 * (-(-2 * 17 * (nw + S) // 4) * 4
                         + (nw + S) * min(4 * groups, 64)),
        rows=128, slots=_SLOTS, slot_columns=_SLOT_COLUMNS,
        bytes=4 * _STAGES * (128 * (_DEPTH + 4)
                             + (_DEPTH + 1) * _SLOTS * _SLOT_STRIDE),
    )


def _cached(op: FusedOperator, key: str, build):
    """``build()`` once per operator and ``key``, kept on ``op.G`` while
    G, bias and the operator's sizes stay as they are."""
    stamp = (tuple(op[2:]), op.bias.data_ptr(), op.G._version,
             op.bias._version)
    cache = op.G.__dict__.setdefault("_fused_rollout_cache", {})
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        hit = cache[key] = (stamp, build())
    return hit[1]


def k1_slot_table(op: FusedOperator):
    """K1's slot table and the operator column behind each packed column.

    Every column past the state ones goes to one slot of 17 columns: up
    to 16 consecutive columns of U or of Y from a multiple of 16 (kind 1,
    stored as 16-byte pieces), or one solve's Z columns followed by its q
    column (kind 2), in chunks of 17 when there are more, one chunk per
    pass, so each solve's cost is summed by one thread. A slot runs
    ``n_pass = ceil((rank + 1) / 17)`` passes (so U and Y slots store
    that many pieces); 8 slots make a column tile.

    The slots' programs are ordered by how many slices of ``D`` (8 rows
    each) their columns have a nonzero entry in, then by those slices
    from the last down, before they are cut into tiles. Solve k's columns
    of the condensed recursion are zero in the noise rows of later solves
    (``control.linear_engine`` starts every tracked quantity with zero
    noise columns), so this order is by how far back a slot's noise
    reaches: a tile holds the slots of neighbouring solves, and
    :func:`k1_pack` lists the few slices it needs. Returns ``table
    (n_tiles, n_pass, 8, 4)`` of int32 ``{kind, a, n, flags}`` (as the
    .cu reads it) and ``index (n_tiles, n_pass, 160)``, each packed
    column's operator column or -1."""
    nc = _SLOT_COLUMNS
    S, K, rank = op.S, op.K, op.rank
    n_uy = op.Ku + op.Kp
    offZ = S + n_uy
    offQ = offZ + K * rank
    n_pass = -(-(rank + 1) // nc)
    stores = [
        ((_SLOT_STORE, off + j, min(16, width - j), 0),
         range(S + off + j, S + off + min(j + 16, width)))
        for off, width in ((0, op.Ku), (op.Ku, op.Kp))
        for j in range(0, width, 16)
    ]
    programs = [stores[i : i + n_pass] for i in range(0, len(stores), n_pass)]
    for k in range(K):
        cols = [*range(offZ + k * rank, offZ + (k + 1) * rank), offQ + k]
        programs.append([
            ((_SLOT_COST, k, len(cols[c : c + nc]) - (c + nc > rank),
              (c == 0) | 2 * (c + nc > rank)), cols[c : c + nc])
            for c in range(0, rank + 1, nc)
        ])
    D = op.G.shape[0]
    live = F.pad(op.G != 0, (0, 0, 0, -D % _DEPTH)).reshape(
        -1, _DEPTH, op.G.shape[1]).any(1).cpu().numpy()  # (n_k, width)

    def reach(program):
        used = live[:, [c for _, cols in program for c in cols]].any(1)
        return used.sum(), tuple(np.flatnonzero(used)[::-1])

    programs.sort(key=reach)
    n_tiles = -(-len(programs) // _SLOTS)
    table = np.zeros((n_tiles, n_pass, _SLOTS, 4), np.int32)
    index = np.full((n_tiles, n_pass, _SLOTS, _SLOT_STRIDE), -1)
    for i, program in enumerate(programs):
        for p, (desc, cols) in enumerate(program):
            table[i // _SLOTS, p, i % _SLOTS] = desc
            index[i // _SLOTS, p, i % _SLOTS, : len(cols)] = cols
    return table, index.reshape(n_tiles, n_pass, _SLOTS * _SLOT_STRIDE)


class K1Pack(NamedTuple):
    """The operator as K1 reads it: the state columns ``Gs (D, 4
    ceil(S/4))`` and ``bs``, zero-padded; every other column in slot order
    ``Gp (n_tiles, n_pass, D_pad, 160)`` (``D`` rounded up to 8, zero
    past the last row and in unused slot columns) and ``bp (n_tiles,
    n_pass, 160)``; the slot table; and the slice lists ``slices
    (n_tiles, n_pass, n_k + 1)``, ``n_k = D_pad / 8``: per column tile
    and pass the count of slices of 8 rows of ``Gp`` that hold a
    nonzero entry (at least one), then every slice, those in ascending
    order first, then the others (int32, all on the operator's device).
    ``streamed`` is the sum of the counts and ``dense`` that of ``n_k``
    over every column tile and pass: the slices one row block of the
    product streams and would stream without the lists."""

    Gs: torch.Tensor
    bs: torch.Tensor
    Gp: torch.Tensor
    bp: torch.Tensor
    slots: torch.Tensor
    slices: torch.Tensor
    streamed: int
    dense: int


def k1_pack(op: FusedOperator) -> K1Pack:
    """:class:`K1Pack` of ``op``, built once per operator and cached
    with it."""
    def build():
        table, index = k1_slot_table(op)
        n_tiles, n_pass = table.shape[:2]
        S, width = op.S, op.G.shape[1]
        D = op.G.shape[0]
        G1 = F.pad(op.G, (0, 1))  # column `width` is zero: unused slots
        b1 = F.pad(op.bias, (0, 1))
        idx = torch.as_tensor(np.where(index < 0, width, index),
                              device=op.G.device)
        Gp = G1[:, idx.reshape(-1)].reshape(D, n_tiles, n_pass, -1)
        Gp = F.pad(Gp.permute(1, 2, 0, 3), (0, 0, 0, -D % _DEPTH))
        # The slices of each column tile and pass that hold a nonzero
        # entry; one with none lists its last slice, which brings its bias.
        n_k = Gp.shape[2] // _DEPTH
        live = (Gp != 0).reshape(n_tiles, n_pass, n_k, -1).any(-1)
        live = live.cpu().numpy()
        live[..., -1] |= ~live.any(-1)
        lists = np.zeros((n_tiles, n_pass, n_k + 1), np.int32)
        lists[..., 0] = live.sum(-1)
        lists[..., 1:] = np.argsort(~live, axis=-1, kind="stable")
        ldgs = 4 * -(-S // 4)
        return K1Pack(
            Gs=F.pad(op.G[:, :S], (0, ldgs - S)).contiguous(),
            bs=F.pad(op.bias[:S], (0, ldgs - S)).contiguous(),
            Gp=Gp.contiguous(),
            bp=b1[idx].contiguous(),
            slots=torch.as_tensor(table, device=op.G.device),
            slices=torch.as_tensor(lists, device=op.G.device),
            streamed=int(lists[..., 0].sum()),
            dense=n_tiles * n_pass * n_k,
        )

    return _cached(op, "k1", build)


def fused_rollout(op: FusedOperator, s0: torch.Tensor, W: torch.Tensor,
                  w_off: int = 0):
    """The fused rollout (same contract as
    :func:`fused_rollout_reference`).

    CPU tensors run the plain version. An operator without cost columns
    goes to :func:`fused_rollout_nocost`. Other CUDA tensors launch
    kernel K1 of ``csrc/fused_rollout.cu`` (float32, contiguous): two
    CUDA kernels on the current stream, the state recursion and then
    every other column of all ``B x n_outer`` rows as one product, its
    operator packed by :func:`k1_pack`. The product streams, for each
    column tile, only the slices of ``D`` its pack lists; a row block
    that holds a value that is not finite streams every slice, so such a
    value poisons its row's outputs as in the plain version. Each call
    that launches them adds one to ``fused_rollout.launches`` and the
    pack's ``streamed`` and ``dense`` to ``fused_rollout.slices_streamed``
    and ``fused_rollout.slices_dense``; the launch call alone is the span
    ``ddmpc.kernel`` (``utils.profiling``). Anything K1 does not take,
    operators beyond :func:`rollout_plan` included, raises before the
    launch."""
    if s0.device.type == "cpu":
        return fused_rollout_reference(op, s0, W, w_off)
    if op.K == 0:
        return fused_rollout_nocost(op, s0, W, w_off)
    _check_kernel_inputs(op, s0, W, w_off)
    Bsz, n_outer, nw = W.shape
    S = op.S
    plan = rollout_plan(S, nw)
    if not plan.fits:
        raise ValueError(
            f"operator too large for the fused rollout kernel's plan: "
            f"S={S}, nw={nw}: its state pass needs {plan.state_bytes} "
            f"bytes of shared memory, more than one block's "
            f"{_SMEM_LIMIT}; use cost_mode='post'"
        )
    from direct_data_driven_mpc_tpu_torch.ops import _kernels

    lib = _kernels.load("fused_rollout").lib
    pack = k1_pack(op)
    kw = dict(dtype=torch.float32, device=s0.device)
    rows = torch.empty((Bsz, n_outer, -(-(nw + S) // _DEPTH) * _DEPTH),
                       **kw)
    flags = torch.empty(Bsz * n_outer, dtype=torch.int32, device=s0.device)
    U = torch.empty((Bsz, n_outer, op.Ku), **kw)
    Y = torch.empty((Bsz, n_outer, op.Kp), **kw)
    C = torch.empty((Bsz, n_outer, op.K), **kw)
    s_fin = torch.empty((Bsz, S), **kw)
    n_tiles, n_pass = pack.slots.shape[:2]
    with torch.cuda.device(s0.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (
            pack.Gs.data_ptr(), pack.bs.data_ptr(), pack.Gp.data_ptr(),
            pack.bp.data_ptr(), pack.slots.data_ptr(),
            pack.slices.data_ptr(), s0.data_ptr(), W.data_ptr(),
            rows.data_ptr(), flags.data_ptr(), U.data_ptr(), Y.data_ptr(),
            C.data_ptr(), s_fin.data_ptr(), Bsz, S, nw, op.Ku, op.Kp,
            op.K, n_outer, int(w_off), n_tiles, n_pass, stream,
        )
        with span("ddmpc.kernel", True):
            err = lib.fused_rollout_launch(*args)
    if err != 0:
        raise RuntimeError(
            f"fused_rollout kernel launch failed: CUDA error {err}"
        )
    fused_rollout.launches += 1
    fused_rollout.slices_streamed += pack.streamed
    fused_rollout.slices_dense += pack.dense
    return U, Y, C, s_fin


#: Calls of :func:`fused_rollout` in this process that launched K1 (its
#: state pass and its product, two CUDA kernels, count as one).
fused_rollout.launches = 0
#: Over those calls, the slices of ``D`` one row block of K1's product
#: streams, summed over its column tiles and passes (:class:`K1Pack`'s
#: ``streamed``), and the slices it would stream without the slice lists
#: (``dense``): host integers, no device work.
fused_rollout.slices_streamed = 0
fused_rollout.slices_dense = 0


def nocost_plan(S: int, nw: int):
    """``(rows, bytes)``: the scenarios per thread block of kernel K3 and
    its shared memory at a state of ``S`` and ``nw`` noise rows, as
    ``csrc/fused_rollout.cu`` plans them (``fused_rollout_nocost_tile_rows``
    and ``fused_rollout_nocost_smem_bytes``): 64 scenarios where that plan
    fits one block, else 32; ``(0, bytes of the 32-row plan)`` when
    neither fits. A block holds the ring of G (3 stages of 16 rows of
    256 + 8 floats), the ``[w | s]`` tile (rows padded to whole ring
    tiles plus 4 floats) and ``s_next``."""
    lda = -(-(nw + S) // 16) * 16 + 4
    for rows in (64, 32):
        nbytes = 4 * (3 * 16 * 264 + rows * lda + rows * S)
        if nbytes <= _SMEM_LIMIT:
            return rows, nbytes
    return 0, nbytes


def fused_rollout_nocost(op: FusedOperator, s0: torch.Tensor,
                         W: torch.Tensor, w_off: int = 0):
    """The fused rollout of an operator without cost columns
    (``cost_mode="post"``; same contract as
    :func:`fused_rollout_reference`, with ``C`` of width 0).

    CPU tensors run the plain version. CUDA tensors launch kernel K3
    (``fused_rollout_nocost_kernel`` of ``csrc/fused_rollout.cu``, the
    products on the tensor cores at float32 grade: 3xTF32, within 1e-4
    of the plain version; 64 or 32 scenarios per block, by
    :func:`nocost_plan`) and add one to ``fused_rollout_nocost.launches``;
    anything the kernel does not take raises before the launch."""
    if s0.device.type == "cpu":
        return fused_rollout_reference(op, s0, W, w_off)
    if op.K != 0:
        raise ValueError("fused_rollout_nocost needs an operator without "
                         "cost columns (include_cost=False)")
    _check_kernel_inputs(op, s0, W, w_off)
    Bsz, n_outer, nw = W.shape
    S = op.S
    rows, nbytes = nocost_plan(S, nw)
    if rows == 0:
        raise ValueError(
            f"operator too large for the no-cost kernel's shared-memory "
            f"plan: S={S}, nw={nw} needs {nbytes} bytes at 32 scenarios "
            f"per block, more than one block's {_SMEM_LIMIT}"
        )
    from direct_data_driven_mpc_tpu_torch.ops import _kernels

    lib = _kernels.load("fused_rollout").lib
    # The kernel copies G in 16-byte pieces: rows padded to a multiple
    # of 4 floats, on an aligned base; padded once per operator.
    width = op.G.shape[1]
    ldg = -(-width // 4) * 4
    aligned = ldg == width and op.G.data_ptr() % 16 == 0
    G = op.G if aligned else _cached(
        op, "k3", lambda: F.pad(op.G, (0, ldg - width)).contiguous()
    )
    kw = dict(dtype=torch.float32, device=s0.device)
    U = torch.empty((Bsz, n_outer, op.Ku), **kw)
    Y = torch.empty((Bsz, n_outer, op.Kp), **kw)
    s_fin = torch.empty((Bsz, S), **kw)
    with torch.cuda.device(s0.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (
            G.data_ptr(), op.bias.data_ptr(), s0.data_ptr(),
            W.data_ptr(), U.data_ptr(), Y.data_ptr(), s_fin.data_ptr(),
            Bsz, S, nw, op.Ku, op.Kp, ldg, n_outer, int(w_off), stream,
        )
        with span("ddmpc.kernel", True):
            err = lib.fused_rollout_nocost_launch(*args)
    if err != 0:
        raise RuntimeError(
            f"fused_rollout_nocost kernel launch failed: CUDA error {err}"
        )
    fused_rollout_nocost.launches += 1
    return U, Y, torch.empty((Bsz, n_outer, 0), **kw), s_fin


#: Kernel launches made by :func:`fused_rollout_nocost` in this process.
fused_rollout_nocost.launches = 0


def _center_and_pack(block_map, x0s, u_pasts, y_pasts, Ws, n_outer,
                     steps_per_outer, pad, setpoints=None):
    """Centered initial state ``(B, S)`` and the noise zero-padded to
    whole outer blocks, batch-major ``(B, n_outer, nw)``, both in the
    block map's dtype on its device.

    A tracking map (``block_map.n_r > 0``) needs ``setpoints``, absolute
    ``[u_s; y_s]``: ``(n_r,)`` constant, ``(n_outer, n_r)`` per block or
    ``(B, n_outer, n_r)`` per scenario and block; the deltas ``dr = r -
    r_bar`` follow each block's noise, so ``nw`` counts them."""
    n_r = block_map.n_r
    if n_r == 0 and setpoints is not None:
        raise ValueError(
            "`setpoints` requires a tracking block map (build with "
            "tracking_op=... / build_tracking_engine)."
        )
    if n_r and setpoints is None:
        raise ValueError(
            "tracking block map (n_r > 0) requires a `setpoints` "
            "schedule: (n_r,), (n_outer, n_r) or (B, n_outer, n_r)."
        )
    dtype = block_map.M_T.dtype
    Bsz = x0s.shape[0]
    p = y_pasts.shape[2]
    s0 = torch.cat(
        [x0s.reshape(Bsz, -1), u_pasts.reshape(Bsz, -1),
         y_pasts.reshape(Bsz, -1)], dim=1,
    ).to(dtype) - block_map.s_star
    W = Ws.to(dtype)
    if pad:
        W = torch.cat(
            [W, torch.zeros((Bsz, pad, p), dtype=dtype, device=W.device)],
            dim=1,
        )
    W = W.reshape(Bsz, n_outer, steps_per_outer * p)
    if n_r:
        R = setpoint_schedule(
            setpoints, n_outer, n_r, Bsz, dtype, W.device,
            f"setpoints must broadcast to (n_outer={n_outer}, B={Bsz}, "
            f"n_r={n_r})",
        )
        W = torch.cat([W, (R - block_map.r_bar).expand(Bsz, n_outer, n_r)],
                      dim=2)
    return s0.contiguous(), W.contiguous()


def _shape(block_map: AffineBlockMap, n_steps: int, n_mpc_step: int):
    S = block_map.M_T.shape[0]
    K = block_map.os_c.shape[0] // S
    steps_per_outer = K * n_mpc_step
    n_outer = math.ceil(n_steps / steps_per_outer)
    return S, steps_per_outer, n_outer, n_outer * steps_per_outer - n_steps


def _cost_mode_parts(block_map, n_mpc_step, cost_mode, cost_rank_rtol):
    """The operator and, with ``cost_mode="post"``, the cost post-pass."""
    if cost_mode not in ("inkernel", "post"):
        raise ValueError(
            f"cost_mode must be 'inkernel' or 'post', got {cost_mode!r}"
        )
    post = cost_mode == "post"
    post_cost = _make_post_cost_fn(block_map, n_mpc_step) if post else None
    op = _build_fused_operator(block_map, include_cost=not post,
                               cost_rank_rtol=cost_rank_rtol)
    return op, post_cost


def make_fused_batched_rollout(
    block_map: AffineBlockMap,
    n_steps: int,
    n_mpc_step: int = 1,
    cost_precision: str = "high",
    cost_mode: str = "inkernel",
    cost_rank_rtol: float = 0.0,
    rollout=fused_rollout,
):
    """``run(x0s, u_pasts, y_pasts, Ws) -> ClosedLoopResult`` through
    ``rollout``: :func:`fused_rollout` (the kernel on CUDA tensors) or
    :func:`fused_rollout_reference` (the plain version anywhere, in the
    block map's dtype). The operator is assembled here, once; inputs
    must be on the block map's device.

    ``cost_mode="inkernel"`` computes the per-solve costs in the kernel
    (K1); ``"post"`` runs the operator without cost columns (K3) and
    rebuilds the costs from the trajectories (:func:`_make_post_cost_fn`,
    its cost factor truncated at rtol 1e-6); then ``converged`` is
    ``isfinite(costs)``, as in the JAX package. ``cost_rank_rtol > 0``
    truncates the in-kernel cost factor the same way (at 1e-6 the two
    modes compute the same costs).

    A tracking map (``build_tracking_engine``) is called as ``run(x0s,
    u_pasts, y_pasts, Ws, setpoints)`` with a schedule of absolute
    setpoints, one per outer block (see :func:`_center_and_pack`).

    Each call is the span ``ddmpc.call`` (``utils.profiling``) holding
    ``ddmpc.pack`` (:func:`_center_and_pack`), ``ddmpc.rollout`` (the
    ``rollout`` call) and ``ddmpc.result``."""
    check_precision(cost_precision, "cost_precision")
    S, steps_per_outer, n_outer, pad = _shape(
        block_map, n_steps, n_mpc_step
    )
    n_solves = math.ceil(n_steps / n_mpc_step)
    n_theta = block_map.cost_P.shape[0] - block_map.n_r
    ns = S - n_theta
    op, post_cost = _cost_mode_parts(block_map, n_mpc_step, cost_mode,
                                     cost_rank_rtol)
    cuda = block_map.M_T.is_cuda

    def run(x0s, u_pasts, y_pasts, Ws, setpoints=None):
        with span("ddmpc.call"), ieee_float32():
            with span("ddmpc.pack", cuda):
                s0, W = _center_and_pack(
                    block_map, x0s, u_pasts, y_pasts, Ws, n_outer,
                    steps_per_outer, pad, setpoints=setpoints,
                )
            with span("ddmpc.rollout"):
                U, Y, C, s_fin = rollout(op, s0, W)
            with span("ddmpc.result", cuda):
                Bsz, n, m = u_pasts.shape
                p = y_pasts.shape[2]
                s_fin = s_fin + block_map.s_star
                u_sys = U.reshape(Bsz, -1, m)[:, :n_steps]
                y_sys = Y.reshape(Bsz, -1, p)[:, :n_steps]
                if post_cost is None:
                    costs = C.reshape(Bsz, -1)[:, :n_solves]
                else:
                    costs = post_cost(u_pasts, y_pasts, u_sys, y_sys)
                return ClosedLoopResult(
                    u_sys=u_sys,
                    y_sys=y_sys,
                    costs=costs,
                    converged=torch.isfinite(costs),
                    x_final=s_fin[:, :ns],
                    u_past=s_fin[:, ns : ns + n * m].reshape(Bsz, n, m),
                    y_past=s_fin[:, ns + n * m :].reshape(Bsz, n, p),
                )

    return run


def pallas_batched_rollout(
    block_map: AffineBlockMap,
    x0s: torch.Tensor,  # (B, ns)
    u_pasts: torch.Tensor,  # (B, n, m)
    y_pasts: torch.Tensor,  # (B, n, p)
    Ws: torch.Tensor,  # (B, n_steps, p)
    n_steps: int,
    n_mpc_step: int = 1,
    cost_precision: str = "high",
    cost_mode: str = "inkernel",
    setpoints=None,
) -> ClosedLoopResult:
    """One-call form of :func:`make_fused_batched_rollout` (the name
    of the JAX package's entry point); ``setpoints`` is a tracking map's
    schedule."""
    return make_fused_batched_rollout(
        block_map, n_steps, n_mpc_step=n_mpc_step,
        cost_precision=cost_precision, cost_mode=cost_mode,
    )(x0s, u_pasts, y_pasts, Ws, setpoints=setpoints)


def make_amortized_run(
    block_map: AffineBlockMap,
    n_steps: int,
    n_mpc_step: int = 1,
    cost_precision: str = "high",
    cost_mode: str = "inkernel",
    cost_rank_rtol: float = 0.0,
    rollout=fused_rollout,
    setpoints=None,
):
    """Throughput harness: ``run(x0s, u_pasts, y_pasts, Ws, R) ->
    (checksum, ok)`` runs ``R`` back-to-back rollouts.

    Repetition ``i`` rotates the noise by ``(-i) mod n_outer`` outer
    blocks through the rollout's ``w_off`` index (no copy), so it equals
    a rollout on the noise rolled by ``i`` blocks; a tracking map's
    schedule (``setpoints``, fixed across repetitions) rides the same
    rows, so it rotates with the noise, as in the JAX package. Every
    repetition's
    U, Y, costs (the last block's in the kernel; all of them from the
    ``cost_mode="post"`` pass, which is part of the timed work) and
    final carry fold into a float32 checksum carried on the device, so
    no repetition's work is dead. ``rollout`` is :func:`fused_rollout`
    or, to time the plain version on the same inputs,
    :func:`fused_rollout_reference`."""
    check_precision(cost_precision, "cost_precision")
    _, steps_per_outer, n_outer, pad = _shape(
        block_map, n_steps, n_mpc_step
    )
    op, post_cost = _cost_mode_parts(block_map, n_mpc_step, cost_mode,
                                     cost_rank_rtol)

    @ieee_float32()
    def run(x0s, u_pasts, y_pasts, Ws, R):
        s0, W = _center_and_pack(
            block_map, x0s, u_pasts, y_pasts, Ws, n_outer,
            steps_per_outer, pad, setpoints=setpoints,
        )
        Bsz, _, m = u_pasts.shape
        p = y_pasts.shape[2]
        checksum = torch.zeros((), dtype=torch.float32, device=s0.device)
        for i in range(R):
            U, Y, C, s_fin = rollout(op, s0, W, w_off=(-i) % n_outer)
            if post_cost is None:
                c = C[:, -1].sum()
            else:
                c = post_cost(
                    u_pasts, y_pasts, U.reshape(Bsz, -1, m)[:, :n_steps],
                    Y.reshape(Bsz, -1, p)[:, :n_steps],
                ).sum()
            checksum = checksum + (c + s_fin.sum() + U.sum() + Y.sum()).float()
        return checksum, torch.isfinite(checksum)

    return run
