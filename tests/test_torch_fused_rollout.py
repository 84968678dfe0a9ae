"""PyTorch port, fused rollout (the module that holds the CUDA kernel):
the fused operator, the plain version of the kernel and the batched
entry points against the JAX package (its Pallas kernel in interpret
mode and its XLA twin). The CUDA kernel itself is tested against the
plain version in tests/test_torch_cuda.py, on a card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import torch.nn.functional as F  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from direct_data_driven_mpc_tpu.control.linear_engine import (  # noqa: E402
    build_affine_block_map as jax_build_affine_block_map,
)
from direct_data_driven_mpc_tpu.ops import pallas_rollout as jpr  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control.linear_engine import (  # noqa: E402
    AffineBlockMap,
    block_map_from_numpy,
    make_linear_batched_rollout,
)
from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr  # noqa: E402

from tests.test_torch_host import port_setup  # noqa: E402

B = 16


def _jax_map(jplant, jctrl, K, jdtype=jnp.float32):
    return jax_build_affine_block_map(
        jplant.as_params(), jctrl.solution_operator(), n=4, m=2, p=2,
        solves_per_block=K, dtype=jdtype,
    )


def _carry(jbm, dtype=torch.float32, device="cpu"):
    """The JAX block map's fields, as the port's block map."""
    return block_map_from_numpy(
        {k: getattr(jbm, k) for k in AffineBlockMap._fields}, device,
        dtype,
    )


def _inputs(jplant, jctrl, rng, n_steps, batch=B):
    x0s = np.tile(jplant.get_state()[None], (batch, 1))
    ups = np.tile(jctrl.u_past.reshape(1, 4, 2), (batch, 1, 1))
    yps = np.tile(jctrl.y_past.reshape(1, 4, 2), (batch, 1, 1))
    Ws = 0.002 * rng.uniform(-1, 1, (batch, n_steps, 2))
    return x0s, ups, yps, Ws


def _t(arrays, dtype=torch.float32, device="cpu"):
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


@pytest.fixture(scope="module")
def setup():
    return port_setup()


def test_suggest_solves_per_block_matches_jax():
    for args in ((4, 4, 2, 2), (10, 4, 2, 2)):
        for n_steps in (None, 400, 37):
            assert fr.suggest_solves_per_block(
                *args, n_steps=n_steps
            ) == jpr.suggest_solves_per_block(*args, n_steps=n_steps)
    assert fr.suggest_solves_per_block(4, 4, 2, 2, n_steps=400) == 50


def test_fused_operator_matches_jax_unpadded(setup):
    """Same columns as the JAX operator without its 128-lane padding,
    and, in float64, the factored cost reproduces the quadratic form."""
    jplant, jctrl, _, rng = setup
    K = 8
    jbm = _jax_map(jplant, jctrl, K, jnp.float64)
    op = fr._build_fused_operator(_carry(jbm, torch.float64))
    G_j, bias_j, _, dims = jpr._build_fused_operator(jbm)
    G_j, bias_j = np.asarray(G_j), np.asarray(bias_j)
    widths = [op.S, op.Ku, op.Kp, op.K * op.rank, op.K]
    assert widths[:3] == [dims["S"], dims["Ku"], dims["Kp"]]
    assert op.G.shape == (op.nw + op.S, sum(widths))
    cols, off = [], 0
    for w, padded in zip(widths, dims["widths"]):
        cols.append(np.arange(off, off + w))
        off += padded
    cols = np.concatenate(cols)
    # JAX casts its operator to float32: compare at float32 rounding.
    np.testing.assert_allclose(
        op.G.float().numpy(), G_j[:, cols], rtol=1e-6, atol=1e-7
    )
    np.testing.assert_allclose(
        op.bias.float().numpy(), bias_j[cols], rtol=1e-6, atol=1e-7
    )

    # Float64: costs through the factor equal theta P theta + q theta + r.
    bm = _carry(jbm, torch.float64)
    sw = torch.as_tensor(rng.uniform(-1, 1, (4, op.nw + op.S)))
    out = sw @ op.G + op.bias
    offZ = op.S + op.Ku + op.Kp
    z = out[:, offZ : offZ + op.K * op.rank].reshape(4, op.K, op.rank)
    cost = (z * z).sum(-1) + out[:, offZ + op.K * op.rank :]
    w, s = sw[:, : op.nw], sw[:, op.nw :]
    st = s @ bm.OsS_T + bm.os_c + w @ bm.OsW_T
    theta = st.reshape(4, op.K, op.S)[:, :, op.S - 16 :]
    ref = ((theta @ bm.cost_P) * theta).sum(-1) + theta @ bm.cost_q \
        + bm.cost_r
    np.testing.assert_allclose(cost.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(
        out[:, : op.S].numpy(), (s @ bm.M_T + bm.c + w @ bm.N_T).numpy(),
        rtol=0, atol=1e-12,
    )


@pytest.mark.parametrize("n_steps", [40, 37])
def test_plain_version_matches_jax_kernel(setup, n_steps):
    jplant, jctrl, _, rng = setup
    K = 8
    jbm = _jax_map(jplant, jctrl, K)
    inputs = _inputs(jplant, jctrl, rng, n_steps)
    res = fr.pallas_batched_rollout(_carry(jbm), *_t(inputs), n_steps)
    refs = {
        "pallas": jpr.pallas_batched_rollout(
            jbm, *_j(inputs), n_steps=n_steps, batch_block=8,
            interpret=True,
        ),
        "xla": jpr.pallas_batched_rollout(
            jbm, *_j(inputs), n_steps=n_steps, backend="xla",
        ),
    }
    assert res.u_sys.shape == (B, n_steps, 2)
    assert res.costs.shape == (B, n_steps)
    for name, ref in refs.items():
        for field in ("u_sys", "y_sys", "u_past", "y_past", "x_final"):
            np.testing.assert_allclose(
                getattr(res, field).numpy(),
                np.asarray(getattr(ref, field)), rtol=0, atol=2e-5,
                err_msg=f"{name}:{field}",
            )
        np.testing.assert_allclose(
            res.costs.numpy(), np.asarray(ref.costs), rtol=1e-3,
            atol=1e-5, err_msg=f"{name}:costs",
        )


def test_plain_version_matches_classic_engine(setup):
    """Same block map, two engines of the port: the fused operator's
    rollout against the condensed recursion it was fused from."""
    jplant, jctrl, _, rng = setup
    n_steps = 37
    bm = _carry(_jax_map(jplant, jctrl, 8))
    inputs = _t(_inputs(jplant, jctrl, rng, n_steps))
    res = fr.make_fused_batched_rollout(bm, n_steps)(*inputs)
    ref = make_linear_batched_rollout(bm, n_steps)(*inputs)
    for field in ("u_sys", "y_sys", "x_final", "u_past", "y_past"):
        np.testing.assert_allclose(
            getattr(res, field).numpy(), getattr(ref, field).numpy(),
            rtol=0, atol=2e-5, err_msg=field,
        )
    np.testing.assert_allclose(
        res.costs.numpy(), ref.costs.numpy(), rtol=1e-3, atol=1e-5
    )


def test_cost_precisions_agree_bitwise(setup):
    jplant, jctrl, _, rng = setup
    n_steps = 40
    bm = _carry(_jax_map(jplant, jctrl, 8))
    inputs = _t(_inputs(jplant, jctrl, rng, n_steps))
    out = {
        cp: fr.pallas_batched_rollout(
            bm, *inputs, n_steps, cost_precision=cp
        )
        for cp in ("high", "highest")
    }
    for field in ("u_sys", "y_sys", "x_final", "u_past", "y_past"):
        torch.testing.assert_close(
            getattr(out["high"], field), getattr(out["highest"], field),
            rtol=0, atol=0,
        )
    torch.testing.assert_close(
        out["high"].costs, out["highest"].costs, rtol=1e-3, atol=1e-5
    )
    with pytest.raises(ValueError, match="cost_precision"):
        fr.make_fused_batched_rollout(bm, n_steps,
                                      cost_precision="bfloat16")


def test_amortized_run_matches_jax(setup):
    jplant, jctrl, _, rng = setup
    n_steps, R = 40, 3
    jbm = _jax_map(jplant, jctrl, 8)
    inputs = _inputs(jplant, jctrl, rng, n_steps)
    checksum, ok = fr.make_amortized_run(_carry(jbm), n_steps)(
        *_t(inputs), R
    )
    jsum, jok = jpr.make_amortized_pallas_run(
        jbm, n_steps, batch_block=8, interpret=True
    )(*_j(inputs), R)
    assert bool(ok) and bool(jok)
    np.testing.assert_allclose(float(checksum), float(jsum), rtol=1e-5)


def test_rotation_index_equals_rolled_noise(setup):
    jplant, jctrl, _, rng = setup
    n_steps, K = 40, 8
    bm = _carry(_jax_map(jplant, jctrl, K))
    op = fr._build_fused_operator(bm)
    s0, W = fr._center_and_pack(
        bm, *_t(_inputs(jplant, jctrl, rng, n_steps)), n_steps // K, K, 0
    )
    for i in (0, 1, 3):
        rolled = fr.fused_rollout_reference(
            op, s0, torch.roll(W, i, dims=1).contiguous()
        )
        rotated = fr.fused_rollout_reference(
            op, s0, W, w_off=(-i) % (n_steps // K)
        )
        for a, b in zip(rolled, rotated):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cpu_tensors_take_plain_version(setup):
    jplant, jctrl, _, rng = setup
    n_steps, K = 40, 8
    bm = _carry(_jax_map(jplant, jctrl, K))
    op = fr._build_fused_operator(bm)
    s0, W = fr._center_and_pack(
        bm, *_t(_inputs(jplant, jctrl, rng, n_steps)), n_steps // K, K, 0
    )
    before = fr.fused_rollout.launches
    got = fr.fused_rollout(op, s0, W, w_off=2)
    want = fr.fused_rollout_reference(op, s0, W, w_off=2)
    assert fr.fused_rollout.launches == before == 0
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    meta = fr.FusedOperator(op.G.to("meta"), op.bias.to("meta"),
                            *op[2:])
    with pytest.raises(ValueError, match="device"):
        fr.fused_rollout(meta, s0.to("meta"), W.to("meta"))


def test_tracking_maps_rejected(setup):
    """A tracking map runs with a setpoint schedule (the plain version,
    against the JAX XLA twin) and is rejected without one, with one of
    the wrong shape, and with ``cost_mode="post"``."""
    from direct_data_driven_mpc_tpu.control.linear_engine import (
        build_tracking_engine as jax_build_tracking_engine,
    )

    jplant, jctrl, _, rng = setup
    n_steps, K = 16, 4
    jbm = jax_build_tracking_engine(jctrl, jplant.as_params(),
                                    solves_per_block=K, dtype=jnp.float32)
    bm = _carry(jbm)
    assert bm.n_r == 4
    inputs = _inputs(jplant, jctrl, rng, n_steps)
    r = np.array([0.9, 0.9, 0.6, 0.7])
    res = fr.make_fused_batched_rollout(bm, n_steps)(
        *_t(inputs), torch.as_tensor(r, dtype=torch.float32))
    ref = jpr.pallas_batched_rollout(
        jbm, *_j(inputs), n_steps=n_steps, backend="xla",
        setpoints=jnp.asarray(r, jnp.float32),
    )
    np.testing.assert_allclose(res.u_sys.numpy(), np.asarray(ref.u_sys),
                               rtol=0, atol=2e-5)
    run = fr.make_fused_batched_rollout(bm, n_steps)
    with pytest.raises(ValueError, match="requires a `setpoints`"):
        run(*_t(inputs))
    with pytest.raises(ValueError, match="must broadcast"):
        run(*_t(inputs), torch.zeros(5))
    with pytest.raises(NotImplementedError, match="post"):
        fr.make_fused_batched_rollout(bm, n_steps, cost_mode="post")


def _old_k1_smem_bytes(S, nw, K):
    """Shared memory of the previous K1 block (one 32-scenario block per
    SM): the transposed [w | s] tile, two G chunks of 128 columns, the
    output stage, s_next and the running costs."""
    D = nw + S
    return 4 * (D * 36 + 2 * D * 128 + 32 * 129 + 32 * S + 32 * K)


@pytest.mark.parametrize("S,nw,plan", [
    # four_tank_robust's main shape
    (20, 100, (16, 96, 25920, 128, 8, 17, 71424, True)),
    # the smallest state, no noise rows (D odd: the tiles' 34 floats
    # round up to 36, so G's columns start on a 16-byte boundary)
    (1, 0, (16, 32, 160, 128, 8, 17, 71424, True)),
    # large_plant with cost columns (K = 25), which the old plan refused
    (210, 250, (16, 256, 180320, 128, 8, 17, 71424, True)),
    # the widest noise that still fits at S = 210, and one row more
    (210, 382, (16, 256, 232064, 128, 8, 17, 71424, True)),
    (210, 383, (16, 256, 232464, 128, 8, 17, 71424, False)),
])
def test_rollout_plan_pins_main_shape_and_edges(S, nw, plan):
    """``rollout_plan`` (the library's plan, mirrored): the state pass's
    scenarios, threads and bytes, then the product's rows, slots,
    columns per slot and bytes, and whether the plan fits."""
    got = fr.rollout_plan(S, nw)
    assert (*got, got.fits) == plan


def test_k1_plan_keeps_the_old_reach():
    """Every (S, nw, K) that the previous K1 plan took (one block within
    232,448 bytes) has a plan."""
    taken = 0
    for S in range(1, 200, 3):
        for nw in range(0, 200, 3):
            for K in (1, 8, 50, 100):
                if _old_k1_smem_bytes(S, nw, K) <= 232448:
                    taken += 1
                    assert fr.rollout_plan(S, nw).fits, (S, nw, K)
    assert taken > 1000


def _slot_columns(op, table):
    """The packed column of every U, Y, Z and q column, read from the slot
    table as the kernel reads it: kind 1 stores ``n`` columns of ``[U |
    Y]`` from ``a``; kind 2 takes ``n`` more Z columns of solve ``a``
    (restarting at flag 1) and, at flag 2, its q column next."""
    n_tiles, n_pass = table.shape[:2]
    uy = np.full(op.Ku + op.Kp, -1)
    z = np.full((op.K, op.rank), -1)
    q = np.full(op.K, -1)
    seen = np.zeros(op.K, int)
    for t in range(n_tiles):
        for p in range(n_pass):
            for sl in range(8):
                kind, a, n, flags = table[t, p, sl]
                base = ((t * n_pass + p) * 8 + sl) * 20
                if kind == 1:
                    assert (uy[a : a + n] < 0).all() and 0 < n <= 16
                    assert a % 16 == 0 or (a - op.Ku) % 16 == 0
                    uy[a : a + n] = base + np.arange(n)
                elif kind == 2:
                    if flags & 1:
                        seen[a] = 0
                    z[a, seen[a] : seen[a] + n] = base + np.arange(n)
                    seen[a] += n
                    if flags & 2:
                        q[a] = base + n
                else:
                    assert kind == 0
    assert (uy >= 0).all() and (z >= 0).all() and (q >= 0).all()
    return uy, z, q


def _packed_rollout(op, s0, W, w_off, fallback=True):
    """K1's plan in plain arithmetic: the recursion through the packed
    state columns, then the product of all B x n_outer rows [w | s_t]
    with the packed operator, whose columns go back to U, Y and the costs
    through the slot table. Each column tile and pass reads only the
    slices of D its slice list names (the others' rows are dropped, set
    to zero), but a block of 128 rows that holds a value that is not
    finite reads every slice, as the kernel does (``fallback``)."""
    pack = fr.k1_pack(op)
    Bsz, n_outer, nw = W.shape
    S, D = op.S, nw + op.S
    states, s = [], s0
    for t in range(n_outer):
        states.append(s)
        s = torch.cat([W[:, (t + w_off) % n_outer], s], 1) \
            @ pack.Gs[:, :S] + pack.bs[:S]
    rows = torch.cat([W[:, (torch.arange(n_outer) + w_off) % n_outer],
                      torch.stack(states, 1)], 2).reshape(-1, D)
    n_tiles, n_pass, D_pad, width = pack.Gp.shape
    depth = D_pad // (pack.slices.shape[2] - 1)
    bad = F.pad(~torch.isfinite(rows).all(1), (0, -len(rows) % 128))
    dense = bad.reshape(-1, 128).any(1).repeat_interleave(128)[: len(rows)]
    dense &= fallback
    out = torch.empty((len(rows), n_tiles, n_pass, width), dtype=rows.dtype)
    for t in range(n_tiles):
        for p in range(n_pass):
            count, *ks = pack.slices[t, p].tolist()
            listed = torch.zeros(D_pad, dtype=torch.bool)
            for k in ks[:count]:
                listed[k * depth : (k + 1) * depth] = True
            keep = listed[:D] | dense[:, None]
            out[:, t, p] = torch.where(keep, rows, 0.0) \
                @ pack.Gp[t, p, :D] + pack.bp[t, p]
    out = out.reshape(len(rows), -1)
    uy, z, q = _slot_columns(op, pack.slots.numpy())
    zz = out[:, z.reshape(-1)].reshape(len(out), op.K, op.rank)
    return (out[:, uy[: op.Ku]].reshape(Bsz, n_outer, op.Ku),
            out[:, uy[op.Ku :]].reshape(Bsz, n_outer, op.Kp),
            ((zz * zz).sum(-1) + out[:, q]).reshape(Bsz, n_outer, op.K), s)


def test_k1_packed_operator_reproduces_plain_version(setup):
    """K1's packed operator and slot table, through plain arithmetic,
    give U, Y, C and the final carry of ``fused_rollout_reference`` bit
    for bit (the four-tank controller, K = 8, B = 16, T = 37 with its
    zero-padded last block, w_off = 2): 2 column tiles of 8 slots, one
    pass; and its tracking map with a per-block schedule (rank 20: each
    solve's 21 cost columns over two passes)."""
    from direct_data_driven_mpc_tpu.control.linear_engine import (
        build_tracking_engine as jax_build_tracking_engine,
    )

    jplant, jctrl, _, rng = setup
    n_steps, K = 37, 8
    n_outer = -(-n_steps // K)
    inputs = _t(_inputs(jplant, jctrl, rng, n_steps))
    r0 = np.array([1.0, 1.0, 0.65, 0.77])
    sched = torch.as_tensor(
        np.stack([(0.85 if i % 2 else 1.0) * r0 for i in range(n_outer)]),
        dtype=torch.float32,
    )
    cases = (
        (_carry(_jax_map(jplant, jctrl, K)), None, (2, 1, 8, 4)),
        (_carry(jax_build_tracking_engine(
            jctrl, jplant.as_params(), solves_per_block=K,
            dtype=jnp.float32)), sched, (2, 2, 8, 4)),
    )
    for bm, setpoints, slots in cases:
        op = fr._build_fused_operator(bm)
        s0, W = fr._center_and_pack(bm, *inputs, n_outer, K,
                                    n_outer * K - n_steps, setpoints)
        assert fr.k1_pack(op).slots.shape == slots
        got = _packed_rollout(op, s0, W, 2)
        want = fr.fused_rollout_reference(op, s0, W, w_off=2)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def _zero_band(G, S, Ku, Kp, K, rank, n_noise):
    """Zero ``G``'s noise rows as the condensed recursion does (p = 2,
    one input and one output pair a solve): solve k's U, Z and q
    columns from row 2k on, its Y columns from row 2k + 2; the rows from
    ``n_noise`` on (setpoints, state) stay."""
    offY, offZ = S + Ku, S + Ku + Kp
    for k in range(K):
        for cols in (range(S + 2 * k, S + 2 * k + 2),
                     range(offZ + k * rank, offZ + (k + 1) * rank),
                     (offZ + K * rank + k,)):
            G[2 * k : n_noise, list(cols)] = 0.0
        G[2 * k + 2 : n_noise, offY + 2 * k : offY + 2 * k + 2] = 0.0


@pytest.mark.parametrize("S,nw,Ku,Kp,K,rank,n_pass,band", [
    # three passes of 17 per solve
    pytest.param(21, 13, 7, 9, 3, 40, 3, False, id="21-13-7-9-3-40-3"),
    # 34 columns per solve: a lone q chunk
    pytest.param(5, 6, 3, 40, 2, 33, 2, False, id="5-6-3-40-2-33-2"),
    # rank 0: the cost is its q-part
    pytest.param(9, 4, 17, 17, 4, 0, 1, False, id="9-4-17-17-4-0-1"),
    # four_tank_tracking's widths: 21 per solve
    pytest.param(20, 104, 100, 100, 50, 20, 2, False,
                 id="20-104-100-100-50-20-2"),
    # four_tank_tracking's zero band: noise rows 0-99, setpoint rows
    # 100-103 nonzero for every solve
    pytest.param(20, 104, 100, 100, 50, 20, 2, True,
                 id="four_tank_tracking_band"),
])
def test_k1_slot_table_covers_every_column_once(S, nw, Ku, Kp, K, rank,
                                                n_pass, band):
    """Every U, Y, Z and q column of an operator lands in exactly one
    packed column (one slot per solve, ``ceil((rank + 1) / 17)``
    passes), whatever order the slots take, and the packed operator,
    through plain arithmetic over the listed slices, gives the plain
    version's results bit for bit."""
    g = torch.Generator().manual_seed(S)
    width = S + Ku + Kp + K * rank + K
    G = torch.randn((nw + S, width), generator=g, dtype=torch.float64)
    G[:, :S] *= 0.5 / (nw + S) ** 0.5
    if band:
        _zero_band(G, S, Ku, Kp, K, rank, 2 * K)
    op = fr.FusedOperator(G, torch.randn(width, generator=g,
                                         dtype=torch.float64),
                          S, nw, Ku, Kp, K, rank)
    table, index = fr.k1_slot_table(op)
    assert table.shape[1] == n_pass
    used = np.sort(index[index >= 0])
    np.testing.assert_array_equal(used, np.arange(S, width))
    s0 = torch.randn((5, S), generator=g, dtype=torch.float64)
    W = torch.randn((5, 3, nw), generator=g, dtype=torch.float64)
    got = _packed_rollout(op, s0, W, 1)
    want = fr.fused_rollout_reference(op, s0, W, w_off=1)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _four_tank_operators(setup, K=50):
    """The four-tank controller's fused operator at ``K`` solves per
    block, and its tracking map's."""
    from direct_data_driven_mpc_tpu.control.linear_engine import (
        build_tracking_engine as jax_build_tracking_engine,
    )

    jplant, jctrl, _, _ = setup
    return {
        "four_tank": fr._build_fused_operator(
            _carry(_jax_map(jplant, jctrl, K))),
        "four_tank_tracking": fr._build_fused_operator(_carry(
            jax_build_tracking_engine(jctrl, jplant.as_params(),
                                      solves_per_block=K,
                                      dtype=jnp.float32))),
    }


@pytest.mark.parametrize("case,counts", [
    # K = 50, 8 column tiles of 15 slices: 84 of 120 (70.0 %)
    ("four_tank", [[5], [7], [8], [10], [11], [13], [15], [15]]),
    # 104 noise and setpoint rows: 16 slices, two passes; 191 of 256
    ("four_tank_tracking", [[6, 6], [8, 8], [10, 10], [11, 12], [13, 13],
                            [15, 15], [16, 16], [16, 16]]),
    # no zero entry: every slice
    ("dense", [[15]] * 8),
])
def test_k1_slice_lists_name_every_nonzero_slice(setup, case, counts):
    """Each column tile and pass lists, in ascending order, exactly the
    slices of 8 rows of its packed operator that hold a nonzero entry,
    then the others in ascending order; the slots ordered by how far back
    their noise reaches put the zero band of the four-tank operators in
    whole slices, and a dense operator lists every slice. ``streamed``
    and ``dense`` sum the counts."""
    if case == "dense":
        g = torch.Generator().manual_seed(3)
        op = fr.FusedOperator(torch.randn((120, 1070), generator=g),
                              torch.randn(1070, generator=g),
                              20, 100, 100, 100, 50, 16)
    else:
        op = _four_tank_operators(setup)[case]
    pack = fr.k1_pack(op)
    n_tiles, n_pass, D_pad, width = pack.Gp.shape
    n_k = D_pad // 8
    assert pack.slices.shape == (n_tiles, n_pass, n_k + 1)
    assert pack.slices.dtype == torch.int32
    live = (pack.Gp != 0).reshape(n_tiles, n_pass, n_k, -1).any(-1)
    for t in range(n_tiles):
        for p in range(n_pass):
            count, *ks = pack.slices[t, p].tolist()
            assert ks[:count] == torch.nonzero(live[t, p]).ravel().tolist()
            assert ks[count:] == torch.nonzero(~live[t, p]).ravel().tolist()
    assert pack.slices[..., 0].tolist() == counts
    assert pack.streamed == sum(map(sum, counts))
    assert pack.dense == n_tiles * n_pass * n_k
    if case == "dense":
        assert pack.streamed == pack.dense


@pytest.mark.parametrize("row", [99, 50])
def test_k1_packed_operator_keeps_the_plain_nan_pattern(setup, row):
    """One NaN in noise row ``row`` of one block (K = 50: the last noise
    row, in the slice every tile lists, or one that the first three
    tiles skip): the packed product over the slice lists, with the
    kernel's rule that a block of rows holding a value that is not finite
    reads every slice, gives the plain version's NaN in every output of
    that row and of the scenario's later rows, and its bits elsewhere.
    Without the rule, outputs of the skipping tiles would read finite."""
    jplant, jctrl, _, rng = setup
    K, n_steps, batch, b, t = 50, 200, 4, 2, 1
    op = _four_tank_operators(setup, K)["four_tank"]
    bm = _carry(_jax_map(jplant, jctrl, K))
    inputs = _t(_inputs(jplant, jctrl, rng, n_steps, batch))
    s0, W = fr._center_and_pack(bm, *inputs, n_steps // K, K, 0)
    W[b, t, row] = float("nan")
    got = _packed_rollout(op, s0, W, 0)
    want = fr.fused_rollout_reference(op, s0, W)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, rtol=0, atol=0, equal_nan=True)
    U, Y, C, s_fin = want
    for out in (U, Y, C):
        assert out[b, t:].isnan().all() and not out[b, :t].isnan().any()
        assert not out[torch.arange(batch) != b].isnan().any()
    assert s_fin[b].isnan().all()
    assert torch.isfinite(got[2]).sum() == C.numel() - (4 - t) * K
    skipped = _packed_rollout(op, s0, W, 0, fallback=False)
    assert skipped[0][b, t].isnan().all() == (row == 99)


def test_operator_packs_are_cached_until_the_operator_changes(setup):
    """K1's pack (and K3's padded G, through the same cache) is built
    once per operator, and again after G is changed in place."""
    jplant, jctrl, _, _ = setup
    op = fr._build_fused_operator(_carry(_jax_map(jplant, jctrl, 8)))
    pack = fr.k1_pack(op)
    assert fr.k1_pack(op) is pack
    calls = []
    build = lambda: calls.append(1) or len(calls)  # noqa: E731
    assert fr._cached(op, "k3", build) == fr._cached(op, "k3", build) == 1
    op.G.mul_(1.0)
    assert fr._cached(op, "k3", build) == 2
    assert fr.k1_pack(op) is not pack
    torch.testing.assert_close(fr.k1_pack(op).Gp, pack.Gp, rtol=0, atol=0)
