"""PyTorch port, the fused closed loop with the adaptive penalty ladder
(the module that holds kernel K5): the stacked operators, the plain
version of the kernel and the batched entry points, held against the
JAX package (its XLA twin, its Pallas kernel in interpret mode and the
independent active-set golden). The CUDA kernel itself is tested
against the plain version in tests/test_torch_cuda.py, on a card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from chip_smoke import build_four_tank_robust  # noqa: E402
from direct_data_driven_mpc_tpu.ops import pallas_admm as jpa  # noqa: E402
from direct_data_driven_mpc_tpu.qp import box as jbox  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp import box  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp.box import BoxADMMState  # noqa: E402

from tests.test_closed_loop import FOUR_TANK  # noqa: E402
from tests.test_fused_admm import (  # noqa: E402
    BOX_ITERS,
    GOLDEN,
    _golden_controller,
    _plant32,
)

PLANT = LTIParams(*(np.asarray(FOUR_TANK[k]) for k in "ABCD"))
#: The engines' parity bar (tests/test_fused_admm.py:110-128).
DU, COST_RTOL, COST_ATOL = 1e-4, 5e-3, 1e-3
KW = dict(iters=BOX_ITERS, cold_iters=60, tol=2e-5)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def ladder(golden):
    """The golden BOX controller (JAX) and its default 7-rung ladder
    operator, built by the port."""
    ctrl = _golden_controller(golden, "BOX")
    u = float(golden["u_box"])
    return ctrl, box.compute_box_admm_operator_np(ctrl.spec,
                                                  u_bounds=(-u, u))


@pytest.fixture(scope="module")
def wide(ladder):
    """The same controller's ladder at |u| <= 2, where the two regimes
    of :func:`_two_regimes` walk down the ladder on different paths
    (their rungs first differ after solve 10)."""
    return box.compute_box_admm_operator_np(ladder[0].spec,
                                            u_bounds=(-2.0, 2.0))


def _tile(golden, T, B):
    """The golden BOX run's initial window and noise, tiled over B."""
    return [
        np.tile(np.asarray(a)[None], (B,) + (1,) * np.asarray(a).ndim)
        for a in (golden["x0"], golden["BOX_u_past0"],
                  golden["BOX_y_past0"], golden["w_sys"][:T])
    ]


def _two_regimes(golden, T, B):
    """B scenarios from the golden window, the second half with the
    window mirrored (negated) and their own noise."""
    x0, up, yp, W = _tile(golden, T, B)
    h = B // 2
    for a in (x0, up, yp):
        a[h:] *= -1.0
    W[h:] = 0.002 * np.random.default_rng(1).uniform(-1, 1, (B - h, T, 2))
    return [x0, up, yp, W]


def _t(arrays, dtype=torch.float32):
    return [torch.as_tensor(a, dtype=dtype) for a in arrays]


def _capture(store):
    """The plain version, keeping its per-solve rung lanes."""
    def rollout(*args):
        out = fl.fused_ladder_reference(*args)
        store["RUNG"] = out[5]
        return out

    return rollout


def _run(op, T, inputs, store=None, **kw):
    rollout = fl.fused_ladder if store is None else _capture(store)
    return fl.make_fused_ladder_rollout(
        PLANT, op, 4, 2, 2, T, device="cpu", rollout=rollout,
        **{**KW, **kw},
    )(*_t(inputs))


def _jax_run(op, T, inputs, backend="xla", **kw):
    """The JAX engine on the same numpy inputs (float32), with its
    per-solve rung lanes read from the engine's output tile."""
    store = {}
    name = "_make_ladder_twin" if backend == "xla" else "_make_ladder_kernel"
    orig = getattr(jpa, name)

    def spy(*a, **k):
        engine = orig(*a, **k)

        def run(*args):
            out = engine(*args)
            store["OUT"] = np.asarray(out[0])
            return out

        return run

    mp = pytest.MonkeyPatch()
    mp.setattr(jpa, name, spy)
    try:
        res = jpa.make_fused_ladder_rollout(
            _plant32(), op, n=4, m=2, p=2, n_steps=T, backend=backend,
            **{**KW, **kw},
        )(*(jnp.asarray(a, jnp.float32) for a in inputs))
    finally:
        mp.undo()
    # OUT (n_blocks, q*(m + p) + 4q, Bq): the rung lanes come last.
    OUT, B = store["OUT"], inputs[0].shape[0]
    q = OUT.shape[1] // 8  # four-tank: q*(2 + 2) + 4q lanes
    rung = OUT[:, -q:].transpose(2, 1, 0).reshape(B, -1)
    return res, rung.astype(np.int32)


def test_per_rung_operators_equal_single_rung_builds(ladder):
    """Rung r of the stack is exactly the fixed-penalty build at
    ``rho = rhos[r]``."""
    ctrl, op = ladder
    ops, dims = fl.build_fused_ladder_operator(PLANT, op, 4, 2, 2,
                                               device="cpu")
    R = op["rhos"].shape[0]
    assert R == 7 and ops.Vop.shape == (R, 52, 52)
    assert (dims.S, dims.nbox, dims.nxi, dims.W2) == (20, 52, 68, 145)
    torch.testing.assert_close(ops.rhos, torch.as_tensor(
        op["rhos"], dtype=torch.float32), rtol=0, atol=0)
    for r in (0, 3, R - 1):
        single = box.compute_box_admm_operator_np(
            ctrl.spec, u_bounds=(-0.85, 0.85), rho=float(op["rhos"][r])
        )
        one, _ = fa.build_fused_admm_operator(PLANT, single, 4, 2, 2,
                                              device="cpu")
        for name in fl.FusedLadderOperator._fields[:6]:
            assert torch.equal(getattr(ops, name)[r], getattr(one, name)), \
                (name, r)
        for name in ("lo", "hi", "u_lo", "u_hi"):
            assert torch.equal(getattr(ops, name), getattr(one, name))


def test_operators_from_jax_dict_equal_port_dict(golden, ladder):
    ctrl, op = ladder
    u = float(golden["u_box"])
    jop = jbox.compute_box_admm_operator_np(ctrl.spec, u_bounds=(-u, u))
    (got, dims), (want, jdims) = (
        fl.build_fused_ladder_operator(PLANT, o, 4, 2, 2, device="cpu",
                                       dtype=torch.float64)
        for o in (op, jop)
    )
    assert dims == jdims
    for name in fl.FusedLadderOperator._fields:
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=1e-12, msg=name)


def test_plain_version_matches_jax_twin(golden, ladder):
    """One rung group over the batch, as the JAX twin shares one rung:
    the rung sequences are equal, u and y within atol 1e-4, costs rtol
    5e-3 / atol 1e-3 (the twin runs bf16 3-pass iterations, the port
    float32). Measured on the CPU: max |du| 2.6e-5, |dy| 4.2e-6."""
    _, op = ladder
    T, B = 120, 2
    inputs = _tile(golden, T, B)
    store = {}
    res = _run(op, T, inputs, store, rung_group=B)
    ref, ref_rung = _jax_run(op, T, inputs)
    np.testing.assert_array_equal(store["RUNG"].numpy(), ref_rung)
    for field in ("u_sys", "y_sys"):
        np.testing.assert_allclose(
            getattr(res, field).numpy(), np.asarray(getattr(ref, field)),
            rtol=0, atol=DU, err_msg=field,
        )
    np.testing.assert_allclose(res.costs.numpy(), np.asarray(ref.costs),
                               rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_array_equal(
        res.solver_state.rho_idx.numpy(),
        np.asarray(ref.solver_state.rho_idx),
    )


def test_plain_version_matches_jax_kernel_two_blocks(golden, wide):
    """Against the JAX kernel in interpret mode with two batch blocks of
    2 packed rows (q = 2 scenarios each): ``rung_group = 4``. The two
    groups walk different rung paths; the sequences are equal."""
    op = wide
    T, B = 16, 8
    inputs = _two_regimes(golden, T, B)
    store = {}
    res = _run(op, T, inputs, store, rung_group=4)
    ref, ref_rung = _jax_run(op, T, inputs, backend="pallas",
                             interpret=True, batch_block=2)
    np.testing.assert_array_equal(store["RUNG"].numpy(), ref_rung)
    assert not np.array_equal(ref_rung[0], ref_rung[-1])
    np.testing.assert_allclose(res.u_sys.numpy(), np.asarray(ref.u_sys),
                               rtol=0, atol=DU)


def test_plain_version_matches_golden(golden, ladder):
    """From the middle rung the balancer climbs to the saturated
    regime's rung: max |du| < 1e-4 against the float64 golden, every
    solve from index 5 converged, the box respected."""
    _, op = ladder
    T = golden["BOX_u"].shape[0]
    res = _run(op, T, _tile(golden, T, 2))
    du = np.abs(res.u_sys[0].double().numpy() - golden["BOX_u"]).max()
    assert du < DU, du
    assert bool(res.converged[:, 5:].all())
    assert float(res.u_sys.abs().max()) <= float(golden["u_box"]) + 1e-6
    R = op["rhos"].shape[0]
    assert int(res.solver_state.rho_idx[0]) != R // 2
    assert isinstance(res.solver_state, BoxADMMState)


def test_loose_box_rung_walks_down():
    """A box that is never active (|u| <= 30): the balancer steps down
    from the middle rung toward the curvature-scale rung and converges
    (tests/test_fused_admm.py::test_fused_ladder_rung_settles_loose_box,
    on bench.py's seed-0 controller)."""
    plant, ctrl = build_four_tank_robust()
    op = box.compute_box_admm_operator_np(ctrl.spec, u_bounds=(-30.0, 30.0))
    T, B = 40, 2
    rng = np.random.default_rng(0)
    inputs = [np.tile(np.asarray(a)[None], (B,) + (1,) * np.ndim(a))
              for a in (plant.get_state(), ctrl.u_past.reshape(4, 2),
                        ctrl.y_past.reshape(4, 2))]
    inputs.append(0.002 * rng.uniform(-1, 1, (B, T, 2)))
    res = fl.make_fused_ladder_rollout(
        plant.as_params(), op, 4, 2, 2, T, device="cpu", **KW
    )(*_t(inputs))
    R = op["rhos"].shape[0]
    assert int(res.solver_state.rho_idx[0]) < R // 2
    assert bool(res.converged[:, 10:].all())


def test_rung_groups_are_independent(golden, wide):
    """B = 6 in groups of 4 and 2 equals the two groups run on their
    own, bit for bit, with the groups on different rung paths."""
    op = wide
    T, B = 16, 6
    inputs = _two_regimes(golden, T, 8)
    inputs = [a[:B] for a in inputs]
    store = {}
    whole = _run(op, T, inputs, store, rung_group=4)
    assert not torch.equal(store["RUNG"][0], store["RUNG"][-1])
    parts = [_run(op, T, [a[sl] for a in inputs], rung_group=4)
             for sl in (slice(0, 4), slice(4, B))]
    for field in ("u_sys", "y_sys", "costs", "converged", "x_final"):
        joined = torch.cat([getattr(p, field) for p in parts])
        assert torch.equal(getattr(whole, field), joined), field
    for i in range(3):
        joined = torch.cat([p.solver_state[i] for p in parts])
        assert torch.equal(whole.solver_state[i], joined)


def test_segmented_restart_resumes_each_group_at_its_rung(golden, wide):
    """Two segments, the second warm-started from the first's state,
    with the two groups on different rungs at the cut: each group
    resumes at its own rung, within 1e-4 of the uninterrupted run. A
    state whose group rows disagree, and an explicit ``init_rung`` that
    contradicts a group's rung, raise."""
    op5 = wide
    T, T1, B = 40, 11, 8
    x0, up, yp, W = _t(_two_regimes(golden, T, B))
    kw = dict(device="cpu", rung_group=4, **KW)
    full = fl.make_fused_ladder_rollout(PLANT, op5, 4, 2, 2, T, **kw)(
        x0, up, yp, W
    )
    seg1 = fl.make_fused_ladder_rollout(PLANT, op5, 4, 2, 2, T1, **kw)(
        x0, up, yp, W[:, :T1]
    )
    rungs = seg1.solver_state.rho_idx
    assert int(rungs[0]) != int(rungs[-1])
    second = fl.make_fused_ladder_rollout(
        PLANT, op5, 4, 2, 2, T - T1, **{**kw, "cold_iters": 0}
    )
    seg2 = second(seg1.x_final, seg1.u_past, seg1.y_past, W[:, T1:],
                  solver_state0=seg1.solver_state)
    joined = torch.cat([seg1.u_sys, seg2.u_sys], dim=1)
    assert float((joined - full.u_sys).abs().max()) < DU
    with pytest.raises(ValueError, match="another rung_group"):
        fl.make_fused_ladder_rollout(
            PLANT, op5, 4, 2, 2, T - T1, **{**kw, "rung_group": 8}
        )(seg1.x_final, seg1.u_past, seg1.y_past, W[:, T1:],
          solver_state0=seg1.solver_state)
    with pytest.raises(ValueError, match="scaled for that rung"):
        fl.make_fused_ladder_rollout(
            PLANT, op5, 4, 2, 2, T - T1, init_rung=int(rungs[0]), **kw
        )(seg1.x_final, seg1.u_past, seg1.y_past, W[:, T1:],
          solver_state0=seg1.solver_state)


def test_tile_plan_and_cpu_tensors_take_plain_version(golden, ladder):
    """The default group is the kernel's tile (64 scenarios in 143,568
    bytes at four_tank_ladder; smaller for larger operators); CPU
    tensors run the plain version and launch nothing."""
    _, op = ladder
    ops, dims = fl.build_fused_ladder_operator(PLANT, op, 4, 2, 2,
                                               device="cpu")
    assert fl.ladder_tile_rows(dims) == 64
    assert fl.ladder_smem_bytes(dims, 64) == 143568
    big = dims._replace(nbox=120, nxi=dims.n_theta + 120)
    assert fl.ladder_tile_rows(big) == 16
    huge = dims._replace(nbox=600, nxi=dims.n_theta + 600)
    assert fl.ladder_tile_rows(huge) == 0
    T = 8
    inputs = _t(_tile(golden, T, 3))
    run = fl.make_fused_ladder_rollout(PLANT, op, 4, 2, 2, T, device="cpu",
                                       **KW)
    assert run.rung_group == 64
    before = fl.fused_ladder.launches
    res = run(*inputs)
    ref = fl.make_fused_ladder_rollout(
        PLANT, op, 4, 2, 2, T, device="cpu",
        rollout=fl.fused_ladder_reference, **KW,
    )(*inputs)
    assert fl.fused_ladder.launches == before == 0
    for a, b in zip(res[:-1] + res.solver_state, ref[:-1] + ref.solver_state):
        assert torch.equal(a, b)
    meta = fa.ADMMCarry(*(torch.zeros(2, w, device="meta") for w in
                          (dims.S, dims.Mw, dims.nbox, dims.nxi, dims.nbox,
                           dims.nbox)))
    with pytest.raises(ValueError, match="device"):
        fl.fused_ladder(ops, dims, meta, torch.zeros(2, T, 2, device="meta"),
                        18, torch.zeros(1, dtype=torch.int32), 64)
    with pytest.raises(ValueError, match="init_rung"):
        fl.make_fused_ladder_rollout(PLANT, op, 4, 2, 2, T, device="cpu",
                                     init_rung=7)


def test_kernel_block_is_smaller_than_the_group_rule(ladder):
    """The ladder kernel keeps s and w in registers, so its block of 64
    scenarios at four_tank_ladder takes 100,736 bytes, two of which (each
    with the 1 KB the SM reserves per block) fit an SM's 228 KB; the rung
    group is still sized by the 143,568-byte rule (the test above)."""
    _, op = ladder
    _, dims = fl.build_fused_ladder_operator(PLANT, op, 4, 2, 2,
                                             device="cpu")
    tile = fl.ladder_tile_rows(dims)
    assert fl.ladder_kernel_smem_bytes(dims, tile) == 100736
    assert 2 * (fl.ladder_kernel_smem_bytes(dims, tile) + 1024) <= 228 * 1024
    for nbox in (52, 60, 120):
        d = dims._replace(nbox=nbox, nxi=dims.n_theta + nbox)
        t = fl.ladder_tile_rows(d)
        assert fl.ladder_kernel_smem_bytes(d, t) < fl.ladder_smem_bytes(d, t)


def test_amortized_run_covers_every_repetition(golden, ladder):
    """The checksum is the sum over R rollouts on the noise rolled by
    0..R-1 steps of the last costs, u and y; ``ok`` needs every solve
    from ``CONVERGED_FROM`` on converged in every repetition."""
    _, op = ladder
    T, R = 16, 3
    x0, up, yp, W = _t(_tile(golden, T, 2))
    kw = dict(device="cpu", **KW)
    checksum, ok = fl.make_amortized_ladder_run(
        PLANT, op, 4, 2, 2, T, **kw
    )(x0, up, yp, W, R)
    run = fl.make_fused_ladder_rollout(PLANT, op, 4, 2, 2, T, **kw)
    want, conv = 0.0, True
    for i in range(R):
        r = run(x0, up, yp, torch.roll(W, i, dims=1))
        want += float(r.costs[:, -1].sum() + r.u_sys.sum() + r.y_sys.sum())
        conv = conv and bool(r.converged[:, fl.CONVERGED_FROM:].all())
    assert bool(ok) == conv and conv
    assert abs(float(checksum) - want) <= 1e-5 * abs(want)
    # An iteration budget too small to converge clears the flag.
    _, ok = fl.make_amortized_ladder_run(
        PLANT, op, 4, 2, 2, T, **{**kw, "iters": (0, 2, 0)}
    )(x0, up, yp, W, 1)
    assert not bool(ok)
