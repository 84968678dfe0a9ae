"""PyTorch port, the options it took last from the JAX package: the
classic engine's Monte-Carlo aggregate mode (``emit_trajectories``) and
its ``precision`` names, the fused ladder's ``balance_ratio`` (kernel
K5's plain version; the kernel itself in tests/test_torch_cuda.py), and
``stacked_solution_map``'s default dtype; each held against the JAX
package on the same numpy inputs (the JAX side in float32, since
tests/conftest.py turns on x64) and, for the aggregate mode, against the
port's own full run bit for bit. The sharded aggregate mode runs in the
gloo spawn of tests/test_torch_mesh.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from direct_data_driven_mpc_tpu.control import linear_engine as jle  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control import linear_engine as le  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp import box  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp.batch_build import (  # noqa: E402
    stacked_solution_map,
)
from direct_data_driven_mpc_tpu_torch.qp.solution_map import (  # noqa: E402
    SolutionMap,
)

from tests.test_torch_fused_ladder import (  # noqa: E402
    DU,
    GOLDEN,
    KW,
    PLANT,
    _golden_controller,
    _jax_run,
    _run,
    _tile,
    _two_regimes,
)
from tests.test_torch_fused_ladder import (  # noqa: E402
    COST_ATOL as LADDER_COST_ATOL,
    COST_RTOL as LADDER_COST_RTOL,
)
from tests.test_torch_host import port_setup  # noqa: E402
from tests.test_torch_iterative import one_blas_thread  # noqa: E402,F401

#: tests/test_torch_linear_engine.py's bar for the float32 classic
#: engine against JAX's.
ATOL = 2e-5
COST_RTOL, COST_ATOL = 1e-3, 1e-5
#: Every field the aggregate mode emits.
EMITTED = ("costs", "converged", "x_final", "u_past", "y_past")
#: case -> (n_mpc_step, solves per block, steps, batch or None for one
#: scenario, tracking). 37 steps at n_mpc_step 4 and K = 3: 10 solves
#: in 4 outer blocks of 12 steps, the last trimmed.
CASES = {
    "one": (1, 8, 40, None, False),
    "batched": (1, 8, 40, 6, False),
    "n_mpc_step_4": (4, 3, 37, 6, False),
    "tracking": (1, 8, 40, 6, True),
}
_SETUPS = {}


def _setup(n_mpc_step):
    """Both controllers (cached per ``n_mpc_step``)."""
    if n_mpc_step not in _SETUPS:
        _SETUPS[n_mpc_step] = port_setup(n_mpc_step=n_mpc_step)
    return _SETUPS[n_mpc_step]


def _case(name):
    """The port's float32 map, JAX's float32 map (each built by its own
    package), the batch as numpy, and a tracking schedule per scenario
    and outer block (or None)."""
    nb, K, T, B, tracking = CASES[name]
    jplant, jctrl, ctrl, _ = _setup(nb)
    plant = jplant.as_params()
    build, jbuild = ((le.build_tracking_engine, jle.build_tracking_engine)
                     if tracking else
                     (le.build_linear_engine, jle.build_linear_engine))
    bm = build(ctrl, plant, solves_per_block=K, device="cpu")
    jbm = jbuild(jctrl, plant, solves_per_block=K, dtype=jnp.float32)
    rng = np.random.default_rng(11)
    Bn = B or 1
    batch = [np.tile(jplant.get_state()[None], (Bn, 1)),
             np.tile(jctrl.u_past.reshape(1, 4, 2), (Bn, 1, 1)),
             np.tile(jctrl.y_past.reshape(1, 4, 2), (Bn, 1, 1)),
             0.002 * rng.uniform(-1, 1, (Bn, T, 2))]
    sched = None
    if tracking:
        r0 = np.concatenate([ctrl.u_s.ravel(), ctrl.y_s.ravel()])
        n_outer = -(-T // (K * nb))
        sched = (r0 * rng.uniform(0.7, 1.0, (Bn, n_outer, 1))).astype(
            np.float32)
    return bm, jbm, batch, sched, (nb, T, B)


def _t(arrays):
    return [torch.as_tensor(np.asarray(a), dtype=torch.float32)
            for a in arrays]


def _j(arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


def _port_runs(bm, batch, sched, nb, T, B, **kw):
    """``{emit: result}`` of the port's classic engine, batched or (B
    None) through the single-scenario entry point."""
    out = {}
    for emit in (True, False):
        if B is None:
            one = [a[0] for a in _t(batch)]
            out[emit] = le.linear_closed_loop_rollout(
                bm, *one[:3], W=one[3], n_steps=T, n_mpc_step=nb,
                emit_trajectories=emit, **kw)
        else:
            out[emit] = le.make_linear_batched_rollout(
                bm, T, n_mpc_step=nb, emit_trajectories=emit,
                setpoints=None if sched is None else torch.as_tensor(sched),
                **kw)(*_t(batch))
    return out


def _assert_emitted_bit_equal(agg, full):
    for field in EMITTED:
        assert torch.equal(getattr(agg, field), getattr(full, field)), field


@pytest.mark.parametrize("name", list(CASES))
def test_aggregate_mode_matches_jax_and_the_full_mode(name):
    """``emit_trajectories=False``: u and y empty in JAX's shapes; every
    emitted field bit-equal to the port's full run (the same products in
    the same order), and within the float32 bar of JAX's aggregate run
    (one scenario, a batch, n_mpc_step 4 with a trimmed last block, and
    a tracking map on a per-scenario schedule)."""
    bm, jbm, batch, sched, (nb, T, B) = _case(name)
    runs = _port_runs(bm, batch, sched, nb, T, B)
    agg, full = runs[False], runs[True]
    if B is None:
        ref = jle.linear_closed_loop_rollout(
            jbm, *(_j(a[0] for a in batch[:3])), W=_j([batch[3][0]])[0],
            n_steps=T, n_mpc_step=nb, emit_trajectories=False)
    else:
        ref = jle.make_linear_batched_rollout(
            jbm, n_steps=T, n_mpc_step=nb, emit_trajectories=False,
            setpoints=None if sched is None else jnp.asarray(sched),
        )(*_j(batch))
    lead = () if B is None else (B,)
    assert agg.u_sys.shape == lead + (0, 2) == ref.u_sys.shape
    assert agg.y_sys.shape == lead + (0, 2) == ref.y_sys.shape
    assert full.u_sys.shape == lead + (T, 2)
    assert agg.costs.shape == lead + (-(-T // nb),) == ref.costs.shape
    _assert_emitted_bit_equal(agg, full)
    for field in ("x_final", "u_past", "y_past"):
        np.testing.assert_allclose(
            getattr(agg, field).numpy(), np.asarray(getattr(ref, field)),
            rtol=0, atol=ATOL, err_msg=field)
    np.testing.assert_allclose(agg.costs.numpy(), np.asarray(ref.costs),
                               rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_array_equal(agg.converged.numpy(),
                                  np.asarray(ref.converged))


@pytest.mark.parametrize("name", ["one", "n_mpc_step_4", "tracking"])
def test_aggregate_mode_with_generator_noise_is_bit_equal(name):
    """Noise drawn block by block from a generator: the aggregate run
    draws what the full run draws, and its emitted fields are equal bit
    for bit."""
    bm, _, batch, sched, (nb, T, B) = _case(name)
    out = {}
    for emit in (True, False):
        gen = torch.Generator().manual_seed(5)
        if B is None:
            out[emit] = le.linear_closed_loop_rollout(
                bm, *(a[0] for a in _t(batch[:3])), n_steps=T,
                n_mpc_step=nb, generator=gen, eps_max=0.002,
                emit_trajectories=emit)
        else:
            out[emit] = le.make_linear_batched_rollout(
                bm, T, n_mpc_step=nb, use_rng_noise=True, eps_max=0.002,
                emit_trajectories=emit,
                setpoints=None if sched is None else torch.as_tensor(sched),
            )(*_t(batch[:3]), gen)
    assert out[False].u_sys.numel() == out[False].y_sys.numel() == 0
    assert out[True].u_sys.shape[-2] == T
    _assert_emitted_bit_equal(out[False], out[True])


@pytest.mark.parametrize("name", ["one", "batched"])
def test_precision_names_run_alike_and_match_jax(name):
    """``precision="high"`` runs in IEEE float32 as "highest" does: every
    field bit-equal; against JAX's "high" run within the float32 bar."""
    bm, jbm, batch, sched, (nb, T, B) = _case(name)
    high = _port_runs(bm, batch, sched, nb, T, B, precision="high")[True]
    highest = _port_runs(bm, batch, sched, nb, T, B,
                         precision="highest")[True]
    for field in ("u_sys", "y_sys") + EMITTED:
        assert torch.equal(getattr(high, field), getattr(highest, field)), \
            field
    if B is None:
        ref = jle.linear_closed_loop_rollout(
            jbm, *(_j(a[0] for a in batch[:3])), W=_j([batch[3][0]])[0],
            n_steps=T, n_mpc_step=nb, precision="high")
    else:
        ref = jle.make_linear_batched_rollout(
            jbm, n_steps=T, n_mpc_step=nb, precision="high")(*_j(batch))
    for field in ("u_sys", "y_sys", "x_final", "u_past", "y_past"):
        np.testing.assert_allclose(
            getattr(high, field).numpy(), np.asarray(getattr(ref, field)),
            rtol=0, atol=ATOL, err_msg=field)
    np.testing.assert_allclose(high.costs.numpy(), np.asarray(ref.costs),
                               rtol=COST_RTOL, atol=COST_ATOL)


def test_an_unknown_precision_raises():
    bm, _, batch, _, (nb, T, _) = _case("batched")
    one = [a[0] for a in _t(batch)]
    with pytest.raises(ValueError, match="'high', 'highest'"):
        le.make_linear_batched_rollout(bm, T, precision="bfloat16")
    with pytest.raises(ValueError, match="precision must be one of"):
        le.linear_closed_loop_rollout(bm, *one[:3], W=one[3], n_steps=T,
                                      precision="default")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def wide_box(golden):
    """The golden BOX controller's default ladder at |u| <= 2, where the
    balancer's ratio moves the rung path (tests/test_torch_fused_ladder.py's
    ``wide``)."""
    ctrl = _golden_controller(golden, "BOX")
    return box.compute_box_admm_operator_np(ctrl.spec, u_bounds=(-2.0, 2.0))


@pytest.mark.parametrize("ratio", [5.0, 20.0])
def test_plain_ladder_at_a_balance_ratio_matches_jax_twin(golden, wide_box,
                                                          ratio):
    """The plain ladder at another balance ratio against the JAX twin at
    that ratio (one rung group over the batch, as the twin shares one
    rung): the rung lanes equal, and equal to the port's float64 run;
    u and y at the engines' bar, costs at theirs (the twin's iterations
    run in bf16 passes). Its rung path differs from the default ratio's."""
    T, B = 120, 2
    inputs = _tile(golden, T, B)
    lanes = {}
    res = _run(wide_box, T, inputs, lanes, rung_group=B, balance_ratio=ratio)
    lanes64 = {}
    _run(wide_box, T, inputs, lanes64, rung_group=B, balance_ratio=ratio,
         dtype=torch.float64)
    ref, ref_rung = _jax_run(wide_box, T, inputs, balance_ratio=ratio)
    assert torch.equal(lanes["RUNG"], lanes64["RUNG"])
    np.testing.assert_array_equal(lanes["RUNG"].numpy(), ref_rung)
    for field in ("u_sys", "y_sys"):
        np.testing.assert_allclose(
            getattr(res, field).numpy(), np.asarray(getattr(ref, field)),
            rtol=0, atol=DU, err_msg=field)
    np.testing.assert_allclose(res.costs.numpy(), np.asarray(ref.costs),
                               rtol=LADDER_COST_RTOL, atol=LADDER_COST_ATOL)
    np.testing.assert_array_equal(res.solver_state.rho_idx.numpy(),
                                  np.asarray(ref.solver_state.rho_idx))
    default = {}
    _run(wide_box, T, inputs, default, rung_group=B)
    assert not torch.equal(lanes["RUNG"], default["RUNG"])


def test_plain_ladder_at_a_balance_ratio_matches_jax_kernel(golden,
                                                            wide_box):
    """Against the JAX kernel in interpret mode at ratio 5, two batch
    blocks of 2 packed rows (``rung_group = 4``): the two groups walk
    different rung paths, equal in both packages."""
    T, B = 16, 8
    inputs = _two_regimes(golden, T, B)
    lanes = {}
    res = _run(wide_box, T, inputs, lanes, rung_group=4, balance_ratio=5.0)
    ref, ref_rung = _jax_run(wide_box, T, inputs, backend="pallas",
                             interpret=True, batch_block=2,
                             balance_ratio=5.0)
    np.testing.assert_array_equal(lanes["RUNG"].numpy(), ref_rung)
    assert not np.array_equal(ref_rung[0], ref_rung[-1])
    np.testing.assert_allclose(res.u_sys.numpy(), np.asarray(ref.u_sys),
                               rtol=0, atol=DU)


def test_balance_ratio_reaches_the_balancer(golden, wide_box):
    """The default is ratio 10 (the same bits as passing it); 5 moves the
    rung path, through the entry point's default rollout (``fused_ladder``,
    which runs the plain version on CPU tensors) as through the plain
    version; the ratio is rounded to float32 as the kernel takes it."""
    T, B = 40, 2
    inputs = _tile(golden, T, B)
    runs = {}
    for ratio in (None, 10.0, 5.0):
        kw = {} if ratio is None else dict(balance_ratio=ratio)
        lanes = {}
        plain = _run(wide_box, T, inputs, lanes, rung_group=B, **kw)
        wrapped = _run(wide_box, T, inputs, rung_group=B, **kw)
        for field in ("u_sys", "y_sys", "costs"):
            assert torch.equal(getattr(plain, field),
                               getattr(wrapped, field)), field
        runs[ratio] = (plain, lanes["RUNG"])
    assert fl.BALANCE_RATIO == 10.0
    assert torch.equal(runs[None][1], runs[10.0][1])
    assert torch.equal(runs[None][0].u_sys, runs[10.0][0].u_sys)
    assert not torch.equal(runs[5.0][1], runs[10.0][1])
    assert fl._ratio32(7.3) == float(np.float32(7.3)) != 7.3


def test_amortized_ladder_run_forwards_the_ratio(golden, wide_box):
    """``make_amortized_ladder_run`` passes ``balance_ratio`` on to the
    rollout: at ratio 5 its checksum is the one of ratio 5's rollouts."""
    T, B, R = 24, 2, 2
    ins = [torch.as_tensor(a, dtype=torch.float32)
           for a in _tile(golden, T, B)]
    sums = {}
    for ratio in (5.0, 10.0):
        kw = dict(KW, device="cpu", rung_group=B, balance_ratio=ratio)
        run = fl.make_amortized_ladder_run(PLANT, wide_box, 4, 2, 2, T,
                                           **kw)
        sums[ratio] = float(run(*ins, R)[0])
        one = fl.make_fused_ladder_rollout(PLANT, wide_box, 4, 2, 2, T, **kw)
        want = torch.zeros((), dtype=torch.float32)
        for i in range(R):
            r = one(*ins[:3], torch.roll(ins[3], i, dims=1))
            want = want + (r.costs[:, -1].sum() + r.u_sys.sum()
                           + r.y_sys.sum()).float()
        assert sums[ratio] == float(want)
    assert sums[5.0] != sums[10.0]


def test_stacked_solution_map_dtype_none_means_float32():
    """``dtype=None`` is float32, as in the JAX package, equal to an
    explicit float32 build; a narrower type still raises."""
    rng = np.random.default_rng(2)
    shapes = {"z_base": (3, 7), "Z": (3, 7, 4), "u_base": (3, 5),
              "U_gain": (3, 5, 4), "cost_P": (3, 4, 4), "cost_q": (3, 4),
              "cost_r": (3,)}
    assert set(shapes) == set(SolutionMap._fields)
    ops = {k: rng.standard_normal(s) for k, s in shapes.items()}
    got = stacked_solution_map(ops, device="cpu")
    want = stacked_solution_map(ops, dtype=torch.float32, device="cpu")
    for name, a, b in zip(SolutionMap._fields, got, want):
        assert a.dtype == torch.float32, name
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="float32 or torch.float64"):
        stacked_solution_map(ops, dtype=torch.float16, device="cpu")
