"""PyTorch port, one scenario through the condensed engine:
``time_parallel_rollout`` (a Hillis-Steele prefix scan of the per-block
affine maps) and ``linear_closed_loop_rollout`` (the sequential
recursion at B = 1), held against the JAX package's two functions on
the same numpy inputs and the JAX block map (carried by
``block_map_from_numpy``), against each other, with a setpoint
schedule, and against the framework-free float64 goldens."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from direct_data_driven_mpc_tpu.control import (  # noqa: E402
    linear_engine as jle,
)
from direct_data_driven_mpc_tpu_torch.control import (  # noqa: E402
    linear_engine as le,
)
from direct_data_driven_mpc_tpu_torch.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams  # noqa: E402
from direct_data_driven_mpc_tpu_torch.parallel.batch import (  # noqa: E402
    draw_block_noise,
)
from direct_data_driven_mpc_tpu_torch.qp.spec import (  # noqa: E402
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

from tests.test_closed_loop import FOUR_TANK  # noqa: E402
from tests.test_torch_host import controller_kwargs, port_setup  # noqa: E402

EXACT = 1e-9  # float64 (tests/test_time_parallel.py)
COST_RTOL = 1e-7
CASES = [(1, 1, 40), (1, 8, 40), (1, 8, 37), (4, 4, 42)]
CASE_IDS = ["K1", "K8", "K8-ragged", "nstep4-K4"]
GOLDEN = os.path.join(
    os.path.dirname(__file__), "golden", "four_tank_golden.npz"
)
#: scheme -> (n_mpc_step, use_terminal_constraint, n_steps), as in
#: tests/test_golden_parity.py.
SCHEMES = {
    "TEC": (1, True, 120),
    "TEC_N_STEP": (4, True, 120),
    "UCON": (1, False, 40),
}
F64_BUDGET = 1e-9  # tests/test_golden_parity.py


def _jax_time_parallel(jbm, x0, up, yp, W, **kw):
    """JAX's scan, compiled (op by op it takes seconds) with the block
    map closed over: its ``n_r`` must stay a Python int."""
    return jax.jit(
        lambda *a: jle.time_parallel_rollout(jbm, *a, **kw)
    )(x0, up, yp, W)


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """The host float64 builds on one BLAS thread (see
    tests/test_torch_iterative.py)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module")
def setups():
    """``port_setup`` per ``n_mpc_step``, built once."""
    cache = {}

    def get(n_mpc_step):
        if n_mpc_step not in cache:
            cache[n_mpc_step] = port_setup(n_mpc_step=n_mpc_step)
        return cache[n_mpc_step]

    return get


def _scenario(jplant, jctrl, rng, n_steps):
    return (jplant.get_state().copy(), jctrl.u_past.reshape(4, 2).copy(),
            jctrl.y_past.reshape(4, 2).copy(),
            0.002 * rng.uniform(-1, 1, (n_steps, 2)))


def _carried(jbm, dtype=torch.float64):
    return le.block_map_from_numpy(
        {k: getattr(jbm, k) for k in le.AffineBlockMap._fields}, "cpu",
        dtype,
    )


def _assert_results_close(got, want, atol=EXACT, rtol=COST_RTOL):
    for name in ("u_sys", "y_sys", "x_final", "u_past", "y_past"):
        a, b = getattr(got, name), getattr(want, name)
        b = np.asarray(b.numpy() if isinstance(b, torch.Tensor) else b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=atol,
                                   err_msg=name)
    b = want.costs
    np.testing.assert_allclose(
        got.costs.numpy(),
        np.asarray(b.numpy() if isinstance(b, torch.Tensor) else b),
        rtol=rtol, atol=atol,
    )
    assert bool(got.converged.all())


@pytest.mark.parametrize("n_mpc_step,K,n_steps", CASES, ids=CASE_IDS)
def test_time_parallel_matches_jax(setups, n_mpc_step, K, n_steps):
    jplant, jctrl, _, _ = setups(n_mpc_step)
    rng = np.random.default_rng(K * 100 + n_steps)
    jbm = jle.build_affine_block_map(
        jplant.as_params(), jctrl.solution_operator(), n=4, m=2, p=2,
        n_mpc_step=n_mpc_step, solves_per_block=K, dtype=jnp.float64,
    )
    x0, up, yp, W = _scenario(jplant, jctrl, rng, n_steps)
    got = le.time_parallel_rollout(_carried(jbm), x0, up, yp, W, n_steps,
                                   n_mpc_step=n_mpc_step)
    want = _jax_time_parallel(jbm, x0, up, yp, W, n_steps=n_steps,
                              n_mpc_step=n_mpc_step)
    _assert_results_close(got, want)


@pytest.mark.parametrize("n_mpc_step,K,n_steps", CASES, ids=CASE_IDS)
def test_time_parallel_matches_sequential(setups, n_mpc_step, K, n_steps):
    """Against the port's sequential engine on the port's own map."""
    jplant, jctrl, ctrl, _ = setups(n_mpc_step)
    rng = np.random.default_rng(K + n_steps)
    bm = le.build_linear_engine(ctrl, jplant.as_params(),
                                solves_per_block=K, device="cpu",
                                dtype=torch.float64)
    x0, up, yp, W = _scenario(jplant, jctrl, rng, n_steps)
    got = le.time_parallel_rollout(bm, x0, up, yp, W, n_steps,
                                   n_mpc_step=n_mpc_step)
    want = le.linear_closed_loop_rollout(bm, x0, up, yp, W, n_steps,
                                         n_mpc_step=n_mpc_step)
    _assert_results_close(got, want)


@pytest.mark.parametrize("K,n_steps", [(40, 40), (64, 37), (8, 56),
                                       (3, 40)],
                         ids=["n_outer1", "n_outer1-ragged", "n_outer7",
                              "n_outer14"])
def test_time_parallel_odd_block_counts(setups, K, n_steps):
    """One outer block (no scan round) and block counts that are not
    powers of two (the last round covers part of the prefix)."""
    jplant, jctrl, ctrl, _ = setups(1)
    rng = np.random.default_rng(K)
    bm = le.build_linear_engine(ctrl, jplant.as_params(),
                                solves_per_block=K, device="cpu",
                                dtype=torch.float64)
    x0, up, yp, W = _scenario(jplant, jctrl, rng, n_steps)
    got = le.time_parallel_rollout(bm, x0, up, yp, W, n_steps)
    want = le.linear_closed_loop_rollout(bm, x0, up, yp, W, n_steps)
    assert got.costs.shape == (n_steps,)
    _assert_results_close(got, want)


def test_time_parallel_float32_within_the_bar(setups):
    """K = 1, 40 blocks: the float32 scan within 1e-4 of float64 in u."""
    jplant, jctrl, ctrl, _ = setups(1)
    x0, up, yp, W = _scenario(jplant, jctrl, np.random.default_rng(5), 40)
    runs = {}
    for dtype in (torch.float32, torch.float64):
        bm = le.build_linear_engine(ctrl, jplant.as_params(),
                                    solves_per_block=1, device="cpu",
                                    dtype=dtype)
        runs[dtype] = le.time_parallel_rollout(bm, x0, up, yp, W, 40)
    assert runs[torch.float32].u_sys.dtype == torch.float32
    du = (runs[torch.float32].u_sys.double()
          - runs[torch.float64].u_sys).abs().max()
    assert float(du) < 1e-4


def test_tracking_schedule_matches_sequential_and_jax(setups):
    """A tracking map with a per-block schedule that steps the setpoint
    to 0.7x halfway (tests/test_tracking_engine.py), in float64."""
    jplant, jctrl, ctrl, _ = setups(1)
    K, n_steps = 8, 40
    bm = le.build_tracking_engine(ctrl, jplant.as_params(),
                                  solves_per_block=K, device="cpu",
                                  dtype=torch.float64)
    jbm = jle.build_tracking_engine(jctrl, jplant.as_params(),
                                    solves_per_block=K, dtype=jnp.float64)
    r0 = np.concatenate([ctrl.u_s.ravel(), ctrl.y_s.ravel()])
    n_outer = n_steps // K
    sched = np.stack([r0 if i < n_outer // 2 else 0.7 * r0
                      for i in range(n_outer)])
    x0, up, yp, W = _scenario(jplant, jctrl, np.random.default_rng(9),
                              n_steps)
    got = le.time_parallel_rollout(bm, x0, up, yp, W, n_steps,
                                   setpoints=sched)
    seq = le.linear_closed_loop_rollout(bm, x0, up, yp, W, n_steps,
                                        setpoints=sched)
    _assert_results_close(got, seq)
    want = _jax_time_parallel(jbm, x0, up, yp, W, n_steps=n_steps,
                              setpoints=jnp.asarray(sched))
    _assert_results_close(got, want)
    # The schedule moves the trajectory: it is not the constant r0's.
    const = le.time_parallel_rollout(bm, x0, up, yp, W, n_steps,
                                     setpoints=r0)
    assert float((const.u_sys - got.u_sys).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="setpoints"):
        le.time_parallel_rollout(bm, x0, up, yp, W, n_steps,
                                 setpoints=sched[:2])
    plain = le.build_linear_engine(ctrl, jplant.as_params(),
                                   solves_per_block=K, device="cpu",
                                   dtype=torch.float64)
    with pytest.raises(ValueError, match="tracking block map"):
        le.time_parallel_rollout(plain, x0, up, yp, W, n_steps,
                                 setpoints=r0)
    with pytest.raises(ValueError, match="n_mpc_step"):
        le.time_parallel_rollout(plain, x0, up, yp, W, n_steps,
                                 n_mpc_step=2)


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_time_parallel_matches_golden(scheme):
    g = np.load(GOLDEN)
    n_mpc_step, use_terminal, n_steps = SCHEMES[scheme]
    ctrl = DirectDataDrivenMPCController(
        **controller_kwargs(g["u_d"], g["y_d"], n_mpc_step=n_mpc_step,
                            use_terminal=use_terminal),
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=DataDrivenMPCType.ROBUST,
    )
    plant = LTIParams(FOUR_TANK["A"], FOUR_TANK["B"], FOUR_TANK["C"],
                      FOUR_TANK["D"])
    bm = le.build_linear_engine(ctrl, plant, solves_per_block=10,
                                device="cpu", dtype=torch.float64)
    res = le.time_parallel_rollout(
        bm, g["x0"], g[f"{scheme}_u_past0"], g[f"{scheme}_y_past0"],
        g["w_sys"][:n_steps], n_steps, n_mpc_step=n_mpc_step,
    )
    du = np.abs(res.u_sys.numpy() - g[f"{scheme}_u"]).max()
    assert du < F64_BUDGET


@pytest.mark.parametrize("n_mpc_step,K,n_steps", [(1, 8, 37), (4, 4, 42)],
                         ids=["K8-ragged", "nstep4-K4"])
def test_linear_closed_loop_rollout_matches_jax(setups, n_mpc_step, K,
                                                n_steps):
    jplant, jctrl, _, _ = setups(n_mpc_step)
    jbm = jle.build_affine_block_map(
        jplant.as_params(), jctrl.solution_operator(), n=4, m=2, p=2,
        n_mpc_step=n_mpc_step, solves_per_block=K, dtype=jnp.float64,
    )
    x0, up, yp, W = _scenario(jplant, jctrl, np.random.default_rng(3),
                              n_steps)
    got = le.linear_closed_loop_rollout(_carried(jbm), x0, up, yp, W,
                                        n_steps, n_mpc_step=n_mpc_step)
    want = jle.linear_closed_loop_rollout(jbm, x0, up, yp, W=W,
                                          n_steps=n_steps,
                                          n_mpc_step=n_mpc_step)
    assert got.solver_state is None
    _assert_results_close(got, want)


def test_linear_closed_loop_rollout_generator_noise(setups):
    """Noise drawn block by block from a generator equals an explicit
    run fed the same per-block draws (whole blocks: drawn noise also
    fills a ragged run's padded steps); neither W nor a generator
    raises."""
    jplant, jctrl, ctrl, _ = setups(1)
    K, n_steps, eps = 8, 40, 0.002
    bm = le.build_linear_engine(ctrl, jplant.as_params(),
                                solves_per_block=K, device="cpu",
                                dtype=torch.float64)
    x0, up, yp, _ = _scenario(jplant, jctrl, np.random.default_rng(0), 1)
    got = le.linear_closed_loop_rollout(
        bm, x0, up, yp, n_steps=n_steps,
        generator=torch.Generator().manual_seed(4), eps_max=eps)
    gen = torch.Generator().manual_seed(4)
    W = torch.cat([draw_block_noise(gen, 1, K * 2, eps, "cpu",
                                    torch.float64).reshape(K, 2)
                   for _ in range(n_steps // K)])
    want = le.linear_closed_loop_rollout(bm, x0, up, yp, W, n_steps)
    _assert_results_close(got, want, atol=0.0, rtol=0.0)
    with pytest.raises(ValueError, match="generator"):
        le.linear_closed_loop_rollout(bm, x0, up, yp, n_steps=n_steps)


def test_chip_smoke_single_scenario_phases_run_on_the_cpu(capsys):
    """``chip_smoke.py``'s phases 36-39 on the CPU, phase 38 at T = 120
    (on the card it is also timed): every check passes."""
    from chip_smoke import (
        build_four_tank_robust,
        device_ops_phase,
        export_phase,
        host_cpu,
        native_phase,
        scenario_batch,
        time_parallel_phase,
    )

    dev = torch.device("cpu")
    plant, ctrl = build_four_tank_robust()
    W = torch.as_tensor(0.002 * np.random.default_rng(0).uniform(
        -1, 1, (2, 120, 2)), dtype=torch.float32)
    main = dict(plant=plant, ctrl=ctrl,
                inputs=(*scenario_batch(plant, ctrl, 2, dev), W))
    native_phase("cpu", host_cpu(), n_lat=20)
    export_phase("cpu")
    time_parallel_phase(dev, "cpu", main, T=120)
    device_ops_phase(dev, "cpu", main)
    out = capsys.readouterr().out
    for line in ("native interactive NONE (nz 571, nc 168)",
                 "native interactive CONVEX (nbox 60)",
                 "export + C runtime CONVEX", "refused",
                 "time-parallel K=1 (n_outer 120) tracking",
                 "time-parallel K=50 (n_outer 3) plain",
                 "rank 76 and PE (76, True)"):
        assert line in out, line
    assert "timing" not in out
