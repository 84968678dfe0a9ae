"""PyTorch port, the generic loop's iterative solvers: the device ADMM of
the CONVEX slack box (``qp.admm``) and the general-box ADMM with a fixed
penalty and with the penalty ladder (``qp.box``), held against the JAX
package on the four-tank Robust setup of tests/test_torch_host.py (the
same numpy data and windows handed to both; the JAX side in float32 or
float64 explicitly, since tests/conftest.py turns on x64) and certified
by the box-QP KKT conditions; their entry points; and the scoped IEEE
float32 guard (``ops.precision``) on every parity-bound path. The loop
and the batch layer are in tests/test_torch_generic_loop.py, the
NON_CONVEX solver in tests/test_torch_nonconvex.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from direct_data_driven_mpc_tpu.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController as JaxController,
)
from direct_data_driven_mpc_tpu.qp import admm as jadmm  # noqa: E402
from direct_data_driven_mpc_tpu.qp import box as jbox  # noqa: E402
from direct_data_driven_mpc_tpu.qp.spec import (  # noqa: E402
    DataDrivenMPCType as JaxType,
    SlackVarConstraintTypes as JaxSlack,
)
from direct_data_driven_mpc_tpu_torch.control import linear_engine as le  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control import loop  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops.estimation import (  # noqa: E402
    estimate_initial_state,
    observability_matrix,
    toeplitz_input_output_matrix,
)
from direct_data_driven_mpc_tpu_torch.ops.lti import (  # noqa: E402
    LTIParams,
    lti_rollout,
)
from direct_data_driven_mpc_tpu_torch.ops.precision import (  # noqa: E402
    ieee_float32,
)
from direct_data_driven_mpc_tpu_torch.qp import admm  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp import box  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp import solution_map as sm  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp.spec import (  # noqa: E402
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

from tests.test_torch_host import controller_kwargs, port_setup  # noqa: E402

EXACT = 1e-9  # float64: u, s, w
ATOL = 2e-5  # float32: u, y, s, w
COST_RTOL, COST_ATOL = 1e-3, 1e-5
B, T = 6, 30
U_BOX = 0.85
DTYPES = {"f64": (torch.float64, jnp.float64, EXACT),
          "f32": (torch.float32, jnp.float32, ATOL)}


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """The host float64 builds (KKT solves of 739 x 739) on one BLAS
    thread: beside the suite's other workers, a pool of threads per
    process oversubscribes the cores and slows these builds by orders of
    magnitude."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module")
def setup():
    """The JAX and port controllers, slack NONE and CONVEX (c = 0.05, so
    the box binds), on the same data; a batch of ``B`` windows around
    the initial one, and the closed-loop inputs (seeded numpy)."""
    jplant, jctrl, ctrl, rng = port_setup()
    kw = dict(controller_kwargs(jctrl.u_d, jctrl.y_d), c=0.05)
    jcvx = JaxController(**kw, slack_var_constraint_type=JaxSlack.CONVEX,
                         controller_type=JaxType.ROBUST)
    cvx = DirectDataDrivenMPCController(
        **kw, slack_var_constraint_type=SlackVarConstraintTypes.CONVEX,
        controller_type=DataDrivenMPCType.ROBUST,
    )
    theta0 = np.concatenate([ctrl.u_past.reshape(-1),
                             ctrl.y_past.reshape(-1)])
    thetas = theta0[None] + 0.05 * rng.standard_normal((B, theta0.size))
    x0 = jplant.get_state()
    ins = [np.tile(x0[None], (B, 1)),
           np.tile(ctrl.u_past.reshape(1, 4, 2), (B, 1, 1)),
           np.tile(ctrl.y_past.reshape(1, 4, 2), (B, 1, 1)),
           0.002 * rng.uniform(-1, 1, (B, T, 2))]
    return dict(plant=jplant, none=(jctrl, ctrl), convex=(jcvx, cvx),
                thetas=thetas, ins=ins, solvers={})


def _solvers(setup, kind, dt, jdt):
    """The JAX and port device solvers of one kind, and its iterations
    (built once per module)."""
    key = (kind, dt)
    if key not in setup["solvers"]:
        setup["solvers"][key] = _build_solvers(setup, kind, dt, jdt)
    return setup["solvers"][key]


def _build_solvers(setup, kind, dt, jdt):
    if kind == "admm":
        jc, c = setup["convex"]
        return (jc.admm_solver(dtype=jdt),
                c.admm_solver(device="cpu", dtype=dt), 16)
    jc, c = setup["none"]
    rho = 1.0 if kind == "box" else None
    return (jc.box_admm_solver(u_bounds=(-U_BOX, U_BOX), rho=rho,
                               dtype=jdt),
            c.box_admm_solver(u_bounds=(-U_BOX, U_BOX), rho=rho,
                              device="cpu", dtype=dt),
            60 if kind == "box" else 120)


def _close(got, want, atol, name):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol, err_msg=name)


def _costs_close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=COST_RTOL, atol=COST_ATOL)


@pytest.mark.parametrize("kind", ["admm", "box", "ladder"])
@pytest.mark.parametrize("dname", ["f64", "f32"])
def test_device_solve_matches_jax(setup, kind, dname):
    """One solve of a batch of windows: ``admm_solve`` (16 fixed
    iterations) and ``box_admm_solve`` (early exit; fixed rho and the
    ladder) against the JAX solves under ``vmap``, warm-started from the
    result of a first solve."""
    dt, jdt, tol = DTYPES[dname]
    js, ps, iters = _solvers(setup, kind, dt, jdt)
    jsolve = jadmm.admm_solve if kind == "admm" else jbox.box_admm_solve
    psolve = admm.admm_solve if kind == "admm" else box.box_admm_solve
    th = setup["thetas"]
    jsolve_b = jax.jit(jax.vmap(
        lambda t, s: jsolve(js, t, num_iters=iters, state=s, tol=1e-6)))
    jst = (jadmm.ADMMState(*(jnp.zeros((B, js.v_c.shape[-1]), jdt),) * 2)
           if kind == "admm" else jax.tree.map(
               lambda x: jnp.broadcast_to(x, (B, *x.shape)),
               jbox.box_initial_state(js)))
    pst = None
    for _ in range(2):
        ju, jc, jst, jstats = jsolve_b(jnp.asarray(th, jdt), jst)
        pu, pc, pst, pstats = psolve(ps, torch.as_tensor(th, dtype=dt),
                                     num_iters=iters, state=pst, tol=1e-6)
        _close(pu, ju, tol, "u")
        _close(pst.s, jst.s, tol, "s")
        _close(pst.w, jst.w, tol, "w")
        _costs_close(pc, jc)
        np.testing.assert_array_equal(pstats.converged.numpy(),
                                      np.asarray(jstats.converged))
        if kind != "admm":
            np.testing.assert_array_equal(pst.rho_idx.numpy(),
                                          np.asarray(jst.rho_idx))
    if kind != "admm":  # the free steps are boxed, the last n pinned
        assert float(pu[:, : (30 - 4) * 2].abs().max()) <= U_BOX + 1e-6


def test_admm_matches_exact_map_when_box_inactive(setup):
    """A huge c makes the slack box vacuous: the device ADMM gives the
    exact affine map's u and cost."""
    jctrl, ctrl = setup["none"]
    kw = dict(controller_kwargs(jctrl.u_d, jctrl.y_d), c=1e9)
    cvx = DirectDataDrivenMPCController(
        **kw, slack_var_constraint_type=SlackVarConstraintTypes.CONVEX,
        controller_type=DataDrivenMPCType.ROBUST,
    )
    th = torch.as_tensor(setup["thetas"])
    u, cost, _, stats = admm.admm_solve(
        cvx.admm_solver(device="cpu", dtype=torch.float64), th,
        num_iters=200,
    )
    smap = ctrl.solution_map(device="cpu", dtype=torch.float64)
    torch.testing.assert_close(u, sm.solve_u(smap, th), rtol=0, atol=1e-6)
    torch.testing.assert_close(cost, sm.optimal_cost(smap, th), rtol=0,
                               atol=1e-6)
    assert bool(stats.converged.all())


def test_admm_active_box_satisfies_kkt(setup):
    """At the device ADMM's fixed point the slack box binds and the
    box-QP KKT conditions hold with the multiplier ``mu = rho w``."""
    _, cvx = setup["convex"]
    spec = cvx.spec
    solver = cvx.admm_solver(device="cpu", dtype=torch.float64)
    theta = setup["thetas"][:1]
    _, _, state, stats = admm.admm_solve(solver, torch.as_tensor(theta),
                                         num_iters=400)
    assert bool(stats.converged.all())
    t = (state.s - state.w)[0].numpy()
    rho, bound = float(solver.rho), float(solver.bound)
    sl = spec.sigma_pred_slice
    nbox = sl.stop - sl.start
    E = np.zeros((nbox, spec.nz))
    E[np.arange(nbox), np.arange(sl.start, sl.stop)] = 1.0
    K = np.zeros((spec.nz + spec.nc, spec.nz + spec.nc))
    K[: spec.nz, : spec.nz] = spec.H + rho * E.T @ E
    K[: spec.nz, spec.nz :] = spec.A.T
    K[spec.nz :, : spec.nz] = spec.A
    b = spec.b_const + spec.S @ theta[0]
    z = np.linalg.lstsq(K, np.concatenate([-spec.g + rho * E.T @ t, b]),
                        rcond=None)[0][: spec.nz]
    sigma = z[sl]
    assert np.abs(spec.A @ z - b).max() < 1e-7
    assert np.abs(sigma).max() <= bound + 1e-7
    assert np.abs(sigma).max() > bound - 1e-9  # the box binds
    mu = rho * state.w[0].numpy()
    grad = spec.H @ z + spec.g + E.T @ mu
    nu = np.linalg.lstsq(spec.A.T, -grad, rcond=None)[0]
    assert np.abs(grad + spec.A.T @ nu).max() < 1e-6
    inactive = np.abs(sigma) < bound - 1e-8
    assert np.abs(mu[inactive]).max(initial=0.0) < 1e-6
    assert np.all(mu[~inactive] * np.sign(sigma[~inactive]) >= -1e-8)


def test_admm_over_relaxation_same_fixed_point_fewer_iters(setup):
    """alpha = 1.6 (the default) reaches the fixed point of plain ADMM
    (alpha = 1) in fewer iterations; the device solve at that count
    converges to it."""
    _, cvx = setup["convex"]
    theta = setup["thetas"][0]

    def iters_to_tol(alpha):
        op = admm.compute_admm_operator_np(cvx.spec, alpha=alpha)
        for it in range(10, 2001, 10):
            u, _, _, stats = admm.admm_solve_np(op, theta, num_iters=it)
            if stats.converged:
                return it, u
        raise AssertionError(f"alpha {alpha}: no convergence")

    it_plain, u_plain = iters_to_tol(1.0)
    it_relax, u_relax = iters_to_tol(1.6)
    assert it_relax < it_plain, (it_relax, it_plain)
    np.testing.assert_allclose(u_relax, u_plain, atol=1e-6)
    solver = cvx.admm_solver(device="cpu", dtype=torch.float64)
    assert float(solver.alpha) == pytest.approx(1.6)
    u, _, _, stats = admm.admm_solve(solver, torch.as_tensor(theta[None]),
                                     num_iters=it_relax + 5)
    assert bool(stats.converged.all())
    np.testing.assert_allclose(u[0].numpy(), u_plain, atol=1e-6)


def test_box_active_input_bound_satisfies_kkt(setup):
    """Tight, asymmetric input bounds (tests/test_box_constraints.py's
    case): the ladder's fixed point saturates, stays feasible, and
    satisfies stationarity and complementary slackness with ``mu = rho
    w`` at the adapted rung."""
    _, ctrl = setup["none"]
    spec = ctrl.spec
    theta = np.concatenate([ctrl.u_past.reshape(-1),
                            ctrl.y_past.reshape(-1)])
    th = torch.as_tensor(theta[None])
    smap = ctrl.solution_map(device="cpu", dtype=torch.float64)
    hi = 0.5 * float(sm.solve_u(smap, th).abs().max())
    lo = -0.25 * hi
    op = box.compute_box_admm_operator_np(spec, u_bounds=(lo, hi))
    solver = box.BoxADMMSolver(**{
        k: torch.as_tensor(op[k]) for k in box.BoxADMMSolver._fields})
    u, _, st, stats = box.box_admm_solve(solver, th, num_iters=3000)
    assert bool(stats.converged.all())
    assert float(u.max()) <= hi + 1e-7 and float(u.min()) >= lo - 1e-7
    assert float(u.max()) > hi - 1e-9
    rho = float(solver.rhos[int(st.rho_idx[0])])
    rows = op["box_rows"]
    E = np.zeros((rows.size, spec.nz))
    E[np.arange(rows.size), rows] = 1.0
    t = (st.s - st.w)[0].numpy()
    K = np.zeros((spec.nz + spec.nc, spec.nz + spec.nc))
    K[: spec.nz, : spec.nz] = spec.H + rho * E.T @ E
    K[: spec.nz, spec.nz :] = spec.A.T
    K[spec.nz :, : spec.nz] = spec.A
    b = spec.b_const + spec.S @ theta
    z = np.linalg.solve(K + 1e-12 * np.eye(K.shape[0]),
                        np.concatenate([-spec.g + rho * E.T @ t, b]))[
        : spec.nz]
    v = E @ z
    assert np.abs(spec.A @ z - b).max() < 1e-7
    assert v.max() <= hi + 1e-7 and v.min() >= lo - 1e-7
    mu = rho * st.w[0].numpy()
    grad = spec.H @ z + spec.g + E.T @ mu
    nu = np.linalg.lstsq(spec.A.T, -grad, rcond=None)[0]
    assert np.abs(grad + spec.A.T @ nu).max() < 1e-6
    at_hi, at_lo = v > hi - 1e-8, v < lo + 1e-8
    assert np.abs(mu[~(at_hi | at_lo)]).max(initial=0.0) < 1e-6
    assert np.all(mu[at_hi] >= -1e-8) and np.all(mu[at_lo] <= 1e-8)


def test_box_loose_bounds_match_exact_map(setup):
    """Bounds far outside the optimum: the ladder reproduces the exact
    map and settles below the middle rung (the inactive box's)."""
    _, ctrl = setup["none"]
    solver = ctrl.box_admm_solver(u_bounds=(-100.0, 100.0), device="cpu",
                                  dtype=torch.float64)
    th = torch.as_tensor(setup["thetas"][:2])
    u, _, state, stats = box.box_admm_solve(solver, th, num_iters=500)
    assert bool(stats.converged.all())
    smap = ctrl.solution_map(device="cpu", dtype=torch.float64)
    torch.testing.assert_close(u, sm.solve_u(smap, th), rtol=0, atol=1e-8)
    assert bool((state.rho_idx < solver.rhos.shape[0] // 2).all())


def _chunks(solver, theta, cap):
    """Chunks a one-scenario solve runs before it exits: the least cap
    of whole chunks at which it returns what it returns uncapped."""
    _, _, full, _ = box.box_admm_solve(solver, theta, num_iters=cap,
                                       tol=1e-6)
    for k in range(1, cap // 10 + 1):
        _, _, st, _ = box.box_admm_solve(solver, theta, num_iters=10 * k,
                                         tol=1e-6)
        if torch.equal(st.s, full.s) and torch.equal(st.w, full.w):
            return k, full
    raise AssertionError("no exit within the cap")


@pytest.mark.parametrize("rho,cap", [(None, 200), (0.01, 400)],
                         ids=["ladder", "fixed"])
def test_box_exits_early_per_scenario(setup, rho, cap):
    """A batch mixing a loose window (the steady state, whose optimum
    lies inside |u| <= 1.2) and saturated ones: each scenario runs its
    own number of chunks and ends on its own rung, those of its
    one-scenario run, and holds them while the others go on."""
    _, ctrl = setup["none"]
    solver = ctrl.box_admm_solver(u_bounds=(-1.2, 1.2), rho=rho,
                                  device="cpu", dtype=torch.float64)
    steady = np.concatenate([np.tile([1.0, 1.0], 4),
                             np.tile([0.65, 0.77], 4)])
    th = torch.as_tensor(np.stack([steady, setup["thetas"][0], steady,
                                   setup["thetas"][1]]))
    _, _, st, stats = box.box_admm_solve(solver, th, num_iters=cap,
                                         tol=1e-6)
    # At the fixed penalty a saturated window may run to the cap.
    assert bool(stats.converged[::2].all())
    assert bool(stats.converged.all()) or rho is not None
    counts = []
    for b in range(th.shape[0]):
        k, one = _chunks(solver, th[b : b + 1], cap)
        counts.append(k)
        assert int(st.rho_idx[b]) == int(one.rho_idx[0])
        torch.testing.assert_close(st.s[b], one.s[0], rtol=0, atol=EXACT)
        torch.testing.assert_close(st.w[b], one.w[0], rtol=0, atol=EXACT)
    assert counts[0] == counts[2] and counts[1] != counts[0], counts
    if rho is None:
        assert int(st.rho_idx[0]) != int(st.rho_idx[1])


@pytest.mark.parametrize("entry", [
    "compute_admm_solver", "compute_box_admm_solver", "admm_solver",
    "box_admm_solver",
])
def test_iterative_entry_points_run_on_the_card_by_default(monkeypatch,
                                                           setup, entry):
    _, ctrl = setup["none"]
    _, cvx = setup["convex"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "compute_admm_solver": lambda: admm.compute_admm_solver(cvx.spec),
        "compute_box_admm_solver": lambda: box.compute_box_admm_solver(
            ctrl.spec, u_bounds=(-1, 1)),
        "admm_solver": cvx.admm_solver,
        "box_admm_solver": lambda: ctrl.box_admm_solver(u_bounds=(-1, 1)),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def _guarded_calls(setup):
    """One call of each guarded path, on small inputs (built once per
    module)."""
    if "guarded" not in setup:
        setup["guarded"] = _build_guarded_calls(setup)
    return setup["guarded"]


def _build_guarded_calls(setup):
    jctrl, ctrl = setup["none"]
    _, cvx = setup["convex"]
    plant = setup["plant"].as_params()
    ins = [torch.as_tensor(a, dtype=torch.float32) for a in setup["ins"]]
    th = torch.as_tensor(setup["thetas"], dtype=torch.float32)
    smap = ctrl.solution_map(device="cpu")
    tmap = ctrl.tracking_map(device="cpu")
    r = torch.tensor([1.0, 1.0, 0.65, 0.77])
    bm = le.build_linear_engine(ctrl, plant, solves_per_block=2,
                                device="cpu")
    op = admm.compute_admm_operator_np(cvx.spec)
    pl32 = LTIParams(*(np.asarray(a) for a in plant)).to("cpu")
    return {
        "solve_u": lambda: sm.solve_u(smap, th),
        "solve_full": lambda: sm.solve_full(smap, th),
        "optimal_cost": lambda: sm.optimal_cost(smap, th),
        "solve_u_tracking": lambda: sm.solve_u_tracking(tmap, th, r),
        "tracking_cost": lambda: sm.tracking_cost(tmap, th, r),
        "closed_loop_rollout": lambda: loop.closed_loop_rollout(
            plant, smap, *ins, n_steps=4),
        "admm_solve": lambda: admm.admm_solve(
            _solvers(setup, "admm", torch.float32, jnp.float32)[1], th,
            num_iters=2),
        "box_admm_solve": lambda: box.box_admm_solve(
            _solvers(setup, "ladder", torch.float32, jnp.float32)[1], th,
            num_iters=2),
        "classic engine": lambda: le.make_linear_batched_rollout(bm, 4)(
            *ins[:3], ins[3][:, :4]),
        "fused_rollout_reference": lambda: fr.make_fused_batched_rollout(
            bm, 4, rollout=fr.fused_rollout_reference)(*ins[:3],
                                                       ins[3][:, :4]),
        "post-pass": lambda: fr.make_fused_batched_rollout(
            bm, 4, cost_mode="post", rollout=fr.fused_rollout_reference)(
                *ins[:3], ins[3][:, :4]),
        "fused_admm_reference": lambda: fa.make_fused_admm_rollout(
            plant, op, 4, 2, 2, 4, device="cpu", iters=(2,), cold_iters=2,
            rollout=fa.fused_admm_reference)(*ins[:3], ins[3][:, :4]),
        "time_parallel_rollout": lambda: le.time_parallel_rollout(
            bm, ins[0][0], ins[1][0], ins[2][0], ins[3][0, :7], 7),
        "lti_rollout": lambda: lti_rollout(
            pl32, ins[0][0], ins[1][0], ins[2][0]),
        "estimate_initial_state": lambda: estimate_initial_state(
            observability_matrix(pl32.A, pl32.C),
            toeplitz_input_output_matrix(*pl32, 4), ins[1][0].reshape(-1),
            ins[2][0].reshape(-1)),
    }


@pytest.mark.parametrize("path", [
    "solve_u", "solve_full", "optimal_cost", "solve_u_tracking",
    "tracking_cost", "closed_loop_rollout", "admm_solve", "box_admm_solve",
    "classic engine", "fused_rollout_reference", "post-pass",
    "fused_admm_reference", "time_parallel_rollout", "lti_rollout",
    "estimate_initial_state",
])
def test_precision_is_scoped_to_the_guarded_paths(monkeypatch, setup, path):
    """With the caller's ``torch.set_float32_matmul_precision("high")``
    (TF32 allowed), every product and convolution of a parity-bound path
    runs under IEEE float32, and the caller's setting reads back intact
    (through ``torch.get_float32_matmul_precision()``, which raises once
    the legacy flags were written) after the call."""
    seen = []

    def spy(fn):
        def wrapped(*args, **kwargs):
            seen.append((torch.backends.cuda.matmul.fp32_precision,
                         torch.backends.cudnn.conv.fp32_precision))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(torch.Tensor, "__matmul__",
                        spy(torch.Tensor.__matmul__))
    monkeypatch.setattr(torch, "matmul", spy(torch.matmul))
    monkeypatch.setattr(fr.F, "conv1d", spy(fr.F.conv1d))
    call = _guarded_calls(setup)[path]
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        call()
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.fp32_precision == "tf32"
    finally:
        torch.set_float32_matmul_precision(saved)
    assert seen and set(seen) == {("ieee", "ieee")}, set(seen)


def test_precision_guard_restores_on_error():
    saved = (torch.backends.cuda.matmul.fp32_precision,
             torch.backends.cudnn.conv.fp32_precision)
    with pytest.raises(ZeroDivisionError):
        with ieee_float32():
            assert torch.backends.cuda.matmul.fp32_precision == "ieee"
            1 / 0
    assert (torch.backends.cuda.matmul.fp32_precision,
            torch.backends.cudnn.conv.fp32_precision) == saved
