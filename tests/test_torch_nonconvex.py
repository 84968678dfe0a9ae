"""PyTorch port, the NON_CONVEX slack variant (the paper's Eq. 6d,
``qp.nonconvex``): the host operator and its float64 solve, the device
solve on a batch of windows with one bound per scenario, its branch of
the generic loop and the controller's opt-in, each held against the JAX
package on the four-tank Robust setup at c = 0.05 (where the bound
binds), the same numpy data and windows handed to both (the JAX side in
float32 or float64 explicitly, since tests/conftest.py turns on x64)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from direct_data_driven_mpc_tpu.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController as JaxController,
)
from direct_data_driven_mpc_tpu.control.loop import (  # noqa: E402
    closed_loop_rollout as jax_closed_loop_rollout,
)
from direct_data_driven_mpc_tpu.qp import nonconvex as jnc  # noqa: E402
from direct_data_driven_mpc_tpu.qp.spec import (  # noqa: E402
    DataDrivenMPCType as JaxType,
    SlackVarConstraintTypes as JaxSlack,
)
from direct_data_driven_mpc_tpu_torch.control import loop  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_tpu_torch.qp import admm  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp import nonconvex as nc  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp.spec import (  # noqa: E402
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

from tests.test_torch_host import controller_kwargs, port_setup  # noqa: E402
from tests.test_torch_generic_loop import host_loop  # noqa: E402
from tests.test_torch_iterative import one_blas_thread  # noqa: E402,F401

EXACT = 1e-9  # float64: u, s, w and the bound
ATOL = 2e-5  # float32: u, y, s, w
COST_RTOL, COST_ATOL = 1e-3, 1e-5
B, T = 6, 24
DTYPES = {"f64": (torch.float64, jnp.float64, EXACT),
          "f32": (torch.float32, jnp.float32, ATOL)}


@pytest.fixture(scope="module")
def setup():
    """The JAX and port NON_CONVEX controllers (opted in, c = 0.05) on
    the same data, the port's CONVEX one, a batch of windows around the
    initial one and the closed-loop inputs (seeded numpy)."""
    jplant, jctrl0, _, rng = port_setup()
    kw = dict(controller_kwargs(jctrl0.u_d, jctrl0.y_d), c=0.05)
    jctrl = JaxController(**kw, slack_var_constraint_type=JaxSlack.NON_CONVEX,
                          controller_type=JaxType.ROBUST,
                          allow_nonconvex_slack=True)
    ctrl = DirectDataDrivenMPCController(
        **kw, slack_var_constraint_type=SlackVarConstraintTypes.NON_CONVEX,
        controller_type=DataDrivenMPCType.ROBUST, allow_nonconvex_slack=True,
    )
    cvx = DirectDataDrivenMPCController(
        **kw, slack_var_constraint_type=SlackVarConstraintTypes.CONVEX,
        controller_type=DataDrivenMPCType.ROBUST,
    )
    theta0 = np.concatenate([ctrl.u_past.reshape(-1),
                             ctrl.y_past.reshape(-1)])
    thetas = theta0[None] + 0.05 * rng.standard_normal((B, theta0.size))
    ins = [np.tile(jplant.get_state()[None], (B, 1)),
           np.tile(ctrl.u_past.reshape(1, 4, 2), (B, 1, 1)),
           np.tile(ctrl.y_past.reshape(1, 4, 2), (B, 1, 1)),
           0.002 * rng.uniform(-1, 1, (B, T, 2))]
    return dict(plant=jplant, jctrl=jctrl, ctrl=ctrl, cvx=cvx,
                thetas=thetas, ins=ins)


def _close(got, want, atol, name):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol, err_msg=name)


def test_operator_matches_jax(setup):
    """The host operator, the alpha maps of ``compute_admm_operator_np(
    return_alpha_maps=True)`` and ``c_eps`` included, equals the JAX
    package's in float64."""
    op = nc.compute_nonconvex_operator_np(setup["ctrl"].spec)
    jop = jnc.compute_nonconvex_operator_np(setup["jctrl"].spec)
    assert set(op) == set(jop)
    for k in ("a_c", "A_theta", "A_s", "V_s", "U_theta", "cost_P"):
        np.testing.assert_allclose(op[k], jop[k], rtol=0, atol=1e-10,
                                   err_msg=k)
    assert float(op["c_eps"]) == float(jop["c_eps"]) == 0.05 * 0.002
    with pytest.raises(ValueError, match="NON_CONVEX"):
        nc.compute_nonconvex_operator_np(setup["cvx"].spec)


@pytest.mark.parametrize("dname", ["f64", "f32"])
def test_device_solve_matches_jax(setup, dname):
    """Cold, then warm from the first result: u, s, w, each scenario's
    bound, the costs and the converged lanes against the JAX solve under
    ``vmap`` (4 outer x 16 inner, as the loop runs it)."""
    dt, jdt, tol = DTYPES[dname]
    js = setup["jctrl"].nonconvex_admm_solver(dtype=jdt)
    ps = setup["ctrl"].nonconvex_admm_solver(device="cpu", dtype=dt)
    th = setup["thetas"]
    jsolve_b = jax.jit(jax.vmap(lambda t, s: jnc.nonconvex_admm_solve(
        js, t, outer_iters=4, inner_iters=16, state=s, tol=1e-6)))
    jst = jax.tree.map(lambda x: jnp.broadcast_to(x, (B, *x.shape)),
                       jnc.nonconvex_initial_state(js))
    pst = None
    for _ in range(2):
        ju, jc, jst, jstats = jsolve_b(jnp.asarray(th, jdt), jst)
        pu, pc, pst, pstats = nc.nonconvex_admm_solve(
            ps, torch.as_tensor(th, dtype=dt), outer_iters=4,
            inner_iters=16, state=pst, tol=1e-6,
        )
        for name, a, b in (("u", pu, ju), ("s", pst.s, jst.s),
                           ("w", pst.w, jst.w),
                           ("bound", pst.bound, jst.bound)):
            _close(a, b, tol, name)
        np.testing.assert_allclose(pc.double().numpy(),
                                   np.asarray(jc, np.float64),
                                   rtol=COST_RTOL, atol=COST_ATOL)
        np.testing.assert_array_equal(pstats.converged.numpy(),
                                      np.asarray(jstats.converged))
        _close(pstats.constraint_violation, jstats.constraint_violation,
               tol, "violation")
    # The bound is material: above the CONVEX box, per scenario.
    assert bool((pst.bound > ps.c_eps * 1.01).all())


def test_host_solve_matches_jax_and_device(setup):
    """``nonconvex_admm_solve_np`` equals the JAX host twin, and the
    float64 device solve run long agrees with it."""
    op = nc.compute_nonconvex_operator_np(setup["ctrl"].spec)
    jop = jnc.compute_nonconvex_operator_np(setup["jctrl"].spec)
    theta = setup["thetas"][0]
    u, cost, (s, w, bound), stats = nc.nonconvex_admm_solve_np(op, theta)
    ju, jcost, (js_, jw, jbound), jstats = jnc.nonconvex_admm_solve_np(
        jop, theta)
    assert stats[-1] and jstats[-1]
    np.testing.assert_allclose(u, ju, rtol=0, atol=EXACT)
    assert abs(bound - jbound) < EXACT and abs(cost - jcost) < 1e-7
    solver = setup["ctrl"].nonconvex_admm_solver(device="cpu",
                                                 dtype=torch.float64)
    u_dev, cost_dev, _, dstats = nc.nonconvex_admm_solve(
        solver, torch.as_tensor(theta[None]), outer_iters=20,
        inner_iters=400, tol=1e-10,
    )
    assert bool(dstats.converged[0])
    np.testing.assert_allclose(u_dev[0].numpy(), u, rtol=0, atol=1e-8)
    assert abs(float(dstats.bound[0]) - bound) <= 1e-8 * bound


def test_warm_start_converges_in_one_outer_iteration(setup):
    """From a converged state one bound update is already at the fixed
    point (the loop's small outer trip count rests on it); the cost
    never exceeds the CONVEX variant's."""
    solver = setup["ctrl"].nonconvex_admm_solver(device="cpu",
                                                 dtype=torch.float64)
    th = torch.as_tensor(setup["thetas"][:2])
    u_ref, cost, state, _ = nc.nonconvex_admm_solve(
        solver, th, outer_iters=20, inner_iters=400, tol=1e-10)
    u1, _, _, stats1 = nc.nonconvex_admm_solve(
        solver, th, outer_iters=1, inner_iters=100, state=state, tol=1e-10)
    assert bool(stats1.converged.all())
    torch.testing.assert_close(u1, u_ref, rtol=0, atol=1e-8)
    _, cost_cvx, _, cstats = admm.admm_solve(
        setup["cvx"].admm_solver(device="cpu", dtype=torch.float64), th,
        num_iters=800, tol=1e-10)
    assert bool(cstats.converged.all())
    assert bool((cost <= cost_cvx + 1e-9 * (1 + cost_cvx.abs())).all())


@pytest.mark.parametrize("dname", ["f64", "f32"])
def test_generic_loop_matches_jax(setup, dname):
    """The generic loop with the NON_CONVEX solver (4 outer x 16 inner
    per solve, ``bench.py``'s ``four_tank_nonconvex``) against the JAX
    loop under ``vmap``; a segmented run through ``solver_state0`` is
    the uninterrupted one bit for bit."""
    dt, jdt, tol = DTYPES[dname]
    js = setup["jctrl"].nonconvex_admm_solver(dtype=jdt)
    ps = setup["ctrl"].nonconvex_admm_solver(device="cpu", dtype=dt)
    plant = setup["plant"].as_params()
    jplant = setup["plant"].as_params(
        dtype=np.float64 if dname == "f64" else np.float32)
    ins = setup["ins"]
    ref = jax.vmap(lambda x0, up, yp, w: jax_closed_loop_rollout(
        jplant, js, x0, up, yp, w, n_steps=T, admm_iters=16,
    ))(*(jnp.asarray(a, jdt) for a in ins))
    x0, up, yp, W = (torch.as_tensor(a, dtype=dt) for a in ins)
    res = loop.closed_loop_rollout(plant, ps, x0, up, yp, W, n_steps=T,
                                   admm_iters=16)
    _close(res.u_sys, ref.u_sys, tol, "u")
    _close(res.y_sys, ref.y_sys, tol, "y")
    np.testing.assert_allclose(res.costs.double().numpy(),
                               np.asarray(ref.costs, np.float64),
                               rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(ref.converged))
    for name, a, b in zip(("s", "w", "bound"), res.solver_state,
                          ref.solver_state):
        _close(a, b, tol, name)
    h = T // 2
    first = loop.closed_loop_rollout(plant, ps, x0, up, yp, W[:, :h],
                                     n_steps=h, admm_iters=16)
    second = loop.closed_loop_rollout(
        plant, ps, first.x_final, first.u_past, first.y_past, W[:, h:],
        n_steps=T - h, admm_iters=16, solver_state0=first.solver_state,
    )
    assert torch.equal(torch.cat([first.u_sys, second.u_sys], 1), res.u_sys)
    assert torch.equal(second.solver_state.bound, res.solver_state.bound)


def test_generic_loop_matches_host_controller_loop(setup):
    """The generic loop's NON_CONVEX solve (float64, 4 bound updates x
    the controller's 200 iterations, tolerance 1e-6) against the
    controller's own host loop (``nonconvex_admm_solve_np``, early exit
    at 1e-10) on the same noise: both warm-started, they agree to the
    fixed point's accuracy."""
    jctrl = setup["jctrl"]
    kw = dict(controller_kwargs(jctrl.u_d, jctrl.y_d), c=0.05)
    ctrl = DirectDataDrivenMPCController(
        **kw, slack_var_constraint_type=SlackVarConstraintTypes.NON_CONVEX,
        controller_type=DataDrivenMPCType.ROBUST, allow_nonconvex_slack=True,
    )
    plant = setup["plant"]
    x0, up, yp = (torch.as_tensor(a[:1]) for a in setup["ins"][:3])
    W = setup["ins"][3][0, :20]
    res = loop.closed_loop_rollout(
        plant.as_params(),
        ctrl.nonconvex_admm_solver(device="cpu", dtype=torch.float64),
        x0, up, yp, torch.as_tensor(W[None]), n_steps=20,
        admm_iters=ctrl.admm_iters,
    )
    u_host, y_host = host_loop(plant, ctrl, W)
    np.testing.assert_allclose(res.u_sys[0].numpy(), u_host, atol=1e-6)
    np.testing.assert_allclose(res.y_sys[0].numpy(), y_host, atol=1e-6)
    assert ctrl.get_problem_solve_status() == "optimal"


def test_controller_parity_raise_and_opt_in(setup, monkeypatch):
    """Without ``allow_nonconvex_slack`` NON_CONVEX raises the
    reference's ``NotImplementedError``; opted in, the per-step host
    solve matches the JAX controller's, the affine and CONVEX entry
    points refuse it, and its device operator runs on the card by
    default."""
    jctrl, ctrl = setup["jctrl"], setup["ctrl"]
    kw = dict(controller_kwargs(jctrl.u_d, jctrl.y_d), c=0.05)
    with pytest.raises(NotImplementedError, match="Non-Convex"):
        DirectDataDrivenMPCController(
            **kw, slack_var_constraint_type=SlackVarConstraintTypes.NON_CONVEX,
            controller_type=DataDrivenMPCType.ROBUST,
        )
    assert ctrl.get_problem_solve_status() == "optimal"
    np.testing.assert_allclose(ctrl.optimal_u, jctrl.optimal_u, rtol=0,
                               atol=EXACT)
    for method in (ctrl.solution_map, ctrl.admm_solver,
                   ctrl.tracking_operator, ctrl.box_admm_solver):
        with pytest.raises(ValueError, match="NON_CONVEX"):
            method()
    with pytest.raises(ValueError, match="NON_CONVEX"):
        setup["cvx"].nonconvex_admm_solver(device="cpu")
    _, st0 = loop.make_solve_fn(
        ctrl.nonconvex_admm_solver(device="cpu"), 2)
    assert st0.bound.shape == (1,) and st0.s.shape == (1, 60)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (ctrl.nonconvex_admm_solver,
                 lambda: nc.compute_nonconvex_admm_solver(ctrl.spec)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
