"""PyTorch port, the generic loop with the iterative solvers
(``control.loop``) and the batch layer (``parallel.batch``): the loop
with the device ADMM, the box ADMM (fixed rho and the ladder) held
against the JAX loop under ``vmap``, against the framework-free float64
goldens of tests/test_golden_box_parity.py and against the
controller's own host loop; segmented runs; the batch layer, plants and
operators per scenario included; and ``chip_smoke.py``'s phases 27-29
at a tiny size. The solvers alone are in tests/test_torch_iterative.py,
the NON_CONVEX loop in tests/test_torch_nonconvex.py. The same numpy
inputs go to both packages (the JAX side in float32 or float64
explicitly, since tests/conftest.py turns on x64)."""

import os

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
from direct_data_driven_mpc_tpu.qp.spec import (  # noqa: E402
    DataDrivenMPCType as JaxType,
    SlackVarConstraintTypes as JaxSlack,
)
from direct_data_driven_mpc_tpu_torch.control import loop  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams  # noqa: E402
from direct_data_driven_mpc_tpu_torch.parallel import batch  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp import admm  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp.spec import (  # noqa: E402
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

from tests.test_closed_loop import FOUR_TANK  # noqa: E402
from tests.test_torch_host import controller_kwargs  # noqa: E402
from tests.test_torch_iterative import (  # noqa: E402,F401
    B,
    DTYPES,
    EXACT,
    T,
    _close,
    _costs_close,
    _solvers,
    one_blas_thread,
    setup,
)

GOLDEN = os.path.join(
    os.path.dirname(__file__), "golden", "four_tank_box_golden.npz"
)
F32_BUDGET = 1e-4  # tests/test_golden_box_parity.py's budgets
F64_BUDGET = 3e-6


def host_loop(plant, ctrl, W):
    """The port controller's own closed loop (its per-step host solve),
    one scenario, as the JAX package's
    ``control.operation.simulate_data_driven_mpc_control_loop``
    (Algorithm 1): solve, apply the first input, step the plant, store
    the measurement. Returns ``(u, y)``, each ``(T, 2)``."""
    from direct_data_driven_mpc_tpu_torch.models.lti_model import LTIModel

    model = LTIModel(**FOUR_TANK)
    model.set_state(plant.get_state().copy())
    u_sys, y_sys = [], []
    for w in W:
        ctrl.update_and_solve_data_driven_mpc()
        u = ctrl.get_optimal_control_input_at_step(0)
        y = model.simulate_step(u=u, w=w)
        ctrl.store_input_output_measurement(u.reshape(-1, 1),
                                            y.reshape(-1, 1))
        u_sys.append(u)
        y_sys.append(y)
    return np.array(u_sys), np.array(y_sys)


def test_generic_loop_matches_host_controller_loop(setup):
    """The generic loop with the device ADMM (float64, the controller's
    200 iterations, tolerance 1e-6) against the controller's own host
    loop on the same noise (``admm_solve_np`` to 1e-8, early exit), as
    tests/test_closed_loop.py holds the JAX engines: both run
    warm-started ADMM to a tight tolerance, so they agree to the fixed
    point's accuracy."""
    jctrl, _ = setup["none"]
    kw = dict(controller_kwargs(jctrl.u_d, jctrl.y_d), c=0.05)
    ctrl = DirectDataDrivenMPCController(
        **kw, slack_var_constraint_type=SlackVarConstraintTypes.CONVEX,
        controller_type=DataDrivenMPCType.ROBUST,
    )
    plant = setup["plant"]
    x0, up, yp = (torch.as_tensor(a[:1]) for a in setup["ins"][:3])
    W = setup["ins"][3][0, :25]
    res = loop.closed_loop_rollout(
        plant.as_params(), ctrl.admm_solver(device="cpu",
                                            dtype=torch.float64),
        x0, up, yp, torch.as_tensor(W[None]), n_steps=25,
        admm_iters=ctrl.admm_iters,
    )
    u_host, y_host = host_loop(plant, ctrl, W)
    np.testing.assert_allclose(res.u_sys[0].numpy(), u_host, atol=1e-6)
    np.testing.assert_allclose(res.y_sys[0].numpy(), y_host, atol=1e-6)
    assert bool(res.converged.all())



def _golden_controller(golden, scheme, cls):
    slack = (SlackVarConstraintTypes if cls is DirectDataDrivenMPCController
             else JaxSlack)
    kind = (DataDrivenMPCType if cls is DirectDataDrivenMPCController
            else JaxType)
    kw = dict(controller_kwargs(golden["u_d"], golden["y_d"]),
              controller_type=kind.ROBUST)
    if scheme == "CONVEX":
        kw.update(c=float(golden["convex_c"]),
                  slack_var_constraint_type=slack.CONVEX)
    else:
        kw.update(slack_var_constraint_type=slack.NONE)
    return cls(**kw)


@pytest.mark.parametrize(
    "scheme,rho,dname,budget,iters",
    [("CONVEX", None, "f64", F64_BUDGET, 200),
     ("CONVEX", None, "f32", F32_BUDGET, 60),
     ("BOX", 1.0, "f64", F64_BUDGET, 300),
     ("BOX", 1.0, "f32", F32_BUDGET, 80),
     ("BOX", None, "f32", F32_BUDGET, 120)],
    ids=["convex-f64", "convex-f32", "box-f64", "box-f32", "ladder-f32"],
)
def test_generic_loop_matches_golden(scheme, rho, dname, budget, iters):
    """The generic loop with the device ADMM (CONVEX slack box at c =
    0.05) and the box ADMM (|u| <= 0.85, rho = 1 and the ladder) against
    the independent active-set golden, at the budgets of
    tests/test_golden_box_parity.py."""
    golden = np.load(GOLDEN)
    dt = DTYPES[dname][0]
    ctrl = _golden_controller(golden, scheme, DirectDataDrivenMPCController)
    u_box = float(golden["u_box"])
    solver = (ctrl.admm_solver(device="cpu", dtype=dt) if scheme == "CONVEX"
              else ctrl.box_admm_solver(u_bounds=(-u_box, u_box), rho=rho,
                                        device="cpu", dtype=dt))
    n_steps = golden[f"{scheme}_u"].shape[0]
    res = loop.closed_loop_rollout(
        LTIParams(FOUR_TANK["A"], FOUR_TANK["B"], FOUR_TANK["C"],
                  FOUR_TANK["D"]),
        solver,
        *(torch.as_tensor(golden[k][None], dtype=dt)
          for k in ("x0", f"{scheme}_u_past0", f"{scheme}_y_past0")),
        torch.as_tensor(golden["w_sys"][None, :n_steps], dtype=dt),
        n_steps=n_steps, admm_iters=iters,
    )
    du = np.abs(res.u_sys[0].double().numpy() - golden[f"{scheme}_u"]).max()
    dy = np.abs(res.y_sys[0].double().numpy() - golden[f"{scheme}_y"]).max()
    assert du < budget and dy < 10 * budget, (du, dy)
    assert bool(res.converged.all())
    np.testing.assert_allclose(res.costs[0].double().numpy(),
                               golden[f"{scheme}_costs"], rtol=5e-3,
                               atol=10 * budget)
    if scheme == "BOX":
        assert float(res.u_sys.abs().max()) <= u_box + 1e-6


@pytest.mark.parametrize("kind", ["admm", "box", "ladder"])
@pytest.mark.parametrize("dname", ["f64", "f32"])
def test_generic_loop_matches_jax(setup, kind, dname):
    """The generic loop on a batch against the JAX loop under ``vmap``
    (``make_solve_fn``'s tolerance 1e-6 on both sides): u, y, costs,
    converged lanes, the final solver state and, on the ladder, the
    rung lanes."""
    dt, jdt, tol = DTYPES[dname]
    js, ps, iters = _solvers(setup, kind, dt, jdt)
    plant = setup["plant"].as_params()
    jplant = setup["plant"].as_params(
        dtype=np.float64 if dname == "f64" else np.float32
    )
    ins = setup["ins"]
    ref = jax.vmap(lambda x0, up, yp, w: jax_closed_loop_rollout(
        jplant, js, x0, up, yp, w, n_steps=T, admm_iters=iters,
    ))(*(jnp.asarray(a, jdt) for a in ins))
    res = loop.closed_loop_rollout(
        plant, ps, *(torch.as_tensor(a, dtype=dt) for a in ins), n_steps=T,
        admm_iters=iters,
    )
    _close(res.u_sys, ref.u_sys, tol, "u")
    _close(res.y_sys, ref.y_sys, tol, "y")
    _costs_close(res.costs, ref.costs)
    np.testing.assert_array_equal(res.converged.numpy(),
                                  np.asarray(ref.converged))
    for name, a, b in zip(("s", "w"), res.solver_state, ref.solver_state):
        _close(a, b, tol, name)
    if kind != "admm":
        np.testing.assert_array_equal(res.solver_state.rho_idx.numpy(),
                                      np.asarray(ref.solver_state.rho_idx))


@pytest.mark.parametrize("kind", ["admm", "ladder"])
def test_segmented_run_is_bit_equal(setup, kind):
    """Two halves through ``solver_state0`` give the uninterrupted run
    bit for bit on the CPU, the rung carried with the state."""
    _, ps, iters = _solvers(setup, kind, torch.float32, jnp.float32)
    plant = setup["plant"].as_params()
    x0, up, yp, W = (torch.as_tensor(a, dtype=torch.float32)
                     for a in setup["ins"])
    full = loop.closed_loop_rollout(plant, ps, x0, up, yp, W, n_steps=T,
                                    admm_iters=iters)
    h = T // 2
    first = loop.closed_loop_rollout(plant, ps, x0, up, yp, W[:, :h],
                                     n_steps=h, admm_iters=iters)
    second = loop.closed_loop_rollout(
        plant, ps, first.x_final, first.u_past, first.y_past, W[:, h:],
        n_steps=T - h, admm_iters=iters, solver_state0=first.solver_state,
    )
    for name in ("u_sys", "y_sys", "costs", "converged"):
        assert torch.equal(
            torch.cat([getattr(first, name), getattr(second, name)], 1),
            getattr(full, name),
        ), name
    for a, b in zip(second.solver_state, full.solver_state):
        assert torch.equal(a, b)


def test_make_solve_fn_states_and_escape_hatch(setup):
    """Each iterative solver's cold state has one row (the loop
    broadcasts it), NON_CONVEX included in tests/test_torch_nonconvex.py;
    a ``(solve_fn, state0)`` pair passes through; a host operator dict
    is not a solver."""
    _, ps, _ = _solvers(setup, "ladder", torch.float64, jnp.float64)
    _, st0 = loop.make_solve_fn(ps, 2)
    assert st0.s.shape == (1, ps.v_c.shape[1])
    assert st0.rho_idx.tolist() == [ps.rhos.shape[0] // 2]
    _, ps, _ = _solvers(setup, "admm", torch.float64, jnp.float64)
    _, st0 = loop.make_solve_fn(ps, 2)
    assert isinstance(st0, admm.ADMMState) and st0.w.shape == (1, 60)
    pair = (lambda theta, state: None, "state")
    assert loop.make_solve_fn(pair, 2) is pair
    with pytest.raises(TypeError, match="solver type"):
        loop.make_solve_fn(
            admm.compute_admm_operator_np(setup["convex"][1].spec), 2
        )


def test_batched_rollout_matches_single_scenarios(setup):
    """``make_batched_rollout`` (the batch layer of ``bench.py``'s
    generic configurations) gives each scenario its one-scenario run."""
    _, ps, iters = _solvers(setup, "admm", torch.float64, jnp.float64)
    plant = setup["plant"].as_params()
    ins = [torch.as_tensor(a) for a in setup["ins"]]
    res = batch.make_batched_rollout(plant, ps, T, admm_iters=iters)(*ins)
    for b in (0, B - 1):
        one = batch.batched_closed_loop(
            plant, ps, *(a[b : b + 1] for a in ins), n_steps=T,
            admm_iters=iters,
        )
        torch.testing.assert_close(res.u_sys[b : b + 1], one.u_sys,
                                   rtol=0, atol=1e-12)


def _realisation(b):
    """One scenario of tests/test_parallel.py's heterogeneous batch: its
    own plant, data and so operator, for both packages."""
    from direct_data_driven_mpc_tpu.models.random_lti import (
        random_stable_lti,
    )

    n, m, p, L, c = 2, 1, 1, 6, (1.0 if b % 2 else 0.05)
    N = m * (L + 2 * n) + L + 2 * n + 5
    rng = np.random.default_rng(100 + b)
    plant = random_stable_lti(seed=200 + b, ns=n, m=m, p=p,
                              spectral_radius=0.8)
    u_d = rng.uniform(-1, 1, (N, m))
    y_d = plant.simulate(u_d, 0.002 * rng.uniform(-1, 1, (N, p)), N)
    u_s = 0.3 * np.ones((m, 1))
    kw = dict(
        n=n, m=m, p=p, u_d=u_d, y_d=y_d, L=L, Q=3.0 * np.eye(p * L),
        R=1e-4 * np.eye(m * L), u_s=u_s,
        y_s=plant.get_equilibrium_output_from_input(
            u_s.ravel()).reshape(-1, 1),
        eps_max=0.002, lamb_alpha=50.0, lamb_sigma=1000.0, c=c,
    )
    jctrl = JaxController(**kw, slack_var_constraint_type=JaxSlack.CONVEX,
                          controller_type=JaxType.ROBUST)
    ctrl = DirectDataDrivenMPCController(
        **kw, slack_var_constraint_type=SlackVarConstraintTypes.CONVEX,
        controller_type=DataDrivenMPCType.ROBUST,
    )
    ins = (plant.get_state().copy(), ctrl.u_past.reshape(n, m),
           ctrl.y_past.reshape(n, p), 0.002 * rng.uniform(-1, 1, (12, p)))
    return plant.as_params(), jctrl, ctrl, ins


def test_heterogeneous_scenarios_all_axes_vary():
    """Noise, data realisation (so the operator) and plant all differ
    per scenario: stacked ``SolutionMap``s of the slack-NONE loop and
    stacked ``ADMMSolver``s (c differs too) each give every scenario its
    one-scenario run, and the ADMM batch matches the JAX package's."""
    from direct_data_driven_mpc_tpu.parallel.batch import (
        heterogeneous_closed_loop as jax_heterogeneous,
        stack_plants as jax_stack_plants,
        stack_solution_maps as jax_stack_maps,
    )

    reals = [_realisation(b) for b in range(3)]
    plants = batch.stack_plants([r[0] for r in reals])
    ins = [torch.as_tensor(np.stack([r[3][i] for r in reals]))
           for i in range(4)]
    admm_solvers = [r[2].admm_solver(device="cpu", dtype=torch.float64)
                    for r in reals]
    res = batch.heterogeneous_closed_loop(
        plants, batch.stack_solution_maps(admm_solvers), *ins, n_steps=12,
        admm_iters=60,
    )
    for b, r in enumerate(reals):
        one = loop.closed_loop_rollout(
            r[0], admm_solvers[b], *(a[b : b + 1] for a in ins), n_steps=12,
            admm_iters=60,
        )
        torch.testing.assert_close(res.u_sys[b], one.u_sys[0], rtol=0,
                                   atol=1e-12)
    ref = jax_heterogeneous(
        jax_stack_plants([r[0] for r in reals]),
        jax_stack_maps([r[1].admm_solver(dtype=jnp.float64)
                        for r in reals]),
        *(jnp.asarray(a.numpy()) for a in ins), n_steps=12, admm_iters=60,
    )
    _close(res.u_sys, ref.u_sys, EXACT, "u")
    assert not torch.allclose(res.y_sys[0], res.y_sys[1])
    with pytest.raises(TypeError, match="one type"):
        batch.stack_solution_maps([admm_solvers[0], tuple(admm_solvers[1])])


def test_heterogeneous_solution_maps():
    """Stacked affine maps of the slack-NONE loop, as in
    tests/test_parallel.py: each scenario equals its own run."""
    reals = [_realisation(b) for b in range(2)]
    maps, plants = [], []
    for plant, _, ctrl, _ in reals:
        kw = {k: getattr(ctrl, k) for k in (
            "n", "m", "p", "u_d", "y_d", "L", "Q", "R", "u_s", "y_s",
            "eps_max", "lamb_alpha", "lamb_sigma", "c")}
        none = DirectDataDrivenMPCController(
            **kw, slack_var_constraint_type=SlackVarConstraintTypes.NONE,
            controller_type=DataDrivenMPCType.ROBUST,
        )
        maps.append(none.solution_map(device="cpu", dtype=torch.float64))
        plants.append(plant)
    ins = [torch.as_tensor(np.stack([r[3][i] for r in reals]))
           for i in range(4)]
    res = batch.heterogeneous_closed_loop(
        batch.stack_plants(plants), batch.stack_solution_maps(maps), *ins,
        n_steps=12,
    )
    for b in range(2):
        one = loop.closed_loop_rollout(plants[b], maps[b],
                                       *(a[b : b + 1] for a in ins),
                                       n_steps=12)
        torch.testing.assert_close(res.u_sys[b], one.u_sys[0], rtol=0,
                                   atol=1e-12)
        torch.testing.assert_close(res.costs[b], one.costs[0], rtol=0,
                                   atol=1e-9)
    with pytest.raises(ValueError, match="stacked per scenario"):
        batch.heterogeneous_closed_loop(
            plants[0], batch.stack_solution_maps(maps), *ins, n_steps=12,
        )



def test_chip_smoke_generic_phases_run_on_the_cpu(capsys):
    """``chip_smoke.py``'s phases 27-29 at a tiny size on the CPU (K4's
    plain version stands in for the kernel there): every check passes
    and each configuration's run is returned for the timing phase."""
    from chip_smoke import build_four_tank_robust, generic_phases, \
        scenario_batch

    plant, ctrl = build_four_tank_robust()
    W = torch.as_tensor(0.002 * np.random.default_rng(0).uniform(
        -1, 1, (4, 12, 2)), dtype=torch.float32)
    runs = generic_phases(
        torch.device("cpu"), "cpu", dict(
            plant=plant, ctrl=ctrl,
            inputs=(*scenario_batch(plant, ctrl, 4, "cpu"), W)),
        B=4, T=12,
    )
    assert set(runs) == {"four_tank_convex_generic",
                         "four_tank_box_generic", "four_tank_nonconvex"}
    for run in runs.values():
        assert torch.equal(run["run"](*run["ins"]).u_sys, run["res"].u_sys)
    assert "segmented (6 + 6 steps" in capsys.readouterr().out
