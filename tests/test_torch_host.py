"""PyTorch port, host float64 layer: QP assembly, the affine solution
operator and the controller, held against the JAX package on the
four-tank Robust setup (the same numpy data handed to both)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from direct_data_driven_mpc_tpu.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController as JaxController,
)
from direct_data_driven_mpc_tpu.qp.solution_map import (  # noqa: E402
    compute_solution_operator_np as jax_solution_operator_np,
)
from direct_data_driven_mpc_tpu_torch.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_tpu_torch.models.lti_model import (  # noqa: E402
    LTIModel,
)
from direct_data_driven_mpc_tpu_torch.qp.solution_map import (  # noqa: E402
    compute_solution_operator_np,
    kkt_residuals,
    solution_operator_from_numpy,
)
from direct_data_driven_mpc_tpu_torch.qp.spec import (  # noqa: E402
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

from tests.test_closed_loop import FOUR_TANK, _make_setup  # noqa: E402

EXACT = 1e-12


def controller_kwargs(u_d, y_d, L=30, n_mpc_step=1, use_terminal=True):
    """The four-tank Robust controller of the paper's example, slack
    NONE (the configuration of ``bench.py``), for either package."""
    return dict(
        n=4, m=2, p=2, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(2 * L), R=1e-4 * np.eye(2 * L),
        u_s=np.array([[1.0], [1.0]]), y_s=np.array([[0.65], [0.77]]),
        eps_max=0.002, lamb_alpha=0.1 / 0.002, lamb_sigma=1000.0, c=1.0,
        n_mpc_step=n_mpc_step, use_terminal_constraint=use_terminal,
    )


def port_setup(n_mpc_step=1, use_terminal=True, slack="NONE",
               solve_path=None):
    """JAX reference setup (seeded data) and the port's controller built
    from the identical numpy data: ``(jax_plant, jax_ctrl, port_ctrl,
    rng)``."""
    from direct_data_driven_mpc_tpu.qp.spec import (
        SlackVarConstraintTypes as JaxSlack,
    )

    jplant, jctrl, rng = _make_setup(
        n_mpc_step=n_mpc_step, use_terminal=use_terminal,
        slack=JaxSlack[slack],
    )
    ctrl = DirectDataDrivenMPCController(
        **controller_kwargs(jctrl.u_d, jctrl.y_d, n_mpc_step=n_mpc_step,
                            use_terminal=use_terminal),
        slack_var_constraint_type=SlackVarConstraintTypes[slack],
        controller_type=DataDrivenMPCType.ROBUST, solve_path=solve_path,
    )
    return jplant, jctrl, ctrl, rng


@pytest.fixture(scope="module")
def setup():
    return port_setup()


@pytest.fixture(scope="module")
def convex_setup():
    """The CONVEX pair on their numpy ``admm_solve_np`` paths: the port's
    by name, the JAX controller's (it takes its C runtime where one
    loads) by dropping its C solver and redoing its first solve."""
    jplant, jctrl, ctrl, rng = port_setup(slack="CONVEX",
                                          solve_path="numpy")
    jctrl._native = None
    jctrl._admm_state = None
    jctrl.update_and_solve_data_driven_mpc()
    return jplant, jctrl, ctrl, rng


def test_qp_spec_matches_jax(setup):
    _, jctrl, ctrl, _ = setup
    spec, jspec = ctrl.spec, jctrl.spec
    assert (spec.nz, spec.nc) == (571, 168)
    assert (jspec.nz, jspec.nc) == (571, 168)
    for name in ("H", "A", "b_const", "S", "g"):
        np.testing.assert_allclose(
            getattr(spec, name), getattr(jspec, name), rtol=0, atol=EXACT,
            err_msg=name,
        )
    assert abs(spec.r0 - jspec.r0) < EXACT
    assert spec.u_pred_slice == jspec.u_pred_slice


def test_solution_operator_matches_jax(setup):
    _, jctrl, ctrl, _ = setup
    op = compute_solution_operator_np(ctrl.spec)
    jop = jax_solution_operator_np(jctrl.spec)
    assert op["feasible"] and jop["feasible"]
    for name in ("z_base", "Z", "u_base", "U_gain", "cost_P", "cost_q",
                 "cost_r"):
        np.testing.assert_allclose(
            op[name], jop[name], rtol=0, atol=EXACT, err_msg=name
        )
    # The carried-over dict is the same operator, float64.
    carried = solution_operator_from_numpy(jop)
    for name, value in carried.items():
        assert np.asarray(value).dtype == np.float64
        np.testing.assert_array_equal(value, jop[name])
    with pytest.raises(KeyError, match="cost_P"):
        solution_operator_from_numpy(
            {k: v for k, v in jop.items() if k != "cost_P"}
        )


def test_controller_first_solve_matches_jax(setup):
    _, jctrl, ctrl, _ = setup
    assert ctrl.solve_path == "native"
    assert ctrl.get_problem_solve_status() == "optimal"
    np.testing.assert_allclose(
        ctrl.optimal_u, jctrl.optimal_u, rtol=0, atol=EXACT
    )
    assert abs(
        ctrl.get_optimal_cost_value() - jctrl.get_optimal_cost_value()
    ) < 1e-9
    theta = np.concatenate(
        [ctrl.u_past.reshape(-1), ctrl.y_past.reshape(-1)]
    )
    res = kkt_residuals(ctrl.spec, ctrl.optimal_solution(), theta)
    assert res["primal_inf"] < 1e-9 and res["stationarity_inf"] < 1e-7
    from direct_data_driven_mpc_tpu.qp.solution_map import (
        kkt_residuals as jax_kkt_residuals,
    )

    jres = jax_kkt_residuals(jctrl.spec, ctrl.optimal_solution(), theta)
    for key in res:
        assert abs(res[key] - jres[key]) < EXACT


def _host_loop(jplant, ctrl, jctrl, n_steps):
    """Interactive steps (solve, apply, measure, shift) through both
    controllers on the same plant and noise: the applied inputs and
    the solve statuses of each."""
    W = 0.002 * np.random.default_rng(3).uniform(-1, 1, (n_steps, 2))
    x0 = jplant.get_state().copy()
    out = {}
    for name, c in (("port", ctrl), ("jax", jctrl)):
        plant = LTIModel(**FOUR_TANK)
        plant.set_state(x0)
        u0, y0 = c.u_past.copy(), c.y_past.copy()
        seq, status = [], []
        for k in range(n_steps):
            c.update_and_solve_data_driven_mpc()
            status.append(c.get_problem_solve_status())
            u = c.get_optimal_control_input_at_step(0)
            y = plant.simulate_step(u, W[k])
            c.store_input_output_measurement(
                u.reshape(-1, 1), y.reshape(-1, 1)
            )
            seq.append(u)
        c.set_past_input_output_data(u0, y0)
        c.update_and_solve_data_driven_mpc()
        out[name] = (np.array(seq), status)
    return out


def test_controller_host_loop_matches_jax(setup):
    """Ten interactive steps through both controllers."""
    jplant, jctrl, ctrl, _ = setup
    out = _host_loop(jplant, ctrl, jctrl, 10)
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=0,
                               atol=1e-10)


def test_closed_loop_result_solver_state_defaults_to_none():
    from direct_data_driven_mpc_tpu_torch.control.loop import (
        ClosedLoopResult,
    )

    assert ClosedLoopResult._fields[-1] == "solver_state"
    res = ClosedLoopResult(*(torch.zeros(1) for _ in range(7)))
    assert res.solver_state is None


def test_convex_controller_first_solve_matches_jax(convex_setup):
    """CONVEX slack: the host ADMM operator and the warm-started
    ``admm_solve_np`` solve of the first window, as in the JAX
    controller."""
    _, jctrl, ctrl, _ = convex_setup
    assert ctrl.solve_path == "numpy"
    assert ctrl.get_problem_solve_status() == jctrl.get_problem_solve_status()
    assert ctrl.get_problem_solve_status() == "optimal"
    np.testing.assert_allclose(
        ctrl.optimal_u, jctrl.optimal_u, rtol=0, atol=1e-10
    )
    assert abs(
        ctrl.get_optimal_cost_value() - jctrl.get_optimal_cost_value()
    ) < 1e-8
    with pytest.raises(ValueError, match="CONVEX"):
        ctrl.solution_operator()
    with pytest.raises(ValueError, match="CONVEX"):
        ctrl.optimal_solution()


def test_convex_controller_host_loop_matches_jax(convex_setup):
    """Twenty interactive CONVEX steps, the ADMM state warm-started
    across steps in both controllers; a two-iteration cap reports
    ``optimal_inaccurate`` in both."""
    jplant, jctrl, ctrl, _ = convex_setup
    out = _host_loop(jplant, ctrl, jctrl, 20)
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=0,
                               atol=1e-10)
    assert out["port"][1] == out["jax"][1]
    assert set(out["port"][1]) == {"optimal"}
    for c in (ctrl, jctrl):
        c.admm_iters = 2
        c._admm_state = None
    try:
        assert ctrl.solve_mpc_problem() == jctrl.solve_mpc_problem() == (
            "optimal_inaccurate"
        )
    finally:
        for c in (ctrl, jctrl):
            c.admm_iters = 200
            c._admm_state = None


def test_non_pe_input_raises(setup):
    _, jctrl, _, _ = setup
    u_d = np.ones_like(jctrl.u_d)  # constant input: rank 2, not PE
    with pytest.raises(ValueError, match="persistently exciting"):
        DirectDataDrivenMPCController(
            **controller_kwargs(u_d, jctrl.y_d),
            slack_var_constraint_type=SlackVarConstraintTypes.NONE,
            controller_type=DataDrivenMPCType.ROBUST,
        )
    with pytest.raises(ValueError, match="persistently exciting"):
        DirectDataDrivenMPCController(
            **controller_kwargs(jctrl.u_d[:100], jctrl.y_d[:100]),
            slack_var_constraint_type=SlackVarConstraintTypes.NONE,
            controller_type=DataDrivenMPCType.ROBUST,
        )


@pytest.mark.parametrize("slack", [SlackVarConstraintTypes.NON_CONVEX])
def test_unported_slack_raises(setup, slack):
    """NON_CONVEX without ``allow_nonconvex_slack=True`` raises the
    reference's ``NotImplementedError``, as the JAX controller does (the
    reference has no solver for it; the opt-in is held against the JAX
    package in tests/test_torch_nonconvex.py)."""
    from direct_data_driven_mpc_tpu.qp.spec import (
        DataDrivenMPCType as JaxType,
        SlackVarConstraintTypes as JaxSlack,
    )

    _, jctrl, _, _ = setup
    kw = controller_kwargs(jctrl.u_d, jctrl.y_d)
    with pytest.raises(NotImplementedError) as jax_err:
        JaxController(**kw, slack_var_constraint_type=JaxSlack[slack.name],
                      controller_type=JaxType.ROBUST)
    with pytest.raises(NotImplementedError, match="Non-Convex") as err:
        DirectDataDrivenMPCController(
            **kw, slack_var_constraint_type=slack,
            controller_type=DataDrivenMPCType.ROBUST,
        )
    assert str(err.value) == str(jax_err.value)


def test_validation_rules_match_jax(setup):
    """Horizon, weight-shape and cadence rules raise like the JAX
    controller's."""
    _, jctrl, _, _ = setup
    bad = [
        dict(L=6),  # Robust needs L >= 2n
        dict(Q=np.eye(3)),
        dict(n_mpc_step=31),
    ]
    for override in bad:
        kw = controller_kwargs(jctrl.u_d, jctrl.y_d)
        kw.update(override)
        if "L" in override:
            kw["Q"] = 3.0 * np.eye(2 * override["L"])
            kw["R"] = 1e-4 * np.eye(2 * override["L"])
        with pytest.raises(ValueError):
            DirectDataDrivenMPCController(
                **kw,
                slack_var_constraint_type=SlackVarConstraintTypes.NONE,
                controller_type=DataDrivenMPCType.ROBUST,
            )
        from direct_data_driven_mpc_tpu.qp.spec import (
            DataDrivenMPCType as JType,
            SlackVarConstraintTypes as JSlack,
        )

        with pytest.raises(ValueError):
            JaxController(
                **kw, slack_var_constraint_type=JSlack.NONE,
                controller_type=JType.ROBUST,
            )


def test_nominal_controller_matches_jax(setup):
    from direct_data_driven_mpc_tpu.qp.spec import (
        DataDrivenMPCType as JType,
    )

    _, jctrl, _, _ = setup
    kw = controller_kwargs(jctrl.u_d, jctrl.y_d)
    for key in ("eps_max", "lamb_alpha", "lamb_sigma", "c"):
        kw.pop(key)
    port = DirectDataDrivenMPCController(
        **kw, controller_type=DataDrivenMPCType.NOMINAL
    )
    ref = JaxController(**kw, controller_type=JType.NOMINAL)
    assert port.spec.nz == ref.spec.nz
    np.testing.assert_allclose(
        port.optimal_u, ref.optimal_u, rtol=0, atol=1e-9
    )


def test_lti_params_to_device():
    from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams

    params = LTIModel(**FOUR_TANK).as_params()
    assert isinstance(params, LTIParams)
    on = params.to("cpu", torch.float64)
    for a, b in zip(on, params):
        assert a.dtype == torch.float64 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b)
    assert params.to("cpu").A.dtype == torch.float32
