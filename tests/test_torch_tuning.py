"""PyTorch port, differentiable regularization tuning
(``control.tuning``): the ridge-parametric solution operator, the
closed-loop objective and its autograd gradient, and the Adam loop,
held against the JAX package (``jax.value_and_grad``, ``optax``) on the
four-tank Robust controller and the same numpy batch, and against
finite differences."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from direct_data_driven_mpc_tpu.control import tuning as jt  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control import tuning as tu  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp.solution_map import (  # noqa: E402
    compute_solution_operator_np,
)
from direct_data_driven_mpc_tpu_torch.qp.spec import (  # noqa: E402
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

from tests.test_torch_host import port_setup  # noqa: E402
from tests.test_torch_iterative import one_blas_thread  # noqa: E402,F401

RTOL = 1e-8  # loss and gradient against JAX
HISTORY_RTOL = 1e-6  # Adam's loss history against optax's


@pytest.fixture(scope="module")
def setup():
    return port_setup()


def _batch(setup, B=2, T=8, seed=3):
    jplant, _, ctrl, _ = setup
    rng = np.random.default_rng(seed)
    return (np.tile(jplant.get_state()[None], (B, 1)),
            np.tile(ctrl.u_past.reshape(1, 4, 2), (B, 1, 1)),
            np.tile(ctrl.y_past.reshape(1, 4, 2), (B, 1, 1)),
            0.002 * rng.uniform(-1, 1, (B, T, 2)), T)


def _objectives(setup, n_mpc_step=1, u_weight=0.0, **batch_kw):
    """The port's and JAX's objectives on the same numpy batch."""
    jplant, jctrl, ctrl, _ = setup
    *ins, T = _batch(setup, **batch_kw)
    kw = dict(n_steps=T, n_mpc_step=n_mpc_step, u_weight=u_weight)
    loss = tu.make_closed_loop_objective(ctrl.spec, jplant.as_params(),
                                         *ins, device="cpu", **kw)
    jloss = jt.make_closed_loop_objective(
        jctrl.spec, jplant.as_params(), *map(jnp.asarray, ins), **kw
    )
    return loss, jloss


def _log0(ctrl):
    return np.log([ctrl.lamb_alpha * ctrl.eps_max, ctrl.lamb_sigma])


def _close_scaled(got, want, tol, name):
    """``|got - want| <= tol * max(1, max |want|)``: the fields' scale
    (cost_P reaches 145) sets the float64 rounding of the solve."""
    want = np.asarray(want)
    bound = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=bound, err_msg=name)


def test_map_matches_jax_and_the_host_operator(setup):
    """At the controller's own ridge weights: JAX's differentiable map
    within 1e-10, the host float64 operator within 1e-9 (each scaled by
    the field's magnitude where it exceeds 1)."""
    _, jctrl, ctrl, _ = setup
    a0, s0 = np.exp(_log0(ctrl))
    sol = tu.differentiable_solution_map(ctrl.spec, a0, s0, device="cpu")
    jsol = jt.differentiable_solution_map(jctrl.spec, jnp.float64(a0),
                                          jnp.float64(s0))
    host = compute_solution_operator_np(ctrl.spec)
    for name, value in sol._asdict().items():
        assert value.dtype == torch.float64
        _close_scaled(value.numpy(), getattr(jsol, name), 1e-10, name)
        _close_scaled(value.numpy(), host[name], 1e-9, name)
    f32 = tu.differentiable_solution_map(ctrl.spec, a0, s0,
                                         dtype=torch.float32, device="cpu")
    assert f32.Z.dtype == torch.float32


@pytest.mark.parametrize("n_mpc_step, u_weight", [(1, 0.0), (2, 0.3)])
def test_loss_and_gradient_match_jax(setup, n_mpc_step, u_weight):
    """B = 2, T = 8: value and gradient against ``jax.value_and_grad``
    of the JAX objective, rtol 1e-8, at the controller's weights and at
    an inflated alpha."""
    _, _, ctrl, _ = setup
    loss, jloss = _objectives(setup, n_mpc_step, u_weight)
    for shift in (0.0, np.log(100.0)):
        log0 = _log0(ctrl) + np.array([shift, 0.0])
        jv, jg = jax.value_and_grad(jloss)(jnp.asarray(log0))
        params = torch.tensor(log0, requires_grad=True)
        value = loss(params)
        value.backward()
        np.testing.assert_allclose(float(value.detach()), float(jv),
                                   rtol=RTOL)
        np.testing.assert_allclose(params.grad.numpy(), np.asarray(jg),
                                   rtol=RTOL)


def test_gradient_matches_finite_differences(setup):
    _, _, ctrl, _ = setup
    loss, _ = _objectives(setup, B=3, T=25)
    log0 = torch.tensor(_log0(ctrl), requires_grad=True)
    loss(log0).backward()
    g = log0.grad.numpy()
    assert np.isfinite(g).all()
    eps = 1e-5
    with torch.no_grad():
        for i in range(2):
            e = torch.zeros(2, dtype=torch.float64)
            e[i] = eps
            fd = float(loss(log0 + e) - loss(log0 - e)) / (2 * eps)
            assert abs(g[i] - fd) < 1e-6 + 1e-4 * abs(fd), (i, g[i], fd)


def test_five_adam_steps_match_optax(setup):
    """From the 100x inflated alpha ridge: the loss history within rtol
    1e-6 of optax's Adam, the best weights alike, and the loss down."""
    _, _, ctrl, _ = setup
    loss, jloss = _objectives(setup, B=2, T=12)
    a0, s0 = np.exp(_log0(ctrl))
    kw = dict(alpha_reg0=100.0 * a0, sigma_reg0=s0, steps=5,
              learning_rate=0.5)
    got = tu.tune_regularization(loss, verbose=True, **kw)
    want = jt.tune_regularization(jloss, **kw)
    assert len(got["loss_history"]) == 6
    np.testing.assert_allclose(got["loss_history"], want["loss_history"],
                               rtol=HISTORY_RTOL)
    for key in ("alpha_reg", "sigma_reg", "initial_loss", "final_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=HISTORY_RTOL,
                                   err_msg=key)
    assert got["final_loss"] < got["initial_loss"]
    assert got["alpha_reg"] < 100.0 * a0


def test_optimizer_factory_matches_optax_sgd(setup):
    """A caller's optimizer factory: SGD in log space, as ``optax.sgd``."""
    _, _, ctrl, _ = setup
    loss, jloss = _objectives(setup)
    a0, s0 = np.exp(_log0(ctrl))
    kw = dict(alpha_reg0=10.0 * a0, sigma_reg0=s0, steps=3)
    got = tu.tune_regularization(
        loss, optimizer=lambda ps: torch.optim.SGD(ps, lr=2.0), **kw
    )
    want = jt.tune_regularization(jloss, optimizer=optax.sgd(2.0), **kw)
    np.testing.assert_allclose(got["loss_history"], want["loss_history"],
                               rtol=HISTORY_RTOL)


@pytest.mark.parametrize("field, value, match", [
    ("controller_type", DataDrivenMPCType.NOMINAL, "ROBUST"),
    ("slack_var_constraint_type", SlackVarConstraintTypes.CONVEX,
     "slack-NONE"),
    ("slack_var_constraint_type", SlackVarConstraintTypes.NON_CONVEX,
     "slack-NONE"),
])
def test_rejects_nominal_and_slack_variants(setup, field, value, match):
    jplant, _, ctrl, _ = setup
    spec = dataclasses.replace(ctrl.spec, **{field: value})
    with pytest.raises(ValueError, match=match):
        tu.differentiable_solution_map(spec, 1.0, 1.0, device="cpu")
    *ins, T = _batch(setup)
    with pytest.raises(ValueError, match=match):
        tu.make_closed_loop_objective(spec, jplant.as_params(), *ins,
                                      n_steps=T, device="cpu")


def test_non_finite_initial_loss_raises(setup):
    """The eager probe: a non-finite objective at the start raises
    before any step (here, noise with a NaN in it)."""
    jplant, _, ctrl, _ = setup
    x0s, ups, yps, Ws, T = _batch(setup)
    Ws[0, 3, 1] = np.nan
    loss = tu.make_closed_loop_objective(ctrl.spec, jplant.as_params(),
                                         x0s, ups, yps, Ws, n_steps=T,
                                         device="cpu")
    calls = []

    def counted(params):
        calls.append(torch.is_grad_enabled())
        return loss(params)

    a0, s0 = np.exp(_log0(ctrl))
    with pytest.raises(ValueError, match="non-finite"):
        tu.tune_regularization(counted, a0, s0, steps=3)
    assert calls == [False]  # the probe alone ran, without autograd
