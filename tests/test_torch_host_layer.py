"""PyTorch port, the host layer: YAML config loading and the derived
controller parameters (``utils.config``), ZOH discretization
(``models.c2d``), the YAML plant (``models.lti_model.LTISystemModel``),
the controller factory and the host closed loop (``control.creation``,
``control.operation``), and the stability certificate
(``control.linear_engine.closed_loop_spectrum``), each held against the
JAX package on the same numpy inputs."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

from direct_data_driven_mpc_tpu.control import linear_engine as jle  # noqa: E402
from direct_data_driven_mpc_tpu.control import operation as jop  # noqa: E402
from direct_data_driven_mpc_tpu.models import c2d as jc2d  # noqa: E402
from direct_data_driven_mpc_tpu.models.lti_model import (  # noqa: E402
    LTIModel as JaxLTIModel,
    LTISystemModel as JaxLTISystemModel,
)
from direct_data_driven_mpc_tpu.utils import config as jconfig  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control import linear_engine as le  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control import operation as op  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control.creation import (  # noqa: E402
    create_data_driven_mpc_controller,
)
from direct_data_driven_mpc_tpu_torch.control.loop import (  # noqa: E402
    closed_loop_rollout,
)
from direct_data_driven_mpc_tpu_torch.models import c2d  # noqa: E402
from direct_data_driven_mpc_tpu_torch.models.lti_model import (  # noqa: E402
    LTIModel,
    LTISystemModel,
)
from direct_data_driven_mpc_tpu_torch.utils import config  # noqa: E402

from tests.test_closed_loop import FOUR_TANK  # noqa: E402
from tests.test_config import BASE  # noqa: E402
from tests.test_torch_host import port_setup  # noqa: E402
from tests.test_torch_iterative import one_blas_thread  # noqa: E402,F401

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "examples", "config")
MODEL_YAML = os.path.join(CONFIG_DIR, "models",
                          "four_tank_system_params.yaml")
CONTROLLER_YAML = os.path.join(CONFIG_DIR, "controllers",
                               "data_driven_mpc_example_params.yaml")
EXACT = 1e-10


def _assert_params_equal(got: dict, want: dict):
    """Config dicts of the two packages: the same keys and values, enums
    compared by name."""
    assert list(got) == list(want)
    for key, value in want.items():
        if hasattr(value, "name"):
            assert got[key].name == value.name, key
        else:
            np.testing.assert_array_equal(got[key], value, err_msg=key)
            assert np.asarray(got[key]).dtype == np.asarray(value).dtype


def _write(tmp_path, params, key="params"):
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump({key: params}))
    return str(path)


def test_config_matches_jax_on_the_repo_yaml():
    for verbose in (0, 2):
        got = config.get_data_driven_mpc_controller_params(
            CONTROLLER_YAML, "data_driven_mpc_params", m=2, p=2,
            verbose=verbose,
        )
        want = jconfig.get_data_driven_mpc_controller_params(
            CONTROLLER_YAML, "data_driven_mpc_params", m=2, p=2,
        )
        _assert_params_equal(got, want)
    assert got["lamb_alpha"] == pytest.approx(0.1 / 0.002)
    assert got["n_mpc_step"] == 4 and got["Q"].shape == (60, 60)


@pytest.mark.parametrize("edit", [
    {},
    {"epsilon_bar": 0},  # the noise-free lamb_alpha rule
    {"slack_var_constraint_type": 99, "controller_type": 99},
    {"slack_var_constraint_type": 1, "controller_type": 0},
    {"slack_var_constraint_type": 2},
])
def test_config_edges_match_jax(tmp_path, edit):
    path = _write(tmp_path, dict(BASE, **edit))
    got = config.get_data_driven_mpc_controller_params(path, "params", 2, 2)
    want = jconfig.get_data_driven_mpc_controller_params(
        path, "params", 2, 2
    )
    _assert_params_equal(got, want)
    if "epsilon_bar" in edit:
        assert got["lamb_alpha"] == 1000.0


def test_config_errors_match_jax(tmp_path):
    params = dict(BASE)
    del params["lambda_sigma"]
    path = _write(tmp_path, params)
    for fn in (config.get_data_driven_mpc_controller_params,
               jconfig.get_data_driven_mpc_controller_params):
        with pytest.raises(ValueError, match="lambda_sigma"):
            fn(path, "params", m=2, p=2)
    for fn in (config.load_yaml_config_params,
               jconfig.load_yaml_config_params):
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path / "nope.yaml"), "k")
        with pytest.raises(ValueError, match="Missing `other`"):
            fn(path, "other")


def test_config_without_pyyaml_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        config.load_yaml_config_params(CONTROLLER_YAML,
                                       "data_driven_mpc_params")


@pytest.mark.parametrize("A_c, B_c, Ts", [
    ([[0.0]], [[1.0]], 0.1),  # integrator
    ([[-2.0]], [[1.0]], 0.25),  # first-order lag
    ([[0.0, 1.0], [0.0, 0.0]], [[0.0], [1.0]], 0.5),  # double integrator
    ([[0.0, 1.0], [-1.0, -0.5]], [[0.0], [1.0]], 0.1),  # damped oscillator
    ("random", "random", 0.3),
])
def test_c2d_matches_jax(A_c, B_c, Ts):
    if A_c == "random":
        rng = np.random.default_rng(3)
        A_c, B_c = rng.normal(size=(5, 5)), rng.normal(size=(5, 2))
    got = c2d.c2d_zoh(np.asarray(A_c), np.asarray(B_c), Ts)
    want = jc2d.c2d_zoh(np.asarray(A_c), np.asarray(B_c), Ts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    C = np.eye(1, np.shape(A_c)[0])
    plant = c2d.discretize_plant(A_c, B_c, C, Ts=Ts, eps_max=0.01)
    ref = jc2d.discretize_plant(A_c, B_c, C, Ts=Ts, eps_max=0.01)
    assert isinstance(plant, LTIModel) and plant.get_eps_max() == 0.01
    for name in ("A", "B", "C", "D"):
        np.testing.assert_allclose(getattr(plant, name),
                                   getattr(ref, name), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="Ts"):
        c2d.c2d_zoh(np.asarray(A_c), np.asarray(B_c), 0.0)


def test_c2d_expm_fallback_matches_scipy(monkeypatch):
    """Without scipy, the Taylor scaling-and-squaring fallback."""
    M = np.array([[-0.3, 1.2, 0.0], [0.0, -1.0, 0.5], [0.2, 0.0, -0.1]])
    want = c2d._expm(M)
    monkeypatch.setitem(sys.modules, "scipy.linalg", None)
    np.testing.assert_allclose(c2d._expm(M), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(c2d._expm(M), jc2d._expm(M), rtol=0,
                               atol=1e-15)


def test_lti_system_model_matches_jax():
    for verbose in (0, 1, 2):
        plant = LTISystemModel(MODEL_YAML, "FourTankSystem", verbose=verbose)
    ref = JaxLTISystemModel(MODEL_YAML, "FourTankSystem")
    for name in ("A", "B", "C", "D", "Ot", "Tt", "x"):
        np.testing.assert_array_equal(getattr(plant, name),
                                      getattr(ref, name), err_msg=name)
    assert plant.get_eps_max() == ref.get_eps_max() == 0.002
    for name in ("A", "B", "C", "D"):
        np.testing.assert_array_equal(getattr(plant, name), FOUR_TANK[name])
    params = plant.as_params(dtype=np.float32)
    jparams = ref.as_params(dtype=np.float32)
    for a, b in zip(params, jparams):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))
    assert plant.as_params().A.dtype == np.float64


@pytest.mark.parametrize("edit, match", [
    ({"A": [[1.0, 0.0]]}, "square"),
    ({"B": [[1.0], [0.0], [0.0]]}, "row count must match A"),
    ({"C": [[1.0, 0.0, 0.0]]}, "column count must match A"),
    ({"D": [[0.0], [0.0]]}, "row count must match C"),
    ({"A": None}, "Missing required matrices"),
])
def test_lti_system_model_validation_matches_jax(tmp_path, edit, match):
    params = {"A": [[0.9, 0.1], [0.0, 0.8]], "B": [[0.0], [1.0]],
              "C": [[1.0, 0.0]], "D": [[0.0]], "eps_max": 0.01}
    params.update(edit)
    params = {k: v for k, v in params.items() if v is not None}
    path = _write(tmp_path, params, key="Plant")
    for cls in (LTISystemModel, JaxLTISystemModel):
        with pytest.raises(ValueError, match=match):
            cls(path, "Plant")


def test_data_generation_matches_jax():
    """``randomize_initial_system_state``, ``generate_initial_input_output_
    data`` and ``simulate_n_input_output_measurements`` on the same seeds
    and plants give the JAX package's numbers."""
    cfg = jconfig.get_data_driven_mpc_controller_params(
        CONTROLLER_YAML, "data_driven_mpc_params", m=2, p=2
    )
    plant, jplant = LTIModel(**FOUR_TANK), JaxLTIModel(**FOUR_TANK)
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    x0 = op.randomize_initial_system_state(plant, cfg, rng)
    jx0 = jop.randomize_initial_system_state(jplant, cfg, jrng)
    np.testing.assert_allclose(x0, jx0, rtol=0, atol=EXACT)
    plant.set_state(x0)
    jplant.set_state(jx0)
    for fn, jfn in ((op.generate_initial_input_output_data,
                     jop.generate_initial_input_output_data),
                    (op.simulate_n_input_output_measurements,
                     jop.simulate_n_input_output_measurements)):
        for a, b in zip(fn(plant, cfg, rng), jfn(jplant, cfg, jrng)):
            np.testing.assert_allclose(a, b, rtol=0, atol=EXACT)
    assert a.shape == (4, 2)
    np.testing.assert_allclose(plant.get_state(), jplant.get_state(),
                               rtol=0, atol=EXACT)


def test_created_controller_equals_the_direct_one():
    """``create_data_driven_mpc_controller`` from the YAML parameters
    builds the controller (its spec and host operator) that the
    constructor builds from the same values."""
    _, jctrl, ctrl, _ = port_setup()
    cfg = config.get_data_driven_mpc_controller_params(
        CONTROLLER_YAML, "data_driven_mpc_params", m=2, p=2
    )
    cfg["n_mpc_step"] = 1
    made = create_data_driven_mpc_controller(cfg, jctrl.u_d, jctrl.y_d)
    assert (made.n, made.m, made.p, made.L) == (4, 2, 2, 30)
    for name in ("H", "A", "b_const", "S", "g"):
        np.testing.assert_array_equal(getattr(made.spec, name),
                                      getattr(ctrl.spec, name))
    got, want = made.solution_operator(), ctrl.solution_operator()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("n_mpc_step, n_steps", [(1, 30), (4, 42)])
def test_host_loop_matches_jax_and_the_generic_loop(n_mpc_step, n_steps):
    """The host closed loop (Algorithms 1 and 2) on injected noise: the
    JAX package's within 1e-10, and the port's generic loop in float64
    on the same noise within 1e-10."""
    jplant, jctrl, ctrl, rng = port_setup(n_mpc_step=n_mpc_step)
    jctrl._native = None  # the JAX controller's numpy solve path
    w_sys = 0.002 * rng.uniform(-1.0, 1.0, (n_steps, 2))
    plant = LTIModel(**FOUR_TANK)
    plant.set_state(jplant.get_state().copy())
    x0 = plant.get_state().copy()
    up0, yp0 = ctrl.u_past.reshape(1, 4, 2), ctrl.y_past.reshape(1, 4, 2)

    u, y = op.simulate_data_driven_mpc_control_loop(
        plant, ctrl, n_steps, np_random=None, verbose=2, w_sys=w_sys
    )
    ju, jy = jop.simulate_data_driven_mpc_control_loop(
        jplant, jctrl, n_steps, np_random=None, verbose=0, w_sys=w_sys
    )
    np.testing.assert_allclose(u, ju, rtol=0, atol=EXACT)
    np.testing.assert_allclose(y, jy, rtol=0, atol=EXACT)
    np.testing.assert_allclose(plant.get_state(), jplant.get_state(),
                               rtol=0, atol=EXACT)

    res = closed_loop_rollout(
        plant.as_params(), ctrl.solution_map(device="cpu",
                                             dtype=torch.float64),
        *(torch.as_tensor(a, dtype=torch.float64)
          for a in (x0[None], up0, yp0, w_sys[None])),
        n_steps=n_steps, n_mpc_step=n_mpc_step,
    )
    np.testing.assert_allclose(res.u_sys[0].numpy(), u, rtol=0, atol=EXACT)
    np.testing.assert_allclose(res.y_sys[0].numpy(), y, rtol=0, atol=EXACT)


@pytest.mark.parametrize("use_terminal, n_mpc_step, stable", [
    (True, 1, True), (True, 4, True), (False, 1, False),
])
def test_closed_loop_spectrum_matches_jax(use_terminal, n_mpc_step, stable):
    """tests/test_stability.py's three cases: TEC certified stable (one
    step and n steps per solve), UCON unstable; the block map within
    1e-10 of JAX's, the spectrum of the same matrix equal, and each
    package's spectral radius of its own map within 1e-10."""
    jplant, jctrl, ctrl, _ = port_setup(n_mpc_step=n_mpc_step,
                                        use_terminal=use_terminal)
    kw = dict(n=4, m=2, p=2, n_mpc_step=n_mpc_step)
    bm = le.build_affine_block_map(jplant.as_params(),
                                   ctrl.solution_operator(), device="cpu",
                                   dtype=torch.float64, **kw)
    jbm = jle.build_affine_block_map(jplant.as_params(), jctrl._op,
                                     dtype=jnp.float64, **kw)
    np.testing.assert_allclose(bm.M_T.numpy(), np.asarray(jbm.M_T),
                               rtol=0, atol=EXACT)
    got, want = le.closed_loop_spectrum(bm), jle.closed_loop_spectrum(jbm)
    assert got["stable"] is want["stable"] is stable
    assert (got["spectral_radius"] < 1.0) is stable
    assert abs(got["spectral_radius"] - want["spectral_radius"]) < EXACT
    same = le.closed_loop_spectrum(le.block_map_from_numpy(
        jbm._asdict(), "cpu", torch.float64
    ))
    np.testing.assert_array_equal(same["eigenvalues"], want["eigenvalues"])
    # A float32 map is read back and analysed in float64.
    f32 = le.closed_loop_spectrum(bm._replace(M_T=bm.M_T.float()))
    assert f32["eigenvalues"].dtype in (np.float64, np.complex128)
    assert f32["stable"] is stable
