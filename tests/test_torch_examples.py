"""PyTorch port, the example CLIs (``direct_data_driven_mpc_tpu_torch.
examples``): each pipeline held against the same pipeline assembled from
the JAX package, on the same YAML, seed and injected numpy noise (the
JAX side in float32 where the port is, since tests/conftest.py turns on
x64; parity never compares random streams); each ``main(argv)`` on the
CPU for the lines tests/test_examples.py asserts; the refusals; the
imports a pipeline run leaves out; and ``chip_smoke.py``'s example
configs against the YAML files."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from direct_data_driven_mpc_tpu.control import linear_engine as jle  # noqa: E402
from direct_data_driven_mpc_tpu.control import operation as jop  # noqa: E402
from direct_data_driven_mpc_tpu.control.creation import (  # noqa: E402
    create_data_driven_mpc_controller as jax_create,
)
from direct_data_driven_mpc_tpu.control.loop import (  # noqa: E402
    closed_loop_rollout as jax_closed_loop_rollout,
)
from direct_data_driven_mpc_tpu.models.lti_model import (  # noqa: E402
    LTISystemModel as JaxSystemModel,
)
from direct_data_driven_mpc_tpu.qp.spec import (  # noqa: E402
    SlackVarConstraintTypes as JaxSlack,
)
from direct_data_driven_mpc_tpu.utils.config import (  # noqa: E402
    get_data_driven_mpc_controller_params as jax_params,
)
from direct_data_driven_mpc_tpu_torch.examples import common  # noqa: E402
from direct_data_driven_mpc_tpu_torch.examples import (  # noqa: E402
    direct_data_driven_mpc_example as direct,
    monte_carlo_example as mc,
    regularization_tuning_example as tuning,
    robust_data_driven_mpc_reproduction as repro,
    setpoint_tracking_example as tracking,
)
from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr  # noqa: E402

from tests.test_torch_iterative import one_blas_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_ATOL = {"None": 1e-12, "Convex": 1e-10}  # tests/test_torch_native.py
ATOL = 2e-5  # float32 u, y (tests/test_pallas_rollout.py)
HISTORY_RTOL = 1e-6  # tests/test_torch_tuning.py


def _jax_configs():
    model = JaxSystemModel(config_file=common.MODEL_CONFIG,
                           model_key_value=common.MODEL_KEY)
    config = jax_params(common.CONTROLLER_CONFIG, common.CONTROLLER_KEY,
                        m=model.get_number_inputs(),
                        p=model.get_number_outputs())
    return model, config


def _jax_start(model, config, seed):
    """The JAX CLIs' first steps: ``(rng, controller)``."""
    rng = np.random.default_rng(seed)
    model.set_state(jop.randomize_initial_system_state(model, config, rng))
    u_d, y_d = jop.generate_initial_input_output_data(model, config, rng)
    return rng, jax_create(config, u_d, y_d)


def _f32(a):
    return jnp.asarray(a, jnp.float32)


def _jax_direct(engine, t_sim, seed, slack=None, u_bounds=None):
    """examples/direct_data_driven_mpc_example.py:164-380 on the JAX
    package: ``(u_sys, y_sys)``."""
    model, config = _jax_configs()
    if slack is not None:
        config["slack_var_constraint_type"] = {
            "None": JaxSlack.NONE, "Convex": JaxSlack.CONVEX}[slack]
    n_steps = t_sim + 1
    rng, ctrl = _jax_start(model, config, seed)
    if engine == "host":
        return jop.simulate_data_driven_mpc_control_loop(
            model, ctrl, n_steps, rng, verbose=0)
    w = model.get_eps_max() * rng.uniform(-1.0, 1.0, (n_steps, 2))
    x0 = _f32(model.get_state())
    up, yp = _f32(ctrl.u_past.reshape(-1, 2)), _f32(ctrl.y_past.reshape(-1, 2))
    nb = ctrl.n_mpc_step
    if engine in ("linear", "kernel"):
        bm = jle.build_linear_engine(
            ctrl, model.as_params(),
            solves_per_block=min(50, -(-n_steps // nb)))
        if engine == "kernel":
            from direct_data_driven_mpc_tpu.ops.pallas_rollout import (
                pallas_batched_rollout,
            )

            tile = lambda a: jnp.tile(_f32(a)[None], (8,) + (1,) * a.ndim)
            res = pallas_batched_rollout(
                bm, tile(x0), tile(up), tile(yp), tile(w), n_steps=n_steps,
                n_mpc_step=nb, batch_block=8, interpret=True)
            res = jax.tree.map(lambda a: a[0], res)
        else:
            res = jle.linear_closed_loop_rollout(
                bm, x0, up, yp, W=_f32(w), n_steps=n_steps, n_mpc_step=nb)
    else:
        if u_bounds is not None:
            solver = ctrl.box_admm_solver(u_bounds=u_bounds)
        elif ctrl.spec.slack_var_constraint_type == JaxSlack.CONVEX:
            solver = ctrl.admm_solver()
        else:
            solver = ctrl.solution_map()
        res = jax_closed_loop_rollout(model.as_params(), solver, x0, up, yp,
                                      _f32(w), n_steps=n_steps,
                                      n_mpc_step=nb)
    return (np.asarray(res.u_sys, np.float64),
            np.asarray(res.y_sys, np.float64))


def _port_args(module, argv):
    return module.parse_args(["--device", "cpu", "--verbose", "0", *argv])


def _port_direct(argv, **kw):
    args = _port_args(direct, argv)
    return direct.simulate(*common.load_configs(), args, **kw)


DIRECT_CASES = {
    # name: (engine, slack, u bounds, tolerance)
    "host-None": ("host", "None", None, HOST_ATOL["None"]),
    "host-Convex": ("host", "Convex", None, HOST_ATOL["Convex"]),
    "linear": ("linear", None, None, ATOL),
    "kernel": ("kernel", None, None, ATOL),
    "fused": ("fused", None, None, ATOL),
    "fused-box": ("fused", None, (-0.85, 0.85), ATOL),
}


@pytest.mark.parametrize("name", list(DIRECT_CASES))
def test_direct_example_matches_jax(name):
    """The direct example's pipeline on each engine against the JAX
    CLI's, same YAML and seed: the host loop at the native solve's bars,
    the device engines in float32 at 2e-5 (``kernel``: the plain version
    on the CPU, JAX's Pallas kernel in interpret mode at its 8-row
    tile)."""
    engine, slack, bounds, atol = DIRECT_CASES[name]
    t_sim = 12 if engine == "fused" else 20
    argv = ["--engine", engine, "--t_sim", str(t_sim), "--seed", "0"]
    if slack:
        argv += ["--slack_var_const_type", slack]
    if bounds:
        argv += ["--u_min", str(bounds[0]), "--u_max", str(bounds[1])]
    fr.fused_rollout.launches = 0
    out = _port_direct(argv)
    assert fr.fused_rollout.launches == 0  # CPU: the plain version
    ju, jy = _jax_direct(engine, t_sim, 0, slack=slack, u_bounds=bounds)
    assert out["u_sys"].shape == ju.shape == (t_sim + 1, 2)
    np.testing.assert_allclose(out["u_sys"], ju, rtol=0, atol=atol)
    np.testing.assert_allclose(out["y_sys"], jy, rtol=0, atol=atol)
    if bounds:
        assert np.abs(out["u_sys"]).max() <= bounds[1] + 1e-4
    if engine != "host":
        assert out["converged"].all()


def test_direct_kernel_engine_is_the_plain_version_on_the_cpu():
    """``--engine kernel`` at B = 1 through ``fused_rollout`` equals the
    same pipeline through ``fused_rollout_reference``, bit for bit, on
    the CPU (on the card, chip_smoke.py phase 43 holds the kernel so)."""
    argv = ["--engine", "kernel", "--t_sim", "30", "--seed", "3"]
    got = _port_direct(argv)
    want = _port_direct(argv, rollout=fr.fused_rollout_reference)
    for key in ("u_sys", "y_sys", "costs", "x_final", "u_past", "y_past"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("argv,match", [
    (["--u_min", "-1"], "require --engine fused"),
    (["--engine", "linear", "--slack_var_const_type", "Convex"],
     "slack-NONE"),
])
def test_direct_example_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        _port_direct(["--t_sim", "5", "--seed", "0", *argv])


def test_monte_carlo_matches_jax():
    """The spectral radius at 1e-10 and the classic engine's u and y at
    2e-5 against monte_carlo_example.py's pipeline on the JAX package,
    fed the same numpy noise."""
    B, T = 6, 20
    noise = 0.002 * np.random.default_rng(5).uniform(-1, 1, (B, T, 2))
    args = _port_args(mc, ["--batch", str(B), "--t_sim", str(T),
                           "--seed", "1"])
    out = mc.simulate(*common.load_configs(), args, noise=noise)

    model, config = _jax_configs()
    config["n_mpc_step"] = 1
    _, ctrl = _jax_start(model, config, 1)
    bm = jle.build_linear_engine(ctrl, model.as_params(),
                                 solves_per_block=50)
    spectrum = jle.closed_loop_spectrum(bm)
    tile = lambda a: jnp.tile(_f32(a)[None], (B,) + (1,) * a.ndim)
    res = jle.make_linear_batched_rollout(bm, n_steps=T)(
        tile(model.get_state()), tile(ctrl.u_past.reshape(4, 2)),
        tile(ctrl.y_past.reshape(4, 2)), _f32(noise))
    assert abs(out["spectral_radius"] - spectrum["spectral_radius"]) < 1e-10
    assert out["stable"] and spectrum["stable"]
    np.testing.assert_allclose(out["u_sys"], np.asarray(res.u_sys),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(out["y_sys"], np.asarray(res.y_sys),
                               rtol=0, atol=ATOL)


def test_monte_carlo_in_loop_noise_is_seeded_and_bounded():
    """Without injected noise, each block's noise comes from a generator
    seeded with ``--seed``: the warm-up and the timed run draw alike, two
    calls agree, another seed differs."""
    def run(seed):
        args = _port_args(mc, ["--batch", "4", "--t_sim", "12",
                               "--seed", str(seed)])
        return mc.simulate(*common.load_configs(), args)

    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a["y_sys"], b["y_sys"])
    assert np.abs(a["y_sys"] - c["y_sys"]).max() > 0
    assert a["seconds"] > 0


def test_setpoint_tracking_matches_jax():
    """The staircase exactly, y at 2e-5 and the printed RMSE within 1e-5
    against setpoint_tracking_example.py's pipeline on the JAX package
    (its XLA twin of the fused rollout), fed the same numpy noise."""
    B, T, K, phases = 4, 40, 10, 3
    noise = 0.002 * np.random.default_rng(2).uniform(-1, 1, (B, T, 2))
    args = _port_args(tracking, ["--batch", str(B), "--t_sim", str(T),
                                 "--phases", str(phases),
                                 "--solves_per_block", str(K)])
    out = tracking.simulate(*common.load_configs(), args, noise=noise)

    from direct_data_driven_mpc_tpu.ops.pallas_rollout import (
        make_fused_batched_rollout,
    )

    model, config = _jax_configs()
    config["n_mpc_step"] = 1
    _, ctrl = _jax_start(model, config, 0)
    bm = jle.build_tracking_engine(ctrl, model.as_params(),
                                   solves_per_block=K)
    n_outer = -(-T // K)
    y_s = np.asarray(ctrl.y_s).ravel()
    scales = np.linspace(1.0, 0.6, phases)
    sched = np.zeros((n_outer, 4))
    for i in range(n_outer):
        y_ref = scales[min(i // max(n_outer // phases, 1), phases - 1)] * y_s
        sched[i] = np.concatenate(
            [model.get_equilibrium_input_from_output(y_ref), y_ref])
    sched = _f32(sched)
    tile = lambda a: jnp.tile(_f32(a)[None], (B,) + (1,) * a.ndim)
    res = make_fused_batched_rollout(bm, n_steps=T, backend="xla")(
        tile(model.get_state()), tile(ctrl.u_past.reshape(4, 2)),
        tile(ctrl.y_past.reshape(4, 2)), _f32(noise), sched)
    y = np.asarray(res.y_sys)
    y_ref_steps = np.repeat(np.asarray(sched)[:, 2:], K, axis=0)[:T]
    rmse = float(np.sqrt(np.mean((y - y_ref_steps[None]) ** 2)))

    np.testing.assert_array_equal(out["sched"], np.asarray(sched))
    np.testing.assert_allclose(out["y_sys"], y, rtol=0, atol=ATOL)
    assert abs(out["rmse"] - rmse) < 1e-5


def test_regularization_tuning_matches_jax():
    """Three Adam steps: the tuned weights and the losses at
    tests/test_torch_tuning.py's rtol against
    regularization_tuning_example.py's pipeline on the JAX package
    (float64, optax), on the same numpy batch."""
    from direct_data_driven_mpc_tpu.control.tuning import (
        make_closed_loop_objective,
        tune_regularization,
    )

    B, T, steps = 2, 10, 3
    args = _port_args(tuning, ["--batch", str(B), "--t_sim", str(T),
                               "--steps", str(steps)])
    out = tuning.simulate(*common.load_configs(), args)

    model, config = _jax_configs()
    rng, ctrl = _jax_start(model, config, 0)
    tile = lambda a: jnp.tile(jnp.asarray(a)[None], (B,) + (1,) * a.ndim)
    Ws = jnp.asarray(rng.uniform(-0.002, 0.002, (B, T, 2)))
    loss = make_closed_loop_objective(
        ctrl.spec, model.as_params(), tile(model.get_state()),
        tile(ctrl.u_past.reshape(4, 2)), tile(ctrl.y_past.reshape(4, 2)),
        Ws, n_steps=T, n_mpc_step=ctrl.n_mpc_step)
    a_yaml = ctrl.lamb_alpha * ctrl.eps_max
    want = tune_regularization(loss, alpha_reg0=100.0 * a_yaml,
                               sigma_reg0=ctrl.lamb_sigma, steps=steps,
                               learning_rate=0.4)
    yaml_loss = float(loss(jnp.log(jnp.asarray([a_yaml, ctrl.lamb_sigma]))))
    np.testing.assert_allclose(out["loss_history"], want["loss_history"],
                               rtol=HISTORY_RTOL)
    for key in ("alpha_reg", "sigma_reg", "initial_loss", "final_loss"):
        np.testing.assert_allclose(out[key], want[key], rtol=HISTORY_RTOL,
                                   err_msg=key)
    np.testing.assert_allclose(out["yaml_loss"], yaml_loss,
                               rtol=HISTORY_RTOL)


MAIN_CASES = {
    # name: (module, argv, expected lines)
    "direct-host": (direct, ["--t_sim", "30", "--seed", "0", "--verbose",
                             "1"], ["Simulation finished"]),
    "direct-fused": (direct, ["--t_sim", "25", "--seed", "1", "--verbose",
                              "1", "--engine", "fused"],
                     ["Simulation finished"]),
    "direct-kernel": (direct, ["--t_sim", "25", "--seed", "1", "--verbose",
                               "2", "--engine", "kernel"],
                      ["Simulation finished", "all converged: True"]),
    "direct-nominal": (direct, ["--t_sim", "20", "--seed", "0", "--verbose",
                                "1", "--controller_type", "Nominal",
                                "--n_mpc_step", "4"], ["Nominal"]),
    "direct-convex": (direct, ["--t_sim", "15", "--seed", "0", "--verbose",
                               "1", "--slack_var_const_type", "Convex"],
                      ["Simulation finished"]),
    "reproduction": (repro, ["--t_sim", "40", "--seed", "4", "--verbose",
                             "1"], ["TEC", "UCON"]),
    "monte_carlo": (mc, ["--batch", "16", "--t_sim", "20", "--seed", "0",
                         "--verbose", "1"],
                    ["spectral radius", "Simulated 16 scenarios"]),
    "tracking": (tracking, ["--batch", "16", "--t_sim", "60", "--phases",
                            "3", "--solves_per_block", "10", "--seed", "0"],
                 ["Simulation finished", "RMS tracking error"]),
    "tuning": (tuning, ["--batch", "2", "--t_sim", "10", "--steps", "2",
                        "--verbose", "0"], ["YAML ridge", "tuned:"]),
}


@pytest.mark.parametrize("name", list(MAIN_CASES))
def test_main_prints_the_jax_cli_lines(name, capsys):
    """Each ``main(argv)`` headless on the CPU prints the lines
    tests/test_examples.py asserts of the JAX CLI."""
    module, argv, lines = MAIN_CASES[name]
    if module is not repro:  # no device of its own: the host loop
        argv = [*argv, "--device", "cpu"]
    module.main([*argv, "--no_plot"])
    out = capsys.readouterr().out
    for line in lines:
        assert line in out, (line, out)


@pytest.mark.parametrize("module", [mc, tracking])
def test_main_saves_its_figure(module, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    fig = tmp_path / "fig.png"
    argv = ["--batch", "8", "--t_sim", "20", "--device", "cpu",
            "--save_fig", str(fig)]
    if module is tracking:
        argv += ["--solves_per_block", "10", "--phases", "2"]
    module.main(argv)
    assert fig.stat().st_size > 0
    assert "Figure saved" in capsys.readouterr().out

    import matplotlib.pyplot as plt

    plt.close("all")


def test_help_names_kernel_as_the_pallas_engine(capsys):
    with pytest.raises(SystemExit):
        direct.parse_args(["--help"])
    out = " ".join(capsys.readouterr().out.split())
    assert "{host,fused,linear,kernel}" in out
    assert "'pallas' engine" in out
    assert direct.parse_args([]).device is None  # the card by default


def test_pipelines_import_no_jax_and_no_matplotlib():
    """In a fresh interpreter (this one has JAX loaded by
    tests/conftest.py): importing every module of the port but ``viz``,
    the CLIs included, and running a pipeline with ``--no_plot`` leave
    ``jax``, the JAX package and matplotlib out of ``sys.modules``;
    ``viz`` then imports matplotlib and still no JAX."""
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import torch
        import direct_data_driven_mpc_tpu_torch as port

        torch.set_num_threads(1)
        names = []

        def walk(pkg):  # pkgutil.walk_packages would import viz
            for m in pkgutil.iter_modules(pkg.__path__,
                                          pkg.__name__ + "."):
                if m.name.endswith(".viz"):
                    continue
                names.append(m.name)
                module = importlib.import_module(m.name)
                if m.ispkg:
                    walk(module)

        walk(port)
        assert any(n.endswith("examples.setpoint_tracking_example")
                   for n in names), names
        from direct_data_driven_mpc_tpu_torch.examples import (
            direct_data_driven_mpc_example as direct,
            robust_data_driven_mpc_reproduction as repro,
        )
        from direct_data_driven_mpc_tpu_torch.entry import entry

        direct.main(["--engine", "kernel", "--t_sim", "10", "--seed", "0",
                     "--device", "cpu", "--verbose", "0", "--no_plot"])
        repro.main(["--t_sim", "12", "--verbose", "0", "--no_plot"])
        fn, args = entry(device="cpu")
        fn(*args)

        def loaded(*prefixes):
            return sorted(m for m in sys.modules
                          if m in prefixes or m.startswith(
                              tuple(p + "." for p in prefixes)))

        bad = loaded("jax", "jaxlib", "direct_data_driven_mpc_tpu")
        assert not bad, bad
        assert not loaded("matplotlib"), loaded("matplotlib")[:5]
        import direct_data_driven_mpc_tpu_torch.viz
        assert loaded("matplotlib")
        assert not loaded("jax", "jaxlib", "direct_data_driven_mpc_tpu")
        print("ok")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env["OPENBLAS_NUM_THREADS"] = env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_chip_smoke_example_configs_equal_the_yaml():
    """chip_smoke.py phases 43-45 build the CLIs' configs in Python (the
    card's machine may lack PyYAML): equal to the two YAML files as
    ``LTISystemModel`` and ``get_data_driven_mpc_controller_params``
    load them."""
    import chip_smoke

    plant, config = chip_smoke.example_configs()
    model, want = common.load_configs()
    for name in ("A", "B", "C", "D"):
        np.testing.assert_array_equal(getattr(plant, name),
                                      getattr(model, name))
    assert plant.get_eps_max() == model.get_eps_max()
    assert sorted(config) == sorted(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert config[key].dtype == value.dtype, key
            np.testing.assert_array_equal(config[key], value, err_msg=key)
        else:
            assert config[key] == value and type(config[key]) is type(
                value), key
