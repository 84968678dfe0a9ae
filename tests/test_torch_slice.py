"""PyTorch port, the whole first slice: the benchmark's four-tank Robust
build (seed 0, N = 400, L = 30) through the port's public entry points
(controller -> build_linear_engine -> make_fused_batched_rollout)
against the same chain in the JAX package, and the port's independence
from JAX."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from chip_smoke import FOUR_TANK, build_four_tank_robust  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control.linear_engine import (  # noqa: E402
    build_linear_engine,
    make_linear_batched_rollout,
)
from direct_data_driven_mpc_tpu_torch.ops.fused_rollout import (  # noqa: E402
    make_fused_batched_rollout,
    suggest_solves_per_block,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T = 8, 100


def _jax_chain(Ws, K):
    """``bench.py``'s build (seed 0) and fused engine in the JAX package,
    every dtype pinned to float32. Returns the rollout and the data."""
    from direct_data_driven_mpc_tpu.control.controller import (
        DirectDataDrivenMPCController,
    )
    from direct_data_driven_mpc_tpu.control.linear_engine import (
        build_linear_engine as jax_build_linear_engine,
    )
    from direct_data_driven_mpc_tpu.models.lti_model import LTIModel
    from direct_data_driven_mpc_tpu.ops.pallas_rollout import (
        pallas_batched_rollout,
    )
    from direct_data_driven_mpc_tpu.qp.spec import (
        DataDrivenMPCType,
        SlackVarConstraintTypes,
    )

    N, L, eps = 400, 30, 0.002
    rng = np.random.default_rng(0)
    plant = LTIModel(**FOUR_TANK)
    u_d = rng.uniform(-1, 1, (N, 2))
    w_d = eps * rng.uniform(-1, 1, (N, 2))
    y_d = plant.simulate(u_d, w_d, N)
    state = plant.get_state()
    ctrl = DirectDataDrivenMPCController(
        n=4, m=2, p=2, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(2 * L), R=1e-4 * np.eye(2 * L),
        u_s=np.array([[1.0], [1.0]]), y_s=np.array([[0.65], [0.77]]),
        eps_max=eps, lamb_alpha=0.1 / eps, lamb_sigma=1000.0, c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
    )
    assert (ctrl.spec.nz, ctrl.spec.nc) == (571, 168)
    bm = jax_build_linear_engine(
        ctrl, plant.as_params(), solves_per_block=K, dtype=jnp.float32
    )
    x0s = jnp.tile(jnp.asarray(state, jnp.float32)[None], (B, 1))
    ups = jnp.tile(
        jnp.asarray(ctrl.u_past.reshape(4, 2), jnp.float32)[None],
        (B, 1, 1),
    )
    yps = jnp.tile(
        jnp.asarray(ctrl.y_past.reshape(4, 2), jnp.float32)[None],
        (B, 1, 1),
    )
    res = pallas_batched_rollout(
        bm, x0s, ups, yps, jnp.asarray(Ws, jnp.float32), n_steps=T,
        backend="xla",
    )
    return res, u_d, y_d, state


def test_slice_matches_jax_chain():
    plant, ctrl = build_four_tank_robust()
    assert (ctrl.spec.nz, ctrl.spec.nc) == (571, 168)
    K = suggest_solves_per_block(4, 4, 2, 2, n_steps=T)
    assert K == 50
    bm = build_linear_engine(ctrl, plant.as_params(), solves_per_block=K,
                             device="cpu")
    Ws = 0.002 * np.random.default_rng(1).uniform(-1, 1, (B, T, 2))
    args = [
        torch.as_tensor(np.asarray(a, np.float64)).to(torch.float32)
        .expand(B, *np.shape(a)).contiguous()
        for a in (plant.get_state(), ctrl.u_past.reshape(4, 2),
                  ctrl.y_past.reshape(4, 2))
    ]
    W_t = torch.as_tensor(Ws, dtype=torch.float32)
    res = make_fused_batched_rollout(bm, T)(*args, W_t)

    ref, u_d, y_d, state = _jax_chain(Ws, K)
    np.testing.assert_array_equal(ctrl.u_d, u_d)
    np.testing.assert_allclose(ctrl.y_d, y_d, rtol=0, atol=1e-12)
    np.testing.assert_allclose(plant.get_state(), state, rtol=0,
                               atol=1e-12)
    assert res.u_sys.shape == (B, T, 2) and res.costs.shape == (B, T)
    for field in ("u_sys", "y_sys", "x_final", "u_past", "y_past"):
        np.testing.assert_allclose(
            getattr(res, field).numpy(), np.asarray(getattr(ref, field)),
            rtol=0, atol=2e-5, err_msg=field,
        )
    np.testing.assert_allclose(
        res.costs.numpy(), np.asarray(ref.costs), rtol=1e-3, atol=1e-5
    )
    # The classic engine at the benchmark's K = 100 on the same inputs.
    bm100 = build_linear_engine(
        ctrl, plant.as_params(), solves_per_block=100, device="cpu"
    )
    classic = make_linear_batched_rollout(bm100, T)(*args, W_t)
    np.testing.assert_allclose(
        res.u_sys.numpy(), classic.u_sys.numpy(), rtol=0, atol=2e-5
    )
    # The loop settles at the setpoint y_s = [0.65, 0.77].
    np.testing.assert_allclose(
        res.y_sys[:, -10:].mean(dim=(0, 1)).numpy(), [0.65, 0.77],
        atol=5e-3,
    )


def test_port_never_imports_jax():
    """Importing the port and running its CPU paths (the condensed loop
    with in-kernel and post-pass costs, the fused ADMM and ladder closed
    loops, the random plant) leave ``jax`` out of ``sys.modules``
    (checked in a fresh interpreter: this test process has JAX loaded by
    tests/conftest.py)."""
    code = textwrap.dedent(
        """
        import sys
        import torch
        import direct_data_driven_mpc_tpu_torch
        from direct_data_driven_mpc_tpu_torch.control import controller
        from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
            build_linear_engine,
        )
        from direct_data_driven_mpc_tpu_torch.ops import _kernels
        from direct_data_driven_mpc_tpu_torch.models.random_lti import (
            random_stable_lti,
        )
        from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa
        from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl
        from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr
        from direct_data_driven_mpc_tpu_torch.parallel.batch import (
            draw_noise_batch,
        )
        from direct_data_driven_mpc_tpu_torch.qp import admm, box
        from chip_smoke import (
            admm_config,
            build_four_tank_robust,
            scenario_batch,
        )

        torch.set_num_threads(1)
        plant, ctrl = build_four_tank_robust()
        bm = build_linear_engine(ctrl, plant.as_params(),
                                 solves_per_block=8, device="cpu")
        Ws = draw_noise_batch(0, 2, 20, 2, 0.002, device="cpu")
        for mode in ("inkernel", "post"):
            res = fr.make_fused_batched_rollout(bm, 20, cost_mode=mode)(
                *scenario_batch(plant, ctrl, 2, "cpu"), Ws
            )
            assert bool(torch.isfinite(res.costs).all())
        assert fr.fused_rollout.launches == 0
        assert fr.fused_rollout_nocost.launches == 0
        from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
            build_tracking_engine,
        )
        from direct_data_driven_mpc_tpu_torch.control.loop import (
            closed_loop_rollout,
        )

        bm_t = build_tracking_engine(ctrl, plant.as_params(),
                                     solves_per_block=4, device="cpu")
        sched = torch.tensor([1.0, 1.0, 0.65, 0.77])
        res = fr.make_fused_batched_rollout(bm_t, 20)(
            *scenario_batch(plant, ctrl, 2, "cpu"), Ws, sched
        )
        gen = closed_loop_rollout(
            plant.as_params(), ctrl.tracking_map(device="cpu"),
            *scenario_batch(plant, ctrl, 2, "cpu"), Ws, 20,
            setpoints=sched,
        )
        assert float((res.u_sys - gen.u_sys).abs().max()) < 2e-5
        assert random_stable_lti(0, 3, 2, 2).A.shape == (3, 3)
        for name in ("four_tank_convex", "four_tank_box"):
            plant, ctrl, op, kw = admm_config(name)
            res = fa.make_fused_admm_rollout(
                plant.as_params(), op, 4, 2, 2, 20, device="cpu", **kw
            )(*scenario_batch(plant, ctrl, 2, "cpu"), Ws)
            assert bool(res.converged.all())
        plant, ctrl, op, kw = admm_config("four_tank_ladder")
        res = fl.make_fused_ladder_rollout(
            plant.as_params(), op, 4, 2, 2, 20, device="cpu", **kw
        )(*scenario_batch(plant, ctrl, 2, "cpu"), Ws)
        assert bool(res.converged[:, 10:].all())
        assert fa.fused_admm.launches == fl.fused_ladder.launches == 0
        assert not _kernels._loaded
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "direct_data_driven_mpc_tpu")
                     or m.startswith(("jax.", "jaxlib"))
                     or m.startswith("direct_data_driven_mpc_tpu."))
        assert not bad, bad
        print("ok")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    # One BLAS thread, as the suite's one-BLAS-thread fixtures give the
    # host builds: beside the other workers, a pool of threads per
    # process oversubscribes the cores (3 s alone, 93 s beside them).
    env["OPENBLAS_NUM_THREADS"] = env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_noise_draw_bounds_and_seed():
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )

    W = draw_noise_batch(0, 64, 50, 2, 0.002, device="cpu")
    assert W.shape == (64, 50, 2) and W.dtype == torch.float32
    assert float(W.abs().max()) <= 0.002
    assert float(W.std()) > 0.0005  # uniform on [-eps, eps]: std eps/sqrt3
    again = draw_noise_batch(0, 64, 50, 2, 0.002, device="cpu")
    torch.testing.assert_close(W, again, rtol=0, atol=0)
    other = draw_noise_batch(1, 64, 50, 2, 0.002, device="cpu")
    assert not torch.equal(W, other)
