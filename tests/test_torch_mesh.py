"""PyTorch port, the scenario mesh (``parallel.mesh``) on eight gloo
ranks, held against the JAX package's ``shard_map`` engines on the
virtual 8-device CPU mesh, or against the port's own unsharded run where
JAX has no counterpart: the generic loop data- and model-parallel (gain
rows padded, 60 over 8), with the ADMM, box-ladder and NON_CONVEX
solvers; the fused rollout's plain version, plain and tracking; the
fused ADMM's plain version; the classic engine's in-scan noise. The JAX
side runs in this process; the port's ranks (tests/_torch_dist.py)
import no JAX and run every case in one spawn for the file, each rank
its shard of the same global inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from direct_data_driven_mpc_tpu.control import linear_engine as jle  # noqa: E402
from direct_data_driven_mpc_tpu.parallel import mesh as jmesh  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control import linear_engine as le  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa  # noqa: E402
from direct_data_driven_mpc_tpu_torch.parallel.batch import (  # noqa: E402
    batched_closed_loop,
    draw_block_noise,
)
from direct_data_driven_mpc_tpu_torch.qp.admm import (  # noqa: E402
    compute_admm_operator_np,
)
from direct_data_driven_mpc_tpu_torch.qp.spec import (  # noqa: E402
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

from tests import _torch_dist_bodies as bodies  # noqa: E402
from tests._torch_dist import run_ranks  # noqa: E402
from tests.test_torch_host import controller_kwargs, port_setup  # noqa: E402
from tests.test_torch_iterative import one_blas_thread  # noqa: E402,F401

WORLD = 8
F64 = torch.float64
EXACT = 1e-9  # float64 port against JAX (tests/test_torch_iterative.py)
ATOL = 2e-5  # float32 fused rollouts (tests/test_parallel.py)
SHARDED_EXACT = 1e-12  # float64 port sharded against unsharded
U_BOX = 0.85
K = 5  # solves per block of the fused and classic engines
ADMM_KW = dict(iters=(4, 5, 2), cold_iters=24, tol=1e-5)
# case -> (mesh, B, T): tests/test_parallel.py's shapes.
SHAPES = {
    "data_parallel": ((4, 2), 8, 15),
    "model_parallel": ((4, 2), 8, 15),
    "model_parallel_padded": ((1, 8), 4, 10),
    "admm": ((4, 2), 8, 10),
    "box_ladder": ((4, 2), 8, 10),
    "nonconvex": ((4, 2), 8, 10),
    "fused": ((8, 1), 16, 20),
    "fused_tracking": ((8, 1), 16, 20),
    "fused_admm": ((8, 1), 16, 20),
    "linear_rng": ((8, 1), 16, 20),
    "linear_rng_aggregate": ((8, 1), 16, 20),
}
ITERS = {"admm": 150, "box_ladder": 120, "nonconvex": 16}


def _inputs(plant, ctrl, B, T, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = (np.tile(plant.get_state()[None], (B, 1)),
              np.tile(ctrl.u_past.reshape(1, 4, 2), (B, 1, 1)),
              np.tile(ctrl.y_past.reshape(1, 4, 2), (B, 1, 1)),
              0.002 * rng.uniform(-1, 1, (B, T, 2)))
    return [torch.as_tensor(a, dtype=dtype) for a in arrays]


@pytest.fixture(scope="module")
def setup():
    """The four-tank controllers (slack NONE, CONVEX c = 1, NON_CONVEX
    c = 0.05) and each case's port inputs and engine."""
    jplant, jctrl, ctrl, _ = port_setup()
    plant = jplant.as_params()
    kw = controller_kwargs(jctrl.u_d, jctrl.y_d)
    cvx = DirectDataDrivenMPCController(
        **kw, slack_var_constraint_type=SlackVarConstraintTypes.CONVEX,
        controller_type=DataDrivenMPCType.ROBUST,
    )
    ncx = DirectDataDrivenMPCController(
        **dict(kw, c=0.05),
        slack_var_constraint_type=SlackVarConstraintTypes.NON_CONVEX,
        controller_type=DataDrivenMPCType.ROBUST, allow_nonconvex_slack=True,
    )
    sol = ctrl.solution_map(device="cpu", dtype=F64)
    solvers = {
        "data_parallel": sol, "model_parallel": sol,
        "model_parallel_padded": sol,
        "admm": cvx.admm_solver(device="cpu", dtype=F64),
        "box_ladder": ctrl.box_admm_solver(u_bounds=(-U_BOX, U_BOX),
                                           device="cpu", dtype=F64),
        "nonconvex": ncx.nonconvex_admm_solver(device="cpu", dtype=F64),
    }
    cases = {}
    for seed, (name, (mesh, B, T)) in enumerate(SHAPES.items()):
        dtype = F64 if name in solvers or name == "linear_rng" else (
            torch.float32)
        c = dict(mesh=mesh, T=T, inputs=_inputs(jplant, ctrl, B, T, dtype,
                                                seed))
        if name in solvers:
            c.update(kind="generic", plant=plant, solver=solvers[name],
                     admm_iters=ITERS.get(name, 100),
                     model_parallel=name.startswith("model_parallel"))
        elif name == "fused":
            c.update(kind="fused", block_map=le.build_linear_engine(
                ctrl, plant, solves_per_block=K, device="cpu"))
        elif name == "fused_tracking":
            r0 = np.concatenate([ctrl.u_s.ravel(), ctrl.y_s.ravel()])
            scale = 1 + 0.1 * np.random.default_rng(9).uniform(
                -1, 1, (B, T // K, 1))
            c.update(kind="fused", setpoints=torch.as_tensor(
                scale * r0, dtype=torch.float32),
                block_map=le.build_tracking_engine(
                    ctrl, plant, solves_per_block=K, device="cpu"))
        elif name == "fused_admm":
            c.update(kind="fused_admm", plant=plant,
                     op=compute_admm_operator_np(cvx.spec), kw=ADMM_KW)
        elif name == "linear_rng":
            c.update(kind="linear_rng", seed=3, eps_max=0.002,
                     block_map=le.build_linear_engine(
                         ctrl, plant, solves_per_block=K, device="cpu",
                         dtype=F64))
        else:  # the same run in the aggregate mode
            c = dict(cases["linear_rng"], emit_trajectories=False)
        cases[name] = c
    return dict(jplant=jplant, jctrl=jctrl, ctrl=ctrl, plant=plant,
                cases=cases)


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    return run_ranks(bodies.mesh_cases, WORLD,
                     tmp_path_factory.mktemp("mesh"), setup["cases"],
                     timeout=240)


def _global(ranks, name, field):
    """A case's field over the global batch: the data shards in order,
    each from the rank at model coordinate 0; the model replicas equal
    to it bit for bit."""
    (n_data, n_model), _, _ = SHAPES[name]
    key = f"{name}/{field}"
    for d in range(n_data):
        for k in range(1, n_model):
            np.testing.assert_array_equal(
                ranks[d * n_model + k][key], ranks[d * n_model][key],
                err_msg=f"{key}: model replica {k} of data shard {d}")
    return np.concatenate([ranks[d * n_model][key] for d in range(n_data)])


def _metrics_replicated(ranks, name):
    for key in ("mean_final_cost", "frac_converged"):
        for out in ranks[1:]:
            assert out[f"{name}/{key}"] == ranks[0][f"{name}/{key}"], key
    return {key: float(ranks[0][f"{name}/{key}"])
            for key in ("mean_final_cost", "frac_converged")}


def _jax_inputs(c, dtype):
    return [jnp.asarray(a.numpy(), dtype) for a in c["inputs"]]


@pytest.mark.parametrize("name", ["data_parallel", "model_parallel",
                                  "model_parallel_padded"])
def test_mesh_rollout_matches_jax(setup, ranks, name):
    """The generic loop with the exact map on a (4, 2) mesh, data- and
    model-parallel, and on (1, 8), where the 60 gain rows pad to 64 and
    the padding is dropped after the gather, against JAX's
    ``make_mesh_rollout`` on the same mesh shapes, in float64."""
    c = setup["cases"][name]
    (n_data, n_model), B, T = SHAPES[name]
    jsol = setup["jctrl"].solution_map(dtype=jnp.float64)
    run = jmesh.make_mesh_rollout(
        jmesh.make_scenario_mesh(n_data, n_model), setup["plant"], jsol,
        n_steps=T, model_parallel=c["model_parallel"],
    )
    jres, jmetrics = run(*_jax_inputs(c, jnp.float64))
    for field in ("u_sys", "y_sys", "costs", "x_final"):
        np.testing.assert_allclose(_global(ranks, name, field),
                                   np.asarray(getattr(jres, field)),
                                   rtol=0, atol=EXACT, err_msg=field)
    metrics = _metrics_replicated(ranks, name)
    assert metrics["frac_converged"] == float(jmetrics["frac_converged"])
    assert metrics["mean_final_cost"] == pytest.approx(
        float(jmetrics["mean_final_cost"]), rel=1e-9)
    assert not bool(ranks[0][f"{name}/model_parallel_refused"])


@pytest.mark.parametrize("name", ["admm", "box_ladder", "nonconvex"])
def test_iterative_solvers_on_the_mesh_match_unsharded(setup, ranks, name):
    """The ADMM (CONVEX), box ladder and NON_CONVEX solvers on the mesh,
    their state sharded with the scenarios, against the port's unsharded
    generic loop in float64 (JAX's mesh carries neither the ladder's
    checks nor any NON_CONVEX state): u, y, costs and state within 1e-12,
    converged and rung lanes equal; model parallelism refused."""
    c = setup["cases"][name]
    ref = batched_closed_loop(c["plant"], c["solver"], *c["inputs"],
                              n_steps=c["T"], admm_iters=c["admm_iters"])
    for field in ("u_sys", "y_sys", "costs", "x_final"):
        np.testing.assert_allclose(_global(ranks, name, field),
                                   getattr(ref, field).numpy(), rtol=0,
                                   atol=SHARDED_EXACT, err_msg=field)
    np.testing.assert_array_equal(_global(ranks, name, "converged"),
                                  ref.converged.numpy())
    for field, leaf in zip(ref.solver_state._fields, ref.solver_state):
        got = _global(ranks, name, f"state/{field}")
        if leaf.dtype.is_floating_point:
            np.testing.assert_allclose(got, leaf.numpy(), rtol=0,
                                       atol=SHARDED_EXACT, err_msg=field)
        else:  # the rung lanes
            np.testing.assert_array_equal(got, leaf.numpy(), err_msg=field)
    metrics = _metrics_replicated(ranks, name)
    assert metrics["frac_converged"] == pytest.approx(
        float(ref.converged.double().mean()), rel=1e-12)
    assert metrics["mean_final_cost"] == pytest.approx(
        float(ref.costs[:, -1].mean()), rel=1e-12)
    assert bool(ranks[0][f"{name}/model_parallel_refused"])


@pytest.mark.parametrize("name", ["fused", "fused_tracking"])
def test_sharded_fused_rollout_matches_jax(setup, ranks, name):
    """The fused rollout's plain version over (8, 1), plain and with a
    per-scenario setpoint schedule, against JAX's sharded XLA twin
    (``backend="xla"``): u, y within 2e-5, metrics rtol 1e-4; a shared
    (n_outer, n_r) schedule refused, as in JAX."""
    c = setup["cases"][name]
    (n_data, _), _, T = SHAPES[name]
    jctrl, plant = setup["jctrl"], setup["plant"]
    if name == "fused":
        jbm = jle.build_affine_block_map(plant, jctrl._op, n=4, m=2, p=2,
                                         solves_per_block=K,
                                         dtype=jnp.float32)
        extra = []
    else:
        jbm = jle.build_tracking_engine(jctrl, plant, solves_per_block=K,
                                        dtype=jnp.float32)
        extra = [jnp.asarray(c["setpoints"].numpy())]
        assert bool(ranks[0][f"{name}/shared_schedule_refused"])
    run = jmesh.make_sharded_fused_rollout(
        jmesh.make_scenario_mesh(n_data, 1), jbm, n_steps=T, backend="xla"
    )
    jres, jmetrics = run(*_jax_inputs(c, jnp.float32), *extra)
    for field in ("u_sys", "y_sys", "x_final"):
        np.testing.assert_allclose(_global(ranks, name, field),
                                   np.asarray(getattr(jres, field)),
                                   rtol=0, atol=ATOL, err_msg=field)
    metrics = _metrics_replicated(ranks, name)
    assert metrics["frac_converged"] == 1.0
    assert metrics["mean_final_cost"] == pytest.approx(
        float(jmetrics["mean_final_cost"]), rel=1e-4)


def test_sharded_fused_admm_matches_unsharded(setup, ranks):
    """The fused ADMM's plain version over (8, 1) against the unsharded
    plain version on the global batch: u, y, costs and the ADMM state
    (s, w) sharded with their scenarios."""
    c = setup["cases"]["fused_admm"]
    ref = fa.make_fused_admm_rollout(
        c["plant"], c["op"], 4, 2, 2, c["T"], device="cpu",
        rollout=fa.fused_admm_reference, **ADMM_KW,
    )(*c["inputs"])
    for field in ("u_sys", "y_sys", "costs", "x_final", "converged"):
        np.testing.assert_array_equal(_global(ranks, "fused_admm", field),
                                      getattr(ref, field).numpy(),
                                      err_msg=field)
    for field, leaf in zip(ref.solver_state._fields, ref.solver_state):
        np.testing.assert_array_equal(
            _global(ranks, "fused_admm", f"state/{field}"), leaf.numpy())
    metrics = _metrics_replicated(ranks, "fused_admm")
    assert metrics["frac_converged"] == float(ref.converged.double().mean())


def test_sharded_classic_engine_in_scan_noise_matches_unsharded(setup,
                                                                ranks):
    """The classic engine drawing its noise inside the block loop, over
    (8, 1): each rank draws the global block and keeps its rows. Each
    shard is bit-equal to the engine run on its rows with that noise fed
    explicitly (the same products), and the whole within 1e-12 of the
    unsharded in-scan run (its products span 16 rows, the shards' 2, so
    the BLAS may round otherwise)."""
    c = setup["cases"]["linear_rng"]
    (n_data, _), B, T = SHAPES["linear_rng"]
    bm, eps = c["block_map"], c["eps_max"]
    gen = torch.Generator().manual_seed(c["seed"])
    W = torch.cat([draw_block_noise(gen, B, K * 2, eps, "cpu", F64)
                   for _ in range(T // K)], 1).reshape(B, T, 2)
    rows = B // n_data
    for d in range(n_data):
        sl = slice(d * rows, (d + 1) * rows)
        ref = le.make_linear_batched_rollout(bm, T)(
            *(a[sl] for a in c["inputs"][:3]), W[sl])
        for field in ("u_sys", "y_sys", "costs", "x_final"):
            np.testing.assert_array_equal(
                ranks[d][f"linear_rng/{field}"],
                getattr(ref, field).numpy(), err_msg=f"{field}, shard {d}")
    ref = le.make_linear_batched_rollout(
        bm, T, use_rng_noise=True, eps_max=eps
    )(*c["inputs"][:3], torch.Generator().manual_seed(c["seed"]))
    for field in ("u_sys", "y_sys", "costs", "x_final"):
        np.testing.assert_allclose(_global(ranks, "linear_rng", field),
                                   getattr(ref, field).numpy(), rtol=0,
                                   atol=SHARDED_EXACT, err_msg=field)


def test_sharded_classic_engine_aggregate_mode_matches_full_mode(setup,
                                                                 ranks):
    """The same in-scan-noise run in the aggregate mode
    (``emit_trajectories=False``) over (8, 1): each shard's u and y are
    empty, ``(2, 0, 2)``, and its costs, flags and final state equal the
    full mode's shard bit for bit."""
    (n_data, _), B, _ = SHAPES["linear_rng_aggregate"]
    for d in range(n_data):
        for field in ("u_sys", "y_sys"):
            assert ranks[d][f"linear_rng_aggregate/{field}"].shape == (
                B // n_data, 0, 2), field
        for field in ("costs", "converged", "x_final", "u_past", "y_past"):
            np.testing.assert_array_equal(
                ranks[d][f"linear_rng_aggregate/{field}"],
                ranks[d][f"linear_rng/{field}"],
                err_msg=f"{field}, shard {d}")
