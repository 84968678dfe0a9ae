"""PyTorch port, the alpha-sharded PMINRES KKT solver
(``qp.distributed``) on gloo ranks, held against the JAX package's
solver on the virtual 8-device CPU mesh and against the exact operator:
the operand's leaves, single solves, iterative refinement, the
preconditioner, the tolerance's early exit, the closed loop and the
CONVEX refusal. The JAX side runs in this process; the port runs on a
``(2, 2)`` mesh of four spawned ranks (tests/_torch_dist.py), which
import no JAX, once for the whole file."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from direct_data_driven_mpc_tpu.parallel.mesh import (  # noqa: E402
    make_scenario_mesh as jax_mesh,
)
from direct_data_driven_mpc_tpu.qp import distributed as jqd  # noqa: E402
from direct_data_driven_mpc_tpu.qp.solution_map import (  # noqa: E402
    compute_solution_map as jax_solution_map,
    solve_u as jax_solve_u,
)
from direct_data_driven_mpc_tpu.qp.spec import (  # noqa: E402
    DataDrivenMPCType as JaxType,
    SlackVarConstraintTypes as JaxSlack,
)
from direct_data_driven_mpc_tpu_torch.control.loop import (  # noqa: E402
    closed_loop_rollout,
)
from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp import distributed as qd  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp import spec as ps  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp.solution_map import (  # noqa: E402
    compute_solution_map,
)

from tests import _torch_dist_bodies as bodies  # noqa: E402
from tests._torch_dist import run_ranks  # noqa: E402
from tests.test_qp import _small_problem  # noqa: E402
from tests.test_torch_iterative import one_blas_thread  # noqa: E402,F401

MESH = (2, 2)  # (data, model): 23 alpha columns padded to 24
F64 = torch.float64
# test_distributed_minres_matches_direct's cases: name -> (type,
# terminal constraint, tol, atol on u against the exact map).
CASES = {
    "robust_terminal": (JaxType.ROBUST, True, 1e-8, 1e-6),
    "robust_free": (JaxType.ROBUST, False, 1e-8, 1e-6),
    # NOMINAL: singular (but consistent) KKT; near-null-space modes make
    # the u error ~1e3x the residual, so the tolerance is driven deeper.
    "nominal_terminal": (JaxType.NOMINAL, True, 1e-11, 1e-5),
}
# Iterations against JAX's: the two recurrences agree to 1e-15 at first
# and drift apart through rounding (summation orders differ), so the exit
# moves by an iteration or two.
ITERS = 2
PLANT = dict(A=np.array([[0.9, 0.2], [0.0, 0.8]]), B=np.array([[0.0], [1.0]]),
             C=np.array([[1.0, 0.3]]), D=np.array([[0.1]]))
LOOP_B, LOOP_T = 4, 12


def port_spec(jspec):
    """The JAX package's QPSpec as the port's, field by field (numpy
    arrays shared, enums by name)."""
    fields = {f.name: getattr(jspec, f.name)
              for f in dataclasses.fields(jspec)}
    fields["dims"] = ps.QPDims(**dataclasses.asdict(jspec.dims))
    fields["controller_type"] = ps.DataDrivenMPCType[
        jspec.controller_type.name]
    fields["slack_var_constraint_type"] = ps.SlackVarConstraintTypes[
        jspec.slack_var_constraint_type.name]
    return ps.QPSpec(**fields)


@pytest.fixture(scope="module")
def problems():
    out = {name: _small_problem(ctype, use_terminal=term)
           for name, (ctype, term, _, _) in CASES.items()}
    out["convex"] = _small_problem(slack=JaxSlack.CONVEX)
    return out


@pytest.fixture(scope="module")
def loop_inputs(problems):
    spec, theta = problems["robust_terminal"]
    rng = np.random.default_rng(0)
    n = 2
    x0s = rng.normal(size=(LOOP_B, n)) * 0.1
    ups = np.tile(theta[:n].reshape(1, n, 1), (LOOP_B, 1, 1))
    yps = np.tile(theta[n:].reshape(1, n, 1), (LOOP_B, 1, 1))
    Ws = 0.002 * rng.uniform(-1, 1, (LOOP_B, LOOP_T, 1))
    return [torch.as_tensor(a, dtype=F64) for a in (x0s, ups, yps, Ws)]


@pytest.fixture(scope="module")
def ranks(problems, loop_inputs, tmp_path_factory):
    """The port's outputs from every rank (one spawn for the file)."""
    robust = port_spec(problems["robust_terminal"][0])
    theta = problems["robust_terminal"][1]
    solves = {
        name: (port_spec(problems[name][0]), problems[name][1], MESH,
               dict(dtype=F64, tol=tol))
        for name, (_, _, tol, _) in CASES.items()
    }
    solves.update({
        "f32": (robust, theta, MESH, dict(dtype=torch.float32)),
        "f32_refine": (robust, theta, MESH,
                       dict(dtype=torch.float32, refine=1)),
        "no_precondition": (robust, theta, MESH,
                            dict(dtype=F64, max_iters=20000,
                                 precondition=False)),
        "tol_1e-4": (robust, theta, MESH, dict(dtype=F64, tol=1e-4)),
        "tol_1e-10": (robust, theta, MESH, dict(dtype=F64, tol=1e-10)),
    })
    case = dict(
        leaves=(robust, MESH),
        solves=solves,
        loop=dict(mesh=MESH, plant=LTIParams(**PLANT), spec=robust,
                  T=LOOP_T, inputs=loop_inputs,
                  kw=dict(dtype=F64, tol=1e-9)),
        convex=port_spec(problems["convex"][0]),
    )
    return run_ranks(bodies.minres_cases, 4, tmp_path_factory.mktemp("qd"),
                     case, timeout=240)


def _exact_u(jspec, theta):
    sol = jax_solution_map(jspec, dtype=jnp.float64)
    return np.asarray(jax_solve_u(sol, jnp.asarray(theta)))


def test_every_rank_solves_alike(ranks):
    """Each rank ends with the same replicated blocks: the exit decision
    reads only all-reduced quantities, so the ranks of a model group run
    the same iterations (and both data replicas solve the same theta)."""
    for key in ranks[0]:
        if key.startswith("loop/"):
            continue
        for out in ranks[1:]:
            np.testing.assert_array_equal(out[key], ranks[0][key],
                                          err_msg=key)


def test_extract_blocks_and_jacobi_match_jax(problems):
    for name in CASES:
        jspec, _ = problems[name]
        spec = port_spec(jspec)
        for got, want in zip(qd._extract_blocks(spec),
                             jqd._extract_blocks(jspec)):
            np.testing.assert_array_equal(got, want)
        robust = spec.controller_type == ps.DataDrivenMPCType.ROBUST
        for got, want in zip(qd._jacobi_diag(spec, robust),
                             jqd._jacobi_diag(jspec, robust)):
            np.testing.assert_array_equal(got, want)


def test_build_sharded_kkt_leaves_match_jax(problems, ranks):
    """The whole padded leaves (23 alpha columns to 24 on a model dim of
    2, as on JAX's 4) bit-equal to JAX's in float64, preconditioner 1 on
    the padded lane."""
    jspec, _ = problems["robust_terminal"]
    jop, jmeta = jqd.build_sharded_kkt(jspec, jax_mesh(2, 4),
                                       dtype=jnp.float64)
    assert int(ranks[0]["leaves/n_alpha_pad"]) == jmeta["n_alpha_pad"] == 24
    for field, want in zip(jop._fields, jop):
        np.testing.assert_array_equal(ranks[0][f"leaves/{field}"],
                                      np.asarray(want), err_msg=field)
    assert ranks[0]["leaves/pc_alpha"][-1] == 1.0
    assert not ranks[0]["leaves/Hu"][:, -1].any()


@pytest.mark.parametrize("name", list(CASES))
def test_distributed_minres_matches_direct_and_jax(problems, ranks, name):
    """The three cases of tests/test_distributed_qp.py: the port's u
    within the case's atol of the exact map and of JAX's solver, its true
    residual below 1e-7, its iterations beside JAX's."""
    _, _, tol, atol = CASES[name]
    jspec, theta = problems[name]
    ju, jres, jiters = jqd.make_distributed_kkt_solver(
        jspec, jax_mesh(2, 4), axis="model", dtype=jnp.float64, tol=tol
    )(theta)
    u, res, iters = (ranks[0][f"{name}/{k}"] for k in ("u", "res", "iters"))
    assert float(res) < 1e-7, f"MINRES residual {float(res)}"
    assert int(iters) < 1000  # the early exit fired
    np.testing.assert_allclose(u, _exact_u(jspec, theta), atol=atol)
    np.testing.assert_allclose(u, np.asarray(ju), atol=atol)
    assert abs(int(iters) - int(jiters)) <= ITERS, (iters, jiters)


def test_refinement_restart_beats_f32_floor(problems, ranks):
    """One refinement restart cuts both the true residual and the
    solution error of the float32 solve, to under 1e-4 against the exact
    map, and its iterations count the restart's."""
    jspec, theta = problems["robust_terminal"]
    u_exact = _exact_u(jspec, theta)
    out = {}
    for name in ("f32", "f32_refine"):
        o = ranks[0]
        out[name] = (float(o[f"{name}/res"]),
                     float(np.abs(o[f"{name}/u"] - u_exact).max()),
                     int(o[f"{name}/iters"]))
    (res0, du0, it0), (res1, du1, it1) = out["f32"], out["f32_refine"]
    assert res1 < res0 and du1 < du0, out
    assert du1 < 1e-4, out
    assert it1 > it0, out


def test_preconditioner_cuts_iterations(ranks):
    o = ranks[0]
    assert float(o["no_precondition/res"]) < 1e-7
    assert int(o["robust_terminal/iters"]) < int(o["no_precondition/iters"])


def test_tolerance_controls_early_exit(ranks):
    o = ranks[0]
    assert int(o["tol_1e-4/iters"]) < int(o["tol_1e-10/iters"])
    assert float(o["tol_1e-10/res"]) < 1e-9


def test_distributed_closed_loop_matches_exact_engine(problems, ranks,
                                                      loop_inputs):
    """Scenarios over data, alpha over model, against the generic loop
    with the exact map in float64: u and costs within 1e-7, every solve
    converged (test_distributed_closed_loop_matches_direct_engine)."""
    jspec, _ = problems["robust_terminal"]
    sol = compute_solution_map(port_spec(jspec), device="cpu", dtype=F64)
    ref = closed_loop_rollout(LTIParams(**PLANT), sol, *loop_inputs,
                              n_steps=LOOP_T)
    half = LOOP_B // MESH[0]
    for field in ("u_sys", "costs", "y_sys"):
        # ranks 0 and 2 hold data shards 0 and 1 (model coordinate 0)
        got = np.concatenate([ranks[0][f"loop/{field}"],
                              ranks[2][f"loop/{field}"]])
        np.testing.assert_allclose(got, getattr(ref, field).numpy(),
                                   atol=1e-7, rtol=1e-7, err_msg=field)
    assert ranks[0]["loop/u_sys"].shape == (half, LOOP_T, 1)
    for r in (0, 1, 2, 3):
        assert ranks[r]["loop/converged"].all()
    np.testing.assert_array_equal(ranks[1]["loop/u_sys"],
                                  ranks[0]["loop/u_sys"])


def test_distributed_rejects_convex_slack(problems, ranks):
    assert bool(ranks[0]["convex_refused"])
    with pytest.raises(ValueError, match="slack-NONE"):
        qd._extract_blocks(port_spec(problems["convex"][0]))
