"""PyTorch port at the seven random shapes of tests/test_random_dims.py:
its float64 engines (host loop, generic loop, condensed engine,
time-parallel scan) against the JAX host loop, and the plain versions of
kernels K1, K3, K4 and K5 against the JAX package, on the same numpy
data, made from each case's seed, and on the same injected noise. The
shapes reach m and p of 1 to 3, ns != n, n_mpc_step of 1 to 5 with a
trimmed last block, NOMINAL and UCON; the CUDA kernels themselves are
held to these plain versions at the same shapes in
tests/test_torch_cuda.py and ``chip_smoke.py`` phase 46, on a card."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from direct_data_driven_mpc_tpu.control import linear_engine as jle  # noqa: E402
from direct_data_driven_mpc_tpu.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController as JaxController,
)
from direct_data_driven_mpc_tpu.control.operation import (  # noqa: E402
    simulate_data_driven_mpc_control_loop as jax_host_loop,
)
from direct_data_driven_mpc_tpu.models import random_lti as jrl  # noqa: E402
from direct_data_driven_mpc_tpu.ops import pallas_admm as jpa  # noqa: E402
from direct_data_driven_mpc_tpu.ops import pallas_rollout as jpr  # noqa: E402
from direct_data_driven_mpc_tpu.qp.spec import (  # noqa: E402
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)
from direct_data_driven_mpc_tpu_torch.control import linear_engine as le  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control.loop import (  # noqa: E402
    closed_loop_rollout,
)
from direct_data_driven_mpc_tpu_torch.control.operation import (  # noqa: E402
    simulate_data_driven_mpc_control_loop,
)
from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp.admm import (  # noqa: E402
    compute_admm_operator_np,
)
from direct_data_driven_mpc_tpu_torch.qp.box import (  # noqa: E402
    compute_box_admm_operator_np,
)

from tests.test_torch_iterative import one_blas_thread  # noqa: E402,F401

CASES = [
    # (seed, ns, n, m, p, L, n_mpc_step, controller_type, use_terminal)
    (0, 3, 3, 1, 1, 8, 1, DataDrivenMPCType.ROBUST, True),
    (1, 5, 4, 2, 3, 9, 3, DataDrivenMPCType.ROBUST, True),
    (2, 2, 2, 3, 1, 6, 1, DataDrivenMPCType.NOMINAL, True),
    (3, 6, 5, 1, 2, 11, 5, DataDrivenMPCType.ROBUST, True),
    (4, 4, 3, 2, 2, 7, 2, DataDrivenMPCType.NOMINAL, True),
    # UCON: no terminal constraint (1-step and n-step cadence).
    (5, 4, 4, 2, 2, 9, 1, DataDrivenMPCType.ROBUST, False),
    (6, 3, 3, 1, 2, 8, 3, DataDrivenMPCType.ROBUST, False),
]
IDS = [f"case{c[0]}" for c in CASES]
ROBUST = [c for c in CASES if c[7] is DataDrivenMPCType.ROBUST]
F64_ATOL = 1e-8  # tests/test_random_dims.py's engines
F32_ATOL = 1e-4  # its float32 kernel
COST_RTOL, COST_ATOL = 1e-3, 1e-5
POST_COST_TOL = dict(rtol=1e-3, atol=1e-2)  # test_torch_post_cost.py
#: The ADMM engines' bar against the JAX twin
#: (tests/test_torch_fused_admm.py, tests/test_torch_fused_ladder.py).
DU, ADMM_COST_RTOL, ADMM_COST_ATOL = 1e-4, 5e-3, 1e-3
CONVEX_KW = dict(iters=(4, 5, 2), cold_iters=24, tol=1e-5)
BOX_KW = dict(iters=(0, 16, 4), cold_iters=80, tol=2e-5)
B = 2  # scenarios in the batched checks: the case's noise and another


def _case(case):
    """The shape as ``chip_smoke.RANDOM_DIMS`` lists it."""
    return case[:7] + (case[7].name, case[8])


@functools.lru_cache(maxsize=None)
def _setup(seed):
    """One case's data, the JAX host loop's run on it (float64) and the
    closed loop's initial windows and noise: the port's plant and the JAX
    package's hold the same matrices (tests/test_torch_post_cost.py), and
    both controllers are built from the same numpy arrays."""
    case = CASES[seed]
    _, ns, n, m, p, L, nb, ctype, _ = case
    plant, kw, rng = cs.random_dims_data(_case(case))
    jplant = jrl.random_stable_lti(seed=seed, ns=ns, m=m, p=p,
                                   spectral_radius=0.85)
    jplant.set_state(plant.get_state().copy())
    jctrl = JaxController(
        **kw, slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=ctype,
    )
    n_steps = 3 * nb + 1  # non-multiple: exercises trimming
    w_sys = 0.002 * rng.uniform(-1, 1, (n_steps, p))
    x0 = plant.get_state().copy()
    up = jctrl.u_past.reshape(n, m).copy()
    yp = jctrl.y_past.reshape(n, p).copy()
    u_host, y_host = jax_host_loop(jplant, jctrl, n_steps, rng, verbose=0,
                                   w_sys=w_sys)
    W = np.stack([w_sys, 0.002 * rng.uniform(-1, 1, (n_steps, p))])
    batch = [np.tile(a[None], (B,) + (1,) * a.ndim) for a in (x0, up, yp)]
    return dict(case=case, n_steps=n_steps, w_sys=w_sys, x0=x0, up=up,
                yp=yp, u_host=u_host, y_host=y_host, inputs=batch + [W])


def _t(arrays, dtype=torch.float32):
    return [torch.as_tensor(a, dtype=dtype) for a in arrays]


def _main_K(case):
    """The port's solves per block at T = 400, as phase 46 runs it."""
    _, ns, n, m, p, _, nb, _, _ = case
    return fr.suggest_solves_per_block(ns, n, m, p, n_mpc_step=nb,
                                       n_steps=cs.T_MAIN)


@functools.lru_cache(maxsize=None)
def _float64_batch(seed):
    """The port's float64 condensed engine on the batch: the truth the
    float32 paths' costs are held to."""
    s = _setup(seed)
    plant, ctrl = cs.build_random_dims(_case(s["case"]))
    bm64 = le.build_linear_engine(ctrl, plant.as_params(),
                                  solves_per_block=2, device="cpu",
                                  dtype=torch.float64)
    return le.make_linear_batched_rollout(
        bm64, s["n_steps"], n_mpc_step=ctrl.n_mpc_step
    )(*_t(s["inputs"], torch.float64))


def test_cases_are_the_jax_tests_and_the_cards():
    """The seven shapes here are tests/test_random_dims.py's, and the
    card's (``chip_smoke.RANDOM_DIMS``) are the same."""
    from tests.test_random_dims import CASES as jax_cases

    assert CASES == jax_cases
    assert cs.RANDOM_DIMS == tuple(_case(c) for c in CASES)


@pytest.mark.parametrize("seed", range(len(CASES)), ids=IDS)
def test_float64_engines_match_jax_host_loop(seed):
    """The port's host loop, generic loop, condensed engine and
    time-parallel scan, in float64, against the JAX host loop at the JAX
    test's 1e-8; the per-solve costs of the three batched engines agree
    at 1e-7."""
    s = _setup(seed)
    n_steps, w_sys = s["n_steps"], s["w_sys"]
    plant, ctrl = cs.build_random_dims(_case(s["case"]))
    nb = ctrl.n_mpc_step
    u_loop, y_loop = simulate_data_driven_mpc_control_loop(
        plant, ctrl, n_steps, np.random.default_rng(0), verbose=0,
        w_sys=w_sys,
    )
    plant, ctrl = cs.build_random_dims(_case(s["case"]))
    x0, up, yp, W = _t((s["x0"], s["up"], s["yp"], w_sys), torch.float64)
    generic = closed_loop_rollout(
        plant.as_params(), ctrl.solution_map(device="cpu",
                                             dtype=torch.float64),
        x0[None], up[None], yp[None], W[None], n_steps=n_steps,
        n_mpc_step=nb,
    )
    bm = le.build_linear_engine(ctrl, plant.as_params(), solves_per_block=2,
                                device="cpu", dtype=torch.float64)
    linear = le.linear_closed_loop_rollout(bm, x0, up, yp, W=W,
                                           n_steps=n_steps, n_mpc_step=nb)
    time_par = le.time_parallel_rollout(bm, x0, up, yp, W, n_steps=n_steps,
                                        n_mpc_step=nb)
    for name, u, y in (
        ("host loop", u_loop, y_loop),
        ("generic loop", generic.u_sys[0], generic.y_sys[0]),
        ("condensed engine", linear.u_sys, linear.y_sys),
        ("time-parallel scan", time_par.u_sys, time_par.y_sys),
    ):
        np.testing.assert_allclose(np.asarray(u), s["u_host"], rtol=0,
                                   atol=F64_ATOL, err_msg=name)
        np.testing.assert_allclose(np.asarray(y), s["y_host"], rtol=0,
                                   atol=F64_ATOL, err_msg=name)
    for res in (linear, time_par):
        torch.testing.assert_close(res.costs, generic.costs[0], rtol=1e-7,
                                   atol=1e-7)


@pytest.mark.parametrize("K", ["2", "main"])
@pytest.mark.parametrize("seed", range(len(CASES)), ids=IDS)
def test_k1_plain_version_matches_jax_host_loop(seed, K):
    """K1's plain version (float32) at K = 2 and at the main path's K:
    u and y within 1e-4 of the JAX host loop, as the JAX test holds its
    Pallas kernel; the costs at rtol 1e-3 / atol 1e-5 of the port's
    float64 condensed engine."""
    s = _setup(seed)
    plant, ctrl = cs.build_random_dims(_case(s["case"]))
    K = 2 if K == "2" else _main_K(s["case"])
    bm = le.build_linear_engine(ctrl, plant.as_params(), solves_per_block=K,
                                device="cpu")
    res = fr.make_fused_batched_rollout(
        bm, s["n_steps"], n_mpc_step=ctrl.n_mpc_step,
        rollout=fr.fused_rollout_reference,
    )(*_t(s["inputs"]))
    np.testing.assert_allclose(res.u_sys[0].numpy(), s["u_host"], rtol=0,
                               atol=F32_ATOL)
    np.testing.assert_allclose(res.y_sys[0].numpy(), s["y_host"], rtol=0,
                               atol=F32_ATOL)
    truth = _float64_batch(seed)
    torch.testing.assert_close(res.u_sys.double(), truth.u_sys, rtol=0,
                               atol=F32_ATOL)
    torch.testing.assert_close(res.costs.double(), truth.costs,
                               rtol=COST_RTOL, atol=COST_ATOL)


@pytest.mark.parametrize("seed", range(len(CASES)), ids=IDS)
def test_k3_plain_version_matches_jax(seed):
    """K3's plain version (``cost_mode="post"``) at the main path's K: u
    and y within 1e-4 of the JAX host loop; its post-pass costs against
    the JAX package's ``_make_post_cost_fn`` on the same trajectories, at
    test_torch_post_cost.py's bar."""
    s = _setup(seed)
    case = s["case"]
    _, _, n, m, p, _, nb, _, _ = case
    plant, ctrl = cs.build_random_dims(_case(case))
    K = _main_K(case)
    bm = le.build_linear_engine(ctrl, plant.as_params(), solves_per_block=K,
                                device="cpu")
    res = fr.make_fused_batched_rollout(
        bm, s["n_steps"], n_mpc_step=nb, cost_mode="post",
        rollout=fr.fused_rollout_reference,
    )(*_t(s["inputs"]))
    np.testing.assert_allclose(res.u_sys[0].numpy(), s["u_host"], rtol=0,
                               atol=F32_ATOL)
    np.testing.assert_allclose(res.y_sys[0].numpy(), s["y_host"], rtol=0,
                               atol=F32_ATOL)
    jplant = jrl.random_stable_lti(seed=seed, ns=case[1], m=m, p=p,
                                   spectral_radius=0.85)
    jctrl = JaxController(
        **cs.random_dims_data(_case(case))[1],
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=case[7],
    )
    jbm = jle.build_linear_engine(jctrl, jplant.as_params(dtype=np.float32),
                                  solves_per_block=K, dtype=jnp.float32)
    ins = s["inputs"]
    want = jpr._make_post_cost_fn(jbm, nb)(
        *(jnp.asarray(a, jnp.float32) for a in (
            ins[1], ins[2], res.u_sys.numpy(), res.y_sys.numpy()))
    )
    np.testing.assert_allclose(res.costs.numpy(), np.asarray(want),
                               **POST_COST_TOL)
    assert res.costs.shape == (B, -(-s["n_steps"] // nb))


def _jax_plant32(case):
    _, ns, _, m, p, _, _, _, _ = case
    jplant = jrl.random_stable_lti(seed=case[0], ns=ns, m=m, p=p,
                                   spectral_radius=0.85)
    return LTIParams(*(jnp.asarray(a, jnp.float32)
                       for a in jplant.as_params()))


def _assert_admm_matches_twin(res, ref, nb, n_steps):
    assert res.u_sys.shape == np.asarray(ref.u_sys).shape
    assert res.costs.shape == (B, -(-n_steps // nb))
    for field in ("u_sys", "y_sys"):
        np.testing.assert_allclose(
            getattr(res, field).numpy(), np.asarray(getattr(ref, field)),
            rtol=0, atol=DU, err_msg=field,
        )
    np.testing.assert_allclose(res.costs.numpy(), np.asarray(ref.costs),
                               rtol=ADMM_COST_RTOL, atol=ADMM_COST_ATOL)


@pytest.mark.parametrize("seed", [c[0] for c in ROBUST],
                         ids=[f"case{c[0]}" for c in ROBUST])
def test_k4_plain_version_matches_jax_twin(seed):
    """K4's plain version on the ROBUST shapes, the controller rebuilt
    with CONVEX slack, against the JAX twin (``backend="xla"``, one
    scenario per row) on the same numpy inputs: u and y within 1e-4,
    costs rtol 5e-3 / atol 1e-3."""
    s = _setup(seed)
    case = s["case"]
    _, _, n, m, p, _, nb, _, _ = case
    plant, ctrl = cs.build_random_dims(_case(case), slack="CONVEX")
    op = compute_admm_operator_np(ctrl.spec)
    T, ins = s["n_steps"], s["inputs"]
    res = fa.make_fused_admm_rollout(
        plant.as_params(), op, n, m, p, T, n_mpc_step=nb, device="cpu",
        rollout=fa.fused_admm_reference, **CONVEX_KW,
    )(*_t(ins))
    ref = jpa.make_fused_admm_rollout(
        _jax_plant32(case), op, n=n, m=m, p=p, n_steps=T, n_mpc_step=nb,
        q=1, backend="xla", **CONVEX_KW,
    )(*(jnp.asarray(a, jnp.float32) for a in ins))
    _assert_admm_matches_twin(res, ref, nb, T)
    np.testing.assert_allclose(res.solver_state.s.numpy(),
                               np.asarray(ref.solver_state.s), rtol=0,
                               atol=DU)


def _jax_ladder(case, op, T, ins):
    """The JAX ladder twin on the same numpy inputs (float32, one
    scenario per row), with its per-solve rung lanes read from the
    engine's output tile."""
    _, _, n, m, p, _, nb, _, _ = case
    store = {}
    orig = jpa._make_ladder_twin

    def spy(*a, **k):
        engine = orig(*a, **k)

        def run(*args):
            out = engine(*args)
            store["OUT"] = np.asarray(out[0])
            return out

        return run

    mp = pytest.MonkeyPatch()
    mp.setattr(jpa, "_make_ladder_twin", spy)
    try:
        res = jpa.make_fused_ladder_rollout(
            _jax_plant32(case), op, n=n, m=m, p=p, n_steps=T, n_mpc_step=nb,
            q=1, backend="xla", **BOX_KW,
        )(*(jnp.asarray(a, jnp.float32) for a in ins))
    finally:
        mp.undo()
    # OUT (n_blocks, nb (m + p) + 4, B) at q = 1: the rung lane is last.
    return res, store["OUT"][:, -1].T.astype(np.int32)


#: Where the JAX twin's rung lanes leave the float64 path. At case 0 the
#: twin (bf16 3-pass iterations) keeps rung 3 after the first solve,
#: where the port's float64 and float32 plain versions both move down to
#: 2 (lanes 3, 2, 1, 0 against 2, 1, 0, 0; measured on the CPU); u
#: stays within 2e-7 of float64 on both. There the port's lanes are held
#: to its float64 run.
TWIN_RUNGS_OFF_FLOAT64 = {0}


@pytest.mark.parametrize("seed", range(len(CASES)), ids=IDS)
def test_k5_plain_version_matches_jax_twin(seed):
    """K5's plain version on every shape, on the box |u| <= 0.85 of the
    default 7-rung ladder, with one rung group over the batch, as the JAX
    twin shares one rung: u and y within 1e-4 of the twin, costs rtol
    5e-3 / atol 1e-3, the box respected; the rung lanes and the final
    rungs equal to the port's float64 run, and to the twin's except
    where the twin leaves the float64 path (``TWIN_RUNGS_OFF_FLOAT64``).
    The converged fraction is not asserted (the reference does not
    converge on every first solve)."""
    s = _setup(seed)
    case = s["case"]
    _, _, n, m, p, _, nb, _, _ = case
    plant, ctrl = cs.build_random_dims(_case(case))
    op = compute_box_admm_operator_np(
        ctrl.spec, u_bounds=(-cs.RANDOM_DIMS_BOX, cs.RANDOM_DIMS_BOX)
    )
    T, ins = s["n_steps"], s["inputs"]
    lanes, res = {}, {}
    for dtype in (torch.float32, torch.float64):
        def keep(*args):
            out = fl.fused_ladder_reference(*args)
            lanes[dtype] = out[5]
            return out

        res[dtype] = fl.make_fused_ladder_rollout(
            plant.as_params(), op, n, m, p, T, n_mpc_step=nb, device="cpu",
            dtype=dtype, rung_group=B, rollout=keep, **BOX_KW,
        )(*_t(ins, dtype))
    got = res[torch.float32]
    assert torch.equal(lanes[torch.float32], lanes[torch.float64])
    assert torch.equal(got.solver_state.rho_idx,
                       res[torch.float64].solver_state.rho_idx)
    ref, ref_rung = _jax_ladder(case, op, T, ins)
    twin_on_path = np.array_equal(lanes[torch.float64].numpy(), ref_rung)
    assert twin_on_path == (seed not in TWIN_RUNGS_OFF_FLOAT64)
    if twin_on_path:
        np.testing.assert_array_equal(
            got.solver_state.rho_idx.numpy(),
            np.asarray(ref.solver_state.rho_idx),
        )
    _assert_admm_matches_twin(got, ref, nb, T)
    assert float(got.u_sys.abs().max()) <= cs.RANDOM_DIMS_BOX + 1e-6
