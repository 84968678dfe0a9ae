"""PyTorch port, the fused rollout with ``cost_mode="post"`` (the path of
kernel K3): the random plant of ``large_plant``, the operator without
cost columns, the cost post-pass and the batched entry points, held
against the JAX package; and the port's device rule (entry points run
on the card unless told otherwise). The CUDA kernel itself is tested
against the plain version in tests/test_torch_cuda.py, on a card."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from direct_data_driven_mpc_tpu.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController as JaxController,
)
from direct_data_driven_mpc_tpu.control.linear_engine import (  # noqa: E402
    build_affine_block_map as jax_build_affine_block_map,
)
from direct_data_driven_mpc_tpu.models import random_lti as jrl  # noqa: E402
from direct_data_driven_mpc_tpu.qp import spec as jspec  # noqa: E402
from direct_data_driven_mpc_tpu.ops import pallas_rollout as jpr  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control import linear_engine as le  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control.linear_engine import (  # noqa: E402
    AffineBlockMap,
    block_map_from_numpy,
)
from direct_data_driven_mpc_tpu_torch.models.random_lti import (  # noqa: E402
    random_stable_lti,
)
from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp.spec import (  # noqa: E402
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

from tests.test_pallas_rollout import _make_setup  # noqa: E402

B = 4


def _t(arrays, dtype=torch.float32):
    return [torch.as_tensor(a, dtype=dtype) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


def _inputs(plant, ctrl, n_steps, rng, batch=B):
    n, m, p = ctrl.n, ctrl.m, ctrl.p
    return (
        np.tile(plant.get_state()[None], (batch, 1)),
        np.tile(ctrl.u_past.reshape(1, n, m), (batch, 1, 1)),
        np.tile(ctrl.y_past.reshape(1, n, p), (batch, 1, 1)),
        plant.get_eps_max() * rng.uniform(-1, 1, (batch, n_steps, p)),
    )


def _four_tank(n_mpc_step, K=4):
    """tests/test_pallas_rollout.py's setup and its float32 block map in
    both packages (the port's carried from the JAX one)."""
    plant, ctrl, rng = _make_setup(n_mpc_step=n_mpc_step)
    jbm = jax_build_affine_block_map(
        plant.as_params(dtype=np.float32), ctrl._op, n=4, m=2, p=2,
        n_mpc_step=n_mpc_step, solves_per_block=K, dtype=jnp.float32,
    )
    bm = block_map_from_numpy(
        {k: getattr(jbm, k) for k in AffineBlockMap._fields}, "cpu"
    )
    return plant, ctrl, rng, jbm, bm


@pytest.mark.parametrize("seed,dims", [(0, (10, 10, 10)), (3, (5, 2, 3))])
def test_random_stable_lti_matches_jax(seed, dims):
    got = random_stable_lti(seed, *dims)
    want = jrl.random_stable_lti(seed, *dims)
    for k in "ABCD":
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.get_eps_max() == want.get_eps_max()
    assert max(abs(np.linalg.eigvals(got.A))) < 1.0


def test_nocost_operator_is_the_first_columns():
    """Without cost columns the operator is exactly the first ``S + Ku +
    Kp`` columns of the full one, and equals the JAX operator's unpadded
    ``[s_next | u | y]`` groups."""
    _, _, _, jbm, bm = _four_tank(1)
    full = fr._build_fused_operator(bm)
    op = fr._build_fused_operator(bm, include_cost=False)
    width = op.S + op.Ku + op.Kp
    assert (op.K, op.rank) == (0, 0) and op.G.shape == (op.nw + op.S, width)
    assert torch.equal(op.G, full.G[:, :width])
    assert torch.equal(op.bias, full.bias[:width])
    G, bias, _, dims = jpr._build_fused_operator(jbm, include_cost=False)
    G, bias = np.asarray(G), np.asarray(bias)
    starts = np.cumsum([0] + dims["widths"])
    for i, (lo, w) in enumerate(((0, op.S), (op.S, op.Ku),
                                 (op.S + op.Ku, op.Kp))):
        np.testing.assert_array_equal(
            op.G[:, lo : lo + w].numpy(), G[:, starts[i] : starts[i] + w]
        )
        np.testing.assert_array_equal(
            op.bias[lo : lo + w].numpy(), bias[starts[i] : starts[i] + w]
        )
    truncated = fr._build_fused_operator(bm, cost_rank_rtol=1e-2)
    assert truncated.rank < full.rank


@pytest.mark.parametrize("n_mpc_step,n_steps", [(1, 48), (4, 42)])
def test_post_matches_jax(n_mpc_step, n_steps):
    """``cost_mode="post"`` against the JAX XLA twin's post path
    (tests/test_pallas_rollout.py:153): u, y within atol 2e-5, costs rtol
    1e-3 / atol 1e-3; and against the port's in-kernel costs, with u and
    y bit-equal. Measured on the CPU: u and y bit-equal to JAX, costs
    within 9.6e-7."""
    plant, ctrl, rng, jbm, bm = _four_tank(n_mpc_step)
    inputs = _inputs(plant, ctrl, n_steps, rng)
    kw = dict(n_steps=n_steps, n_mpc_step=n_mpc_step)
    ref = jpr.pallas_batched_rollout(jbm, *_j(inputs), backend="xla",
                                     cost_mode="post", **kw)
    post = fr.pallas_batched_rollout(bm, *_t(inputs), cost_mode="post", **kw)
    ink = fr.pallas_batched_rollout(bm, *_t(inputs), **kw)
    for field in ("u_sys", "y_sys", "x_final"):
        np.testing.assert_allclose(
            getattr(post, field).numpy(), np.asarray(getattr(ref, field)),
            rtol=0, atol=2e-5, err_msg=field,
        )
        assert torch.equal(getattr(post, field), getattr(ink, field))
    assert post.costs.shape == (B, -(-n_steps // n_mpc_step))
    np.testing.assert_allclose(post.costs.numpy(), np.asarray(ref.costs),
                               rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(post.costs, ink.costs, rtol=1e-3, atol=1e-3)
    assert bool(post.converged.all())


def test_post_rejects_tracking_maps_and_unknown_modes():
    _, _, _, _, bm = _four_tank(1)
    with pytest.raises(ValueError, match="cost_mode"):
        fr.make_fused_batched_rollout(bm, 8, cost_mode="later")
    with pytest.raises(ValueError, match="cost_mode"):
        fr.make_amortized_run(bm, 8, cost_mode="")
    tracking = bm._replace(n_r=4)
    with pytest.raises(NotImplementedError, match="post"):
        fr.make_fused_batched_rollout(tracking, 8, cost_mode="post")


@pytest.mark.parametrize("K,plan", [
    (25, (64, 224256)), (28, (64, 232448)), (29, (32, 143616)),
    (50, (32, 170240)), (99, (32, 231680)), (100, (0, 233728)),
])
def test_nocost_plan_at_large_plant(K, plan):
    """K3's plan at large_plant (S = 210, nw = 10 K): 64 scenarios per
    block up to K = 28, where that plan fills the 232,448 bytes a block
    may hold exactly; 32 up to K = 99 (the reference ran K = 50); none
    beyond, where the wrapper raises before loading the library."""
    assert fr.nocost_plan(210, 10 * K) == plan


def test_nocost_cpu_tensors_take_plain_version():
    plant, ctrl, rng, _, bm = _four_tank(1)
    op = fr._build_fused_operator(bm, include_cost=False)
    x0s, ups, yps, Ws = _t(_inputs(plant, ctrl, 16, rng))
    s0, W = fr._center_and_pack(bm, x0s, ups, yps, Ws, 4, 4, 0)
    got = fr.fused_rollout(op, s0, W, w_off=1)
    want = fr.fused_rollout_reference(op, s0, W, w_off=1)
    assert fr.fused_rollout_nocost.launches == fr.fused_rollout.launches == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[2].shape == (B, 4, 0)
    with pytest.raises(ValueError, match="device"):
        fr.fused_rollout_nocost(op, s0.to("meta"), W.to("meta"))


def test_amortized_post_run_folds_every_repetition():
    """Every repetition's post-pass costs (all of them), final carry, U
    and Y fold into the checksum."""
    plant, ctrl, rng, _, bm = _four_tank(1)
    T, R = 16, 3
    args = _t(_inputs(plant, ctrl, T, rng))
    checksum, ok = fr.make_amortized_run(bm, T, cost_mode="post")(*args, R)
    run = fr.make_fused_batched_rollout(bm, T, cost_mode="post")
    want = 0.0
    for i in range(R):
        W = torch.roll(args[3].reshape(B, T // 4, -1), i, dims=1)
        r = run(*args[:3], W.reshape(B, T, 2))
        s_fin = torch.cat([r.x_final, r.u_past.reshape(B, -1),
                           r.y_past.reshape(B, -1)], 1) - bm.s_star
        want += float(r.costs.sum() + s_fin.sum() + r.u_sys.sum()
                      + r.y_sys.sum())
    assert bool(ok)
    assert abs(float(checksum) - want) <= 1e-4 * abs(want)


@functools.lru_cache(maxsize=1)
def _large_plant(K=25, N=600, L=30):
    """``bench.py``'s large_plant (seed 0) in both packages, from the
    same numpy data: the random 10 x 10 x 10 plant, N = 600, L = 30,
    ``u_s = 0.5``, ``y_s`` its equilibrium output (built once per
    process; the tests only read it)."""
    from direct_data_driven_mpc_tpu_torch.control.controller import (
        DirectDataDrivenMPCController,
    )

    n = m = p = 10
    plant = random_stable_lti(0, n, m, p)
    jplant = jrl.random_stable_lti(0, n, m, p)
    rng = np.random.default_rng(0)
    u_s = 0.5 * np.ones((m, 1))
    y_s = plant.get_equilibrium_output_from_input(u_s.ravel()).reshape(-1, 1)
    u_d = rng.uniform(-1, 1, (N, m))
    w_d = plant.get_eps_max() * rng.uniform(-1, 1, (N, p))
    y_d = plant.simulate(u_d, w_d, N)
    kw = dict(
        n=n, m=m, p=p, u_d=u_d, y_d=y_d, L=L, Q=3.0 * np.eye(p * L),
        R=1e-4 * np.eye(m * L), u_s=u_s, y_s=y_s, eps_max=0.002,
        lamb_alpha=0.1 / 0.002, lamb_sigma=1000.0, c=1.0, n_mpc_step=1,
    )
    ctrl = DirectDataDrivenMPCController(
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=DataDrivenMPCType.ROBUST, **kw,
    )
    jctrl = JaxController(
        slack_var_constraint_type=jspec.SlackVarConstraintTypes.NONE,
        controller_type=jspec.DataDrivenMPCType.ROBUST, **kw,
    )
    assert (ctrl.spec.nz, ctrl.spec.nc) == (1761, 1200)
    bm = le.build_linear_engine(ctrl, plant.as_params(), solves_per_block=K,
                                device="cpu")
    jbm = jax_build_affine_block_map(
        jplant.as_params(dtype=np.float32), jctrl.solution_operator(),
        n=n, m=m, p=p, solves_per_block=K, dtype=jnp.float32,
    )
    return plant, ctrl, bm, jbm


def test_large_plant_matches_jax():
    """The 10 x 10 x 10 plant at B = 4, T = 50, K = 25 (S = 210, 460
    operator rows). On the JAX block map, u, y and state are within
    1e-4 of the JAX post path: in its transient (|u| up to 7) every
    float32 path is 2e-5 to 3e-5 from float64 (measured on the CPU: JAX
    2.3e-5, the port 2.9e-5), so the two meet at the float64 bar, not at
    the four-tank's 2e-5. Costs, like JAX's, use the cost factor
    truncated at rtol 1e-6 (98 of 200 eigenvalues) and are held at rtol
    1e-3 / atol 1e-2: against JAX's post path (measured on the CPU:
    1.9e-3; 9.2e-4 on the same trajectories), against the port's own
    in-kernel costs at the same truncation (3.1e-3) and against float64
    (5.7e-3). In float64 the post-pass equals the truncated in-kernel
    costs to 1.3e-11."""
    plant, ctrl, bm, jbm = _large_plant()
    T = 50
    inputs = _inputs(plant, ctrl, T, np.random.default_rng(5))
    carried = block_map_from_numpy(
        {k: getattr(jbm, k) for k in AffineBlockMap._fields}, "cpu"
    )
    got = fr.make_fused_batched_rollout(carried, T, cost_mode="post")(
        *_t(inputs)
    )
    ref = jpr.pallas_batched_rollout(jbm, *_j(inputs), n_steps=T,
                                     backend="xla", cost_mode="post")
    for field in ("u_sys", "y_sys", "x_final"):
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(ref, field)),
            rtol=0, atol=1e-4, err_msg=field,
        )
    cost_tol = dict(rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(ref.costs),
                               **cost_tol)
    same_traj = jpr._make_post_cost_fn(jbm, 1)(
        *_j(inputs[1:3]), *_j((got.u_sys.numpy(), got.y_sys.numpy()))
    )
    np.testing.assert_allclose(
        fr._make_post_cost_fn(carried, 1)(
            *_t(inputs[1:3]), got.u_sys, got.y_sys
        ).numpy(), np.asarray(same_traj), **cost_tol,
    )
    post = fr.make_fused_batched_rollout(bm, T, cost_mode="post")(
        *_t(inputs)
    )
    ink = fr.make_fused_batched_rollout(bm, T, cost_rank_rtol=1e-6)(
        *_t(inputs)
    )
    assert torch.equal(post.u_sys, ink.u_sys)
    torch.testing.assert_close(post.costs, ink.costs, **cost_tol)
    bm64 = le.build_linear_engine(ctrl, plant.as_params(),
                                  solves_per_block=25, device="cpu",
                                  dtype=torch.float64)
    res64 = fr.make_fused_batched_rollout(bm64, T, cost_rank_rtol=1e-6)(
        *_t(inputs, torch.float64)
    )
    assert float((post.u_sys.double() - res64.u_sys).abs().max()) < 1e-4
    torch.testing.assert_close(post.costs.double(), res64.costs, **cost_tol)
    post64 = fr._make_post_cost_fn(bm64, 1)(
        *_t(inputs[1:3], torch.float64), res64.u_sys, res64.y_sys
    )
    torch.testing.assert_close(post64, res64.costs, rtol=0, atol=1e-8)
    assert bool(post.converged.all())


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) as cvt.rna.tf32.f32 rounds a
    finite float32: to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32x3_rollout(op, s0, W, w_off=0):
    """Kernel K3's arithmetic in plain PyTorch: each operand split into
    hi = tf32(x) and lo = tf32(x - hi); per 16 rows of G (one ring tile)
    the products a_lo b_hi, a_hi b_lo and a_hi b_hi summed from zero,
    then added to the float32 accumulator."""
    Bsz, n_outer, _ = W.shape
    S, Ku = op.S, op.Ku
    G_hi = _tf32(op.G)
    G_lo = _tf32(op.G - G_hi)
    U = torch.empty((Bsz, n_outer, Ku))
    Y = torch.empty((Bsz, n_outer, op.Kp))
    s = s0
    for t in range(n_outer):
        sw = torch.cat([W[:, (t + w_off) % n_outer], s], dim=1)
        a_hi = _tf32(sw)
        a_lo = _tf32(sw - a_hi)
        out = torch.zeros((Bsz, op.G.shape[1]))
        for k in range(0, sw.shape[1], 16):
            rows = slice(k, k + 16)
            out += (a_lo[:, rows] @ G_hi[rows] + a_hi[:, rows] @ G_lo[rows]
                    + a_hi[:, rows] @ G_hi[rows])
        out += op.bias
        U[:, t] = out[:, S:S + Ku]
        Y[:, t] = out[:, S + Ku:]
        s = out[:, :S]
    return U, Y, torch.empty((Bsz, n_outer, 0)), s.contiguous()


def test_large_plant_tf32x3_meets_the_float64_bar():
    """The precision of kernel K3 (3xTF32 on the tensor cores), emulated
    on the CPU at large_plant (B = 4, T = 50): u, y and the final state
    within 1e-4 of float64 and of the JAX post path (measured on the
    CPU: u 1.8e-5 from float64, where the float32 plain version is at
    2.4e-5, and 2.9e-5 from JAX), and the split itself exact to 2^-21 of
    each operand."""
    plant, ctrl, bm, jbm = _large_plant()
    T = 50
    inputs = _inputs(plant, ctrl, T, np.random.default_rng(5))
    op = fr._build_fused_operator(bm, include_cost=False)
    hi = _tf32(op.G)
    lo = _tf32(op.G - hi)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF,
                       torch.zeros_like(hi, dtype=torch.int32))
    assert float(((hi + lo) - op.G).abs().max()) <= (
        2.0 ** -21 * float(op.G.abs().max()))
    got = fr.make_fused_batched_rollout(
        bm, T, cost_mode="post", rollout=_tf32x3_rollout
    )(*_t(inputs))
    bm64 = le.build_linear_engine(ctrl, plant.as_params(),
                                  solves_per_block=25, device="cpu",
                                  dtype=torch.float64)
    res64 = fr.make_fused_batched_rollout(bm64, T, cost_mode="post")(
        *_t(inputs, torch.float64)
    )
    ref = jpr.pallas_batched_rollout(jbm, *_j(inputs), n_steps=T,
                                     backend="xla", cost_mode="post")
    for field in ("u_sys", "y_sys", "x_final"):
        g = getattr(got, field).double()
        assert float((g - getattr(res64, field)).abs().max()) < 1e-4, field
        np.testing.assert_allclose(
            g.numpy(), np.asarray(getattr(ref, field)), rtol=0, atol=1e-4,
            err_msg=field,
        )
    assert bool(got.converged.all())


def test_cost_rank_rtol_matches_jax():
    """``cost_rank_rtol`` on the in-kernel path, as in
    tests/test_pallas_rollout.py::test_cost_rank_truncation_bounds: a
    factor cut to half its rank leaves u and y bit-equal and gives the
    JAX twin's truncated costs (rtol 1e-3 / atol 1e-3)."""
    plant, ctrl, rng, jbm, bm = _four_tank(1)
    evals = np.linalg.eigvalsh(np.asarray(jbm.cost_P, np.float64))
    rtol = float(evals[len(evals) // 2] / evals[-1]) * 1.01
    T = 24
    inputs = _inputs(plant, ctrl, T, rng)
    ref = jpr.make_fused_batched_rollout(jbm, T, backend="xla",
                                         cost_rank_rtol=rtol)(*_j(inputs))
    got = fr.make_fused_batched_rollout(bm, T, cost_rank_rtol=rtol)(
        *_t(inputs)
    )
    full = fr.make_fused_batched_rollout(bm, T)(*_t(inputs))
    assert torch.equal(got.u_sys, full.u_sys)
    assert torch.equal(got.y_sys, full.y_sys)
    assert not torch.equal(got.costs, full.costs)
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(ref.costs),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("entry", [
    "build_affine_block_map", "build_linear_engine",
    "build_fused_admm_operator", "make_fused_admm_rollout",
    "build_fused_ladder_operator", "make_fused_ladder_rollout",
])
def test_entry_points_run_on_the_card_by_default(monkeypatch, entry):
    """Without a device an entry point means the CUDA card: with none
    present it raises (naming ``device='cpu'``), never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from chip_smoke import admm_config

    plant, ctrl, op, _ = admm_config("four_tank_box")
    P = plant.as_params()
    if entry == "build_affine_block_map":
        call = (le.build_affine_block_map, P, ctrl.solution_operator(),
                4, 2, 2)
    elif entry == "build_linear_engine":
        call = (le.build_linear_engine, ctrl, P)
    elif entry.endswith("ladder_operator"):
        call = (fl.build_fused_ladder_operator, P, op, 4, 2, 2)
    elif entry == "make_fused_ladder_rollout":
        call = (fl.make_fused_ladder_rollout, P, op, 4, 2, 2, 8)
    else:
        call = (getattr(fa, entry), P, op, 4, 2, 2) + (
            (8,) if entry.startswith("make") else ()
        )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call[0](*call[1:])
