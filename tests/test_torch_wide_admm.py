"""PyTorch port, the constrained engines at ``bench.py``'s ``large_plant``
(``random_stable_lti(seed=0, ns=m=p=10)``, N = 600, L = 30, Robust),
where the resident plans of kernels K4 and K5 do not fit one block and
their wide bodies, K4w and K5w, run: the plain versions of K4 (CONVEX
slack, nbox 300) and K5 (the input box |u| <= 0.85 with the default
7-rung ladder, nbox 200) against the JAX package's XLA twins on the same
numpy inputs, the wide plans pinned, and the entry points at a wide
shape on the CPU. The CUDA kernels themselves are held to these plain
versions in tests/test_torch_cuda.py and ``chip_smoke.py`` phase 48, on
a card."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from direct_data_driven_mpc_tpu.ops import pallas_admm as jpa  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp.admm import (  # noqa: E402
    compute_admm_operator_np,
)
from direct_data_driven_mpc_tpu_torch.qp.box import (  # noqa: E402
    compute_box_admm_operator_np,
)

from tests.test_torch_iterative import one_blas_thread  # noqa: E402,F401

B, T = 2, 20
NOISE = 1e-3  # uniform noise bound of the closed loop's inputs
#: large_plant_convex's iterations (chip_smoke.WIDE_CONVEX_KW).
CONVEX_KW = dict(cs.WIDE_CONVEX_KW)
#: The ADMM engines' bar against the JAX twin
#: (tests/test_torch_fused_admm.py).
DU, COST_RTOL, COST_ATOL = 1e-4, 5e-3, 1e-3


@functools.lru_cache(maxsize=None)
def _large_plant(slack):
    """``large_plant`` with ``slack`` and its ADMM operator: CONVEX's
    (``compute_admm_operator_np``) or, for NONE, the box |u| <= 0.85
    with the default ladder. Built once per process."""
    plant, ctrl = cs.build_large_plant(slack=slack)
    if slack == "CONVEX":
        op = compute_admm_operator_np(ctrl.spec)
    else:
        op = compute_box_admm_operator_np(
            ctrl.spec, u_bounds=(-cs.WIDE_BOX, cs.WIDE_BOX))
    return plant, ctrl, op


def _inputs(plant, ctrl, seed=0):
    """B scenarios from a zero initial window, each with its own
    uniform noise of bound ``NOISE`` (numpy, ``seed``)."""
    rng = np.random.default_rng(seed)
    n, m, p = ctrl.n, ctrl.m, ctrl.p
    return [np.zeros((B, plant.get_system_order())), np.zeros((B, n, m)),
            np.zeros((B, n, p)), NOISE * rng.uniform(-1, 1, (B, T, p))]


def _t(arrays, dtype=torch.float32):
    return [torch.as_tensor(a, dtype=dtype) for a in arrays]


def _jax_plant32(plant):
    return LTIParams(*(jnp.asarray(a, jnp.float32)
                       for a in plant.as_params()))


def _jax_args(plant, ctrl, op):
    return (_jax_plant32(plant), op), dict(n=ctrl.n, m=ctrl.m, p=ctrl.p,
                                           n_steps=T, q=1, backend="xla")


def _dims(slack):
    plant, ctrl, op = _large_plant(slack)
    build = (fa.build_fused_admm_operator if slack == "CONVEX"
             else fl.build_fused_ladder_operator)
    return build(plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p,
                 device="cpu")[1]


def test_k4_plain_version_matches_jax_twin_at_large_plant():
    """K4's plain version at ``large_plant_convex`` (nbox 300, where only
    K4w runs on the card) against the JAX twin (``q=1``,
    ``backend="xla"``) on the same numpy inputs: u and y within 1e-4
    (measured 4.4e-5 and 2.8e-5), both converged on every solve. The
    twin forms its costs through its bf16 3-pass cost channel, which here
    errs by up to 4.3e-3 (measured; the port's float32 by 9.8e-4 against
    float64), so the costs are held to the port's float64 run at rtol
    5e-3 / atol 1e-3, and to the twin at atol 6e-3, as
    tests/test_torch_fused_admm.py holds them at L = 8 and 40."""
    plant, ctrl, op = _large_plant("CONVEX")
    ins = _inputs(plant, ctrl)
    res = fa.make_fused_admm_rollout(
        plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T, device="cpu",
        rollout=fa.fused_admm_reference, **CONVEX_KW,
    )(*_t(ins))
    a, kw = _jax_args(plant, ctrl, op)
    ref = jpa.make_fused_admm_rollout(*a, **kw, **CONVEX_KW)(
        *(jnp.asarray(x, jnp.float32) for x in ins))
    assert res.u_sys.shape == (B, T, ctrl.m)
    for field in ("u_sys", "y_sys"):
        np.testing.assert_allclose(
            getattr(res, field).numpy(), np.asarray(getattr(ref, field)),
            rtol=0, atol=DU, err_msg=field,
        )
    res64 = fa.make_fused_admm_rollout(
        plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T, device="cpu",
        dtype=torch.float64, rollout=fa.fused_admm_reference, **CONVEX_KW,
    )(*_t(ins, torch.float64))
    np.testing.assert_allclose(res.costs.double().numpy(),
                               res64.costs.numpy(), rtol=COST_RTOL,
                               atol=COST_ATOL)
    np.testing.assert_allclose(res.costs.numpy(), np.asarray(ref.costs),
                               rtol=COST_RTOL, atol=6e-3)
    assert bool(res.converged.all()) and bool(np.asarray(ref.converged).all())


def _jax_ladder(plant, ctrl, op, ins):
    """The JAX ladder twin on the same numpy inputs (float32, one rung
    over the batch), with its per-solve rung lanes read from the
    engine's output tile."""
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
        a, kw = _jax_args(plant, ctrl, op)
        res = jpa.make_fused_ladder_rollout(*a, **kw, **cs.LADDER_KW)(
            *(jnp.asarray(x, jnp.float32) for x in ins))
    finally:
        mp.undo()
    # OUT (n_blocks, m + p + 4, B) at q = 1: the rung lane is last.
    return res, store["OUT"][:, -1].T.astype(np.int32)


def test_k5_plain_version_matches_jax_twin_at_large_plant():
    """K5's plain version at ``large_plant_ladder`` (nbox 200, the
    default 7-rung ladder at ``LADDER_KW``), one rung group over the
    batch as the JAX twin shares one rung: u within 1e-4 of the twin
    (measured 5.6e-5); y within 1e-4 of the port's float64 run and 2e-4
    of the twin (measured 1.05e-4: the twin runs bf16 iterations); the
    rung lanes equal to the float64 run's and to the twin's, which stays
    on that path here (4, 3, 2, 1, then 0; measured on the CPU, unlike
    ``TWIN_RUNGS_OFF_FLOAT64``'s case 0 of tests/test_torch_random_dims.py);
    the final rungs equal; the converged fractions equal (0.9 each,
    not 100 %: the rung walk's first solves do not converge), the box
    respected."""
    plant, ctrl, op = _large_plant("NONE")
    ins = _inputs(plant, ctrl)
    lanes, res = {}, {}
    for dtype in (torch.float32, torch.float64):
        def keep(*args, dtype=dtype):
            out = fl.fused_ladder_reference(*args)
            lanes[dtype] = out[5]
            return out

        res[dtype] = fl.make_fused_ladder_rollout(
            plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T, device="cpu",
            dtype=dtype, rung_group=B, rollout=keep, **cs.LADDER_KW,
        )(*_t(ins, dtype))
    got, got64 = res[torch.float32], res[torch.float64]
    assert torch.equal(lanes[torch.float32], lanes[torch.float64])
    np.testing.assert_allclose(got.y_sys.double().numpy(),
                               got64.y_sys.numpy(), rtol=0, atol=DU)
    ref, ref_rung = _jax_ladder(plant, ctrl, op, ins)
    assert np.array_equal(lanes[torch.float64].numpy(), ref_rung)
    np.testing.assert_array_equal(got.solver_state.rho_idx.numpy(),
                                  np.asarray(ref.solver_state.rho_idx))
    np.testing.assert_allclose(got.u_sys.numpy(), np.asarray(ref.u_sys),
                               rtol=0, atol=DU)
    np.testing.assert_allclose(got.y_sys.numpy(), np.asarray(ref.y_sys),
                               rtol=0, atol=2 * DU)
    assert int(got.converged.sum()) == int(np.asarray(ref.converged).sum())
    assert float(got.u_sys.abs().max()) <= cs.WIDE_BOX + 1e-6


#: The wide plan (rows, bytes) at large_plant's other sizes (S 210,
#: n_theta 200, nb m = nb p = 10, Mw 11), nbox from just past the
#: resident cap to 600, with nxi = n_theta + nbox. The rows are the
#: frozen tile rule's (so ladder_wide_group's); the bytes are the
#: mbarrier head, the state without s and w, and two ring stages of a
#: multiple of 32 floats.
WIDE_PLANS = {193: (32, 232320), 196: (32, 232448), 200: (32, 232320),
              256: (16, 232448), 300: (16, 232320), 400: (16, 232320),
              520: (8, 232448), 600: (8, 232320)}


def test_wide_plans_pinned_at_large_plant():
    """``admm_wide_plan`` and ``ladder_wide_group`` mirror ``wide_plan``
    and ``wide_group_rows`` of ``csrc/fused_admm.cu`` (held to the
    library on a card in tests/test_torch_cuda.py): 16 scenarios per
    block for ``large_plant_convex``, a rung group of 32 for
    ``large_plant_ladder``, each block taking its ring up to the opt-in
    shared memory; the resident plans refuse both."""
    convex, ladder = _dims("CONVEX"), _dims("NONE")
    assert (convex.nbox, convex.nxi, convex.W2) == (300, 500, 1031)
    assert (ladder.nbox, ladder.nxi, ladder.W2) == (200, 400, 831)
    assert fa.admm_wide_plan(convex) == (16, 232320)
    assert fa.wide_plan(convex).stage == 15264  # ring stage floats
    assert fl.ladder_wide_group(ladder) == 32
    assert fa.admm_wide_plan(ladder) == (32, 232320)
    assert fa.admm_plan(convex) == (0, 1973376)
    assert fa.admm_plan(ladder)[0] == 0
    assert fl.ladder_tile_rows(ladder) == 0
    assert fl.ladder_tile_rows(convex) == 0


@pytest.mark.parametrize("nbox", sorted(WIDE_PLANS))
def test_wide_plan_past_the_resident_cap(nbox):
    """Past nbox 192 the resident plans refuse every shape (K4's cap;
    K5's group rule, whose one rung of operators alone outgrows a block
    past nbox 170) and the wide plan takes it, its tile shrinking as the
    state grows."""
    d = _dims("CONVEX")._replace(nbox=nbox, nxi=200 + nbox,
                                 W2=230 + 1 + nbox + 200 + nbox)
    assert fa.admm_plan(d)[0] == 0
    assert fl.ladder_tile_rows(d) == 0
    assert fa.admm_wide_plan(d) == WIDE_PLANS[nbox]
    assert fl.ladder_wide_group(d) == WIDE_PLANS[nbox][0]


def test_wide_plan_at_resident_shapes_and_its_limit():
    """At four_tank_convex and four_tank_ladder the resident plans are
    unchanged (64 scenarios, 111,168 bytes; the group rule 64) and the
    wide plan, which only the card tests launch there, takes 64 too, so
    the two bodies share K5's rung groups. Where no tile's iteration is
    one window (nbox above 2048) the wide plan gives 0 and the bytes of
    its 4-row block."""
    plant, ctrl, op, _ = cs.admm_config("four_tank_convex")
    dims = fa.build_fused_admm_operator(plant.as_params(), op, ctrl.n,
                                        ctrl.m, ctrl.p, device="cpu")[1]
    assert fa.admm_plan(dims) == (64, 111168)
    assert fa.admm_wide_plan(dims) == (64, 232320)
    plant, ctrl, op, _ = cs.admm_config("four_tank_ladder")
    dims = fl.build_fused_ladder_operator(plant.as_params(), op, ctrl.n,
                                          ctrl.m, ctrl.p, device="cpu")[1]
    assert fl.ladder_tile_rows(dims) == 64
    assert fl.ladder_wide_group(dims) == 64
    huge = dims._replace(nbox=2100, nxi=2116, W2=24 + 1 + 2100 + 2116)
    rows, nbytes = fa.admm_wide_plan(huge)
    assert rows == 0 and nbytes > fa._SMEM_LIMIT


@pytest.mark.parametrize("slack,plan", [
    ("CONVEX", fa.WidePlan(16, 15264, 232320, 300, 512, 1032)),
    ("NONE", fa.WidePlan(32, 9824, 232320, 200, 412, 832)),
])
def test_wide_plan_pads_rows_and_sets_ring(slack, plan):
    """The whole wide plan at both ``large_plant`` shapes: K4w
    (``large_plant_convex``, nbox 300, W1 511, W2 1031) and K5w
    (``large_plant_ladder``, nbox 200, W1 411, W2 831) pad their operator
    rows to a multiple of four floats (300, 512, 1032 and 200, 412, 832)
    and keep two ring stages after the state (two measured faster than
    three or four on the card). ``wide_operators`` pads to exactly those
    widths with zeros, into new tensors, leaving the operators as they
    were."""
    dims = _dims(slack)
    assert fa.WIDE_STAGES == 2
    assert fa.wide_plan(dims) == plan
    assert plan.bytes == 4 * (32 + fa._ceil32(fa._wide_state_floats(
        dims, plan.rows, frozen=False)) + fa.WIDE_STAGES * plan.stage)
    Vop, M1, M2 = (torch.ones(2, dims.nbox, w) for w in (
        dims.nbox, dims.Mw + dims.nxi, dims.W2))
    Vop = Vop[:, :, :dims.nbox].contiguous()
    M2 = torch.ones(2, dims.D2, dims.W2)
    padded = fa.wide_operators(Vop, M1, M2)
    assert [tuple(p.shape[1:]) for p in padded] == [
        (dims.nbox, plan.ldv), (dims.nbox, plan.ld1), (dims.D2, plan.ld2)]
    for p, src in zip(padded, (Vop, M1, M2)):
        w = src.shape[-1]
        assert p.is_contiguous() and torch.equal(p[..., :w], src)
        assert not bool(p[..., w:].any())
        assert p.data_ptr() != src.data_ptr() and bool(src.eq(1).all())


def test_ladder_entry_point_takes_the_wide_group():
    """``make_fused_ladder_rollout(rung_group=None)`` at
    ``large_plant_ladder`` takes ``ladder_wide_group`` (it raised before
    the wide body), on the CPU as on the card; CPU tensors run the plain
    version through ``fused_ladder`` and launch nothing."""
    plant, ctrl, op = _large_plant("NONE")
    dims = _dims("NONE")
    args = (plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, 2)
    run = fl.make_fused_ladder_rollout(*args, device="cpu",
                                       **cs.LADDER_KW)
    assert run.rung_group == fl.ladder_wide_group(dims) == 32
    ins = _t(_inputs(plant, ctrl))
    ins[3] = ins[3][:, :2]
    before = (fl.fused_ladder.launches, fl.fused_ladder.wide_launches)
    got = run(*ins)
    want = fl.make_fused_ladder_rollout(
        *args, device="cpu", rollout=fl.fused_ladder_reference,
        **cs.LADDER_KW)(*ins)
    assert torch.equal(got.u_sys, want.u_sys)
    assert torch.equal(got.solver_state.rho_idx, want.solver_state.rho_idx)
    assert (fl.fused_ladder.launches,
            fl.fused_ladder.wide_launches) == before


def test_segmented_ladder_resumes_at_the_wide_group():
    """A run of 2 + 2 solves through ``solver_state0`` at the wide group
    (32, one group over B = 34 that would split it at 16) resumes each
    group at its own rung: the second segment's first rung lanes are the
    first segment's last; a state whose rows disagree inside a group of
    32 raises."""
    plant, ctrl, op = _large_plant("NONE")
    args = (plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, 2)
    Bs = 34
    rng = np.random.default_rng(1)
    ins = _t([np.zeros((Bs, 10)), np.zeros((Bs, ctrl.n, ctrl.m)),
              np.zeros((Bs, ctrl.n, ctrl.p)),
              NOISE * rng.uniform(-1, 1, (Bs, 4, ctrl.p))])
    first = fl.make_fused_ladder_rollout(*args, device="cpu",
                                         **cs.LADDER_KW)
    second = fl.make_fused_ladder_rollout(
        *args, device="cpu", **dict(cs.LADDER_KW, cold_iters=0))
    assert first.rung_group == second.rung_group == 32
    seg1 = first(*ins[:3], ins[3][:, :2])
    rungs = seg1.solver_state.rho_idx
    assert torch.equal(rungs[:32], rungs[:1].expand(32))
    seg2 = second(seg1.x_final, seg1.u_past, seg1.y_past, ins[3][:, 2:],
                  solver_state0=seg1.solver_state)
    assert seg2.u_sys.shape == (Bs, 2, ctrl.m)
    assert bool(torch.isfinite(seg2.costs).all())
    bad = seg1.solver_state._replace(
        rho_idx=torch.cat([rungs[:31], (rungs[31:32] + 1) % 7, rungs[32:]]))
    with pytest.raises(ValueError, match="differs inside a group"):
        second(seg1.x_final, seg1.u_past, seg1.y_past, ins[3][:, 2:],
               solver_state0=bad)


def test_cpu_tensors_take_plain_version_at_large_plant():
    """``fused_admm`` on CPU tensors at ``large_plant_convex`` is the
    plain version, bit for bit, and launches nothing."""
    plant, ctrl, op = _large_plant("CONVEX")
    ops, dims = fa.build_fused_admm_operator(
        plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, device="cpu")
    rng = np.random.default_rng(2)
    carry = fa.ADMMCarry(*(
        torch.as_tensor(0.01 * rng.standard_normal((3, w)),
                        dtype=torch.float32)
        for w in (dims.S, dims.Mw, dims.nbox, dims.nxi, dims.nbox,
                  dims.nbox)))
    W = torch.as_tensor(NOISE * rng.uniform(-1, 1, (3, 2, dims.p)),
                        dtype=torch.float32)
    before = (fa.fused_admm.launches, fa.fused_admm.wide_launches)
    got = fa.fused_admm(ops, dims, carry, W, 5)
    want = fa.fused_admm_reference(ops, dims, carry, W, 5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (fa.fused_admm.launches, fa.fused_admm.wide_launches) == before
