"""PyTorch port, fused ADMM closed loop (the module that holds kernel
K4): the host ADMM and box operators, the fused operators, the plain
version of the kernel and the batched entry points, held against the
JAX package (its XLA twin of the Pallas kernel and the independent
active-set golden). The CUDA kernel itself is tested against the plain
version in tests/test_torch_cuda.py, on a card."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from direct_data_driven_mpc_tpu.ops import pallas_admm as jpa  # noqa: E402
from direct_data_driven_mpc_tpu.qp import admm as jadmm  # noqa: E402
from direct_data_driven_mpc_tpu.qp import box as jbox  # noqa: E402
from direct_data_driven_mpc_tpu.qp import solution_map as jsm  # noqa: E402
from direct_data_driven_mpc_tpu_torch.models.lti_model import (  # noqa: E402
    LTIModel,
)
from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp import admm, box  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp.solution_map import (  # noqa: E402
    setpoint_channels_np,
)

from tests.test_closed_loop import FOUR_TANK  # noqa: E402
from tests.test_fused_admm import (  # noqa: E402
    BOX_ITERS,
    CONVEX_ITERS,
    GOLDEN,
    _golden_controller,
)
from tests.test_torch_iterative import one_blas_thread  # noqa: E402,F401

EXACT = 1e-12
PLANT = LTIParams(*(np.asarray(FOUR_TANK[k]) for k in "ABCD"))
#: The engines' parity bar (tests/test_fused_admm.py:110-128).
DU, COST_RTOL, COST_ATOL = 1e-4, 5e-3, 1e-3


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def convex(golden):
    """The golden CONVEX controller (JAX) and its ADMM operators: the
    port's own and the JAX package's, both with the setpoint maps."""
    ctrl = _golden_controller(golden, "CONVEX")
    return (
        ctrl,
        admm.compute_admm_operator_np(ctrl.spec, return_setpoint_maps=True),
        jadmm.compute_admm_operator_np(ctrl.spec, return_setpoint_maps=True),
    )


@pytest.fixture(scope="module")
def box_ctrl(golden):
    return _golden_controller(golden, "BOX")


def _box_op(golden, spec, module=box, **kw):
    u = float(golden["u_box"])
    return module.compute_box_admm_operator_np(spec, u_bounds=(-u, u), **kw)


def _tile(golden, scheme, T, B=2):
    """The golden run's initial window and noise, tiled over B."""
    return [
        np.tile(np.asarray(a)[None], (B,) + (1,) * np.asarray(a).ndim)
        for a in (golden["x0"], golden[f"{scheme}_u_past0"],
                  golden[f"{scheme}_y_past0"], golden["w_sys"][:T])
    ]


def _t(arrays, dtype=torch.float32):
    return [torch.as_tensor(a, dtype=dtype) for a in arrays]


def _run(plant, op, n, m, p, T, inputs, dtype=torch.float32, **kw):
    return fa.make_fused_admm_rollout(plant, op, n, m, p, T, device="cpu",
                                      dtype=dtype, **kw)(*_t(inputs, dtype))


def _assert_dict_close(got, want, keys, atol=EXACT):
    for k in keys:
        np.testing.assert_allclose(
            np.asarray(got[k], np.float64), np.asarray(want[k], np.float64),
            rtol=0, atol=atol, err_msg=k,
        )


def test_setpoint_channels_match_jax(convex):
    ctrl = convex[0]
    got = setpoint_channels_np(ctrl.spec)
    want = jsm.setpoint_channels_np(ctrl.spec)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=EXACT)
    # The self-checks fire on a spec whose baked channels disagree.
    bad = dataclasses.replace(ctrl.spec, g=ctrl.spec.g + 1e-6)
    with pytest.raises(AssertionError, match="spec.g"):
        setpoint_channels_np(bad)


@pytest.mark.parametrize("setpoint_maps", [False, True])
def test_admm_operator_matches_jax(convex, setpoint_maps):
    spec = convex[0].spec
    got = admm.compute_admm_operator_np(
        spec, return_setpoint_maps=setpoint_maps
    )
    want = jadmm.compute_admm_operator_np(
        spec, return_setpoint_maps=setpoint_maps
    )
    assert set(got) == set(want)
    _assert_dict_close(got, want, want)


@pytest.mark.parametrize("rho", [None, 1.0], ids=["ladder", "fixed_rho"])
def test_box_operator_matches_jax(golden, box_ctrl, rho):
    got = _box_op(golden, box_ctrl.spec, rho=rho)
    want = _box_op(golden, box_ctrl.spec, module=jbox, rho=rho)
    assert set(got) == set(want)
    assert got["V_s"].shape[0] == (7 if rho is None else 1)
    _assert_dict_close(got, want, want)
    with pytest.raises(ValueError, match="lower bound exceeds"):
        box.compute_box_admm_operator_np(box_ctrl.spec, u_bounds=(1.0, -1.0))


def test_admm_solve_np_matches_jax(convex):
    """A capped cold solve, then a warm-started one, on both hosts."""
    ctrl, op, jop = convex
    theta = np.concatenate(
        [ctrl.u_past.reshape(-1), ctrl.y_past.reshape(-1)]
    )
    state = jstate = None
    for iters in (5, 200):
        u, cost, state, stats = admm.admm_solve_np(
            op, theta, num_iters=iters, state=state
        )
        ju, jcost, jstate, jstats = jadmm.admm_solve_np(
            jop, theta, num_iters=iters, state=jstate
        )
        np.testing.assert_allclose(u, ju, rtol=0, atol=EXACT)
        np.testing.assert_allclose(state.w, jstate[1], rtol=0, atol=EXACT)
        assert abs(cost - jcost) < 1e-9
        assert stats.converged == jstats[2] == (iters == 200)
    assert isinstance(state, admm.ADMMState)


def test_openloop_block_rows_match_jax():
    for nb in (1, 4):
        got = fa._openloop_block_rows(PLANT, 4, 2, 2, nb)
        want = jpa._openloop_block_rows(PLANT, 4, 2, 2, nb)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["convex", "box", "track_nb4"])
def test_fused_operator_from_jax_dict_equals_port_dict(golden, convex,
                                                       box_ctrl, case):
    """The fused operators take the JAX package's float64 dict as it is:
    built from it and from the port's own dict they agree to 1e-12."""
    if case == "box":
        ops = (_box_op(golden, box_ctrl.spec, rho=1.0),
               _box_op(golden, box_ctrl.spec, module=jbox, rho=1.0))
    else:
        ops = convex[1:]
    kw = dict(n_mpc_step=4, track=True) if case == "track_nb4" else {}
    (got, dims), (want, jdims) = (
        fa.build_fused_admm_operator(PLANT, o, 4, 2, 2, device="cpu",
                                     dtype=torch.float64, **kw)
        for o in ops
    )
    assert dims == jdims
    for name in fa.FusedADMMOperator._fields[:-1]:
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=EXACT, msg=name)
    if kw:
        sp = np.asarray(ops[0]["r_bar"]) * np.array([[1.0], [0.9]])
        torch.testing.assert_close(
            fa.compute_setpoint_adds(got, dims, sp),
            fa.compute_setpoint_adds(want, jdims, sp), rtol=0, atol=EXACT,
        )


def test_fused_operator_shapes_and_rejections(golden, convex, box_ctrl):
    ops, dims = fa.build_fused_admm_operator(PLANT, convex[1], 4, 2, 2,
                                             device="cpu")
    # Four-tank, L = 30: S = 20, nbox = 60, nxi = 76.
    assert (dims.S, dims.nbox, dims.nxi, dims.Mw) == (20, 60, 76, 3)
    assert tuple(ops.Vop.shape) == (60, 60)
    assert tuple(ops.M1.shape) == (60, 79)
    assert tuple(ops.M2.shape) == (24, 161)
    assert ops.Vop.dtype == torch.float32 and ops.track is None
    with pytest.raises(ValueError, match="SINGLE-rung"):
        fa.build_fused_admm_operator(
            PLANT, _box_op(golden, box_ctrl.spec), 4, 2, 2, device="cpu"
        )
    no_maps = {k: v for k, v in convex[1].items() if k != "V_r"}
    with pytest.raises(ValueError, match="setpoint tracking"):
        fa.build_fused_admm_operator(PLANT, no_maps, 4, 2, 2, track=True,
                                     device="cpu")
    with pytest.raises(ValueError, match="track=True"):
        fa.compute_setpoint_adds(ops, dims, convex[1]["r_bar"])


@pytest.mark.parametrize("scheme", ["CONVEX", "BOX"])
def test_plain_version_matches_golden(golden, convex, box_ctrl, scheme):
    """The plain version against the independent active-set golden at
    the JAX engine's own bar: max |du| < 1e-4, every solve converged,
    costs rtol 5e-3 / atol 1e-3, the input box respected."""
    T = golden[f"{scheme}_u"].shape[0]
    if scheme == "CONVEX":
        op = convex[1]
        kw = dict(iters=CONVEX_ITERS, cold_iters=24, tol=1e-5)
    else:
        op = _box_op(golden, box_ctrl.spec, rho=1.0)
        kw = dict(iters=BOX_ITERS, cold_iters=60, tol=2e-5)
    res = _run(PLANT, op, 4, 2, 2, T, _tile(golden, scheme, T), **kw)
    du = np.abs(res.u_sys[0].double().numpy() - golden[f"{scheme}_u"]).max()
    assert du < DU, du
    assert bool(res.converged.all())
    np.testing.assert_allclose(
        res.costs[0].double().numpy(), golden[f"{scheme}_costs"],
        rtol=COST_RTOL, atol=COST_ATOL,
    )
    if scheme == "BOX":
        assert float(res.u_sys.abs().max()) <= float(golden["u_box"]) + 1e-6


def _two_state_setup(L):
    """The JAX pack-factor test's plant and controller
    (tests/test_fused_admm.py::test_fused_admm_pack_factors): nbox = 2L,
    so L = 8 and L = 40 were the TPU's pack factors 4 and 1."""
    from direct_data_driven_mpc_tpu.control.controller import (
        DirectDataDrivenMPCController,
    )
    from direct_data_driven_mpc_tpu.qp.spec import (
        DataDrivenMPCType,
        SlackVarConstraintTypes,
    )

    rng = np.random.default_rng(3)
    model = LTIModel(
        A=np.array([[0.9, 0.2], [0.0, 0.8]]), B=np.array([[0.0], [1.0]]),
        C=np.array([[1.0, 0.3], [0.2, 0.5]]), D=np.zeros((2, 1)),
        eps_max=0.002,
    )
    n, m, p, N = 2, 1, 2, 30 + 4 * L
    u_d = rng.uniform(-1, 1, (N, m))
    y_d = model.simulate(u_d, 0.002 * rng.uniform(-1, 1, (N, p)), N)
    y_s = model.get_equilibrium_output_from_input(np.array([0.5]))
    ctrl = DirectDataDrivenMPCController(
        n=n, m=m, p=p, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(p * L), R=1e-4 * np.eye(m * L),
        u_s=np.array([[0.5]]), y_s=y_s.reshape(-1, 1), eps_max=0.002,
        lamb_alpha=50.0, lamb_sigma=1000.0, c=0.1,
        slack_var_constraint_type=SlackVarConstraintTypes.CONVEX,
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
    )
    T, B = 24, 4
    inputs = [
        np.tile(model.get_state()[None], (B, 1)),
        np.tile(ctrl.u_past.reshape(1, n, m), (B, 1, 1)),
        np.tile(ctrl.y_past.reshape(1, n, p), (B, 1, 1)),
        0.002 * rng.uniform(-1, 1, (B, T, p)),
    ]
    return (model.as_params(), admm.compute_admm_operator_np(ctrl.spec),
            (n, m, p), T, inputs,
            dict(iters=(0, 16, 6), cold_iters=60, tol=1e-4))


def _case(name, golden, convex, box_ctrl):
    """(plant, op, (n, m, p), T, inputs, engine kwargs) of one case."""
    if name.startswith("L"):
        return _two_state_setup(int(name[1:]))
    dims = (4, 2, 2)
    if name == "box":
        T = 120
        return (PLANT, _box_op(golden, box_ctrl.spec, rho=1.0), dims, T,
                _tile(golden, "BOX", T),
                dict(iters=BOX_ITERS, cold_iters=60, tol=2e-5))
    kw = dict(iters=CONVEX_ITERS, cold_iters=24, tol=1e-5)
    T = 120
    if name == "nstep4":
        T = 38  # ten solve blocks, the last one ragged
        kw.update(n_mpc_step=4, iters=(4, 8, 2))
    elif name == "tracking":
        # The 4-phase schedule of bench.py's four_tank_admm_tracking.
        T = 40
        r_bar = np.asarray(convex[1]["r_bar"])
        kw.update(iters=(4, 6, 2), setpoints=np.repeat(
            np.array([1.0, 0.85, 1.1, 0.95])[:, None] * r_bar[None],
            T // 4, axis=0,
        ))
    return PLANT, convex[1], dims, T, _tile(golden, "CONVEX", T), kw


@pytest.mark.parametrize(
    "name", ["convex", "box", "nstep4", "tracking", "L8", "L40"]
)
def test_plain_version_matches_jax_twin(golden, convex, box_ctrl, name):
    """The plain version against the JAX twin (the Pallas kernel's math
    as ``lax.scan``) on the same numpy inputs: u and y within atol 1e-4,
    costs rtol 5e-3 / atol 1e-3, both 100 % converged. The JAX engine
    runs its bf16 tiers, the port float32 throughout. Measured on the
    CPU: max |du| 1.3e-5 (convex), 9.5e-6 (box), 1.1e-5 (nstep4),
    1.2e-5 (tracking), 2.7e-6 (L8), 8.6e-6 (L40); max |dy| at most
    2.9e-6; max |dcost| 4.0e-5, 1.4e-4, 2.8e-5, 4.2e-5, 2.1e-3 and
    2.0e-3."""
    plant, op, (n, m, p), T, inputs, kw = _case(name, golden, convex,
                                                box_ctrl)
    res = _run(plant, op, n, m, p, T, inputs, **kw)
    ref = jpa.make_fused_admm_rollout(
        LTIParams(*(jnp.asarray(a, jnp.float32) for a in plant)), op,
        n=n, m=m, p=p, n_steps=T, backend="xla", **kw,
    )(*(jnp.asarray(a, jnp.float32) for a in inputs))
    nb = kw.get("n_mpc_step", 1)
    assert res.u_sys.shape == (inputs[0].shape[0], T, m)
    assert res.costs.shape == (inputs[0].shape[0], -(-T // nb))
    for field in ("u_sys", "y_sys"):
        np.testing.assert_allclose(
            getattr(res, field).numpy(), np.asarray(getattr(ref, field)),
            rtol=0, atol=DU, err_msg=field,
        )
    cost_atol = COST_ATOL
    if name.startswith("L"):
        # The twin forms its costs through its bf16 3-pass cost channel,
        # which on this plant errs by up to 2.1e-3 against float64
        # (measured; the port's float32 errs by 9e-5). Here the costs
        # are held to the port's float64 run at the bar, and to the
        # twin at the twin's own error.
        res64 = _run(plant, op, n, m, p, T, inputs, dtype=torch.float64,
                     **kw)
        np.testing.assert_allclose(
            res.costs.double().numpy(), res64.costs.numpy(),
            rtol=COST_RTOL, atol=COST_ATOL,
        )
        cost_atol = 3e-3
    np.testing.assert_allclose(
        res.costs.numpy(), np.asarray(ref.costs), rtol=COST_RTOL,
        atol=cost_atol,
    )
    assert bool(res.converged.all()) and bool(np.asarray(ref.converged).all())
    np.testing.assert_allclose(
        res.solver_state.s.numpy(), np.asarray(ref.solver_state.s),
        rtol=0, atol=DU,
    )


def test_setpoints_dr0_bit_identical(golden, convex):
    """A constant schedule at the baked setpoints adds exact zeros: u, y,
    the plant state and the ADMM state equal the untracked run bit for
    bit (only the cost features ride a differently factored, equal
    valued quadratic)."""
    T = 40
    inputs = _tile(golden, "CONVEX", T)
    kw = dict(iters=CONVEX_ITERS, cold_iters=24)
    plain = _run(PLANT, convex[1], 4, 2, 2, T, inputs, **kw)
    tracked = _run(PLANT, convex[1], 4, 2, 2, T, inputs,
                   setpoints=np.asarray(convex[1]["r_bar"]), **kw)
    for field in ("u_sys", "y_sys", "x_final", "u_past", "y_past",
                  "converged"):
        assert torch.equal(getattr(tracked, field), getattr(plain, field))
    for a, b in zip(tracked.solver_state, plain.solver_state):
        assert torch.equal(a, b)
    torch.testing.assert_close(tracked.costs, plain.costs, rtol=1e-3,
                               atol=1e-5)


def test_segmented_run_matches_uninterrupted(golden, convex):
    """Two halves, the second warm-started from the first's
    ``solver_state`` and final windows, reproduce the uninterrupted run
    (tests/test_fused_admm.py:234-266)."""
    T = 60
    x0, up, yp, W = _t(_tile(golden, "CONVEX", T))
    kw = dict(iters=CONVEX_ITERS, device="cpu")
    full = fa.make_fused_admm_rollout(PLANT, convex[1], 4, 2, 2, T,
                                      cold_iters=24, **kw)(x0, up, yp, W)
    seg1 = fa.make_fused_admm_rollout(PLANT, convex[1], 4, 2, 2, 30,
                                      cold_iters=24, **kw)(
        x0, up, yp, W[:, :30]
    )
    seg2 = fa.make_fused_admm_rollout(PLANT, convex[1], 4, 2, 2, 30,
                                      cold_iters=0, **kw)(
        seg1.x_final, seg1.u_past, seg1.y_past, W[:, 30:],
        solver_state0=seg1.solver_state,
    )
    joined = torch.cat([seg1.u_sys, seg2.u_sys], dim=1)
    assert float((joined - full.u_sys).abs().max()) < 1e-5
    assert isinstance(full.solver_state, admm.ADMMState)
    assert full.solver_state.s.shape == (2, 60)


def test_cpu_tensors_take_plain_version(golden, convex):
    T = 12
    ops, dims = fa.build_fused_admm_operator(PLANT, convex[1], 4, 2, 2,
                                             device="cpu")
    run = fa.make_fused_admm_rollout(PLANT, convex[1], 4, 2, 2, T,
                                     iters=CONVEX_ITERS, device="cpu")
    inputs = _t(_tile(golden, "CONVEX", T))
    before = fa.fused_admm.launches
    res = run(*inputs)
    ref = fa.make_fused_admm_rollout(
        PLANT, convex[1], 4, 2, 2, T, iters=CONVEX_ITERS, device="cpu",
        rollout=fa.fused_admm_reference,
    )(*inputs)
    assert fa.fused_admm.launches == before == 0
    for a, b in zip(res[:-1] + res.solver_state,
                    ref[:-1] + ref.solver_state):
        assert torch.equal(a, b)
    meta = fa.ADMMCarry(*(torch.zeros(2, w, device="meta") for w in
                          (dims.S, dims.Mw, dims.nbox, dims.nxi,
                           dims.nbox, dims.nbox)))
    with pytest.raises(ValueError, match="device"):
        fa.fused_admm(ops, dims, meta, torch.zeros(2, T, 2, device="meta"),
                      11)


def test_amortized_run_folds_every_repetition(golden, convex):
    """The throughput harness's checksum is the sum over R rollouts on
    the noise rolled by 0..R-1 steps of the last costs, u and y."""
    T, R = 16, 3
    kw = dict(iters=CONVEX_ITERS, cold_iters=24, tol=1e-5, device="cpu")
    x0, up, yp, W = _t(_tile(golden, "CONVEX", T))
    checksum, ok = fa.make_amortized_admm_run(
        PLANT, convex[1], 4, 2, 2, T, **kw
    )(x0, up, yp, W, R)
    run = fa.make_fused_admm_rollout(PLANT, convex[1], 4, 2, 2, T, **kw)
    want = 0.0
    for i in range(R):
        r = run(x0, up, yp, torch.roll(W, i, dims=1))
        want += float(r.costs[:, -1].sum() + r.u_sys.sum() + r.y_sys.sum())
    assert bool(ok)
    assert abs(float(checksum) - want) <= 1e-5 * abs(want)
    # An iteration budget too small to converge clears the flag.
    _, ok = fa.make_amortized_admm_run(
        PLANT, convex[1], 4, 2, 2, T, iters=(0, 1, 0), cold_iters=0,
        tol=1e-9, device="cpu",
    )(x0, up, yp, W, 1)
    assert not bool(ok)


def _sized(dims, nbox, S=None, nb=1, extra=0):
    """``dims`` resized to a box of ``nbox`` lanes (and optionally a
    plant window of ``S``, ``nb`` steps per solve and ``extra`` tracking
    features), as the fused operators would size it."""
    S = dims.S if S is None else S
    nxi = dims.n_theta + nbox + extra
    D2 = S + nb * (dims.m + dims.p)
    return dims._replace(S=S, nb=nb, Mw=nb * dims.m + 1, D2=D2, nbox=nbox,
                         nxi=nxi, W2=D2 + 1 + nbox + nxi)


@pytest.fixture(scope="module")
def convex_dims(convex):
    return fa.build_fused_admm_operator(PLANT, convex[1], 4, 2, 2,
                                        device="cpu")[1]


@pytest.mark.parametrize("nbox,plan", [
    (30, (64, 56944)),    # four_tank_convex_q4 (L = 15)
    (52, (64, 95168)),    # the box engines (L = 30, slack NONE)
    (60, (64, 111168)),   # four_tank_convex: two blocks per SM
    (120, (32, 212224)),  # long_horizon_convex (L = 60): NT = 2
    (144, (4, 226992)),   # the last box that fits at S = 20
    (148, (0, 237872)),   # the reach edge
])
def test_admm_plan_pins_rows_and_bytes(convex_dims, nbox, plan):
    """K4's plan (``admm_plan``, mirrored from ``csrc/fused_admm.cu``) at
    the four-tank window (S = 20, one step per solve): 64 scenarios per
    block up to nbox 60, where two 111,168-byte blocks (each with the
    1 KB the SM reserves per block) fit an SM's 228 KB; 32 at nbox 120;
    none past nbox 144."""
    assert fa.admm_plan(_sized(convex_dims, nbox)) == plan
    if nbox == 60:
        assert 2 * (plan[1] + 1024) <= 228 * 1024


@pytest.mark.parametrize("nbox,B,plan", [
    (60, None, (64, 111168)),  # no batch: the full batch's plan
    (60, 1, (32, 82624)),      # one block of 64 would leave 131 SMs empty
    (60, 33, (32, 82624)),
    (60, 4096, (32, 82624)),   # four_tank_convex.b4096: 128 blocks of 32
    (60, 4224, (32, 82624)),   # 132 blocks of 32: one on each SM
    (60, 4225, (64, 111168)),  # 133 of 32 would put two on an SM
    (60, 8192, (64, 111168)),
    (60, 65536, (64, 111168)),
    (30, 4096, (32, 39920)),   # four_tank_convex_q4: the tile halves too
    (120, 1, (32, 212224)),    # no 64 tile to halve: the 32 that fits
    (120, 4096, (32, 212224)),
    (144, 4096, (4, 226992)),
    (148, 4096, (0, 237872)),  # none fits at any batch
])
def test_admm_plan_by_batch(convex_dims, nbox, B, plan):
    """K4's plan by batch on a card of 132 SMs: the 64-scenario tile is
    halved to 32 scenarios, 4 a warp, while a grid of 32-scenario blocks
    puts at most one on each SM (``ceil(B / 32) <= 132``: B <= 4224),
    and kept above; a shape whose largest tile is not 64 keeps its plan
    at every batch, and one with no tile that fits gets none."""
    assert fa.admm_plan(_sized(convex_dims, nbox), B, 132) == plan


def test_admm_plan_by_batch_follows_the_card(convex_dims):
    """The switch is at ``ceil(B / 32) <= sms``: where the card's SMs are
    unknown (0) the tile is never halved; on a card of half the SMs the
    switch comes at half the batch."""
    for B in (1, 4096, 65536):
        assert fa.admm_plan(convex_dims, B, 0) == fa.admm_plan(convex_dims)
    assert fa.admm_plan(convex_dims, 2112, 66)[0] == 32
    assert fa.admm_plan(convex_dims, 2113, 66)[0] == 64
    assert fa.SMALL_TILE == 32


def test_admm_plan_keeps_the_old_reach(convex_dims):
    """Every size the fixed-penalty kernel took before its redesign
    (the rung-group rule's layout without the balancer's four maxima)
    still launches, with at least as many scenarios per block; beyond
    three 64-column tiles per lane (nbox 192) none does, even where the
    block would fit."""
    from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl

    checked = 0
    for S in (6, 20, 44, 120):
        for nb in (1, 4):
            for extra in (0, 4):
                for nbox in range(4, 200, 4):
                    d = _sized(convex_dims, nbox, S, nb, extra)
                    old = next((t for t in (64, 32, 16, 8, 4)
                                if fl.ladder_smem_bytes(d, t) - 16
                                <= fa._SMEM_LIMIT), 0)
                    rows = fa.admm_plan(d)[0]
                    assert rows >= old, (S, nb, extra, nbox, old, rows)
                    checked += old > 0
    assert checked > 300
    thin = convex_dims._replace(nxi=4, W2=convex_dims.D2 + 1 + 192 + 4)
    assert fa.admm_plan(thin._replace(nbox=192))[0] > 0
    assert fa.admm_plan(thin._replace(nbox=193, W2=thin.W2 + 1))[0] == 0


def test_rung_group_rule_unchanged(convex_dims):
    """K5's rung groups are sized by the layout both ADMM kernels had
    before their redesigns, so they stay where they were: 64 scenarios
    at nbox 52 and 60, 16 at nbox 120."""
    from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl

    for nbox, group in ((52, 64), (60, 64), (120, 16)):
        d = _sized(convex_dims, nbox)
        assert fl.ladder_tile_rows(d) == group
    assert fl.ladder_smem_bytes(_sized(convex_dims, 60), 64) == 166096
