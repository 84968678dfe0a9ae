"""PyTorch port, setpoint tracking: the tracking operator and its device
map, the tracking block map, the fused operator's setpoint lanes, the
three schedule forms through the fused plain version, the classic
engine and the generic loop, the amortized harness, and the classic
engine's in-scan noise, each held against the JAX package (its Pallas
kernel in interpret mode, its XLA twin, its classic engine and its
generic loop) on the four-tank setup of tests/test_tracking_engine.py,
the same numpy inputs handed to both. The CUDA kernel is held against
the plain version on a card in tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from direct_data_driven_mpc_tpu.control import linear_engine as jle  # noqa: E402
from direct_data_driven_mpc_tpu.control.loop import (  # noqa: E402
    closed_loop_rollout as jax_closed_loop_rollout,
)
from direct_data_driven_mpc_tpu.ops import pallas_rollout as jpr  # noqa: E402
from direct_data_driven_mpc_tpu.qp import solution_map as jsm  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control import linear_engine as le  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_tpu_torch.control.loop import (  # noqa: E402
    build_closed_loop,
    closed_loop_rollout,
    make_solve_fn,
)
from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr  # noqa: E402
from direct_data_driven_mpc_tpu_torch.parallel.batch import (  # noqa: E402
    draw_block_noise,
)
from direct_data_driven_mpc_tpu_torch.qp import solution_map as sm  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp.admm import (  # noqa: E402
    compute_admm_operator_np,
)
from direct_data_driven_mpc_tpu_torch.qp.box import (  # noqa: E402
    compute_box_admm_operator_np,
)
from direct_data_driven_mpc_tpu_torch.qp.spec import (  # noqa: E402
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

from tests.test_torch_host import controller_kwargs, port_setup  # noqa: E402
from tests.test_torch_iterative import one_blas_thread  # noqa: E402,F401

K, B, T = 8, 4, 48
N_OUTER = T // K
EXACT = 1e-9  # float64 operators of the two packages
ATOL = 2e-5  # u, y and state in float32 (tests/test_pallas_rollout.py)
COST_RTOL, COST_ATOL = 1e-3, 1e-4


def _t(arrays, dtype=torch.float32):
    return [torch.as_tensor(np.asarray(a), dtype=dtype) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a, jnp.float32) for a in arrays]


def _carry(jbm, dtype=torch.float32):
    return le.block_map_from_numpy(
        {k: getattr(jbm, k) for k in le.AffineBlockMap._fields}, "cpu",
        dtype,
    )


@pytest.fixture(scope="module")
def setup():
    """Both controllers, the port's tracking and plain block maps, the
    JAX tracking map in float32 (XLA twin, Pallas kernel), the batch
    (seeded numpy) and the baked setpoints ``r0``."""
    jplant, jctrl, ctrl, rng = port_setup()
    plant = jplant.as_params()
    bm_t = le.build_tracking_engine(ctrl, plant, solves_per_block=K,
                                    device="cpu")
    bm = le.build_linear_engine(ctrl, plant, solves_per_block=K,
                                device="cpu")
    jbm_t = jle.build_tracking_engine(jctrl, plant, solves_per_block=K,
                                      dtype=jnp.float32)
    batch = (
        np.tile(jplant.get_state()[None], (B, 1)),
        np.tile(jctrl.u_past.reshape(1, 4, 2), (B, 1, 1)),
        np.tile(jctrl.y_past.reshape(1, 4, 2), (B, 1, 1)),
        0.002 * rng.uniform(-1, 1, (B, T, 2)),
    )
    r0 = np.concatenate([ctrl.u_s.ravel(), ctrl.y_s.ravel()])
    return jplant, jctrl, ctrl, bm, bm_t, jbm_t, batch, r0


def _schedules(r0):
    """The three schedule forms: constant, per outer block (0.7 x r0
    after half the blocks, tests/test_tracking_engine.py) and per
    scenario and block (each scenario on its own scale of r0)."""
    per_block = np.stack(
        [r0 if i < N_OUTER // 2 else 0.7 * r0 for i in range(N_OUTER)]
    )
    scales = np.linspace(0.6, 1.0, B)
    per_scenario = scales[:, None, None] * per_block[None]
    return {"constant": 0.85 * r0, "per_block": per_block,
            "per_scenario": per_scenario}


def _specs(u_d, y_d, ctype, use_terminal):
    """The JAX package's and the port's QP spec of the four-tank
    controller on the same data, each assembled by its own package (no
    controller: a NOMINAL one would factor its KKT matrix again)."""
    from direct_data_driven_mpc_tpu.ops.host import (
        hankel_matrix_np as jax_hankel,
    )
    from direct_data_driven_mpc_tpu.qp import assembly as jax_assembly
    from direct_data_driven_mpc_tpu.qp import spec as jax_spec
    from direct_data_driven_mpc_tpu_torch.ops.host import hankel_matrix_np
    from direct_data_driven_mpc_tpu_torch.qp import assembly, spec

    kw = controller_kwargs(u_d, y_d, use_terminal=use_terminal)
    n, m, p, L = kw["n"], kw["m"], kw["p"], kw["L"]
    args = dict(
        Q=kw["Q"], R=kw["R"], u_s=kw["u_s"], y_s=kw["y_s"],
        eps_max=kw["eps_max"], lamb_alpha=kw["lamb_alpha"],
        lamb_sigma=kw["lamb_sigma"], c=kw["c"],
        use_terminal_constraint=use_terminal,
    )
    out = []
    for hankel, asm, sp in ((jax_hankel, jax_assembly, jax_spec),
                            (hankel_matrix_np, assembly, spec)):
        out.append(asm.build_qp_spec(
            hankel(u_d, L + n), hankel(y_d, L + n),
            sp.QPDims(n=n, m=m, p=p, L=L, N=len(u_d)),
            controller_type=sp.DataDrivenMPCType[ctype.name],
            slack_var_constraint_type=sp.SlackVarConstraintTypes.NONE,
            **args,
        ))
    return out


@pytest.mark.parametrize("ctype", [DataDrivenMPCType.ROBUST,
                                   DataDrivenMPCType.NOMINAL])
@pytest.mark.parametrize("use_terminal", [True, False])
def test_tracking_operator_matches_jax(setup, ctype, use_terminal):
    """The float64 tracking operator (pseudoinverse KKT solves for
    NOMINAL) and its TrackingMap in float64 equal the JAX package's."""
    jctrl = setup[1]
    jspec, spec = _specs(jctrl.u_d, jctrl.y_d, ctype, use_terminal)
    op = sm.compute_tracking_operator_np(spec)
    jop = jsm.compute_tracking_operator_np(jspec)
    assert op["feasible"] and jop["feasible"]
    for key in ("U_theta", "U_r", "cost_P", "Z", "u_s", "y_s"):
        np.testing.assert_allclose(op[key], jop[key], rtol=0, atol=EXACT,
                                   err_msg=key)
    tm = sm.tracking_map_from_numpy(op, "cpu", torch.float64)
    jtm = jsm.TrackingMap(**{k: jnp.asarray(jop[k], jnp.float64)
                             for k in jsm.TrackingMap._fields})
    for name in sm.TrackingMap._fields:
        assert getattr(tm, name).dtype == torch.float64
        np.testing.assert_allclose(
            getattr(tm, name).numpy(), np.asarray(getattr(jtm, name)),
            rtol=0, atol=EXACT, err_msg=name,
        )


def test_device_maps_and_solves_match_jax(setup):
    """The controller's TrackingMap and SolutionMap on the device in
    float64, and their solve functions, equal the JAX package's; the JAX
    TrackingMap carried over is the port's; a batch of windows gives
    each window's solve."""
    jctrl, ctrl = setup[1], setup[2]
    tm = ctrl.tracking_map(device="cpu", dtype=torch.float64)
    jtm = jctrl.tracking_map(dtype=jnp.float64)
    carried = sm.tracking_map_from_numpy(jtm, "cpu", torch.float64)
    for name in sm.TrackingMap._fields:
        for got in (getattr(tm, name), getattr(carried, name)):
            np.testing.assert_allclose(
                got.numpy(), np.asarray(getattr(jtm, name)), rtol=0,
                atol=EXACT, err_msg=name,
            )
    smap = ctrl.solution_map(device="cpu", dtype=torch.float64)
    jsmap = jctrl.solution_map(dtype=jnp.float64)
    for name in sm.SolutionMap._fields:
        assert getattr(smap, name).dtype == torch.float64
        np.testing.assert_allclose(
            getattr(smap, name).numpy(), np.asarray(getattr(jsmap, name)),
            rtol=0, atol=EXACT, err_msg=name,
        )
    rng = np.random.default_rng(1)
    theta = rng.uniform(-1, 1, 16)
    r = 0.8 * np.concatenate([ctrl.u_s.ravel(), ctrl.y_s.ravel()])
    th, rt = _t((theta, r), torch.float64)
    jth, jr = jnp.asarray(theta), jnp.asarray(r)
    pairs = [
        (sm.solve_u_tracking(tm, th, rt), jsm.solve_u_tracking(jtm, jth, jr)),
        (sm.tracking_cost(tm, th, rt), jsm.tracking_cost(jtm, jth, jr)),
        (sm.solve_u(smap, th), jsm.solve_u(jsmap, jth)),
        (sm.solve_full(smap, th), jsm.solve_full(jsmap, jth)),
        (sm.optimal_cost(smap, th), jsm.optimal_cost(jsmap, jth)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=EXACT)
    batch = torch.stack([th, 0.5 * th])
    np.testing.assert_allclose(
        sm.solve_u_tracking(tm, batch, rt)[1].numpy(),
        sm.solve_u_tracking(tm, 0.5 * th, rt).numpy(), rtol=0, atol=1e-12,
    )


def test_set_input_output_setpoints_matches_jax_and_the_tracking_map():
    """Retargeting re-derives the operator as the JAX controller does,
    and the new baked solve is the tracking operator's at the new
    setpoints; shapes are checked as in the JAX package."""
    _, jctrl, ctrl, _ = port_setup()
    tm = ctrl.tracking_operator()
    u_s2, y_s2 = 0.85 * ctrl.u_s, 0.85 * ctrl.y_s
    ctrl.set_input_output_setpoints(u_s2, y_s2)
    jctrl.set_input_output_setpoints(u_s2, y_s2)
    op, jop = ctrl.solution_operator(), jctrl.solution_operator()
    for key in ("u_base", "U_gain", "cost_P", "cost_q", "cost_r"):
        np.testing.assert_allclose(op[key], jop[key], rtol=0, atol=EXACT,
                                   err_msg=key)
    r2 = np.concatenate([u_s2.ravel(), y_s2.ravel()])
    np.testing.assert_allclose(op["u_base"], tm["U_r"] @ r2, rtol=0,
                               atol=EXACT)
    np.testing.assert_allclose(ctrl.optimal_u, jctrl.optimal_u, rtol=0,
                               atol=EXACT)
    for bad in ((ctrl.u_s.ravel(), ctrl.y_s), (ctrl.u_s, ctrl.y_s[:1])):
        with pytest.raises(ValueError, match="Incorrect dimensions"):
            ctrl.set_input_output_setpoints(*bad)


@pytest.fixture(scope="module")
def convex_ctrl(setup):
    """The port's CONVEX controller on the setup's data."""
    jctrl = setup[1]
    return DirectDataDrivenMPCController(
        **controller_kwargs(jctrl.u_d, jctrl.y_d),
        slack_var_constraint_type=SlackVarConstraintTypes.CONVEX,
        controller_type=DataDrivenMPCType.ROBUST,
    )


def test_convex_controller_has_no_tracking_operator(convex_ctrl):
    ctrl = convex_ctrl
    for method in (ctrl.tracking_operator, ctrl.tracking_map,
                   ctrl.solution_map):
        with pytest.raises(ValueError, match="CONVEX"):
            method()


@pytest.mark.parametrize("n_mpc_step,Kb", [(1, K), (4, 3)])
def test_tracking_block_map_matches_jax_f64(setup, n_mpc_step, Kb):
    """Every field of the tracking block map, ``s_star`` and ``r_bar``
    included, equals the JAX package's in float64, and the JAX map
    carried over through ``block_map_from_numpy`` is the same map."""
    jplant, jctrl, ctrl = setup[:3]
    kw = dict(n=4, m=2, p=2, n_mpc_step=n_mpc_step, solves_per_block=Kb)
    got = le.build_affine_block_map(
        jplant.as_params(), ctrl.solution_operator(), device="cpu",
        dtype=torch.float64, tracking_op=ctrl.tracking_operator(), **kw,
    )
    want = jle.build_affine_block_map(
        jplant.as_params(), jctrl.solution_operator(), dtype=jnp.float64,
        tracking_op=jctrl.tracking_operator(), **kw,
    )
    assert got.n_r == want.n_r == 4
    carried = _carry(want, torch.float64)
    assert carried.n_r == 4
    for name in le.AffineBlockMap._fields:
        if name == "n_r":
            continue
        for port in (got, carried):
            np.testing.assert_allclose(
                getattr(port, name).numpy(), np.asarray(getattr(want, name)),
                rtol=0, atol=EXACT, err_msg=name,
            )
    assert got.N_T.shape[0] == Kb * n_mpc_step * 2 + 4
    # The carried map runs through every engine as the port's own does.
    batch = [torch.as_tensor(np.asarray(a)[:2], dtype=torch.float64)
             for a in setup[6]]
    n_steps = 2 * Kb * n_mpc_step
    sched = torch.as_tensor(np.stack([setup[7], 0.9 * setup[7]]))
    for name, make in (
        ("fused", lambda bm: fr.make_fused_batched_rollout(
            bm, n_steps, n_mpc_step)(*batch[:3], batch[3][:, :n_steps],
                                     sched)),
        ("classic", lambda bm: le.make_linear_batched_rollout(
            bm, n_steps, n_mpc_step, setpoints=sched)(
            *batch[:3], batch[3][:, :n_steps])),
        ("amortized", lambda bm: fr.make_amortized_run(
            bm, n_steps, n_mpc_step, setpoints=sched)(
            *batch[:3], batch[3][:, :n_steps], 2)),
    ):
        for a, b in zip(make(carried), make(got)):
            if a is not None:
                torch.testing.assert_close(a, b, rtol=0, atol=1e-12,
                                           msg=name)


def test_tracking_block_map_checks_its_operator(setup):
    """The two float64 checks of the build: the tracking solve at the
    baked setpoints is the baked solve, and the joint cost reduces to
    the baked one at dr = 0."""
    jplant, _, ctrl = setup[:3]
    args = (jplant.as_params(), ctrl.solution_operator(), 4, 2, 2)
    top = ctrl.tracking_operator()
    with pytest.raises(AssertionError, match="inconsistent"):
        le.build_affine_block_map(
            *args, device="cpu",
            tracking_op=dict(top, U_r=1.001 * top["U_r"]),
        )
    P = top["cost_P"].copy()
    P[:16, :16] *= 1.001
    with pytest.raises(AssertionError, match="joint tracking cost"):
        le.build_affine_block_map(*args, device="cpu",
                                  tracking_op=dict(top, cost_P=P))


def test_fused_tracking_operator_matches_jax_unpadded(setup):
    """The fused operator of a tracking map has the JAX operator's
    columns without its 128-lane padding; in float64 its cost columns
    give the joint quadratic in ``[theta; dr]`` and its state columns
    the recursion, dr lanes included."""
    jplant, jctrl, ctrl = setup[:3]
    jbm = jle.build_tracking_engine(jctrl, jplant.as_params(),
                                    solves_per_block=K, dtype=jnp.float64)
    bm = _carry(jbm, torch.float64)
    op = fr._build_fused_operator(bm)
    assert (op.S, op.nw, op.K, op.rank) == (20, 2 * K + 4, K, 20)
    G_j, bias_j, _, dims = jpr._build_fused_operator(jbm)
    G_j, bias_j = np.asarray(G_j), np.asarray(bias_j)
    widths = [op.S, op.Ku, op.Kp, op.K * op.rank, op.K]
    assert dims["n_theta"] == 16 and dims["nw"] == op.nw
    cols, off = [], 0
    for w, padded in zip(widths, dims["widths"]):
        cols.append(np.arange(off, off + w))
        off += padded
    cols = np.concatenate(cols)
    assert op.G.shape == (op.nw + op.S, len(cols))
    np.testing.assert_allclose(op.G.float().numpy(), G_j[:, cols],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(op.bias.float().numpy(), bias_j[cols],
                               rtol=1e-6, atol=1e-7)

    rng = np.random.default_rng(3)
    sw = torch.as_tensor(rng.uniform(-1, 1, (4, op.nw + op.S)))
    out = sw @ op.G + op.bias
    offZ = op.S + op.Ku + op.Kp
    z = out[:, offZ : offZ + op.K * op.rank].reshape(4, op.K, op.rank)
    cost = (z * z).sum(-1) + out[:, offZ + op.K * op.rank :]
    w, s = sw[:, : op.nw], sw[:, op.nw :]
    st = s @ bm.OsS_T + bm.os_c + w @ bm.OsW_T
    xi = torch.cat([st.reshape(4, op.K, op.S)[:, :, 4:],
                    w[:, None, -4:].expand(4, op.K, 4)], dim=2)
    ref = ((xi @ bm.cost_P) * xi).sum(-1) + xi @ bm.cost_q + bm.cost_r
    np.testing.assert_allclose(cost.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(
        out[:, : op.S].numpy(), (s @ bm.M_T + bm.c + w @ bm.N_T).numpy(),
        rtol=0, atol=1e-12,
    )


def _close(res, ref, tag, costs_too=True):
    for field in ("u_sys", "y_sys", "x_final", "u_past", "y_past"):
        np.testing.assert_allclose(
            getattr(res, field).numpy(), np.asarray(getattr(ref, field)),
            rtol=0, atol=ATOL, err_msg=f"{tag}:{field}",
        )
    if costs_too:
        np.testing.assert_allclose(
            res.costs.numpy(), np.asarray(ref.costs), rtol=COST_RTOL,
            atol=COST_ATOL, err_msg=f"{tag}:costs",
        )


@pytest.mark.parametrize("form", ["constant", "per_block",
                                  "per_scenario"])
def test_plain_version_matches_jax_kernel_with_schedules(setup, form):
    """The fused plain version with each schedule form against the JAX
    Pallas kernel (interpret mode) and its XLA twin: u, y and state
    atol 2e-5, costs rtol 1e-3 / atol 1e-4."""
    *_, bm_t, jbm_t, batch, r0 = setup
    sched = _schedules(r0)[form]
    res = fr.pallas_batched_rollout(bm_t, *_t(batch), T,
                                    setpoints=_t([sched])[0])
    assert res.u_sys.shape == (B, T, 2) and res.costs.shape == (B, T)
    refs = {
        "pallas": jpr.pallas_batched_rollout(
            jbm_t, *_j(batch), n_steps=T, batch_block=4, interpret=True,
            setpoints=_j([sched])[0],
        ),
        "xla": jpr.pallas_batched_rollout(
            jbm_t, *_j(batch), n_steps=T, backend="xla",
            setpoints=_j([sched])[0],
        ),
    }
    for name, ref in refs.items():
        _close(res, ref, f"{form}:{name}")


def test_classic_engine_matches_jax_and_fused_with_schedules(setup):
    """The classic engine with each schedule form against the JAX
    classic engine and the port's fused plain version; a per-scenario
    schedule of identical rows is the shared one."""
    *_, bm_t, jbm_t, batch, r0 = setup
    for form, sched in _schedules(r0).items():
        res = le.make_linear_batched_rollout(
            bm_t, T, setpoints=_t([sched])[0])(*_t(batch))
        fused = fr.pallas_batched_rollout(bm_t, *_t(batch), T,
                                          setpoints=_t([sched])[0])
        _close(res, fused, f"{form}:fused")
        jrun = jle.make_linear_batched_rollout(
            jbm_t, n_steps=T, setpoints=_j([sched])[0])
        _close(res, jrun(*_j(batch)), f"{form}:jax")
    per_block = _schedules(r0)["per_block"]
    shared = le.make_linear_batched_rollout(
        bm_t, T, setpoints=_t([per_block])[0])(*_t(batch))
    tiled = le.make_linear_batched_rollout(
        bm_t, T, setpoints=_t([np.tile(per_block, (B, 1, 1))])[0],
    )(*_t(batch))
    for a, b in zip(shared, tiled):
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_dr0_reduces_to_the_plain_map_bit_for_bit(setup):
    """With the constant schedule r_bar the tracking map's u, y and
    final state equal the plain map's bit for bit, in the classic engine
    and in the fused plain version; costs to float32 rounding of the
    wider factor."""
    *_, bm, bm_t, _, batch, r0 = setup
    r_bar = _t([r0])[0]
    pairs = {
        "classic": (
            le.make_linear_batched_rollout(bm_t, T, setpoints=r_bar),
            le.make_linear_batched_rollout(bm, T),
        ),
        "fused": (
            fr.make_fused_batched_rollout(bm_t, T),
            fr.make_fused_batched_rollout(bm, T),
        ),
    }
    for name, (run_t, run) in pairs.items():
        args = _t(batch)
        got = run_t(*args) if name == "classic" else run_t(*args, r_bar)
        want = run(*args)
        for field in ("u_sys", "y_sys", "x_final", "u_past", "y_past"):
            torch.testing.assert_close(getattr(got, field),
                                       getattr(want, field), rtol=0,
                                       atol=0, msg=f"{name}:{field}")
        torch.testing.assert_close(got.costs, want.costs, rtol=1e-3,
                                   atol=1e-4)


def test_generic_loop_matches_jax_and_fused(setup):
    """The generic loop with a TrackingMap and the schedule expanded to
    per solve against the JAX generic loop, scenario by scenario (atol
    1e-5), and against the fused plain version (u, y atol 2e-5); the
    retarget bites: late outputs nearer 0.7 x y_s than at half time."""
    jplant, jctrl, ctrl, _, bm_t, _, batch, r0 = setup
    per_block = _schedules(r0)["per_block"]
    per_solve = np.repeat(per_block, K, axis=0)
    tm = ctrl.tracking_map(device="cpu")
    res = closed_loop_rollout(jplant.as_params(), tm, *_t(batch),
                              n_steps=T, setpoints=_t([per_solve])[0])
    assert res.costs.shape == (B, T) and bool(res.converged.all())
    assert res.solver_state is None
    jtm = jctrl.tracking_map(dtype=jnp.float32)
    ref = jax.vmap(lambda x0, up, yp, w: jax_closed_loop_rollout(
        jplant.as_params(), jtm, x0, up, yp, w, n_steps=T,
        setpoints=jnp.asarray(per_solve, jnp.float32),
    ))(*_j(batch))
    for field in ("u_sys", "y_sys", "x_final", "u_past", "y_past"):
        np.testing.assert_allclose(
            getattr(res, field).numpy(), np.asarray(getattr(ref, field)),
            rtol=0, atol=1e-5, err_msg=field,
        )
    np.testing.assert_allclose(res.costs.numpy(), np.asarray(ref.costs),
                               rtol=1e-5, atol=1e-4)
    fused = fr.pallas_batched_rollout(bm_t, *_t(batch), T,
                                      setpoints=_t([per_block])[0])
    for field in ("u_sys", "y_sys"):
        torch.testing.assert_close(getattr(res, field),
                                   getattr(fused, field), rtol=0,
                                   atol=ATOL)
    torch.testing.assert_close(res.costs, fused.costs, rtol=1e-3,
                               atol=1e-3)
    target = torch.as_tensor(0.7 * r0[2:], dtype=torch.float32)
    late = (res.y_sys[0, -1] - target).abs().max()
    assert late < (res.y_sys[0, T // 2 - 1] - target).abs().max()
    # The per-scenario form, and build_closed_loop, give the same loop.
    run = build_closed_loop(
        jplant.as_params(), tm, T,
        setpoints=_t([np.tile(per_solve, (B, 1, 1))])[0],
    )
    for a, b in zip(run(*_t(batch)), res):
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.fixture(scope="module")
def nstep():
    """Both controllers at n_mpc_step = 4 (tests/test_tracking_engine.py)
    and a seeded generator."""
    return port_setup(n_mpc_step=4)


def test_generic_loop_solution_map_matches_jax_with_trim(nstep):
    """The generic loop with a SolutionMap at n_mpc_step = 4 and a
    trailing partial block (42 steps) against the JAX generic loop."""
    jplant, jctrl, ctrl, rng = nstep
    n_steps = 42
    batch = (
        np.tile(jplant.get_state()[None], (2, 1)),
        np.tile(jctrl.u_past.reshape(1, 4, 2), (2, 1, 1)),
        np.tile(jctrl.y_past.reshape(1, 4, 2), (2, 1, 1)),
        0.002 * rng.uniform(-1, 1, (2, n_steps, 2)),
    )
    res = closed_loop_rollout(
        jplant.as_params(), ctrl.solution_map(device="cpu"), *_t(batch),
        n_steps=n_steps, n_mpc_step=4,
    )
    assert res.u_sys.shape == (2, n_steps, 2)
    assert res.costs.shape == (2, 11)
    jsmap = jctrl.solution_map(dtype=jnp.float32)
    ref = jax.vmap(lambda x0, up, yp, w: jax_closed_loop_rollout(
        jplant.as_params(), jsmap, x0, up, yp, w, n_steps=n_steps,
        n_mpc_step=4,
    ))(*_j(batch))
    for field in ("u_sys", "y_sys", "x_final", "u_past", "y_past"):
        np.testing.assert_allclose(
            getattr(res, field).numpy(), np.asarray(getattr(ref, field)),
            rtol=0, atol=1e-5, err_msg=field,
        )
    np.testing.assert_allclose(res.costs.numpy(), np.asarray(ref.costs),
                               rtol=COST_RTOL, atol=COST_ATOL)
    assert bool(res.converged.all())


def test_tracking_at_n_step_cadence_matches_generic_loop(nstep):
    """n_mpc_step = 4, three solves per block: the fused plain version
    with a per-block schedule against the generic loop with the same
    schedule per solve (tests/test_tracking_engine.py)."""
    jplant, jctrl, ctrl, rng = nstep
    Kn, Tn = 3, 48
    plant = jplant.as_params()
    bm_t = le.build_tracking_engine(ctrl, plant, solves_per_block=Kn,
                                    device="cpu")
    batch = _t((
        jplant.get_state()[None], jctrl.u_past.reshape(1, 4, 2),
        jctrl.y_past.reshape(1, 4, 2),
        0.002 * rng.uniform(-1, 1, (1, Tn, 2)),
    ))
    r0 = np.concatenate([ctrl.u_s.ravel(), ctrl.y_s.ravel()])
    n_outer = Tn // (Kn * 4)
    sched = np.stack(
        [r0 if i < n_outer // 2 else 0.8 * r0 for i in range(n_outer)]
    )
    res = fr.pallas_batched_rollout(bm_t, *batch, Tn, n_mpc_step=4,
                                    setpoints=_t([sched])[0])
    gen = closed_loop_rollout(
        plant, ctrl.tracking_map(device="cpu"), *batch, n_steps=Tn,
        n_mpc_step=4, setpoints=_t([np.repeat(sched, Kn, axis=0)])[0],
    )
    for field in ("u_sys", "y_sys"):
        torch.testing.assert_close(getattr(res, field),
                                   getattr(gen, field), rtol=0, atol=ATOL)


def test_amortized_checksum_matches_jax(setup):
    """The amortized harness with a per-block schedule: its checksum
    equals the JAX harness's (Pallas kernel in interpret mode), whose
    index map rotates the schedule with the noise; and each rotation is
    ``torch.roll`` of noise and setpoint lanes together."""
    *_, bm_t, jbm_t, batch, r0 = setup
    sched = _schedules(r0)["per_block"]
    R = 3
    checksum, ok = fr.make_amortized_run(
        bm_t, T, setpoints=_t([sched])[0])(*_t(batch), R)
    jsum, jok = jpr.make_amortized_pallas_run(
        jbm_t, T, batch_block=4, interpret=True,
        setpoints=jnp.asarray(sched, jnp.float32),
    )(*_j(batch), R)
    assert bool(ok) and bool(jok)
    np.testing.assert_allclose(float(checksum), float(jsum), rtol=1e-5)
    op = fr._build_fused_operator(bm_t)
    s0, W = fr._center_and_pack(bm_t, *_t(batch), N_OUTER, K, 0,
                                setpoints=_t([sched])[0])
    assert W.shape == (B, N_OUTER, 2 * K + 4)
    for i in (1, 4):
        rotated = fr.fused_rollout(op, s0, W, w_off=(-i) % N_OUTER)
        rolled = fr.fused_rollout_reference(
            op, s0, torch.roll(W, i, dims=1).contiguous())
        for a, b in zip(rotated, rolled):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("n_steps", [48, 45])
def test_in_scan_noise_is_bounded_and_equals_explicit_draws(setup,
                                                            n_steps):
    """The classic engine's in-scan noise: drawn block by block from a
    generator, it equals the explicit-noise run fed the same draws (a
    generator with the same seed, one ``draw_block_noise`` per block), u
    and y bit for bit, with a tracking schedule; the draws lie within
    eps_max and fill it."""
    *_, bm_t, _, batch, r0 = setup
    eps = 0.002
    n_outer = -(-n_steps // K)
    sched = _t([0.9 * r0])[0]
    run = le.make_linear_batched_rollout(bm_t, n_steps, use_rng_noise=True,
                                         eps_max=eps, setpoints=sched)
    got = run(*_t(batch[:3]), torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    draws = torch.stack([draw_block_noise(gen, B, 2 * K, eps, "cpu")
                         for _ in range(n_outer)], dim=1)
    assert float(draws.abs().max()) <= eps
    assert float(draws.abs().max()) > 0.9 * eps
    assert abs(float(draws.mean())) < 0.1 * eps
    Ws = draws.reshape(B, n_outer * K, 2)[:, :n_steps]
    want = le.make_linear_batched_rollout(bm_t, n_steps, setpoints=sched)(
        *_t(batch[:3]), Ws)
    fields = ["u_sys", "y_sys", "costs"]
    if n_steps % K == 0:  # else the padded steps' noise moves the carry
        fields += ["x_final", "u_past", "y_past"]
    for field in fields:
        torch.testing.assert_close(getattr(got, field),
                                   getattr(want, field), rtol=0, atol=0,
                                   msg=field)
    other = run(*_t(batch[:3]), torch.Generator().manual_seed(8))
    assert not torch.equal(other.y_sys, got.y_sys)
    with pytest.raises(ValueError, match="generator"):
        le.linear_batched_rollout(bm_t, *_t(batch[:3]), None, n_steps,
                                  setpoints=sched)


def test_schedules_are_validated(setup):
    """Setpoints on a plain map, a tracking map without a schedule, a
    schedule of the wrong shape and ``cost_mode="post"`` raise, in the
    fused, classic and generic engines, with the JAX package's
    messages."""
    jplant, _, ctrl, bm, bm_t, _, batch, r0 = setup
    args = _t(batch)
    r = _t([r0])[0]
    with pytest.raises(ValueError, match="requires a tracking"):
        fr.pallas_batched_rollout(bm, *args, T, setpoints=r)
    with pytest.raises(ValueError, match="requires a `setpoints`"):
        fr.pallas_batched_rollout(bm_t, *args, T)
    with pytest.raises(ValueError, match="must broadcast"):
        fr.pallas_batched_rollout(bm_t, *args, T, setpoints=r[:3])
    with pytest.raises(ValueError, match="must broadcast"):
        fr.pallas_batched_rollout(bm_t, *args, T,
                                  setpoints=r.expand(N_OUTER + 1, 4))
    with pytest.raises(NotImplementedError, match="post"):
        fr.make_fused_batched_rollout(bm_t, T, cost_mode="post")
    with pytest.raises(ValueError, match="require a tracking"):
        le.make_linear_batched_rollout(bm, T, setpoints=r)(*args)
    with pytest.raises(ValueError, match="requires a `setpoints`"):
        le.make_linear_batched_rollout(bm_t, T)(*args)
    with pytest.raises(ValueError, match="must have shape"):
        le.make_linear_batched_rollout(
            bm_t, T, setpoints=r.expand(B + 1, N_OUTER, 4))(*args)
    tm = ctrl.tracking_map(device="cpu")
    plant = jplant.as_params()
    with pytest.raises(ValueError, match="requires a `setpoints`"):
        closed_loop_rollout(plant, tm, *args, n_steps=T)
    with pytest.raises(ValueError, match="must have shape"):
        closed_loop_rollout(plant, tm, *args, n_steps=T,
                            setpoints=r.expand(T - 1, 4))
    with pytest.raises(ValueError, match="TrackingMap"):
        closed_loop_rollout(plant, ctrl.solution_map(device="cpu"), *args,
                            n_steps=T, setpoints=r)
    with pytest.raises(ValueError, match="float32 or torch.float64"):
        ctrl.tracking_map(device="cpu", dtype=torch.float16)
    assert fr.suggest_solves_per_block(4, 4, 2, 2, n_r=4) == (128 - 24) // 2


def test_generic_loop_rejects_iterative_solvers(setup, convex_ctrl):
    """The generic loop rejects the host operator dicts of ``qp.admm``
    and ``qp.box`` (and any unknown type) with ``TypeError``, and runs
    their device solvers (ADMM, box ADMM, and the NON_CONVEX one in
    tests/test_torch_nonconvex.py), each with its cold state."""
    _, _, ctrl, *_ = setup
    for op in (compute_admm_operator_np(convex_ctrl.spec),
               compute_box_admm_operator_np(ctrl.spec,
                                            u_bounds=(-0.85, 0.85),
                                            rho=1.0)):
        with pytest.raises(TypeError, match="solver type"):
            make_solve_fn(op, 2)
    with pytest.raises(TypeError, match="solver type"):
        make_solve_fn(object(), 2)
    theta = torch.zeros((3, 16))
    for solver in (convex_ctrl.admm_solver(device="cpu"),
                   ctrl.box_admm_solver(u_bounds=(-0.85, 0.85), rho=1.0,
                                        device="cpu")):
        solve, state0 = make_solve_fn(solver, 2, admm_iters=4)
        u_seq, cost, state, ok = solve(
            theta, type(state0)(*(x.expand(3, *x.shape[1:])
                                  for x in state0)))
        assert u_seq.shape == (3, 30, 2) and cost.shape == ok.shape == (3,)
        assert state.s.shape == (3, solver.v_c.shape[-1])


def test_suggest_solves_per_block_with_setpoint_lanes_matches_jax():
    for n_steps in (None, 400, 37):
        for n_r in (0, 4):
            assert fr.suggest_solves_per_block(
                4, 4, 2, 2, n_steps=n_steps, n_r=n_r
            ) == jpr.suggest_solves_per_block(4, 4, 2, 2, n_steps=n_steps,
                                              n_r=n_r)
    # four_tank_tracking (bench.py): 50 solves per block, 104 W rows.
    assert fr.suggest_solves_per_block(4, 4, 2, 2, n_steps=400, n_r=4) == 50


@pytest.mark.parametrize("entry", ["compute_tracking_map",
                                   "build_tracking_engine"])
def test_tracking_entry_points_run_on_the_card_by_default(monkeypatch,
                                                          setup, entry):
    jplant, _, ctrl, *_ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "compute_tracking_map":
            sm.compute_tracking_map(ctrl.spec)
        else:
            le.build_tracking_engine(ctrl, jplant.as_params())
