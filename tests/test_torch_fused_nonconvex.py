"""PyTorch port, the NON_CONVEX slack (the paper's Eq. 6d) through the
fused ADMM entry: ``ops/fused_admm.py``'s NON_CONVEX mode (the plain
version of kernel K4's mode) held to the generic closed loop with a
``NonConvexADMMSolver`` at the same trip counts and to the benchmark's
float64 reference (``port_bench/reference_nonconvex.py``), at c = 1 (the
benchmark's configuration), c = 0.05 (``bench.py``'s) and c = 0.005,
where the bound binds on this controller, and to the JAX package's generic
NON_CONVEX closed loop on the same data, windows and noise. The CUDA
kernel itself is held to the plain version in tests/test_torch_cuda.py,
on a card."""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from direct_data_driven_mpc_tpu.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController as JaxController,
)
from direct_data_driven_mpc_tpu.control.loop import (  # noqa: E402
    closed_loop_rollout as jax_closed_loop_rollout,
)
from direct_data_driven_mpc_tpu.ops.lti import (  # noqa: E402
    LTIParams as JaxLTIParams,
)
from direct_data_driven_mpc_tpu.qp import nonconvex as jnc  # noqa: E402
from direct_data_driven_mpc_tpu.qp.spec import (  # noqa: E402
    DataDrivenMPCType as JaxType,
    SlackVarConstraintTypes as JaxSlack,
)
from direct_data_driven_mpc_tpu_torch.control.loop import (  # noqa: E402
    closed_loop_rollout,
)
from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp.admm import (  # noqa: E402
    compute_admm_operator_np,
)
from direct_data_driven_mpc_tpu_torch.qp.nonconvex import (  # noqa: E402
    NonConvexState,
    compute_nonconvex_admm_solver,
    compute_nonconvex_operator_np,
)
from port_bench import reference, reference_nonconvex, traffic  # noqa: E402
from port_bench.engines import nonconvex as engine, plant  # noqa: E402

from tests.test_torch_iterative import one_blas_thread  # noqa: E402,F401

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "port_bench"
                     / "configs" / "four_tank_nonconvex.json").read_text())
RHO, ALPHA, INNER, OUTER = 2000.0, 1.6, 16, 4
#: The generic loop's tolerances (make_solve_fn, nonconvex_admm_solve).
TOL, OUTER_TOL = 1e-6, 1e-6
B, T = 4, 30


def _config(c):
    cfg = json.loads(json.dumps(CONFIG))
    cfg["controller"]["c"] = c
    return cfg


@pytest.fixture(scope="module", params=[1.0, 0.05, 0.005],
                ids=["c1", "c0.05", "c0.005"])
def case(request):
    """The benchmark's four-tank data run (seed 7) at ``c``: the
    program's controller and its Eq. 6d operator, the inputs of B
    scenarios, each with its own noise."""
    cfg = _config(request.param)
    data = traffic.data_run(cfg, 7)
    ctrl = engine.controller(cfg, data)
    op = compute_nonconvex_operator_np(ctrl.spec, rho=RHO, alpha=ALPHA)
    rng = np.random.default_rng(1)
    W = 0.002 * rng.uniform(-1, 1, (B, T, 2))

    def tile(a):
        a = torch.as_tensor(np.asarray(a), dtype=torch.float32)
        return a.expand(B, *a.shape).contiguous()

    ins = (tile(data.x0), tile(data.u_past), tile(data.y_past),
           torch.as_tensor(W, dtype=torch.float32))
    return dict(c=request.param, cfg=cfg, data=data, ctrl=ctrl, op=op,
                ins=ins, W=W)


def _fused(case, n_steps=T, keep=None, **kw):
    def rollout(*args, **kwargs):
        out = fa.fused_admm_reference(*args, **kwargs)
        if keep is not None:
            keep.append(out)
        return out

    return fa.make_fused_admm_rollout(
        plant(case["cfg"]), case["op"], 4, 2, 2, n_steps, iters=(INNER,),
        tol=TOL, outer_iters=OUTER, outer_tol=OUTER_TOL, device="cpu",
        rollout=rollout, **kw)


def test_plain_version_matches_generic_loop(case):
    """The same fixed point at the same trip counts (4 bound updates,
    each after 16 iterations, from nonconvex_initial_state): inputs
    within 1e-4 (the benchmark's limit), the final bound to 1e-5
    relative, every converged flag equal."""
    res = _fused(case)(*case["ins"])
    solver = compute_nonconvex_admm_solver(case["ctrl"].spec, rho=RHO,
                                           alpha=ALPHA, device="cpu")
    gen = closed_loop_rollout(plant(case["cfg"]), solver, *case["ins"], T,
                              admm_iters=INNER)
    assert float((res.u_sys - gen.u_sys).abs().max()) < 1e-4
    assert float((res.y_sys - gen.y_sys).abs().max()) < 1e-5
    torch.testing.assert_close(res.costs, gen.costs, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(res.solver_state.bound,
                               gen.solver_state.bound, rtol=1e-5, atol=0)
    torch.testing.assert_close(res.solver_state.s, gen.solver_state.s,
                               rtol=0, atol=1e-6)
    assert torch.equal(res.converged, gen.converged)
    assert isinstance(res.solver_state, NonConvexState)


def test_plain_version_matches_float64_reference(case):
    """Against the benchmark's float64 reference (the QP in [alpha;
    sigma], nothing of the program): inputs within 1e-4, the final bound
    to 1e-5 relative, every flag equal."""
    res = _fused(case)(*case["ins"])
    qp = reference.RobustQP(case["data"].u_d, case["data"].y_d,
                            case["cfg"]["controller"])
    solver = dict(rho=RHO, alpha=ALPHA, inner=INNER, outer=OUTER, tol=TOL,
                  outer_tol=OUTER_TOL)
    d = case["data"]
    ref = reference_nonconvex.closed_loop(
        case["cfg"]["model"], reference_nonconvex.nonconvex_maps(qp, RHO),
        solver, d.x0, d.u_past, d.y_past,
        torch.as_tensor(case["W"], dtype=torch.float64))
    assert np.abs(res.u_sys.double().numpy() - ref["u"]).max() < 1e-4
    bound = ref["solver_state"][:, -1]
    got = res.solver_state.bound.double().numpy()
    assert np.abs(got - bound).max() <= 1e-5 * bound.max()
    assert np.array_equal(res.converged.numpy(), ref["converged"])


def _jax_controller(cfg, data):
    """The JAX package's NON_CONVEX Robust controller on the same data,
    built from the configuration as ``engines.nonconvex.controller``
    builds the program's."""
    c = cfg["controller"]
    L, eps = c["L"], c["epsilon_bar"]
    return JaxController(
        n=c["n"], m=2, p=2, u_d=data.u_d, y_d=data.y_d, L=L,
        Q=c["Q_scalar"] * np.eye(2 * L), R=c["R_scalar"] * np.eye(2 * L),
        u_s=np.asarray(c["u_s"], np.float64).reshape(-1, 1),
        y_s=np.asarray(c["y_s"], np.float64).reshape(-1, 1),
        eps_max=eps, lamb_alpha=c["lambda_alpha_epsilon_bar"] / eps,
        lamb_sigma=c["lambda_sigma"], c=c["c"],
        slack_var_constraint_type=JaxSlack.NON_CONVEX,
        controller_type=JaxType(c["controller_type"]),
        n_mpc_step=c["n_mpc_step"], allow_nonconvex_slack=True,
    )


def test_plain_version_matches_jax_generic_loop(case):
    """Against the JAX package's generic closed loop with its
    NonConvexADMMSolver (float32, the same rho and alpha, 4 bound updates
    each after 16 iterations, from its nonconvex_initial_state) under
    ``vmap``, on the same data, initial state, windows and noise: inputs
    within 1e-4, outputs within 1e-5, the costs, the returned s and the
    bound (1e-5 relative), every converged flag equal. Measured on the
    CPU at the three c: max |du| 9.6e-6, |dy| 4.2e-7, |dcost| 4.4e-5, the
    bound 4.0e-7 relative, |ds| 3.5e-9; with ||alpha||_inf in place of
    ||alpha||_1, or the bound frozen at c eps_bar, the bound is 0.95
    relative off at every c."""
    res = _fused(case)(*case["ins"])
    js = jnc.compute_nonconvex_admm_solver(
        _jax_controller(case["cfg"], case["data"]).spec, rho=RHO,
        alpha=ALPHA, dtype=jnp.float32)
    jplant = JaxLTIParams(*(jnp.asarray(case["cfg"]["model"][k],
                                        jnp.float32) for k in "ABCD"))
    ref = jax.vmap(lambda x0, up, yp, w: jax_closed_loop_rollout(
        jplant, js, x0, up, yp, w, n_steps=T, admm_iters=INNER,
    ))(*(jnp.asarray(a.numpy(), jnp.float32) for a in case["ins"]))

    def j(a):
        return torch.as_tensor(np.array(a, np.float32))

    assert float((res.u_sys - j(ref.u_sys)).abs().max()) < 1e-4
    assert float((res.y_sys - j(ref.y_sys)).abs().max()) < 1e-5
    torch.testing.assert_close(res.costs, j(ref.costs), rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(res.solver_state.bound,
                               j(ref.solver_state.bound), rtol=1e-5, atol=0)
    torch.testing.assert_close(res.solver_state.s, j(ref.solver_state.s),
                               rtol=0, atol=1e-6)
    assert np.array_equal(res.converged.numpy(), np.asarray(ref.converged))


def test_the_bound_binds_at_small_c(case):
    """At c = 0.005 the bound is active in some solves (the clip moves
    s, so w leaves zero); at c = 1 and at bench.py's c = 0.05 it is not
    on this controller: ||sigma_pred||_inf stays below 0.9 of it in every
    solve (0.36-0.43 of it at c = 0.05 over twelve data runs)."""
    keep = []
    _fused(case, keep=keep)(*case["ins"])
    GP, BD, w = keep[0][9], keep[0][10], keep[0][7]
    active = GP.abs() <= 1e-4 * BD
    if case["c"] == 0.005:
        assert bool(active.any()) and float(w.abs().max()) > 0
    else:
        assert not bool(active.any())
        assert float(((GP + BD) / BD).max()) < 0.9


def test_segmented_run_matches_whole(case):
    """Two halves, the second resumed from the first's NonConvexState and
    final windows, reproduce the uninterrupted run."""
    x0, up, yp, W = case["ins"]
    whole = _fused(case)(x0, up, yp, W)
    first = _fused(case, T // 2)(x0, up, yp, W[:, : T // 2])
    second = _fused(case, T // 2)(
        first.x_final, first.u_past, first.y_past, W[:, T // 2 :],
        solver_state0=first.solver_state)
    joined = torch.cat([first.u_sys, second.u_sys], dim=1)
    assert float((joined - whole.u_sys).abs().max()) < 1e-5
    torch.testing.assert_close(second.solver_state.bound,
                               whole.solver_state.bound, rtol=1e-6, atol=0)
    assert torch.equal(torch.cat([first.converged, second.converged], 1),
                       whole.converged)


def _parent_reference(ops, dims, carry, W, n_iter, adds=None):
    """The plain version as it was before the NON_CONVEX mode, line for
    line: the box modes have to give its bits."""
    Bsz, n_blocks, _ = W.shape
    S, nbox, Mw = dims.S, dims.nbox, dims.Mw
    nbm, nbp = dims.nb * dims.m, dims.nb * dims.p
    alpha, beta, rho = dims.alpha, 1.0 - dims.alpha, dims.rho
    Wc = S + nbm + nbp + 1 + nbox
    M1u = ops.M1[:, :Mw].contiguous()
    M1z = ops.M1[:, Mw:].contiguous()
    M2c, b2c = ops.M2[:, :Wc].contiguous(), ops.b2[:Wc]
    M2z, b2z = ops.M2[:, Wc:].contiguous(), ops.b2[Wc:]
    kw = dict(dtype=ops.Vop.dtype, device=ops.Vop.device)
    U = torch.empty((Bsz, n_blocks, nbm), **kw)
    Y = torch.empty((Bsz, n_blocks, nbp), **kw)
    C = torch.empty((Bsz, n_blocks), **kw)
    RP = torch.empty((Bsz, n_blocks), **kw)
    RD = torch.empty((Bsz, n_blocks), **kw)
    s_flat, pre, vc, zth, s, w = carry
    for t in range(n_blocks):
        if adds is not None:
            pre = pre + adds[t, :Mw]
            vc = vc + adds[t, Mw : Mw + nbox]
            zth = zth + adds[t, Mw + nbox :]
        v_last = torch.zeros_like(s)
        s_prev = torch.zeros_like(s)
        for _ in range(n_iter):
            v = (s - w) @ ops.Vop + vc
            vh = alpha * v + beta * s
            s_new = torch.clamp(vh + w, ops.lo, ops.hi)
            w = w + vh - s_new
            v_last, s_prev, s = v, s, s_new
        RP[:, t] = (v_last - s).abs().amax(1)
        RD[:, t] = rho * (s - s_prev).abs().amax(1)
        tv = s - w
        m1 = tv @ M1u
        u = torch.clamp(pre[:, :nbm] + m1[:, :nbm], ops.u_lo, ops.u_hi)
        z = zth + tv @ M1z
        C[:, t] = (z * z).sum(1) + (pre[:, nbm] + m1[:, nbm])
        U[:, t] = u
        in2 = torch.cat([s_flat, u, W[:, t]], dim=1)
        out = in2 @ M2c + b2c
        s_flat = out[:, :S]
        pre = torch.cat(
            [out[:, S : S + nbm], out[:, S + nbm + nbp : Wc - nbox]], dim=1
        )
        Y[:, t] = out[:, S + nbm : S + nbm + nbp]
        vc = out[:, Wc - nbox :]
        zth = in2 @ M2z + b2z
    return U, Y, C, RP, RD, s_flat.contiguous(), s, w


@pytest.mark.parametrize("track", [False, True], ids=["convex", "tracked"])
def test_convex_mode_gives_the_parents_bits(track):
    """The CONVEX mode of the plain version, with and without tracking
    adds, equals the plain version before the NON_CONVEX mode bit for
    bit, on the four-tank Convex operator of the benchmark."""
    cfg = json.loads(json.dumps(CONFIG))
    cfg["controller"]["slack_var_constraint_type"] = 1
    data = traffic.data_run(cfg, 3)
    from port_bench.engines import controller

    ctrl = controller(cfg, data)
    op = compute_admm_operator_np(ctrl.spec, rho=RHO, alpha=ALPHA,
                                  return_setpoint_maps=track)
    kw = dict(iters=(4, 5, 2), cold_iters=24, tol=1e-5, device="cpu")
    if track:
        kw["setpoints"] = np.repeat([1.0, 0.9], 5)[:, None] * op["r_bar"]
    ins = tuple(torch.as_tensor(np.asarray(a), dtype=torch.float32)
                .expand(3, *np.shape(a)).contiguous()
                for a in (data.x0, data.u_past, data.y_past))
    W = torch.as_tensor(0.002 * np.random.default_rng(2).uniform(
        -1, 1, (3, 10, 2)), dtype=torch.float32)
    args = (plant(cfg), op, 4, 2, 2, 10)
    got = fa.make_fused_admm_rollout(
        *args, rollout=fa.fused_admm_reference, **kw)(*ins, W)
    want = fa.make_fused_admm_rollout(
        *args, rollout=_parent_reference, **kw)(*ins, W)
    for a, b in zip(got[:-1] + tuple(got.solver_state),
                    want[:-1] + tuple(want.solver_state)):
        assert torch.equal(a, b)


def test_alpha_l1_sums_in_the_kernels_order():
    """``alpha_l1`` adds |alpha| as the kernel's lanes do (lane cg: the
    columns 4 cg + 64 j + c in the order (j, c); the 16 lane sums by the
    xor butterfly), to the bit, and is the 1-norm to float32 rounding."""
    rng = np.random.default_rng(5)
    n_alpha, nth, nbox, R = 367, 16, 60, 6
    G = np.zeros((nth + nbox, 368))
    G[:, :n_alpha] = rng.standard_normal((nth + nbox, n_alpha))
    a_c = np.zeros(368)
    a_c[:n_alpha] = rng.standard_normal(n_alpha)
    nc = fa.NonConvexMaps(torch.as_tensor(G, dtype=torch.float32),
                          torch.as_tensor(a_c, dtype=torch.float32), 0.002)
    theta = torch.as_tensor(rng.standard_normal((R, nth)),
                            dtype=torch.float32)
    t = torch.as_tensor(rng.standard_normal((R, nbox)), dtype=torch.float32)
    got = fa.alpha_l1(theta, t, nc, n_alpha)
    a = (torch.cat([theta, t], 1) @ nc.G[:, :n_alpha]
         + nc.a_c[:n_alpha]).abs()
    for r in range(R):
        lanes = []
        for cg in range(16):
            acc = torch.zeros((), dtype=torch.float32)
            for j in range(6):
                for c in range(4):
                    col = 4 * cg + 64 * j + c
                    if col < n_alpha:
                        acc = acc + a[r, col]
            lanes.append(acc)
        for half in (8, 4, 2, 1):
            lanes = [lanes[i] + lanes[i + half] for i in range(half)]
        assert torch.equal(got[r], lanes[0])
    torch.testing.assert_close(got.double(), a.double().sum(1), rtol=1e-6,
                               atol=0)


def test_plan_and_rejections(case):
    """At four-tank the NON_CONVEX block takes 64 scenarios in 112,640
    bytes (K4's and a_c); the entry refuses tracking, cold iterations
    and a state without the bound, and an operator past the resident
    block (nbox above 192) has no plan, which the wrapper refuses on the
    card before the launch."""
    ops, dims = fa.build_fused_admm_operator(plant(case["cfg"]), case["op"],
                                             4, 2, 2, device="cpu")
    assert dims.n_alpha == 367 and tuple(ops.nc.G.shape) == (76, 368)
    assert fa.nonconvex_plan(dims) == (64, 112640)
    assert fa.nonconvex_plan(dims._replace(nbox=196))[0] == 0
    with pytest.raises(ValueError, match="tracking"):
        fa.build_fused_admm_operator(plant(case["cfg"]), case["op"], 4, 2,
                                     2, track=True, device="cpu")
    with pytest.raises(ValueError, match="cold"):
        fa.make_fused_admm_rollout(plant(case["cfg"]), case["op"], 4, 2, 2,
                                   T, cold_iters=24, device="cpu")
    run = _fused(case)
    x0, up, yp, W = case["ins"]
    with pytest.raises(ValueError, match="bound"):
        run(x0, up, yp, W, solver_state0=(torch.zeros(B, 60),
                                          torch.zeros(B, 60)))
    before = fa.fused_admm.launches
    out = fa.fused_admm(ops, dims, fa.ADMMCarry(*(
        torch.zeros(B, w) for w in (dims.S, dims.Mw, dims.nbox, dims.nxi,
                                    dims.nbox, dims.nbox))),
        W, 2, bound=torch.full((B,), ops.nc.c_eps), n_outer=2)
    assert len(out) == 12 and fa.fused_admm.launches == before
