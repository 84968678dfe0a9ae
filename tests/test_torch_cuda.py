"""PyTorch port, the CUDA kernels on a card: ``fused_rollout`` (K1),
``fused_rollout_nocost`` (K3), ``fused_admm`` (K4) and ``fused_ladder``
(K5) against their plain PyTorch versions and against the
framework-free goldens; and the generic loop's iterative solvers on the
card, with TF32 allowed by the caller, against the same loop on the CPU.

These tests need an NVIDIA card and skip without one. This file
imports no JAX, so on a machine without it run them with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from direct_data_driven_mpc_tpu_torch.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_tpu_torch.control.linear_engine import (  # noqa: E402
    build_linear_engine,
    build_tracking_engine,
)
from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams  # noqa: E402
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
from direct_data_driven_mpc_tpu_torch.utils import profiling  # noqa: E402

pytestmark = pytest.mark.cuda

GOLDEN = os.path.join(
    os.path.dirname(__file__), "golden", "four_tank_golden.npz"
)
BOX_GOLDEN = os.path.join(
    os.path.dirname(__file__), "golden", "four_tank_box_golden.npz"
)
PLANT = LTIParams(
    A=np.array([[0.921, 0, 0.041, 0], [0, 0.918, 0, 0.033],
                [0, 0, 0.924, 0], [0, 0, 0, 0.937]]),
    B=np.array([[0.017, 0.001], [0.001, 0.023], [0, 0.061], [0.072, 0]]),
    C=np.array([[1.0, 0, 0, 0], [0, 1, 0, 0]]),
    D=np.zeros((2, 2)),
)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _controller(golden, n_mpc_step=1):
    L = 30
    return DirectDataDrivenMPCController(
        n=4, m=2, p=2, u_d=golden["u_d"], y_d=golden["y_d"], L=L,
        Q=3.0 * np.eye(2 * L), R=1e-4 * np.eye(2 * L),
        u_s=np.array([[1.0], [1.0]]), y_s=np.array([[0.65], [0.77]]),
        eps_max=0.002, lamb_alpha=0.1 / 0.002, lamb_sigma=1000.0, c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=n_mpc_step,
    )


def _packed(golden, bm, n_steps, batch, device, seed=0, setpoints=None):
    p = 2
    rng = np.random.default_rng(seed)
    x0s = torch.as_tensor(np.tile(golden["x0"], (batch, 1)),
                          dtype=torch.float32, device=device)
    ups = torch.as_tensor(
        np.tile(golden["TEC_u_past0"][None], (batch, 1, 1)),
        dtype=torch.float32, device=device,
    )
    yps = torch.as_tensor(
        np.tile(golden["TEC_y_past0"][None], (batch, 1, 1)),
        dtype=torch.float32, device=device,
    )
    Ws = torch.as_tensor(0.002 * rng.uniform(-1, 1, (batch, n_steps, p)),
                         dtype=torch.float32, device=device)
    K = bm.os_c.shape[0] // bm.M_T.shape[0]
    n_outer = math.ceil(n_steps / K)
    return fr._center_and_pack(bm, x0s, ups, yps, Ws, n_outer, K,
                               n_outer * K - n_steps, setpoints)


@pytest.mark.parametrize(
    "n_steps,K,batch,w_off",
    [(40, 8, 16, 0), (37, 8, 40, 2), (400, 50, 4096, 3)],
)
def test_kernel_matches_plain_version(cuda, golden, n_steps, K, batch,
                                      w_off):
    """K1 against its plain version: U, Y and the final carry bit-equal
    at the main shape, where the kernel and cuBLAS both sum each value
    as one FMA chain, else within 2e-5 (cuBLAS may take another order at
    small batches); costs at rtol 1e-3, atol 1e-5."""
    bm = build_linear_engine(_controller(golden), PLANT,
                             solves_per_block=K, device=cuda)
    op = fr._build_fused_operator(bm)
    s0, W = _packed(golden, bm, n_steps, batch, cuda)
    before = fr.fused_rollout.launches
    got = fr.fused_rollout(op, s0, W, w_off=w_off)
    torch.cuda.synchronize()
    assert fr.fused_rollout.launches == before + 1
    U, Y, C, s_fin = fr.fused_rollout_reference(op, s0, W, w_off=w_off)
    atol = 0.0 if batch == 4096 else 2e-5
    for a, b in zip((got[0], got[1], got[3]), (U, Y, s_fin)):
        torch.testing.assert_close(a, b, rtol=0, atol=atol)
    torch.testing.assert_close(got[2], C, rtol=1e-3, atol=1e-5)


def _tracking_schedule(n_outer, device):
    """bench.py's retarget schedule: the baked setpoints, then 0.85 x
    them, in alternation every 2 outer blocks."""
    r0 = torch.tensor([1.0, 1.0, 0.65, 0.77], device=device)
    low = torch.tensor([(i // 2) % 2 == 1 for i in range(n_outer)],
                       device=device)
    return torch.where(low[:, None], 0.85 * r0, r0)


@pytest.mark.parametrize(
    "n_steps,K,batch,w_off", [(37, 8, 40, 2), (400, 50, 4096, 3)],
)
def test_k1_tracking_matches_plain_version(cuda, golden, n_steps, K, batch,
                                           w_off):
    """K1 on a tracking operator (four_tank_tracking at K = 50: rank 20,
    two slot passes, 104 W rows) with the retarget schedule against its
    plain version: U, Y and the final carry within 2e-5, costs at rtol
    1e-3, atol 1e-5."""
    bm = build_tracking_engine(_controller(golden), PLANT,
                               solves_per_block=K, device=cuda)
    op = fr._build_fused_operator(bm)
    assert (op.rank, op.nw) == (20, 2 * K + 4)
    assert fr.k1_pack(op).slots.shape[1] == 2
    sched = _tracking_schedule(math.ceil(n_steps / K), cuda)
    s0, W = _packed(golden, bm, n_steps, batch, cuda, setpoints=sched)
    before = fr.fused_rollout.launches
    got = fr.fused_rollout(op, s0, W, w_off=w_off)
    torch.cuda.synchronize()
    assert fr.fused_rollout.launches == before + 1
    U, Y, C, s_fin = fr.fused_rollout_reference(op, s0, W, w_off=w_off)
    for a, b in zip((got[0], got[1], got[3]), (U, Y, s_fin)):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)
    torch.testing.assert_close(got[2], C, rtol=1e-3, atol=1e-5)


def test_k1_tracking_at_r_bar_equals_the_plain_map(cuda, golden):
    """With the constant schedule r_bar the dr lanes are zero, and K1's
    U, Y and final carry on the tracking operator are bit-equal to K1's
    on the plain map (each value one FMA chain, with exact zero terms
    added); costs to float32 rounding of the wider factor."""
    n_steps, K, batch = 400, 50, 4096
    ctrl = _controller(golden)
    bm = build_linear_engine(ctrl, PLANT, solves_per_block=K, device=cuda)
    bm_t = build_tracking_engine(ctrl, PLANT, solves_per_block=K,
                                 device=cuda)
    plain = fr.fused_rollout(fr._build_fused_operator(bm),
                             *_packed(golden, bm, n_steps, batch, cuda))
    tracked = fr.fused_rollout(
        fr._build_fused_operator(bm_t),
        *_packed(golden, bm_t, n_steps, batch, cuda, setpoints=bm_t.r_bar),
    )
    for i in (0, 1, 3):
        assert torch.equal(tracked[i], plain[i]), i
    torch.testing.assert_close(tracked[2], plain[2], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("row", [99, 50])
def test_k1_nan_in_the_noise_poisons_as_the_plain_version(cuda, golden,
                                                          row):
    """One NaN in noise row ``row`` of one block (K = 50, B = 4096: the
    last noise row, in the slice every column tile streams, or one that
    the first three tiles skip): K1's U, Y and costs have the plain
    version's NaN pattern and its bits elsewhere, and the entry's
    ``converged`` is the plain entry's."""
    n_steps, K, batch, b, t = 400, 50, 4096, 1234, 3
    ctrl = _controller(golden)
    bm = build_linear_engine(ctrl, PLANT, solves_per_block=K, device=cuda)
    op = fr._build_fused_operator(bm)
    s0, W = _packed(golden, bm, n_steps, batch, cuda)
    W[b, t, row] = float("nan")
    got = fr.fused_rollout(op, s0, W)
    want = fr.fused_rollout_reference(op, s0, W)
    for a, c in zip(got, want):
        assert torch.equal(a.isnan(), c.isnan())
    for a, c in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        torch.testing.assert_close(a, c, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got[2], want[2], rtol=1e-3, atol=1e-5,
                               equal_nan=True)
    assert got[0][b, t:].isnan().all() and not got[0][b, :t].isnan().any()

    rng = np.random.default_rng(0)
    Ws = torch.as_tensor(0.002 * rng.uniform(-1, 1, (batch, n_steps, 2)),
                         dtype=torch.float32, device=cuda)
    Ws[b, t * K + row // 2, row % 2] = float("nan")
    args = [torch.as_tensor(np.tile(np.asarray(golden[k])[None],
                                    (batch,) + (1,) * np.ndim(golden[k])),
                            dtype=torch.float32, device=cuda)
            for k in ("x0", "TEC_u_past0", "TEC_y_past0")]
    res = fr.make_fused_batched_rollout(bm, n_steps)(*args, Ws)
    ref = fr.make_fused_batched_rollout(
        bm, n_steps, rollout=fr.fused_rollout_reference)(*args, Ws)
    assert torch.equal(res.converged, ref.converged)
    assert not res.converged[b, t * K:].any()
    assert res.converged[b, : t * K].all()


def test_k1_counts_the_slices_it_streams(cuda, golden):
    """Each K1 launch adds its pack's ``streamed`` and ``dense`` to
    ``fused_rollout.slices_streamed`` and ``slices_dense``: 84 and 120 a
    launch at the four-tank shape (K = 50), where the zero band leaves
    70.0 % of the product's slices."""
    bm = build_linear_engine(_controller(golden), PLANT,
                             solves_per_block=50, device=cuda)
    op = fr._build_fused_operator(bm)
    pack = fr.k1_pack(op)
    assert (pack.streamed, pack.dense) == (84, 120)
    s0, W = _packed(golden, bm, 400, 256, cuda)
    before = (fr.fused_rollout.launches, fr.fused_rollout.slices_streamed,
              fr.fused_rollout.slices_dense)
    for _ in range(3):
        fr.fused_rollout(op, s0, W)
    torch.cuda.synchronize()
    assert (fr.fused_rollout.launches, fr.fused_rollout.slices_streamed,
            fr.fused_rollout.slices_dense) == (
        before[0] + 3, before[1] + 3 * 84, before[2] + 3 * 120)


def test_rollout_plan_matches_library(cuda):
    """``rollout_plan`` mirrors the library's K1 plan (both kernels'
    threads and shared memory, and whether it fits) over states of 1 to
    210 and 0 to 1700 noise rows."""
    import ctypes

    from direct_data_driven_mpc_tpu_torch.ops import _kernels

    lib = _kernels.load("fused_rollout").lib
    plan = (ctypes.c_int * 7)()
    for S in (1, 3, 4, 5, 20, 33, 64, 128, 210):
        for nw in (0, 1, 16, 100, 250, 1000, 1600, 1700):
            fits = lib.fused_rollout_plan(S, nw, plan)
            want = fr.rollout_plan(S, nw)
            assert tuple(plan) == tuple(want), (S, nw)
            assert bool(fits) == want.fits, (S, nw)


def test_k1_kernels_blocks_per_sm(cuda):
    """At the four-tank shape (S = 20, nw = 100) K1's product runs two
    blocks per SM with at most 255 registers a thread and nothing
    spilled; its state pass launches (at least one block per SM), with
    nothing spilled."""
    import ctypes

    from direct_data_driven_mpc_tpu_torch.ops import _kernels

    lib = _kernels.load("fused_rollout").lib
    assert lib.fused_rollout_blocks_per_sm(20, 100, 1) >= 2
    assert lib.fused_rollout_blocks_per_sm(20, 100, 0) >= 1
    for which in (0, 1):
        regs, local = ctypes.c_int(), ctypes.c_int()
        assert lib.fused_rollout_kernel_attributes(
            which, ctypes.byref(regs), ctypes.byref(local)) == 0
        assert 0 < regs.value <= 255
        assert local.value == 0, which


@pytest.mark.parametrize("batch,n_steps,w_off", [(256, 50, 1), (37, 75, 2)])
def test_k1_large_plant_with_cost_columns(cuda, batch, n_steps, w_off):
    """K1 reaches large_plant's operator with its cost columns (460 rows,
    rank 200: 12 passes per slot), which the previous plan did not take:
    U, Y and the final carry within 1e-4 of the plain version (the bar of
    large_plant, whose float32 paths sit 2e-5 to 3e-5 from float64),
    costs, each a small difference of terms near 1e3, at rtol 1e-3, atol
    1e-2."""
    plant, ctrl, bm, _ = _large_plant_op(cuda)
    op = fr._build_fused_operator(bm)
    assert (op.S, op.nw, op.rank) == (210, 250, 200)
    assert fr.rollout_plan(op.S, op.nw).fits
    gen = torch.Generator(device=cuda).manual_seed(2)
    n_outer = math.ceil(n_steps / 25)
    s0 = 0.5 * (torch.rand((batch, op.S), generator=gen, device=cuda) - 0.5)
    W = 0.002 * (torch.rand((batch, n_outer, op.nw), generator=gen,
                            device=cuda) - 0.5)
    before = fr.fused_rollout.launches
    got = fr.fused_rollout(op, s0, W, w_off=w_off)
    torch.cuda.synchronize()
    assert fr.fused_rollout.launches == before + 1
    want = fr.fused_rollout_reference(op, s0, W, w_off=w_off)
    for a, b in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    torch.testing.assert_close(got[2], want[2], rtol=1e-3, atol=1e-2)


def test_kernel_matches_golden(cuda, golden):
    """The kernel through the batched entry point meets the float32
    north-star budget on the TEC golden run."""
    n_steps = 120
    bm = build_linear_engine(_controller(golden), PLANT,
                             solves_per_block=10, device=cuda)
    args = [
        torch.as_tensor(np.asarray(golden[k])[None], dtype=torch.float32,
                        device=cuda)
        for k in ("x0", "TEC_u_past0", "TEC_y_past0")
    ]
    Ws = torch.as_tensor(golden["w_sys"][:n_steps][None],
                         dtype=torch.float32, device=cuda)
    before = fr.fused_rollout.launches
    res = fr.pallas_batched_rollout(bm, *args, Ws, n_steps)
    assert fr.fused_rollout.launches == before + 1
    du = np.abs(res.u_sys[0].double().cpu().numpy()
                - golden["TEC_u"]).max()
    assert du < 1e-4, du


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda, golden):
    bm = build_linear_engine(_controller(golden), PLANT,
                             solves_per_block=8, device=cuda)
    op = fr._build_fused_operator(bm)
    s0, W = _packed(golden, bm, 40, 16, cuda)
    with pytest.raises(ValueError, match="float32"):
        fr.fused_rollout(op, s0.double(), W)
    with pytest.raises(ValueError, match="contiguous"):
        fr.fused_rollout(op, s0, W.transpose(0, 1).contiguous()
                         .transpose(0, 1))
    with pytest.raises(ValueError, match="w_off"):
        fr.fused_rollout(op, s0, W, w_off=W.shape[1])


def _admm_setup(scheme):
    """The box golden's CONVEX or BOX controller, its operator and the
    JAX engine's schedule for it (tests/test_fused_admm.py)."""
    g = np.load(BOX_GOLDEN)
    L = 30
    slack = "CONVEX" if scheme == "CONVEX" else "NONE"
    ctrl = DirectDataDrivenMPCController(
        n=4, m=2, p=2, u_d=g["u_d"], y_d=g["y_d"], L=L,
        Q=3.0 * np.eye(2 * L), R=1e-4 * np.eye(2 * L),
        u_s=np.array([[1.0], [1.0]]), y_s=np.array([[0.65], [0.77]]),
        eps_max=0.002, lamb_alpha=0.1 / 0.002, lamb_sigma=1000.0,
        c=float(g["convex_c"]) if scheme == "CONVEX" else 1.0,
        slack_var_constraint_type=SlackVarConstraintTypes[slack],
        controller_type=DataDrivenMPCType.ROBUST,
    )
    if scheme == "CONVEX":
        op = compute_admm_operator_np(ctrl.spec)
        kw = dict(iters=(4, 5, 2), cold_iters=24, tol=1e-5)
    else:
        u = float(g["u_box"])
        op = compute_box_admm_operator_np(ctrl.spec, u_bounds=(-u, u),
                                          rho=1.0)
        kw = dict(iters=(0, 14, 4), cold_iters=60, tol=2e-5)
    return g, op, kw


def _admm_inputs(g, scheme, batch, n_steps, device):
    """Golden initial window for every scenario; scenario 0 gets the
    golden noise, the others their own draws."""
    def tile(a):
        a = np.asarray(a)
        return torch.as_tensor(np.tile(a[None], (batch,) + (1,) * a.ndim),
                               dtype=torch.float32, device=device)

    W = 0.002 * np.random.default_rng(0).uniform(-1, 1, (batch, n_steps, 2))
    W[0] = g["w_sys"][:n_steps]
    return (tile(g["x0"]), tile(g[f"{scheme}_u_past0"]),
            tile(g[f"{scheme}_y_past0"]),
            torch.as_tensor(W, dtype=torch.float32, device=device))


@pytest.mark.parametrize(
    "scheme,batch,n_steps",
    [("CONVEX", 64, 120), ("BOX", 64, 120), ("CONVEX", 100, 37)],
)
def test_admm_kernel_matches_plain_version(cuda, scheme, batch, n_steps):
    """Kernel K4 against its plain version (u, y, state atol 2e-5; costs
    rtol 1e-3; converged flags equal), and scenario 0 against the
    float64 active-set golden (max |du| < 1e-4). Batch 100 leaves the
    last tile of 64 scenarios ragged."""
    g, op, kw = _admm_setup(scheme)
    args = (PLANT, op, 4, 2, 2, n_steps)
    ins = _admm_inputs(g, scheme, batch, n_steps, cuda)
    before = fa.fused_admm.launches
    got = fa.make_fused_admm_rollout(*args, device=cuda, **kw)(*ins)
    torch.cuda.synchronize()
    assert fa.fused_admm.launches == before + 1
    want = fa.make_fused_admm_rollout(
        *args, device=cuda, rollout=fa.fused_admm_reference, **kw
    )(*ins)
    for f in ("u_sys", "y_sys", "x_final", "u_past", "y_past"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=2e-5, msg=f)
    for a, b in zip(got.solver_state, want.solver_state):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)
    torch.testing.assert_close(got.costs, want.costs, rtol=1e-3, atol=1e-5)
    assert torch.equal(got.converged, want.converged)
    assert bool(got.converged.all())
    du = np.abs(got.u_sys[0].double().cpu().numpy()
                - g[f"{scheme}_u"][:n_steps]).max()
    assert du < 1e-4, du
    if scheme == "BOX":
        assert float(got.u_sys.abs().max()) <= float(g["u_box"]) + 1e-6


@pytest.mark.parametrize("entry", ["k1", "k4"])
def test_kernel_span_times_the_kernel_alone(cuda, golden, entry):
    """Each entry's ``ddmpc.kernel`` span holds a positive device time no
    longer than a CUDA-event pair around the whole ``rollout(...)``
    call, and its pack, cold start and result spans have device times."""
    pairs = []

    def timed(kernel):
        def rollout(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = kernel(*args)
            end.record()
            pairs.append((start, end))
            return out
        return rollout

    batch, n_steps = 1024, 120  # the box golden's noise run
    if entry == "k1":
        bm = build_linear_engine(_controller(golden), PLANT,
                                 solves_per_block=50, device=cuda)
        run = fr.make_fused_batched_rollout(bm, n_steps,
                                            rollout=timed(fr.fused_rollout))
        ins = _admm_inputs(np.load(BOX_GOLDEN), "CONVEX", batch, n_steps,
                           cuda)
        device_spans = {"ddmpc.pack", "ddmpc.kernel", "ddmpc.result"}
    else:
        g, op, kw = _admm_setup("CONVEX")
        run = fa.make_fused_admm_rollout(PLANT, op, 4, 2, 2, n_steps,
                                         device=cuda,
                                         rollout=timed(fa.fused_admm), **kw)
        ins = _admm_inputs(g, "CONVEX", batch, n_steps, cuda)
        device_spans = {"ddmpc.pack", "ddmpc.cold_start", "ddmpc.kernel",
                        "ddmpc.result"}
    run(*ins)
    torch.cuda.synchronize()
    pairs.clear()
    with profiling.collect() as spans:
        for _ in range(3):
            run(*ins)
    kernel = [s for s in spans if s.name == "ddmpc.kernel"]
    rollout = [s for s in spans if s.name == "ddmpc.rollout"]
    assert len(kernel) == len(rollout) == len(pairs) == 3
    for k, r, (start, end) in zip(kernel, rollout, pairs):
        assert k.parent == r.id and k.call == r.call
        assert 0 < k.device_ms <= start.elapsed_time(end)
    assert {s.name for s in spans if s.device_ms is not None} == device_spans


def test_admm_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    g, op, kw = _admm_setup("CONVEX")
    ops, dims = fa.build_fused_admm_operator(PLANT, op, 4, 2, 2,
                                             device=cuda)
    B, T = 8, 6
    carry = fa.ADMMCarry(*(
        torch.zeros(B, w, device=cuda)
        for w in (dims.S, dims.Mw, dims.nbox, dims.nxi, dims.nbox,
                  dims.nbox)
    ))
    W = torch.zeros(B, T, 2, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fa.fused_admm(ops, dims, carry._replace(sa=carry.sa.double()), W, 4)
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_admm(ops, dims, carry, W.transpose(0, 1).contiguous()
                      .transpose(0, 1), 4)
    with pytest.raises(ValueError, match="shape"):
        fa.fused_admm(ops, dims, carry, W[:, :, :1].contiguous(), 4)
    with pytest.raises(ValueError, match="n_iter"):
        fa.fused_admm(ops, dims, carry, W, -1)
    # An operator whose resident plan does not fit one block (nbox 600)
    # takes the wide body (K4w), which matches the plain version.
    nbox = 600
    big = dims._replace(nbox=nbox, nxi=dims.n_theta + nbox,
                        W2=dims.D2 + 1 + nbox + dims.n_theta + nbox)
    big_ops, big_carry = _random_wide_operators(ops, big, B, cuda)
    assert fa.admm_plan(big)[0] == 0 and fa.admm_wide_plan(big)[0] == 8
    before = (fa.fused_admm.launches, fa.fused_admm.wide_launches)
    got = fa.fused_admm(big_ops, big, big_carry, W, 4)
    torch.cuda.synchronize()
    assert (fa.fused_admm.launches,
            fa.fused_admm.wide_launches) == (before[0], before[1] + 1)
    want = fa.fused_admm_reference(big_ops, big, big_carry, W, 4)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=2e-5)


def _random_wide_operators(ops, dims, B, cuda, R=None, seed=0):
    """Seeded random operators and carries at ``dims`` (a wide shape):
    a contracting iteration (``Vop`` of norm about 0.4), bounds of +-1
    that a carry of 0.01 seldom reaches, so rounding is not amplified
    through the clip. With ``R``, a ladder of R rungs stacked."""
    rng = np.random.default_rng(seed)
    nbox = dims.nbox

    def t(*shape, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(shape),
                               dtype=torch.float32, device=cuda)

    lead = () if R is None else (R,)
    new = dict(
        Vop=t(*lead, nbox, nbox, scale=0.2 / math.sqrt(nbox)),
        M1=t(*lead, nbox, dims.Mw + dims.nxi, scale=0.05),
        M2=t(*lead, dims.D2, dims.W2, scale=0.05),
        b2=t(*lead, dims.W2, scale=0.05),
        lo=torch.full((nbox,), -1.0, device=cuda),
        hi=torch.full((nbox,), 1.0, device=cuda),
    )
    carry = fa.ADMMCarry(*(
        t(B, w, scale=0.01)
        for w in (dims.S, dims.Mw, nbox, dims.nxi, nbox, nbox)
    ))
    return ops._replace(**new), carry


def _ladder_setup(u_box=0.85):
    """The box golden's BOX controller with the default 7-rung ladder
    (tests/test_fused_admm.py::test_fused_ladder_matches_golden)."""
    from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl

    g, _, kw = _admm_setup("BOX")
    ctrl = DirectDataDrivenMPCController(
        n=4, m=2, p=2, u_d=g["u_d"], y_d=g["y_d"], L=30,
        Q=3.0 * np.eye(60), R=1e-4 * np.eye(60),
        u_s=np.array([[1.0], [1.0]]), y_s=np.array([[0.65], [0.77]]),
        eps_max=0.002, lamb_alpha=0.1 / 0.002, lamb_sigma=1000.0, c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=DataDrivenMPCType.ROBUST,
    )
    op = compute_box_admm_operator_np(ctrl.spec, u_bounds=(-u_box, u_box))
    return fl, g, op, kw


@pytest.mark.parametrize("u_box,batch,n_steps", [
    (0.85, 64, 120), (0.85, 100, 37), (3.0, 256, 60),
])
def test_ladder_kernel_matches_plain_version(cuda, u_box, batch, n_steps):
    """Kernel K5 against its plain version: rung lanes equal, u, y, state
    and ADMM state atol 2e-5, costs rtol 1e-3; at the saturated box,
    scenario 0 against the float64 golden (max |du| < 1e-4). Batch 100
    leaves the last rung group short; at |u| <= 3 with half the windows
    mirrored the groups walk different rung paths."""
    fl, g, op, kw = _ladder_setup(u_box)
    ins = _admm_inputs(g, "BOX", batch, n_steps, cuda)
    if u_box > 1:
        for a in ins[:3]:
            a[batch // 2:] *= -1.0
    lanes = {}

    def keep(fn, key):
        def rollout(*args):
            out = fn(*args)
            lanes[key] = out[5]
            return out
        return rollout

    args = (PLANT, op, 4, 2, 2, n_steps)
    before = fl.fused_ladder.launches
    got = fl.make_fused_ladder_rollout(
        *args, device=cuda, rollout=keep(fl.fused_ladder, "k"), **kw
    )(*ins)
    torch.cuda.synchronize()
    assert fl.fused_ladder.launches == before + 1
    want = fl.make_fused_ladder_rollout(
        *args, device=cuda, rollout=keep(fl.fused_ladder_reference, "p"),
        **kw,
    )(*ins)
    assert torch.equal(lanes["k"], lanes["p"])
    if u_box > 1:
        assert not torch.equal(lanes["k"][0], lanes["k"][-1])
    for f in ("u_sys", "y_sys", "x_final", "u_past", "y_past"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=2e-5, msg=f)
    for a, b in zip(got.solver_state, want.solver_state):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)
    torch.testing.assert_close(got.costs, want.costs, rtol=1e-3, atol=1e-5)
    assert torch.equal(got.converged, want.converged)
    if u_box < 1 and n_steps == 120:
        du = np.abs(got.u_sys[0].double().cpu().numpy() - g["BOX_u"]).max()
        assert du < 1e-4, du
        assert bool(got.converged[:, 5:].all())


def test_ladder_plan_matches_library_and_wrapper_rejects(cuda):
    """``ladder_tile_rows`` and ``ladder_wide_group`` mirror the
    library's plans; operators too large for the resident group rule
    (nbox 600) take the wide body (K5w), which matches the plain
    version; the wrapper refuses another rung group, rungs outside the
    ladder and inputs of the wrong type."""
    from direct_data_driven_mpc_tpu_torch.ops import _kernels

    fl, g, op, kw = _ladder_setup()
    lib = _kernels.load("fused_admm").lib
    ops, dims = fl.build_fused_ladder_operator(PLANT, op, 4, 2, 2,
                                               device=cuda)
    for nbox in (52, 60, 120, 200, 600):
        d = dims._replace(nbox=nbox, nxi=dims.n_theta + nbox)
        sizes = (d.S, 2, 2, d.nbox, d.nxi)
        assert lib.fused_ladder_tile_rows(*sizes) == fl.ladder_tile_rows(d)
        tile = fl.ladder_tile_rows(d)
        assert lib.fused_ladder_smem_bytes(*sizes) == (
            fl.ladder_kernel_smem_bytes(d, tile) if tile else 0)
        wide = fa.admm_wide_plan(d)
        assert (lib.fused_wide_tile_rows(*sizes),
                lib.fused_wide_smem_bytes(*sizes)) == wide
        assert wide[0] == fl.ladder_wide_group(d)
        plan = fa.wide_plan(d)
        assert lib.fused_wide_stage_floats(*sizes) == plan.stage
    # nbox 600: no resident group; the wide body, against the plain
    # version.
    nbox = 600
    big = dims._replace(nbox=nbox, nxi=dims.n_theta + nbox,
                        W2=dims.D2 + 1 + nbox + dims.n_theta + nbox)
    R = ops.Vop.shape[0]
    big_ops, big_carry = _random_wide_operators(ops, big, 19, cuda, R=R)
    G = fl.ladder_wide_group(big)
    assert fl.ladder_tile_rows(big) == 0 and G == 8
    Wb = torch.as_tensor(
        0.002 * np.random.default_rng(1).uniform(-1, 1, (19, 6, 2)),
        dtype=torch.float32, device=cuda)
    rung0b = torch.tensor([0, 3, 6], dtype=torch.int32, device=cuda)
    before = (fl.fused_ladder.launches, fl.fused_ladder.wide_launches)
    got = fl.fused_ladder(big_ops, big, big_carry, Wb, 4, rung0b, G)
    torch.cuda.synchronize()
    assert (fl.fused_ladder.launches,
            fl.fused_ladder.wide_launches) == (before[0], before[1] + 1)
    want = fl.fused_ladder_reference(big_ops, big, big_carry, Wb, 4,
                                     rung0b, G)
    assert torch.equal(got[5], want[5])  # the rung lanes
    for a, b in zip(got[:5] + got[6:], want[:5] + want[6:]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=2e-5)
    with pytest.raises(ValueError, match="rung_group"):
        fl.fused_ladder(big_ops, big, big_carry, Wb, 4, rung0b, 16)
    B, T = 70, 6
    carry = fa.ADMMCarry(*(
        torch.zeros(B, w, device=cuda)
        for w in (dims.S, dims.Mw, dims.nbox, dims.nxi, dims.nbox,
                  dims.nbox)
    ))
    W = torch.zeros(B, T, 2, device=cuda)
    rung0 = torch.full((2,), 3, dtype=torch.int32, device=cuda)
    before = fl.fused_ladder.launches
    with pytest.raises(ValueError, match="rung_group"):
        fl.fused_ladder(ops, dims, carry, W, 4, rung0, 32)
    with pytest.raises(ValueError, match="outside the ladder"):
        fl.fused_ladder(ops, dims, carry, W, 4, rung0 + 4, 64)
    with pytest.raises(ValueError, match="int32"):
        fl.fused_ladder(ops, dims, carry, W, 4, rung0.long(), 64)
    with pytest.raises(ValueError, match="float32"):
        fl.fused_ladder(ops, dims, carry._replace(wa=carry.wa.double()), W,
                        4, rung0, 64)
    assert fl.fused_ladder.launches == before


def _bit_equal_inputs(ctrl, plant_state, batch, n_steps, cuda):
    """Every scenario from the controller's initial window, each with its
    own noise (numpy, seed 0)."""
    def tile(a, shape):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=cuda).reshape(shape).expand(
            batch, *shape[1:]).contiguous()

    W = 0.002 * np.random.default_rng(0).uniform(-1, 1, (batch, n_steps, 2))
    return (tile(plant_state, (1, 4)), tile(ctrl.u_past, (1, 4, 2)),
            tile(ctrl.y_past, (1, 4, 2)),
            torch.as_tensor(W, dtype=torch.float32, device=cuda))


def _assert_bit_equal(got, want):
    for f in ("u_sys", "y_sys", "x_final", "u_past", "y_past"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f, a, b in zip(got.solver_state._fields, got.solver_state,
                       want.solver_state):
        assert torch.equal(a, b), f"solver_state.{f}"
    torch.testing.assert_close(got.costs, want.costs, rtol=1e-3, atol=1e-5)
    assert torch.equal(got.converged, want.converged)


@pytest.mark.parametrize("L,batch,iters,init_rung", [
    (30, 8192 - 13, (0, 16, 4), None),  # nbox 52: NT = 1, ragged group
    (30, 8192 - 13, (0, 0, 0), None),   # n_iter = 0
    (30, 8192 - 13, (0, 16, 4), 0),     # from the bottom rung: forced moves
    (64, 8192 - 13, (0, 16, 4), None),  # nbox 120: NT = 2, 16-row groups
])
def test_ladder_kernel_bit_equal_to_plain_version(cuda, L, batch, iters,
                                                  init_rung):
    """Kernel K5 (warp-owned scenarios, s and w in registers) is
    bit-equal to its plain version: u, y, the final windows, s, w, every
    rung lane and the final rungs equal (each v is the same FMA chain,
    the update rounds explicitly, residual maxima are exact); only the
    costs, summed in another order, are held at rtol 1e-3 / atol 1e-5.
    The batch is 8179: below about 8000 scenarios cuBLAS sums the plain
    version's products in another order (measured on an H100 at B =
    1000 to 6131: up to 8.3e-7 apart; bit-equal from 8179 on)."""
    from chip_smoke import build_four_tank_robust
    from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl

    plant, ctrl = build_four_tank_robust(L=L)
    op = compute_box_admm_operator_np(ctrl.spec, u_bounds=(-0.85, 0.85))
    n_steps = 30
    ins = _bit_equal_inputs(ctrl, plant.get_state(), batch, n_steps, cuda)
    lanes = {}

    def keep(fn, key):
        def rollout(*args):
            out = fn(*args)
            lanes[key] = out[5]
            return out
        return rollout

    kw = dict(iters=iters, cold_iters=80, tol=2e-5, init_rung=init_rung,
              device=cuda)
    args = (plant.as_params(), op, 4, 2, 2, n_steps)
    run = fl.make_fused_ladder_rollout(
        *args, rollout=keep(fl.fused_ladder, "k"), **kw)
    assert run.rung_group == (64 if L == 30 else 16)
    before = fl.fused_ladder.launches
    got = run(*ins)
    torch.cuda.synchronize()
    assert fl.fused_ladder.launches == before + 1
    want = fl.make_fused_ladder_rollout(
        *args, rollout=keep(fl.fused_ladder_reference, "p"), **kw)(*ins)
    assert torch.equal(lanes["k"], lanes["p"])
    if sum(iters):  # the groups walk the ladder
        assert bool((lanes["k"][:, 1:] != lanes["k"][:, :-1]).any())
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("L,N,iters,track,batch,rows", [
    (30, 400, (4, 5, 2), False, 8179, 64),  # four_tank_convex, nbox 60: NT = 1
    (60, 800, (4, 5, 2), False, 8179, 32),  # long_horizon_convex, nbox 120: NT = 2
    (30, 400, (4, 6, 2), True, 8179, 64),   # tracked: the adds on pre, vc, zth
    (30, 400, (0, 0, 0), False, 8179, 64),  # n_iter = 0: rp = rd = max |s|
    (30, 400, (4, 5, 2), False, 4083, 32),  # the half-height tile
    (30, 400, (4, 6, 2), True, 4083, 32),   # the half-height tile, tracked
])
def test_admm_kernel_bit_equal_to_plain_version(cuda, L, N, iters, track,
                                                batch, rows):
    """Kernel K4 (warp-owned scenarios, s and w in registers) stays
    bit-equal to its plain version on a ragged batch: u, y, the final
    windows, s and w equal, costs (summed by 16 lanes, in another order)
    at rtol 1e-3 / atol 1e-5. The plain version runs 8179 scenarios,
    where cuBLAS sums its products as one FMA chain (at B = 1000 to 6131
    it does not, and the two are up to 1.5e-5 apart). At 4083, where the
    plan halves the four-tank tile (``rows``, on a 132-SM H100), the
    kernel runs the first 4083 of the plain version's inputs, from the
    same carry (the entry's cold start and first maps are cuBLAS
    products too), and holds its outputs to the plain version's first
    rows: U, Y, the residuals, the final window, s and w equal."""
    from chip_smoke import build_four_tank_robust

    plant, ctrl = build_four_tank_robust(N=N, L=L, slack="CONVEX")
    op = compute_admm_operator_np(ctrl.spec, return_setpoint_maps=track)
    n_steps = 30
    ins = _bit_equal_inputs(ctrl, plant.get_state(), 8192 - 13, n_steps,
                            cuda)
    kw = dict(iters=iters, cold_iters=24, tol=1e-5, device=cuda)
    if track:  # four phases around the baked setpoints
        phases = np.repeat([1.0, 0.85, 1.1, 0.95], 8)[:n_steps]
        kw["setpoints"] = phases[:, None] * op["r_bar"][None]
    args = (plant.as_params(), op, 4, 2, 2, n_steps)
    _, dims = fa.build_fused_admm_operator(*args[:5], track=track,
                                           device=cuda)
    assert fa.admm_plan(dims, batch, fa.sm_count(cuda))[0] == rows
    store = {}

    def keep(*a):
        store["args"], store["out"] = a, fa.fused_admm_reference(*a)
        return store["out"]

    want = fa.make_fused_admm_rollout(*args, rollout=keep, **kw)(*ins)
    before = (fa.fused_admm.launches, fa.fused_admm.small_tile_launches)
    if batch == len(ins[0]):
        got = fa.make_fused_admm_rollout(*args, **kw)(*ins)
    else:
        ops, dims, carry, W, n_iter, adds = store["args"]
        got = fa.fused_admm(ops, dims, fa.ADMMCarry(
            *(c[:batch].contiguous() for c in carry)),
            W[:batch].contiguous(), n_iter, adds)
    torch.cuda.synchronize()
    assert (fa.fused_admm.launches, fa.fused_admm.small_tile_launches) == (
        before[0] + 1, before[1] + (rows != fa.admm_plan(dims)[0]))
    if batch == len(ins[0]):
        _assert_bit_equal(got, want)
        return
    names = ("U", "Y", "C", "RP", "RD", "s_fin", "sa_fin", "wa_fin")
    for name, a, b in zip(names, got, store["out"]):
        if name == "C":
            torch.testing.assert_close(a, b[:batch], rtol=1e-3, atol=1e-5)
        else:
            assert torch.equal(a, b[:batch]), name


def test_admm_kernel_two_blocks_per_sm(cuda):
    """At four_tank_convex the K4 block of the full batch (65536: 64
    scenarios, 111,168 bytes) and of the half-height tile (4096: 32
    scenarios, 4 a warp, 82,624 bytes) each leave room for two per SM;
    their instantiations' registers are pinned (the 64-scenario one's as
    before the half tile came; nvcc 12.8 on an H100), at most 128 a
    thread, nothing spilled."""
    import ctypes

    from direct_data_driven_mpc_tpu_torch.ops import _kernels

    lib = _kernels.load("fused_admm").lib
    sizes = (20, 2, 2, 60, 76)
    for B, rows, nbytes, warp_rows, registers in (
            (65536, 64, 111168, 8, K4_REGISTERS[8]),
            (4096, 32, 82624, 4, K4_REGISTERS[4])):
        assert lib.fused_admm_tile_rows(*sizes, B) == rows
        assert lib.fused_admm_smem_bytes(*sizes, B) == nbytes
        assert lib.fused_admm_blocks_per_sm(*sizes, B) == 2
        regs, local = ctypes.c_int(), ctypes.c_int()
        assert lib.fused_admm_kernel_attributes(
            60, warp_rows, ctypes.byref(regs), ctypes.byref(local)) == 0
        assert regs.value == registers
        assert local.value == 0
    assert lib.fused_admm_tile_rows(*sizes, 0) == 64  # no batch: the full
    assert lib.fused_admm_kernel_attributes(
        60, 2, ctypes.byref(regs), ctypes.byref(local)) != 0


#: Registers a thread of K4's NT = 1 instantiations (nvcc 12.8,
#: sm_90a), by scenarios a warp.
K4_REGISTERS = {8: 128, 4: 120}


def test_admm_plan_matches_library(cuda):
    """``admm_plan`` mirrors the library's K4 plan (rows and bytes, 0
    bytes where no block fits) at the four-tank window for boxes of 4 to
    196 lanes, with and without tracking features, at one and four
    steps per solve, for no batch and batches of 1, 4096, 4224, 4225,
    8448, 8449 and 65536 on this card (``sm_count``); at four_tank_convex
    on a 132-SM H100 the tile halves up to 4224."""
    from direct_data_driven_mpc_tpu_torch.ops import _kernels

    lib = _kernels.load("fused_admm").lib
    g, op, kw = _admm_setup("CONVEX")
    _, dims = fa.build_fused_admm_operator(PLANT, op, 4, 2, 2, device=cuda)
    sms = fa.sm_count(cuda)
    assert sms == torch.cuda.get_device_properties(cuda).multi_processor_count
    batches = (1, 4096, 4224, 4225, 8448, 8449, 65536)
    if sms == 132:
        assert [fa.admm_plan(dims, B, sms)[0] for B in batches] == [
            32, 32, 32, 64, 64, 64, 64]
    for nb in (1, 4):
        for extra in (0, 4):
            for nbox in range(4, 200, 8):
                nxi = dims.n_theta + nbox + extra
                D2 = dims.S + 4 * nb
                d = dims._replace(nb=nb, Mw=2 * nb + 1, D2=D2, nbox=nbox,
                                  nxi=nxi, W2=D2 + 1 + nbox + nxi)
                sizes = (d.S, 2 * nb, 2 * nb, nbox, nxi)
                for B in (0, *batches):
                    rows, nbytes = (fa.admm_plan(d, B, sms) if B
                                    else fa.admm_plan(d))
                    assert lib.fused_admm_tile_rows(*sizes, B) == rows, (
                        sizes, B)
                    assert lib.fused_admm_smem_bytes(*sizes, B) == (
                        nbytes if rows else 0), (sizes, B)


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("iters", [(4, 5, 2), (0, 0, 0)])
def test_admm_half_tile_bit_equal_to_full_tile(cuda, track, iters):
    """K4's half-height tile (32 scenarios a block, 4 a warp) gives the
    bits of its 64-scenario tile: the same scenarios run as a batch of
    4096 (the half tile, 128 blocks) and as the first rows of a batch of
    16896 (the full tile, 264 blocks) give equal U, Y, costs, residuals,
    final windows and ADMM state, with and without tracking adds, at 11
    and 0 iterations; so do ragged batches of 4099 and 33, whose last
    block is partial. Each launch adds its grid to the counters: one
    ``small_tile_launches`` on the half tile, ``min(blocks, SMs)`` to
    ``sms_reached``, the card's SMs to ``sms_total``."""
    from chip_smoke import build_four_tank_robust

    plant, ctrl = build_four_tank_robust(slack="CONVEX")
    op = compute_admm_operator_np(ctrl.spec, return_setpoint_maps=track)
    n_steps, full = 30, 16896
    ins = _bit_equal_inputs(ctrl, plant.get_state(), full, n_steps, cuda)
    kw = dict(iters=iters, cold_iters=24, tol=1e-5, device=cuda)
    if track:  # four phases around the baked setpoints
        phases = np.repeat([1.0, 0.85, 1.1, 0.95], 8)[:n_steps]
        kw["setpoints"] = phases[:, None] * op["r_bar"][None]
    store = {}

    def keep(*args):
        store["args"] = args
        return fa.fused_admm(*args)

    fa.make_fused_admm_rollout(plant.as_params(), op, 4, 2, 2, n_steps,
                               rollout=keep, **kw)(*ins)
    ops, dims, carry, W, n_iter, adds = store["args"]
    assert (adds is not None) == track and n_iter == sum(iters)
    sms = fa.sm_count(cuda)

    def counted(B, rows, small):
        before = (fa.fused_admm.small_tile_launches,
                  fa.fused_admm.sms_reached, fa.fused_admm.sms_total)
        assert fa.admm_plan(dims, B, sms)[0] == rows
        out = fa.fused_admm(ops, dims, fa.ADMMCarry(
            *(c[:B].contiguous() for c in carry)), W[:B].contiguous(),
            n_iter, adds)
        torch.cuda.synchronize()
        assert (fa.fused_admm.small_tile_launches, fa.fused_admm.sms_reached,
                fa.fused_admm.sms_total) == (
            before[0] + small, before[1] + min(-(-B // rows), sms),
            before[2] + sms)
        return out

    want = counted(full, 64, False)
    names = ("U", "Y", "C", "RP", "RD", "s_fin", "sa_fin", "wa_fin")
    for B in (4096, 4099, 33):
        got = counted(B, 32, True)
        for name, a, b in zip(names, got, want):
            assert torch.equal(a, b[:B]), (B, name)
    assert bool((want[3][:, -1] > 0).any())  # the residuals are not void


def _nonconvex_case(c, cuda, batch=8192 - 13, n_steps=30):
    """The four-tank controller of ``chip_smoke.build_four_tank_robust``
    with the NON_CONVEX slack at ``c``, its Eq. 6d operator (rho 2000,
    alpha 1.6, as ``four_tank_nonconvex``) and the bit-equality inputs."""
    from chip_smoke import build_four_tank_robust
    from direct_data_driven_mpc_tpu_torch.qp.nonconvex import (
        compute_nonconvex_operator_np,
    )

    plant, ctrl = build_four_tank_robust(slack="NON_CONVEX", c=c,
                                         allow_nonconvex_slack=True)
    op = compute_nonconvex_operator_np(ctrl.spec, rho=2000.0, alpha=1.6)
    ins = _bit_equal_inputs(ctrl, plant.get_state(), batch, n_steps, cuda)
    return plant.as_params(), op, ins


@pytest.mark.parametrize("c", [0.005, 1.0])
def test_admm_nonconvex_kernel_bit_equal_to_plain_version(cuda, c):
    """K4's NON_CONVEX mode (4 bound updates x 16 iterations) is
    bit-equal to its plain version on a ragged batch of 8179, where
    cuBLAS sums the plain version's products as one chain: u, y, the
    final windows, s, w, the final bound and every converged flag equal
    (the 1-norm is summed in the kernel's order,
    ``fused_admm.alpha_l1``); costs at rtol 1e-3 / atol 1e-5. At c =
    0.005 the bound binds in some solves, at c = 1 in none."""
    plant, op, ins = _nonconvex_case(c, cuda)
    kw = dict(iters=(16,), tol=1e-5, device=cuda)
    args = (plant, op, 4, 2, 2, ins[3].shape[1])
    before = fa.fused_admm.launches
    got = fa.make_fused_admm_rollout(*args, **kw)(*ins)
    torch.cuda.synchronize()
    assert fa.fused_admm.launches == before + 1
    want = fa.make_fused_admm_rollout(
        *args, rollout=fa.fused_admm_reference, **kw)(*ins)
    _assert_bit_equal(got, want)
    assert bool(got.converged.all())


def test_admm_nonconvex_plan_and_counters(cuda):
    """``nonconvex_plan`` mirrors the library's (at four-tank 64
    scenarios, 112,640 bytes, two blocks per SM, at most 128 registers a
    thread); the counters count only under
    ``profiling.collect()``: every scenario-solve once, some with the
    bound active at c = 0.005, the bound update's cycles a part of the
    kernel's."""
    import ctypes

    from direct_data_driven_mpc_tpu_torch.ops import _kernels

    lib = _kernels.load("fused_admm").lib
    plant, op, ins = _nonconvex_case(0.005, cuda, batch=1000, n_steps=20)
    ops, dims = fa.build_fused_admm_operator(plant, op, 4, 2, 2,
                                             device=cuda)
    sizes = (dims.S, 2, 2, dims.nbox, dims.nxi, dims.n_alpha)
    assert fa.nonconvex_plan(dims) == (64, 112640)
    assert lib.fused_admm_nonconvex_tile_rows(*sizes) == 64
    assert lib.fused_admm_nonconvex_smem_bytes(*sizes) == 112640
    assert lib.fused_admm_nonconvex_blocks_per_sm(*sizes) == 2
    for nbox in range(4, 200, 8):  # the plan at other boxes too
        d = dims._replace(nbox=nbox, nxi=dims.n_theta + nbox,
                          W2=dims.D2 + 1 + nbox + dims.n_theta + nbox)
        rows, nbytes = fa.nonconvex_plan(d)
        got = (dims.S, 2, 2, nbox, d.nxi, dims.n_alpha)
        assert lib.fused_admm_nonconvex_tile_rows(*got) == rows
        assert lib.fused_admm_nonconvex_smem_bytes(*got) == (
            nbytes if rows else 0)
    regs, local = ctypes.c_int(), ctypes.c_int()
    assert lib.fused_admm_nonconvex_kernel_attributes(
        60, ctypes.byref(regs), ctypes.byref(local)) == 0
    assert 0 < regs.value <= 128
    run = fa.make_fused_admm_rollout(plant, op, 4, 2, 2, 20, iters=(16,),
                                     device=cuda)
    before = fa.fused_admm_counters(cuda)
    run(*ins)
    assert fa.fused_admm_counters(cuda) == before
    with profiling.collect():
        run(*ins)
    after = fa.fused_admm_counters(cuda)
    d = {k: after[k] - before[k] for k in after}
    assert d["nonconvex_solves"] == 1000 * 20
    assert 0 < d["bound_active"] < d["nonconvex_solves"]
    assert 0 < d["bound_cycles"] < d["kernel_cycles"]


def test_ladder_kernel_two_blocks_per_sm(cuda):
    """At four_tank_ladder the K5 block (100,736 bytes, at most 128
    registers a thread) leaves room for two per SM."""
    import ctypes

    from direct_data_driven_mpc_tpu_torch.ops import _kernels

    lib = _kernels.load("fused_admm").lib
    assert lib.fused_ladder_smem_bytes(20, 2, 2, 52, 68) == 100736
    assert lib.fused_ladder_blocks_per_sm(20, 2, 2, 52, 68) == 2
    regs, local = ctypes.c_int(), ctypes.c_int()
    assert lib.fused_ladder_kernel_attributes(52, ctypes.byref(regs),
                                              ctypes.byref(local)) == 0
    assert 0 < regs.value <= 128


def _large_plant_op(cuda, K=25):
    """``large_plant`` (bench.py, seed 0) and its operator without cost
    columns."""
    from chip_smoke import build_large_plant

    plant, ctrl = build_large_plant()
    bm = build_linear_engine(ctrl, plant.as_params(), solves_per_block=K,
                             device=cuda)
    return plant, ctrl, bm, fr._build_fused_operator(bm, include_cost=False)


def _nocost_against_plain(cuda, batch, n_steps, w_off, K=25):
    """K3 at large_plant with K solves per block against its plain
    version (u, y and the final carry at 1e-4), one launch; and the
    ``cost_mode="post"`` path's u within 1e-4 of float64 on 8
    scenarios."""
    plant, ctrl, bm, op = _large_plant_op(cuda, K)
    rng = np.random.default_rng(0)
    x0s, ups, yps = (
        torch.as_tensor(np.tile(np.asarray(a).reshape(1, -1), (batch, 1)),
                        dtype=torch.float32, device=cuda).reshape(shape)
        for a, shape in ((plant.get_state(), (batch, 10)),
                         (ctrl.u_past, (batch, 10, 10)),
                         (ctrl.y_past, (batch, 10, 10)))
    )
    Ws = torch.as_tensor(0.002 * rng.uniform(-1, 1, (batch, n_steps, 10)),
                         dtype=torch.float32, device=cuda)
    n_outer = math.ceil(n_steps / K)
    s0, W = fr._center_and_pack(bm, x0s, ups, yps, Ws, n_outer, K,
                                n_outer * K - n_steps)
    before = fr.fused_rollout_nocost.launches
    got = fr.fused_rollout(op, s0, W, w_off=w_off)
    torch.cuda.synchronize()
    assert fr.fused_rollout_nocost.launches == before + 1
    want = fr.fused_rollout_reference(op, s0, W, w_off=w_off)
    for a, b in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    assert got[2].shape == (batch, n_outer, 0)
    res = fr.make_fused_batched_rollout(bm, n_steps, cost_mode="post")(
        x0s, ups, yps, Ws
    )
    bm64 = build_linear_engine(ctrl, plant.as_params(), solves_per_block=K,
                               device=cuda, dtype=torch.float64)
    u64 = fr.make_fused_batched_rollout(
        bm64, n_steps, rollout=fr.fused_rollout_reference
    )(
        x0s[:8].double(), ups[:8].double(), yps[:8].double(),
        Ws[:8].double(),
    ).u_sys
    assert float((res.u_sys[:8].double() - u64).abs().max()) < 1e-4


@pytest.mark.parametrize("batch,n_steps,w_off", [(4096, 100, 1),
                                                 (333, 50, 0)])
def test_nocost_kernel_matches_plain_version(cuda, batch, n_steps, w_off):
    """Kernel K3 at large_plant (460 rows, 710 columns, 64 scenarios per
    block) against its plain version. The bar is the float64 one (1e-4):
    in the transient (|u| up to 7) every float32 path is 2e-5 to 3e-5
    from float64, so where cuBLAS takes another summation order than the
    kernel (small batches) the two differ at that level. u also within
    1e-4 of float64."""
    _nocost_against_plain(cuda, batch, n_steps, w_off)


@pytest.mark.parametrize("batch,w_off", [(1024, 2), (100, 0)])
def test_nocost_kernel_32_row_plan(cuda, batch, w_off):
    """K3 at large_plant with K = 50 solves per block (D = 710 rows: the
    64-scenario plan needs 289,792 bytes, so the block takes 32) against
    its plain version and float64 at 1e-4, as at K = 25."""
    assert fr.nocost_plan(210, 500) == (32, 170240)
    _nocost_against_plain(cuda, batch, 200, w_off, K=50)


def test_nocost_plan_matches_library(cuda):
    """``nocost_plan`` mirrors the library's plan at large_plant's state
    (S = 210) for K = 25 .. 100 solves per block (nw = 10 K)."""
    from direct_data_driven_mpc_tpu_torch.ops import _kernels

    lib = _kernels.load("fused_rollout").lib
    for K in (25, 28, 29, 50, 99, 100):
        rows, nbytes = fr.nocost_plan(210, 10 * K)
        assert lib.fused_rollout_nocost_tile_rows(210, 10 * K) == rows
        assert lib.fused_rollout_nocost_smem_bytes(210, 10 * K) == (
            nbytes if rows else 0)


@pytest.mark.parametrize("plant_name,w_off", [("four_tank", 2),
                                               ("large_plant", 3)])
def test_nocost_kernel_ragged_tile(cuda, golden, plant_name, w_off):
    """K3 with a ragged batch (one tile of scenarios and 3 more) against
    the plain version on u, y and the final carry at the float64 bar
    (1e-4: the kernel's 3xTF32 products sum in another order than
    cuBLAS), at the four-tank's small operator (D = 120, K = 50) and at
    large_plant's (D = 460, 710 columns); one launch per call."""
    from direct_data_driven_mpc_tpu_torch.ops import _kernels

    lib = _kernels.load("fused_rollout").lib
    if plant_name == "four_tank":
        bm = build_linear_engine(_controller(golden), PLANT,
                                 solves_per_block=50, device=cuda)
        op = fr._build_fused_operator(bm, include_cost=False)
        batch = lib.fused_rollout_nocost_tile_rows(op.S, op.nw) + 3
        s0, W = _packed(golden, bm, 200, batch, cuda)
    else:
        _, _, _, op = _large_plant_op(cuda)
        batch = lib.fused_rollout_nocost_tile_rows(op.S, op.nw) + 3
        gen = torch.Generator(device=cuda).manual_seed(1)
        s0 = torch.rand((batch, op.S), generator=gen, device=cuda) - 0.5
        W = 0.002 * (torch.rand((batch, 8, op.nw), generator=gen,
                                device=cuda) - 0.5)
    before = fr.fused_rollout_nocost.launches
    got = fr.fused_rollout_nocost(op, s0, W, w_off=w_off)
    torch.cuda.synchronize()
    assert fr.fused_rollout_nocost.launches == before + 1
    want = fr.fused_rollout_reference(op, s0, W, w_off=w_off)
    for a, b in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def test_nocost_and_k1_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """K1 raises before the launch on an operator too large for its plan
    (large_plant's state with cost columns and 1600 noise rows: the state
    pass needs 709,520 bytes); K3 refuses an operator with cost
    columns, bad inputs and an operator beyond both of its plans (1000
    noise rows: even the 32-scenario plan needs 233,728 bytes, more than
    a block's 232,448)."""
    plant, ctrl, bm, op = _large_plant_op(cuda)
    full = fr._build_fused_operator(bm)
    B, n_outer = 8, 2
    s0 = torch.zeros(B, op.S, device=cuda)
    W = torch.zeros(B, n_outer, op.nw, device=cuda)
    nw = 1000
    wide = op._replace(G=torch.zeros(nw + op.S, op.G.shape[1], device=cuda),
                       nw=nw)
    nw_k1 = 1600
    wide_k1 = full._replace(
        G=torch.zeros(nw_k1 + op.S, full.G.shape[1], device=cuda), nw=nw_k1)
    assert fr.rollout_plan(op.S, nw_k1).state_bytes == 709520
    before = (fr.fused_rollout.launches, fr.fused_rollout_nocost.launches)
    with pytest.raises(ValueError, match="S=210, nw=1600"):
        fr.fused_rollout(wide_k1, s0, torch.zeros(B, n_outer, nw_k1,
                                                  device=cuda))
    with pytest.raises(ValueError, match="without cost columns"):
        fr.fused_rollout_nocost(full, s0, W)
    with pytest.raises(ValueError, match="float32"):
        fr.fused_rollout_nocost(op, s0.double(), W)
    with pytest.raises(ValueError, match="w_off"):
        fr.fused_rollout_nocost(op, s0, W, w_off=n_outer)
    with pytest.raises(ValueError, match="too large.*S=210, nw=1000"):
        fr.fused_rollout_nocost(wide, s0, torch.zeros(B, n_outer, nw,
                                                      device=cuda))
    assert (fr.fused_rollout.launches,
            fr.fused_rollout_nocost.launches) == before


@pytest.mark.parametrize("rho", [1.0, None], ids=["fixed", "ladder"])
def test_generic_loop_box_on_the_card_ignores_the_callers_tf32(cuda, rho):
    """With ``torch.set_float32_matmul_precision("high")`` set by the
    caller, the generic loop's box ADMM (fixed rho and the ladder) runs
    its products in IEEE float32 on the card: it agrees with the same
    loop on the CPU to float32 rounding, its rung lanes equal, and the
    caller's setting reads back afterwards."""
    from direct_data_driven_mpc_tpu_torch.control.loop import (
        closed_loop_rollout,
    )

    golden = np.load(BOX_GOLDEN)
    ctrl = _controller(golden)
    B, T = 64, 40
    gen = np.random.default_rng(0)
    ins = [np.tile(golden["x0"][None], (B, 1)),
           np.tile(golden["BOX_u_past0"][None], (B, 1, 1)),
           np.tile(golden["BOX_y_past0"][None], (B, 1, 1)),
           0.002 * gen.uniform(-1, 1, (B, T, 2))]
    runs = {}
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        for dev in ("cpu", cuda):
            solver = ctrl.box_admm_solver(u_bounds=(-0.85, 0.85), rho=rho,
                                          device=dev)
            runs[str(dev)] = closed_loop_rollout(
                PLANT, solver, *(torch.as_tensor(a, dtype=torch.float32,
                                                 device=dev) for a in ins),
                n_steps=T, admm_iters=60 if rho else 120,
            )
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
    cpu, card = runs["cpu"], runs["cuda"]
    torch.testing.assert_close(card.u_sys.cpu(), cpu.u_sys, rtol=0,
                               atol=2e-5)
    assert torch.equal(card.solver_state.rho_idx.cpu(),
                       cpu.solver_state.rho_idx)
    assert float(card.u_sys.abs().max()) <= 0.85 + 1e-6


def _realisation_hankels(golden, B, N=400, L=30, n=4):
    """B data realisations of the four-tank plant (seed s for realisation
    s, the golden controller's input and noise distributions) arranged
    into Hankels of depth L + n in numpy."""
    from direct_data_driven_mpc_tpu_torch.ops.host import (
        hankel_matrix_np,
        lti_rollout_np,
    )

    Hu, Hy = [], []
    for s in range(B):
        rng = np.random.default_rng(s)
        u_d = rng.uniform(-1, 1, (N, 2))
        w_d = 0.002 * rng.uniform(-1, 1, (N, 2))
        _, y_d = lti_rollout_np(*PLANT, np.zeros(4), u_d, w_d)
        Hu.append(hankel_matrix_np(u_d, L + n))
        Hy.append(hankel_matrix_np(y_d, L + n))
    return np.stack(Hu), np.stack(Hy)


def test_batched_operators_on_the_card_match_the_cpu(cuda, golden):
    """``build_batched_solution_operators`` at the paper's size (nz 571)
    on the card against its ``device="cpu"`` run: every field within
    1e-9 relative to the field's largest magnitude, every lane feasible."""
    from direct_data_driven_mpc_tpu_torch.qp.batch_build import (
        build_batched_solution_operators,
    )
    from direct_data_driven_mpc_tpu_torch.qp.spec import QPDims

    ctrl = _controller(golden)
    Hu, Hy = _realisation_hankels(golden, B=24)
    kw = dict(dims=QPDims(n=4, m=2, p=2, L=30, N=400), Q=ctrl.Q, R=ctrl.R,
              u_s=ctrl.u_s, y_s=ctrl.y_s, eps_max=0.002,
              lamb_alpha=0.1 / 0.002, lamb_sigma=1000.0, chunk=16)
    card = build_batched_solution_operators(Hu, Hy, device=cuda, **kw)
    cpu = build_batched_solution_operators(Hu, Hy, device="cpu", **kw)
    assert bool(card["feasible"].all()) and bool(cpu["feasible"].all())
    for key, want in cpu.items():
        got = card[key].cpu()
        assert got.dtype == want.dtype and got.shape == want.shape
        if key != "feasible":
            scale = max(1.0, float(want.abs().max()))
            torch.testing.assert_close(got, want, rtol=0, atol=1e-9 * scale)


def test_tuning_gradient_on_the_card_matches_the_cpu(cuda, golden):
    """The closed-loop objective's value and autograd gradient in float64
    on the card against the CPU's, rtol 1e-8."""
    from direct_data_driven_mpc_tpu_torch.control.tuning import (
        make_closed_loop_objective,
    )

    ctrl = _controller(golden)
    B, T = 4, 20
    rng = np.random.default_rng(2)
    ins = (np.tile(golden["x0"][None], (B, 1)),
           np.tile(golden["TEC_u_past0"][None], (B, 1, 1)),
           np.tile(golden["TEC_y_past0"][None], (B, 1, 1)),
           0.002 * rng.uniform(-1, 1, (B, T, 2)))
    log0 = np.log([100.0 * 0.1, 1000.0])
    out = []
    for dev in ("cpu", cuda):
        loss = make_closed_loop_objective(ctrl.spec, PLANT, *ins, n_steps=T,
                                          device=dev)
        params = torch.tensor(log0, requires_grad=True)
        value = loss(params)
        value.backward()
        out.append((value.detach().cpu(), params.grad))
    for want, got in zip(*out):
        torch.testing.assert_close(got, want, rtol=1e-8, atol=0)


@pytest.mark.parametrize("K", [1, 10])
def test_time_parallel_rollout_on_the_card_matches_the_cpu(cuda, golden, K):
    """One scenario's prefix scan in float64 where its block map lives,
    on the card and on the CPU, within 1e-9 (costs rtol 1e-7), and within
    the float64 budget of the golden inputs."""
    from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
        time_parallel_rollout,
    )

    ctrl = _controller(golden)
    args = (golden["x0"], golden["TEC_u_past0"], golden["TEC_y_past0"],
            golden["w_sys"], 120)
    out = []
    for dev in ("cpu", cuda):
        bm = build_linear_engine(ctrl, PLANT, solves_per_block=K,
                                 device=dev, dtype=torch.float64)
        res = time_parallel_rollout(bm, *args)
        assert res.u_sys.device.type == torch.device(dev).type
        out.append(res)
    cpu, card = out
    for name in ("u_sys", "y_sys", "x_final", "u_past", "y_past"):
        torch.testing.assert_close(getattr(card, name).cpu(),
                                   getattr(cpu, name), rtol=0, atol=1e-9)
    torch.testing.assert_close(card.costs.cpu(), cpu.costs, rtol=1e-7,
                               atol=1e-9)
    assert np.abs(card.u_sys.cpu().numpy() - golden["TEC_u"]).max() < 1e-9


def test_hankel_matrix_on_the_card_matches_the_cpu(cuda, golden):
    from direct_data_driven_mpc_tpu_torch.ops.hankel import (
        hankel_matrix,
        matrix_rank,
    )

    for dtype in (torch.float32, torch.float64):
        X = torch.as_tensor(golden["u_d"], dtype=dtype)
        H = hankel_matrix(X.to(cuda), 38)
        assert H.device.type == "cuda" and H.dtype == dtype
        torch.testing.assert_close(H.cpu(), hankel_matrix(X, 38), rtol=0,
                                   atol=0)
    assert int(matrix_rank(H)) == int(matrix_rank(H.cpu())) == 76


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_noise_draw_on_the_card_equals_the_cpu(cuda, dtype):
    """Scenario i's noise is the same bits on the card and on the CPU,
    for a whole batch and for a shard of it."""
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )

    for first in (0, 1000):
        card = draw_noise_batch(5, 4096, 50, 2, 0.002, cuda, dtype,
                                first_index=first)
        assert card.device.type == "cuda" and card.dtype == dtype
        assert torch.equal(card.cpu(), draw_noise_batch(
            5, 4096, 50, 2, 0.002, "cpu", dtype, first_index=first))


def test_sharded_k1_and_k4_at_world_size_one_equal_unsharded(cuda, golden):
    """On a world of one NCCL rank, the sharded fused rollout (K1) and
    the sharded fused ADMM (K4) launch their kernels and equal the
    unsharded runs bit for bit; the metrics equal those of the unsharded
    result."""
    from direct_data_driven_mpc_tpu_torch.parallel import mesh as pm

    mesh = pm.make_scenario_mesh()
    batch, n_steps = 256, 40
    bm = build_linear_engine(_controller(golden), PLANT,
                             solves_per_block=8, device=cuda)
    rng = np.random.default_rng(1)
    ins = [torch.as_tensor(a, dtype=torch.float32, device=cuda) for a in (
        np.tile(golden["x0"], (batch, 1)),
        np.tile(golden["TEC_u_past0"][None], (batch, 1, 1)),
        np.tile(golden["TEC_y_past0"][None], (batch, 1, 1)),
        0.002 * rng.uniform(-1, 1, (batch, n_steps, 2)))]
    before = fr.fused_rollout.launches
    got, metrics = pm.make_sharded_fused_rollout(mesh, bm, n_steps)(*ins)
    assert fr.fused_rollout.launches == before + 1
    want = fr.make_fused_batched_rollout(bm, n_steps)(*ins)
    for a, b in zip(got, want):
        if a is not None:
            assert torch.equal(a, b)
    assert float(metrics["mean_final_cost"]) == float(
        want.costs[:, -1].double().sum() / batch)
    assert float(metrics["frac_converged"]) == 1.0

    g, op, kw = _admm_setup("CONVEX")
    args = (PLANT, op, 4, 2, 2, n_steps)
    ins = _admm_inputs(g, "CONVEX", batch, n_steps, cuda)
    before = fa.fused_admm.launches
    got, metrics = pm.make_sharded_fused_admm_rollout(
        mesh, *args, device=cuda, **kw)(*ins)
    assert fa.fused_admm.launches == before + 1
    want = fa.make_fused_admm_rollout(*args, device=cuda, **kw)(*ins)
    for a, b in zip(got[:7] + tuple(got.solver_state),
                    want[:7] + tuple(want.solver_state)):
        assert torch.equal(a, b)
    assert float(metrics["frac_converged"]) == float(
        want.converged.double().mean())


def test_direct_example_kernel_engine_on_the_card(cuda):
    """The direct example's ``--engine kernel`` on the card: K1 launched
    once at B = 1, within 1e-4 of the host loop (float64) on the CLI's
    default configs (chip_smoke.py's ``example_configs``, no YAML)."""
    from chip_smoke import example_configs
    from direct_data_driven_mpc_tpu_torch.examples import (
        direct_data_driven_mpc_example as direct,
    )

    def run(engine, device):
        args = direct.parse_args(["--engine", engine, "--t_sim", "100",
                                  "--seed", "0", "--verbose", "0",
                                  "--device", device, "--no_plot"])
        return direct.simulate(*example_configs(), args)

    host = run("host", "cpu")
    fr.fused_rollout.launches = 0
    kern = run("kernel", "cuda")
    assert fr.fused_rollout.launches == 1
    assert np.abs(kern["u_sys"] - host["u_sys"]).max() < 1e-4
    assert kern["converged"].all()


def test_entry_step_on_the_card_matches_the_cpu(cuda):
    from direct_data_driven_mpc_tpu_torch.entry import entry

    fn, args = entry()
    assert all(a.device.type == "cuda" for a in args)
    got = fn(*args)
    cpu_fn, cpu_args = entry(device="cpu")
    want = cpu_fn(*cpu_args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0,
                                   atol=2e-5)


def _random_dims_ids():
    from chip_smoke import RANDOM_DIMS

    return [f"case{c[0]}" for c in RANDOM_DIMS]


def _random_dims_case(seed, slack="NONE"):
    """``(case, plant, controller)`` of one shape of
    tests/test_random_dims.py, built by the port alone
    (``chip_smoke.build_random_dims``)."""
    from chip_smoke import RANDOM_DIMS, build_random_dims

    case = RANDOM_DIMS[seed]
    return (case, *build_random_dims(case, slack))


def _random_dims_inputs(plant, ctrl, batch, n_steps, cuda):
    """Every scenario from the controller's initial window, each with its
    own noise (numpy, seed 0)."""
    n, m, p = ctrl.n, ctrl.m, ctrl.p

    def tile(a, shape):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=cuda).reshape(shape).expand(
            batch, *shape[1:]).contiguous()

    W = 0.002 * np.random.default_rng(0).uniform(-1, 1, (batch, n_steps, p))
    return (tile(plant.get_state(), (1, plant.get_system_order())),
            tile(ctrl.u_past, (1, n, m)), tile(ctrl.y_past, (1, n, p)),
            torch.as_tensor(W, dtype=torch.float32, device=cuda))


def _random_dims_packed(case, plant, ctrl, K, cuda, include_cost=True,
                        batch=8192 - 13):
    """K1's (or, without cost columns, K3's) operator and packed inputs
    at K solves per block: four outer blocks, the last one trimmed."""
    nb = case[6]
    bm = build_linear_engine(ctrl, plant.as_params(), solves_per_block=K,
                             device=cuda)
    op = fr._build_fused_operator(bm, include_cost=include_cost)
    n_steps = 3 * K * nb + 1
    _, steps_per_outer, n_outer, pad = fr._shape(bm, n_steps, nb)
    ins = _random_dims_inputs(plant, ctrl, batch, n_steps, cuda)
    return op, fr._center_and_pack(bm, *ins, n_outer, steps_per_outer, pad)


def _main_K(case):
    _, ns, n, m, p, _, nb, _, _ = case
    return fr.suggest_solves_per_block(ns, n, m, p, n_mpc_step=nb,
                                       n_steps=400)


@pytest.mark.parametrize("K", ["2", "main"])
@pytest.mark.parametrize("seed", range(7), ids=_random_dims_ids())
def test_k1_at_random_dims_bit_equal_to_plain_version(cuda, seed, K):
    """K1 at the seven shapes of tests/test_random_dims.py, at K = 2 and
    at the main path's K (odd S, Ku or Kp not a multiple of 4, two slot
    passes at p = 3): U, Y and the final carry bit-equal to the plain
    version at B = 8179, where cuBLAS sums it as one FMA chain; costs at
    rtol 1e-3, atol 1e-5."""
    case, plant, ctrl = _random_dims_case(seed)
    K = 2 if K == "2" else _main_K(case)
    op, (s0, W) = _random_dims_packed(case, plant, ctrl, K, cuda)
    before = fr.fused_rollout.launches
    got = fr.fused_rollout(op, s0, W, w_off=1)
    torch.cuda.synchronize()
    assert fr.fused_rollout.launches == before + 1
    U, Y, C, s_fin = fr.fused_rollout_reference(op, s0, W, w_off=1)
    for a, b in zip((got[0], got[1], got[3]), (U, Y, s_fin)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(got[2], C, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("seed", range(7), ids=_random_dims_ids())
def test_k3_at_random_dims_matches_plain_version(cuda, seed):
    """K3 (``cost_mode="post"``, 3xTF32) at the seven shapes, at the main
    path's K: U, Y and the final carry within 1e-4 of the plain
    version."""
    case, plant, ctrl = _random_dims_case(seed)
    op, (s0, W) = _random_dims_packed(case, plant, ctrl, _main_K(case),
                                      cuda, include_cost=False)
    before = fr.fused_rollout_nocost.launches
    got = fr.fused_rollout(op, s0, W, w_off=2)
    torch.cuda.synchronize()
    assert fr.fused_rollout_nocost.launches == before + 1
    want = fr.fused_rollout_reference(op, s0, W, w_off=2)
    for i in (0, 1, 3):
        torch.testing.assert_close(got[i], want[i], rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 3, 5, 6],
                         ids=["case0", "case1", "case3", "case5", "case6"])
def test_k4_at_random_dims_bit_equal_to_plain_version(cuda, seed):
    """K4 on the ROBUST shapes of tests/test_random_dims.py, the
    controller built with CONVEX slack (nbox 8, 27, 22, 18, 16; m, p of 1
    to 3; n_mpc_step 1, 3 or 5; UCON): u, y, the final windows, s and w
    bit-equal to the plain version at B = 8179, costs at rtol 1e-3 /
    atol 1e-5."""
    case, plant, ctrl = _random_dims_case(seed, slack="CONVEX")
    n, m, p, nb = ctrl.n, ctrl.m, ctrl.p, case[6]
    op = compute_admm_operator_np(ctrl.spec)
    n_steps, batch = 10 * nb + 1, 8192 - 13
    ins = _random_dims_inputs(plant, ctrl, batch, n_steps, cuda)
    kw = dict(iters=(4, 5, 2), cold_iters=24, tol=1e-5, n_mpc_step=nb,
              device=cuda)
    args = (plant.as_params(), op, n, m, p, n_steps)
    before = fa.fused_admm.launches
    got = fa.make_fused_admm_rollout(*args, **kw)(*ins)
    torch.cuda.synchronize()
    assert fa.fused_admm.launches == before + 1
    want = fa.make_fused_admm_rollout(
        *args, rollout=fa.fused_admm_reference, **kw)(*ins)
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("seed", range(7), ids=_random_dims_ids())
def test_k5_at_random_dims_bit_equal_to_plain_version(cuda, seed):
    """K5 at the seven shapes on the box |u| <= 0.85 (nbox 5 to 18, the
    default 7-rung ladder, 64-scenario rung groups): the rung lanes, u,
    y, the final windows, s, w and the final rungs bit-equal to the plain
    version at B = 8179, costs at rtol 1e-3 / atol 1e-5."""
    from chip_smoke import RANDOM_DIMS_BOX
    from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl

    case, plant, ctrl = _random_dims_case(seed)
    n, m, p, nb = ctrl.n, ctrl.m, ctrl.p, case[6]
    op = compute_box_admm_operator_np(
        ctrl.spec, u_bounds=(-RANDOM_DIMS_BOX, RANDOM_DIMS_BOX))
    n_steps, batch = 10 * nb + 1, 8192 - 13
    ins = _random_dims_inputs(plant, ctrl, batch, n_steps, cuda)
    lanes = {}

    def keep(fn, key):
        def rollout(*args):
            out = fn(*args)
            lanes[key] = out[5]
            return out
        return rollout

    kw = dict(iters=(0, 16, 4), cold_iters=80, tol=2e-5, n_mpc_step=nb,
              device=cuda)
    args = (plant.as_params(), op, n, m, p, n_steps)
    run = fl.make_fused_ladder_rollout(
        *args, rollout=keep(fl.fused_ladder, "k"), **kw)
    assert run.rung_group == 64
    before = fl.fused_ladder.launches
    got = run(*ins)
    torch.cuda.synchronize()
    assert fl.fused_ladder.launches == before + 1
    want = fl.make_fused_ladder_rollout(
        *args, rollout=keep(fl.fused_ladder_reference, "p"), **kw)(*ins)
    assert torch.equal(lanes["k"], lanes["p"])
    _assert_bit_equal(got, want)


def _mid_wide_plant(slack, n, m, p, L, seed, N=600):
    """A random plant (``random_stable_lti(seed, ns=n, m, p)``) with a
    Robust controller built as ``chip_smoke.build_large_plant`` builds
    ``large_plant``'s, at other sizes."""
    from direct_data_driven_mpc_tpu_torch.models.random_lti import (
        random_stable_lti,
    )

    plant = random_stable_lti(seed=seed, ns=n, m=m, p=p)
    eps = plant.get_eps_max()
    u_s = 0.5 * np.ones((m, 1))
    y_s = plant.get_equilibrium_output_from_input(u_s.ravel()).reshape(-1, 1)
    rng = np.random.default_rng(seed)
    u_d = rng.uniform(-1, 1, (N, m))
    y_d = plant.simulate(u_d, eps * rng.uniform(-1, 1, (N, p)), N)
    return plant, DirectDataDrivenMPCController(
        n=n, m=m, p=p, u_d=u_d, y_d=y_d, L=L, Q=3.0 * np.eye(p * L),
        R=1e-4 * np.eye(m * L), u_s=u_s, y_s=y_s, eps_max=eps,
        lamb_alpha=0.1 / eps, lamb_sigma=1000.0, c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes[slack],
        controller_type=DataDrivenMPCType.ROBUST,
    )


def _wide_case(name):
    """``(plant, controller, operator, engine keywords, ladder)`` of a
    shape only the wide bodies take: ``large_plant`` with CONVEX slack
    (nbox 300) or on the box |u| <= 0.85 with the default ladder (nbox
    200), and just past the resident cap, nbox 196 both (CONVEX at m = p
    = 7, L = 28; the box at m = 7, p = 4, n = 4, L = 32)."""
    import chip_smoke as cs

    ladder = name.endswith("ladder")
    slack = "NONE" if ladder else "CONVEX"
    if name.startswith("large_plant"):
        plant, ctrl = cs.build_large_plant(slack=slack)
    elif ladder:
        plant, ctrl = _mid_wide_plant(slack, n=4, m=7, p=4, L=32, seed=0)
    else:
        plant, ctrl = _mid_wide_plant(slack, n=2, m=7, p=7, L=28, seed=7)
    if ladder:
        op = compute_box_admm_operator_np(
            ctrl.spec, u_bounds=(-cs.WIDE_BOX, cs.WIDE_BOX))
        return plant, ctrl, op, dict(cs.LADDER_KW), True
    op = compute_admm_operator_np(ctrl.spec)
    return plant, ctrl, op, dict(cs.WIDE_CONVEX_KW), False


def _engine(ladder):
    """``(module, make rollout, wrapper, plain version)`` of K4 or K5."""
    from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl

    if ladder:
        return (fl, fl.make_fused_ladder_rollout, fl.fused_ladder,
                fl.fused_ladder_reference)
    return (fa, fa.make_fused_admm_rollout, fa.fused_admm,
            fa.fused_admm_reference)


def _keep(fn, lanes, key):
    """``fn``, keeping its residual lanes (and K5's rung lanes)."""
    def rollout(*args):
        out = fn(*args)
        lanes[key] = out[3:6] if len(out) == 9 else out[3:5]
        return out
    return rollout


def _assert_close_at_rounding(got, want, lanes, tol):
    """u, y, the final windows, s and w within 2e-5, costs (small
    differences of terms near 1e3 at large_plant) at rtol 1e-3 / atol
    1e-2, the residual lanes within 2e-5, a converged flag different
    only where the two residuals fall on either side of ``tol``, and
    K5's rung lanes and final rungs equal."""
    for f in ("u_sys", "y_sys", "x_final", "u_past", "y_past"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=2e-5, msg=f)
    for a, b in zip(got.solver_state[:2], want.solver_state[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)
    torch.testing.assert_close(got.costs, want.costs, rtol=1e-3, atol=1e-2)
    k, p = lanes["k"], lanes["p"]
    for a, b in zip(k[:2], p[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)
    straddle = ((k[0] <= tol) != (p[0] <= tol)) | ((k[1] <= tol)
                                                   != (p[1] <= tol))
    flipped = got.converged != want.converged
    assert bool(straddle[flipped].all())
    if len(k) > 2:
        assert torch.equal(k[2], p[2])
        assert torch.equal(got.solver_state.rho_idx,
                           want.solver_state.rho_idx)


@pytest.mark.parametrize("name", ["large_plant_convex", "large_plant_ladder",
                                  "mid_wide_convex", "mid_wide_ladder"])
def test_wide_kernels_match_plain_version(cuda, name):
    """K4w and K5w, where the resident plans refuse the shape, against
    their plain versions at B = 8179 x T = 12: the route (the wide launch
    count goes up by one, the resident one not at all), K5's rung group
    ``ladder_wide_group``, and the results at
    ``_assert_close_at_rounding``'s bar."""
    plant, ctrl, op, kw, ladder = _wide_case(name)
    mod, make, wrapper, plain = _engine(ladder)
    args = (plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, 12)
    dims = (mod.build_fused_ladder_operator if ladder
            else mod.build_fused_admm_operator)(*args[:5], device=cuda)[1]
    assert dims.nbox == {"large_plant_convex": 300, "large_plant_ladder": 200
                         }.get(name, 196)
    ins = _random_dims_inputs(plant, ctrl, 8192 - 13, 12, cuda)
    lanes = {}
    run = make(*args, device=cuda, rollout=_keep(wrapper, lanes, "k"), **kw)
    if ladder:
        assert mod.ladder_tile_rows(dims) == 0
        assert run.rung_group == mod.ladder_wide_group(dims) > 0
    else:
        assert fa.admm_plan(dims)[0] == 0 and fa.admm_wide_plan(dims)[0] > 0
    before = (wrapper.launches, wrapper.wide_launches)
    got = run(*ins)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.wide_launches) == (before[0],
                                                         before[1] + 1)
    want = make(*args, device=cuda, rollout=_keep(plain, lanes, "p"),
                **kw)(*ins)
    _assert_close_at_rounding(got, want, lanes, kw["tol"])


@pytest.mark.parametrize("name", ["four_tank_convex", "four_tank_ladder",
                                  "four_tank_admm_tracking"])
def test_wide_body_matches_resident_body(cuda, name):
    """At shapes both bodies take, the wide body through the library's
    launcher against the resident one through the wrapper, at B = 8179 x
    T = 30: u, y, the final windows, s and w within 2e-5 (each output is
    the same FMA chain in both, so they agree to the bit unless the
    compiler contracts differently), costs at rtol 1e-3 / atol 1e-5, and
    K5's rung lanes equal: the wide plan's tile is the resident rung
    group, 64."""
    import chip_smoke as cs

    plant, ctrl, op, kw = cs.admm_config(name)
    ladder = name == "four_tank_ladder"
    mod, make, wrapper, _ = _engine(ladder)
    T = 30
    if "setpoints" in kw:
        kw["setpoints"] = kw["setpoints"][:T]
    args = (plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T)
    ins = _random_dims_inputs(plant, ctrl, 8192 - 13, T, cuda)
    lanes = {}
    run = make(*args, device=cuda, rollout=_keep(wrapper, lanes, "r"), **kw)
    before = wrapper.launches
    got = run(*ins)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    if ladder:
        assert run.rung_group == mod.ladder_wide_group(
            mod.build_fused_ladder_operator(*args[:5], device=cuda)[1]) == 64
    wide = make(*args, device=cuda,
                rollout=_keep(cs.wide_launcher(ladder), lanes, "w"),
                **kw)(*ins)
    torch.cuda.synchronize()
    for f in ("u_sys", "y_sys", "x_final", "u_past", "y_past"):
        torch.testing.assert_close(getattr(wide, f), getattr(got, f),
                                   rtol=0, atol=2e-5, msg=f)
    for a, b in zip(wide.solver_state, got.solver_state):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)
    torch.testing.assert_close(wide.costs, got.costs, rtol=1e-3, atol=1e-5)
    if ladder:
        assert torch.equal(lanes["w"][2], lanes["r"][2])


def test_segmented_ladder_resume_at_the_wide_group(cuda):
    """``large_plant_ladder`` through K5w in two segments, the second
    warm-started through ``solver_state0`` at the wide rung group (each
    group resumes at its own rung): each segment matches the plain
    version's same segment at ``_assert_close_at_rounding``'s bar, and
    the joined run stays within 1e-4 of the uninterrupted one (the
    resumed segment rebuilds its first maps from the carried window,
    the uninterrupted run takes them from the plant step)."""
    from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl

    plant, ctrl, op, kw, _ = _wide_case("large_plant_ladder")
    T, T1, Bs = 16, 6, 2048
    ins = _random_dims_inputs(plant, ctrl, Bs, T, cuda)
    base = (plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p)
    full = fl.make_fused_ladder_rollout(*base, T, device=cuda, **kw)(*ins)
    segs = {}
    for key, fn in (("k", fl.fused_ladder), ("p", fl.fused_ladder_reference)):
        lanes = {}
        first = fl.make_fused_ladder_rollout(
            *base, T1, device=cuda, rollout=_keep(fn, lanes, "1"), **kw)
        second = fl.make_fused_ladder_rollout(
            *base, T - T1, device=cuda, rollout=_keep(fn, lanes, "2"),
            **dict(kw, cold_iters=0))
        assert first.rung_group == second.rung_group == 32
        s1 = first(*ins[:3], ins[3][:, :T1])
        s2 = second(s1.x_final, s1.u_past, s1.y_past, ins[3][:, T1:],
                    solver_state0=s1.solver_state)
        segs[key] = (s1, s2, lanes)
    for h in (0, 1):
        lanes = {"k": segs["k"][2][str(h + 1)], "p": segs["p"][2][str(h + 1)]}
        _assert_close_at_rounding(segs["k"][h], segs["p"][h], lanes,
                                  kw["tol"])
    joined = torch.cat([segs["k"][0].u_sys, segs["k"][1].u_sys], dim=1)
    torch.testing.assert_close(joined, full.u_sys, rtol=0, atol=1e-4)


def test_wide_kernel_on_an_odd_grid(cuda):
    """At B = 8163 K4w's 16-scenario tile gives an odd grid of 511
    blocks, the last one part empty (its rows past B compute on zeros and
    store nothing). Held to the plain version at ``large_plant_convex``
    (T = 12) at ``_assert_close_at_rounding``'s bar."""
    plant, ctrl, op, kw, _ = _wide_case("large_plant_convex")
    args = (plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, 12)
    dims = fa.build_fused_admm_operator(*args[:5], device=cuda)[1]
    plan = fa.wide_plan(dims)
    assert plan.rows == 16
    B = 8163
    assert -(-B // plan.rows) == 511
    ins = _random_dims_inputs(plant, ctrl, B, 12, cuda)
    lanes = {}
    before = fa.fused_admm.wide_launches
    got = fa.make_fused_admm_rollout(
        *args, device=cuda, rollout=_keep(fa.fused_admm, lanes, "k"),
        **kw)(*ins)
    torch.cuda.synchronize()
    assert fa.fused_admm.wide_launches == before + 1
    want = fa.make_fused_admm_rollout(
        *args, device=cuda, rollout=_keep(fa.fused_admm_reference, lanes,
                                          "p"), **kw)(*ins)
    _assert_close_at_rounding(got, want, lanes, kw["tol"])


@pytest.mark.parametrize("ladder", [False, True])
def test_wide_kernels_at_zero_iterations(cuda, ladder):
    """``n_iter = 0``: no iteration product, so the residuals are max |s|
    of the carried state, and the producer warp streams only M1 and M2.
    K4w and K5w (three rungs) on seeded random operators at nbox 300
    against the plain version, at the bar of the wide launches in
    ``test_admm_wrapper_rejects_what_the_kernel_does_not_take``."""
    from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl

    g, op, kw = _admm_setup("CONVEX")
    ops, dims = fa.build_fused_admm_operator(PLANT, op, 4, 2, 2,
                                             device=cuda)
    nbox = 300
    big = dims._replace(nbox=nbox, nxi=dims.n_theta + nbox,
                        W2=dims.D2 + 1 + nbox + dims.n_theta + nbox)
    B = 37
    W = torch.as_tensor(
        0.002 * np.random.default_rng(3).uniform(-1, 1, (B, 5, 2)),
        dtype=torch.float32, device=cuda)
    if ladder:
        R = 3
        lops, _ = fl.build_fused_ladder_operator(
            PLANT, _ladder_setup()[2], 4, 2, 2, device=cuda)
        big_ops, carry = _random_wide_operators(lops, big, B, cuda, R=R)
        big_ops = big_ops._replace(rhos=big_ops.rhos[:R].contiguous())
        G = fl.ladder_wide_group(big)
        rung0 = torch.tensor([i % R for i in range(-(-B // G))],
                             dtype=torch.int32, device=cuda)
        before = fl.fused_ladder.wide_launches
        got = fl.fused_ladder(big_ops, big, carry, W, 0, rung0, G)
        torch.cuda.synchronize()
        assert fl.fused_ladder.wide_launches == before + 1
        want = fl.fused_ladder_reference(big_ops, big, carry, W, 0, rung0,
                                         G)
        assert torch.equal(got[5], want[5])  # the rung lanes
        got, want = got[:5] + got[6:], want[:5] + want[6:]
    else:
        big_ops, carry = _random_wide_operators(ops, big, B, cuda)
        before = fa.fused_admm.wide_launches
        got = fa.fused_admm(big_ops, big, carry, W, 0)
        torch.cuda.synchronize()
        assert fa.fused_admm.wide_launches == before + 1
        want = fa.fused_admm_reference(big_ops, big, carry, W, 0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=2e-5)


@pytest.mark.parametrize("S,nbox,nxi,residue", [(22, 200, 201, 0),
                                                (23, 199, 200, 3)])
def test_wide_kernels_at_widths_aligned_and_not(cuda, S, nbox, nxi, residue):
    """The wide bodies pad every operator row to a multiple of four
    floats: at widths nbox, W1 = Mw + nxi and W2 all = 0 mod 4 the padded
    operators are the operators, at widths all = 3 mod 4 (as at
    ``large_plant``: 511, 1031) each row gains one zero. K4w and K5w on
    seeded random operators at both, against the plain version, at the
    bar of the wide launches in
    ``test_admm_wrapper_rejects_what_the_kernel_does_not_take``."""
    from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl

    g, op, kw = _admm_setup("CONVEX")
    ops, dims = fa.build_fused_admm_operator(PLANT, op, 4, 2, 2,
                                             device=cuda)
    D2 = S + 4
    big = dims._replace(S=S, D2=D2, nbox=nbox, nxi=nxi,
                        W2=D2 + 1 + nbox + nxi)
    widths = (big.nbox, big.Mw + big.nxi, big.W2)
    assert all(x % 4 == residue for x in widths), widths
    assert fa.admm_plan(big)[0] == 0
    B = 70
    W = torch.as_tensor(
        0.002 * np.random.default_rng(4).uniform(-1, 1, (B, 6, 2)),
        dtype=torch.float32, device=cuda)
    big_ops, carry = _random_wide_operators(ops, big, B, cuda)
    padded = fa.wide_operators(big_ops.Vop, big_ops.M1, big_ops.M2)
    assert all(p.shape[-1] % 4 == 0 and p.is_contiguous() for p in padded)
    before = fa.fused_admm.wide_launches
    got = fa.fused_admm(big_ops, big, carry, W, 5)
    torch.cuda.synchronize()
    assert fa.fused_admm.wide_launches == before + 1
    want = fa.fused_admm_reference(big_ops, big, carry, W, 5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=2e-5)
    lops, _ = fl.build_fused_ladder_operator(
        PLANT, _ladder_setup()[2], 4, 2, 2, device=cuda)
    R = lops.Vop.shape[0]
    lad_ops, carry = _random_wide_operators(lops, big, B, cuda, R=R, seed=1)
    G = fl.ladder_wide_group(big)
    rung0 = torch.tensor([(3 * i) % R for i in range(-(-B // G))],
                         dtype=torch.int32, device=cuda)
    before = fl.fused_ladder.wide_launches
    got = fl.fused_ladder(lad_ops, big, carry, W, 5, rung0, G)
    torch.cuda.synchronize()
    assert fl.fused_ladder.wide_launches == before + 1
    want = fl.fused_ladder_reference(lad_ops, big, carry, W, 5, rung0, G)
    assert torch.equal(got[5], want[5])  # the rung lanes
    for a, b in zip(got[:5] + got[6:], want[:5] + want[6:]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=2e-5)


@pytest.mark.parametrize("name", ["four_tank_ladder_u3", "mid_wide_ladder"])
def test_ladder_kernels_bit_equal_to_plain_version_at_a_balance_ratio(
        cuda, name):
    """K5 (nbox 52, |u| <= 3, where the groups walk down the ladder) and
    K5w (nbox 196) at ``balance_ratio=7.3``, which float32 does not hold
    exactly, at B = 8179: launched once each, bit-equal to the plain
    version at that ratio in u, y, the final windows, s, w, the residual
    and rung lanes and the final rungs (costs at rtol 1e-3 / atol 1e-5).
    K5's rung lanes differ from its run at the default ratio: the kernel
    reads the argument."""
    import chip_smoke as cs
    from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl

    wide = name == "mid_wide_ladder"
    if wide:
        plant, ctrl, op, kw, _ = _wide_case(name)
    else:
        plant, ctrl, op, kw = cs.admm_config(name)
    n_steps = 12 if wide else 30
    ins = _random_dims_inputs(plant, ctrl, 8192 - 13, n_steps, cuda)
    args = (plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, n_steps)
    lanes = {}
    runs = {}
    for key, fn, ratio in (("k", fl.fused_ladder, 7.3),
                           ("p", fl.fused_ladder_reference, 7.3),
                           ("d", fl.fused_ladder, fl.BALANCE_RATIO)):
        before = (fl.fused_ladder.launches, fl.fused_ladder.wide_launches)
        runs[key] = fl.make_fused_ladder_rollout(
            *args, device=cuda, balance_ratio=ratio,
            rollout=_keep(fn, lanes, key), **kw)(*ins)
        torch.cuda.synchronize()
        after = (fl.fused_ladder.launches, fl.fused_ladder.wide_launches)
        if key != "p":
            assert after == (before[0] + (not wide), before[1] + wide)
    for a, b in zip(lanes["k"], lanes["p"]):
        assert torch.equal(a, b)  # residual and rung lanes
    _assert_bit_equal(runs["k"], runs["p"])
    assert torch.equal(runs["k"].solver_state.rho_idx,
                       runs["p"].solver_state.rho_idx)
    if not wide:
        assert not torch.equal(lanes["k"][2], lanes["d"][2])


def test_classic_engine_aggregate_mode_on_the_card(cuda, golden):
    """``make_linear_batched_rollout(emit_trajectories=False)`` on the
    card, with noise drawn in the block loop: u and y empty, costs,
    converged flags, final state and windows bit-equal to the full run."""
    from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
        make_linear_batched_rollout,
    )

    ctrl = _controller(golden)
    bm = build_linear_engine(ctrl, PLANT, solves_per_block=25, device=cuda)
    B, T = 8192 - 13, 100
    ins = _bit_equal_inputs(ctrl, golden["x0"], B, T, cuda)[:3]
    out = {}
    for emit in (True, False):
        out[emit] = make_linear_batched_rollout(
            bm, T, use_rng_noise=True, eps_max=0.002,
            emit_trajectories=emit,
        )(*ins, torch.Generator(device=cuda).manual_seed(3))
    assert out[False].u_sys.shape == (B, 0, 2) == out[False].y_sys.shape
    assert out[True].u_sys.shape == (B, T, 2)
    for f in ("costs", "converged", "x_final", "u_past", "y_past"):
        assert torch.equal(getattr(out[False], f), getattr(out[True], f)), f


def _k1_small(golden, cuda):
    """K1's operator and packed inputs at a small shape (K = 8, B = 16,
    T = 40)."""
    bm = build_linear_engine(_controller(golden), PLANT, solves_per_block=8,
                             device=cuda)
    op = fr._build_fused_operator(bm)
    return op, *_packed(golden, bm, 40, 16, cuda)


def test_session_reader_counts_two_kernels_per_k1_call(cuda, golden):
    """``chip_smoke``'s session reader over ``fused_rollout`` calls: the
    host's records give 2 kernel launches and 0 copies per call, and
    where the device's records are complete they are K1's two
    kernels."""
    from collections import Counter

    from chip_smoke import device_kernels, profile_session

    op, s0, W = _k1_small(golden, cuda)
    call = lambda: fr.fused_rollout(op, s0, W)  # noqa: E731
    assert device_kernels(call, 3) == (2, 0)
    before = fr.fused_rollout.launches
    s = profile_session(call, 3, warmup=1)[0]
    assert fr.fused_rollout.launches == before + 4
    assert (s.launches, s.copies) == (6, 0)
    print(f"K1 x 3: {s.counts()}, complete {s.complete}")
    if s.complete:
        assert s.names == Counter({"fused_rollout_state_kernel": 3,
                                   "fused_rollout_product_kernel": 3})


def test_trace_after_a_convolution_holds_every_kernel_or_warns(
        cuda, golden, tmp_path):
    """``utils.profiling.trace`` around a K1 call that follows an
    ``F.conv1d`` (cuDNN) on the card: the trace holds as many kernel
    events as kernel launches, or ``trace`` warned with both counts and
    the path; never fewer in silence."""
    import json
    import warnings

    from direct_data_driven_mpc_tpu_torch.utils.profiling import (
        _launches_and_kernels,
        trace,
    )

    op, s0, W = _k1_small(golden, cuda)
    x = torch.randn(64, 8, 400, device=cuda)
    w = torch.randn(16, 8, 30, device=cuda)
    torch.nn.functional.conv1d(x, w).sum().item()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with trace(str(tmp_path)) as path:
            fr.fused_rollout(op, s0, W)
    with open(path) as f:
        launches, kernels = _launches_and_kernels(json.load(f)["traceEvents"])
    ours = [str(m.message) for m in caught
            if "kernel events for" in str(m.message)]
    print(f"trace after F.conv1d: {kernels} kernel events for {launches} "
          f"kernel launches; warnings {ours}")
    assert launches >= 2
    if kernels < launches:
        assert any(f"{kernels} kernel events for {launches} kernel "
                   "launches" in m and path in m for m in ours), ours
    else:
        assert not ours
