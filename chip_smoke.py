"""Smoke run of the PyTorch port on one NVIDIA card.

Drives the port's two main paths through their hand-written CUDA
kernels and checks them. First the Monte-Carlo batch of the paper's
four-tank Robust controller (B = 4096 scenarios x T = 400 closed-loop
steps, N = 400, L = 30, slack NONE) through
``direct_data_driven_mpc_tpu_torch/ops/csrc/fused_rollout.cu``:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: both kernels are compiled from the sources in this checkout,
   one nvcc each, started together;
3. host build: the controller exactly as ``bench.py`` builds it
   (seed 0), the block maps for K = 50 (kernel) and K = 100 (classic
   engine);
4. main path: ``make_fused_batched_rollout`` on the card, with launch
   counts; kernel vs its plain PyTorch version and vs the classic
   condensed engine (u, y, final state atol 2e-5; costs rtol 1e-3,
   atol 1e-5);
5. float64 truth: the kernel's max |du| against the plain version in
   float64 (64 scenarios) below 1e-4;
6. edges: a ragged batch, a rollout that does not divide into blocks,
   and the noise rotation against ``torch.roll`` (bit-equal);
7. timing: closed-loop QP solves/s of the kernel, the plain version
   and the classic engine, with CUDA events.

Then the fused ADMM closed loop of ``bench.py``'s ``four_tank_convex``
(CONVEX slack, c = 1, B = 65536 x T = 400) through
``direct_data_driven_mpc_tpu_torch/ops/csrc/fused_admm.cu``:

8. host build: the CONVEX controller and the fused operators, the
   kernel's tile and shared memory;
9. main path: ``make_fused_admm_rollout`` on the card, with the launch
   count; every solve converged; kernel vs plain version (u, y, final
   state and ADMM state atol 2e-5; costs rtol 1e-3, atol 1e-5;
   converged flags equal);
10. float64 truth: the kernel's max |du| against the plain version in
    float64 (64 scenarios) below 1e-4;
11. variants, each kernel vs plain version at the same tolerances:
    ``four_tank_box`` (|u| <= 0.85 checked too), the 4-phase setpoint
    schedule, ``n_mpc_step = 4``, a ragged batch, a segmented run
    (two halves through ``solver_state0``, against the uninterrupted
    one), L = 15 (nbox 30) and L = 60 (nbox 120, N = 800);
12. timing: solves/s of the kernel and the plain version, in turns.

Any failed check raises. Run from the repository root:
``python3 chip_smoke.py``. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it the kernels'
record.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

FOUR_TANK = dict(
    A=np.array(
        [
            [0.921, 0, 0.041, 0],
            [0, 0.918, 0, 0.033],
            [0, 0, 0.924, 0],
            [0, 0, 0, 0.937],
        ]
    ),
    B=np.array([[0.017, 0.001], [0.001, 0.023], [0, 0.061], [0.072, 0]]),
    C=np.array([[1.0, 0, 0, 0], [0, 1, 0, 0]]),
    D=np.zeros((2, 2)),
    eps_max=0.002,
)
KERNELS = ("fused_rollout", "fused_admm")
B_MAIN, T_MAIN = 4096, 400
B_ADMM, T_ADMM = 65536, 400  # bench.py's fused ADMM batch
B_VARIANT = 8192  # the ADMM variants' batch
ATOL = 2e-5  # u, y and state (tests/test_pallas_rollout.py)
COST_RTOL, COST_ATOL = 1e-3, 1e-5
NORTH_STAR = 1e-4  # max |du| against float64


def log(msg: str) -> None:
    print(msg, flush=True)


def build_four_tank_robust(N: int = 400, L: int = 30, seed: int = 0,
                           slack: str = "NONE"):
    """The four-tank Robust controller as ``bench.py`` builds it:
    uniform input data, bounded measurement noise, slack NONE (or
    CONVEX, as its fused ADMM configurations build it)."""
    from direct_data_driven_mpc_tpu_torch.control.controller import (
        DirectDataDrivenMPCController,
    )
    from direct_data_driven_mpc_tpu_torch.models.lti_model import LTIModel
    from direct_data_driven_mpc_tpu_torch.qp.spec import (
        DataDrivenMPCType,
        SlackVarConstraintTypes,
    )

    n, m, p = 4, 2, 2
    rng = np.random.default_rng(seed)
    plant = LTIModel(**FOUR_TANK)
    eps = plant.get_eps_max()
    u_d = rng.uniform(-1, 1, (N, m))
    w_d = eps * rng.uniform(-1, 1, (N, p))
    y_d = plant.simulate(u_d, w_d, N)
    ctrl = DirectDataDrivenMPCController(
        n=n, m=m, p=p, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(p * L), R=1e-4 * np.eye(m * L),
        u_s=np.array([[1.0], [1.0]]), y_s=np.array([[0.65], [0.77]]),
        eps_max=eps, lamb_alpha=0.1 / max(eps, 1e-12),
        lamb_sigma=1000.0, c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes[slack],
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
    )
    return plant, ctrl


def scenario_batch(plant, ctrl, B, device, dtype=torch.float32):
    """Every scenario starts from the plant's state after the data run
    and the controller's initial window (as in ``bench.py``)."""
    def tile(a, shape):
        return torch.as_tensor(a, dtype=dtype, device=device).reshape(
            shape
        ).expand(B, *shape[1:]).contiguous()

    return (
        tile(plant.get_state(), (1, ctrl.n)),
        tile(ctrl.u_past, (1, ctrl.n, ctrl.m)),
        tile(ctrl.y_past, (1, ctrl.n, ctrl.p)),
    )


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def check_close(name, got, want, atol, rtol=0.0):
    """Raise unless |got - want| <= atol + rtol |want| everywhere."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    excess = (got.double() - want.double()).abs() - (
        atol + rtol * want.double().abs()
    )
    worst = float(excess.max())
    if worst > 0:
        raise AssertionError(
            f"{name}: exceeds atol {atol} rtol {rtol} by {worst:.3e} "
            f"(max |diff| {max_abs(got, want):.3e})"
        )
    return max_abs(got, want)


def time_amortized(run, args, seconds=1.0, min_reps=8):
    """Milliseconds per rollout of an amortized ``run(*args, R)``, by
    CUDA events, after a warm-up; R (at least ``min_reps``) is chosen
    to fill ~``seconds``."""
    def timed(R):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        checksum, ok = run(*args, R)
        end.record()
        torch.cuda.synchronize()
        if not bool(ok):
            raise AssertionError(f"non-finite checksum {float(checksum)}")
        return start.elapsed_time(end) / R

    per = timed(2)  # warm-up, and a first estimate
    R = max(min_reps, min(4000, math.ceil(seconds * 1e3 / per)))
    return timed(R), R


def admm_config(name: str):
    """``(plant, controller, operator, engine keywords)`` of one fused
    ADMM configuration as ``bench.py`` (``run_fused_admm_config``)
    builds it: seed 0, four-tank Robust, N = 400, L = 30 unless named
    otherwise."""
    from direct_data_driven_mpc_tpu_torch.qp.admm import (
        compute_admm_operator_np,
    )
    from direct_data_driven_mpc_tpu_torch.qp.box import (
        compute_box_admm_operator_np,
    )

    if name == "four_tank_box":
        # Slack NONE with a saturated input box at the fixed rho = 1.
        plant, ctrl = build_four_tank_robust()
        op = compute_box_admm_operator_np(
            ctrl.spec, u_bounds=(-0.85, 0.85), rho=1.0
        )
        return plant, ctrl, op, dict(iters=(0, 14, 4), cold_iters=60,
                                     tol=2e-5)
    N, L = {"four_tank_convex_q4": (400, 15),
            "long_horizon_convex": (800, 60)}.get(name, (400, 30))
    plant, ctrl = build_four_tank_robust(N=N, L=L, slack="CONVEX")
    track = name == "four_tank_admm_tracking"
    op = compute_admm_operator_np(ctrl.spec, return_setpoint_maps=track)
    kw = dict(iters=(4, 5, 2), cold_iters=24, tol=1e-5)
    if track:
        # Four phases around the baked setpoints (scaling an equilibrium
        # pair keeps it an equilibrium).
        phases = np.array([1.0, 0.85, 1.1, 0.95])
        kw.update(iters=(4, 6, 2), setpoints=np.repeat(
            phases[:, None] * op["r_bar"][None], T_ADMM // 4, axis=0
        ))
    return plant, ctrl, op, kw


def compare_admm(tag, got, want):
    """Kernel against plain version: u, y, final windows and ADMM state
    within ``ATOL``, costs within ``COST_RTOL``/``COST_ATOL``, converged
    flags equal. Returns the largest |diff| off the costs and on them."""
    errs = [
        check_close(f"{tag} {f}", getattr(got, f), getattr(want, f), ATOL)
        for f in ("u_sys", "y_sys", "x_final", "u_past", "y_past")
    ]
    errs += [
        check_close(f"{tag} solver_state.{f}", a, b, ATOL)
        for f, a, b in zip(("s", "w"), got.solver_state, want.solver_state)
    ]
    err_c = check_close(f"{tag} costs", got.costs, want.costs, COST_ATOL,
                        COST_RTOL)
    if not torch.equal(got.converged, want.converged):
        raise AssertionError(f"{tag}: converged flags differ")
    return max(errs), err_c


def admm_phases(dev, smi) -> dict:
    """Phases 8-12: the fused ADMM closed loop through kernel K4.
    Returns its record for the ``kernels`` line."""
    from direct_data_driven_mpc_tpu_torch.ops import _kernels
    from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )

    # 8. Host build of four_tank_convex and its fused operators.
    t0 = time.perf_counter()
    plant, ctrl, op, kw = admm_config("four_tank_convex")
    if (ctrl.spec.nz, ctrl.spec.nc) != (571, 168):
        raise AssertionError(
            f"QP dims {ctrl.spec.nz}, {ctrl.spec.nc} != 571, 168"
        )
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    ops, dims = fa.build_fused_admm_operator(plant.as_params(), op, ctrl.n,
                                             ctrl.m, ctrl.p, device=dev)
    sizes = (dims.S, dims.nb * dims.m, dims.nb * dims.p, dims.nbox,
             dims.nxi)
    lib = _kernels.load("fused_admm").lib
    log(f"ADMM host build: four_tank_convex nz={ctrl.spec.nz} "
        f"nc={ctrl.spec.nc}, first solve {ctrl.get_problem_solve_status()}"
        f", {t_host:.2f} s; fused operators Vop "
        f"{tuple(ops.Vop.shape)}, M1 {tuple(ops.M1.shape)}, M2 "
        f"{tuple(ops.M2.shape)} in {time.perf_counter() - t0:.2f} s; "
        f"kernel tile {lib.fused_admm_tile_rows(*sizes)} scenarios, "
        f"{lib.fused_admm_smem_bytes(*sizes)} B of shared memory")

    def inputs(plant, ctrl, B, T=T_ADMM, seed=0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        Ws = draw_noise_batch(gen, B, T, ctrl.p, plant.get_eps_max(),
                              device=dev)
        return (*scenario_batch(plant, ctrl, B, dev), Ws)

    def rollouts(plant, ctrl, op, T=T_ADMM, **kw):
        """The kernel's and the plain version's rollouts."""
        args = (plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T)
        return (
            fa.make_fused_admm_rollout(*args, device=dev, **kw),
            fa.make_fused_admm_rollout(
                *args, device=dev, rollout=fa.fused_admm_reference, **kw
            ),
        )

    # 9. The main path, through the kernel.
    ins = inputs(plant, ctrl, B_ADMM)
    run_k, run_p = rollouts(plant, ctrl, op, **kw)
    fa.fused_admm.launches = 0
    res = run_k(*ins)
    torch.cuda.synchronize()
    main_launches = fa.fused_admm.launches
    if main_launches < 1:
        raise AssertionError("the ADMM main path launched no kernel")
    if res.u_sys.shape != (B_ADMM, T_ADMM, 2) or res.costs.shape != (
        B_ADMM, T_ADMM
    ):
        raise AssertionError(f"ADMM main-path shapes "
                             f"{tuple(res.u_sys.shape)} "
                             f"{tuple(res.costs.shape)}")
    if not bool(res.converged.all()):
        raise AssertionError(
            f"ADMM main path: {float((~res.converged).float().mean()):.2e}"
            " of the solves did not converge"
        )
    log(f"ADMM main path: four_tank_convex B={B_ADMM} T={T_ADMM}, "
        f"iters {kw['iters']} + cold {kw['cold_iters']}, fused_admm "
        f"launches {main_launches}, all {B_ADMM * T_ADMM} solves converged")
    kernel_err, err_c = compare_admm("four_tank_convex kernel vs plain",
                                     res, run_p(*ins))
    log(f"ADMM kernel vs plain (B={B_ADMM}, T={T_ADMM}): max |diff| on "
        f"u, y, state and solver state {kernel_err:.3e} (atol {ATOL}); "
        f"costs {err_c:.3e} (rtol {COST_RTOL}, atol {COST_ATOL}); "
        "converged flags equal")

    # 10. Float64 truth for the first 64 scenarios.
    run64 = fa.make_fused_admm_rollout(
        plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T_ADMM, device=dev,
        dtype=torch.float64, rollout=fa.fused_admm_reference, **kw,
    )
    u64 = run64(*(a[:64].double() for a in ins)).u_sys
    du = max_abs(res.u_sys[:64], u64)
    if not du < NORTH_STAR:
        raise AssertionError(f"ADMM max |du| vs float64 {du:.3e} >= 1e-4")
    log(f"ADMM float64 truth (64 scenarios): kernel max |du| {du:.3e} "
        f"(< {NORTH_STAR})")

    # 11. Variants, each through the kernel and against the plain version.
    def variant(tag, run_pair, args):
        before = fa.fused_admm.launches
        got = run_pair[0](*args)
        torch.cuda.synchronize()
        if fa.fused_admm.launches != before + 1:
            raise AssertionError(f"{tag} did not go through the kernel")
        err, err_c = compare_admm(tag, got, run_pair[1](*args))
        log(f"ADMM variant {tag}: max |diff| {err:.3e}, costs "
            f"{err_c:.3e}, converged {float(got.converged.float().mean())}")
        return got

    for name in ("four_tank_box", "four_tank_admm_tracking"):
        p_v, c_v, op_v, kw_v = admm_config(name)
        got = variant(f"{name} B={B_VARIANT}", rollouts(p_v, c_v, op_v,
                                                        **kw_v),
                      inputs(p_v, c_v, B_VARIANT))
        if name == "four_tank_box":
            u_max = float(got.u_sys.abs().max())
            if u_max > 0.85 + 1e-6:
                raise AssertionError(f"box violated: max |u| {u_max}")
            log(f"  box respected: max |u| {u_max:.6f} <= 0.85")
    ins_v = tuple(a[:B_VARIANT] for a in ins)
    variant(f"n_mpc_step=4 B={B_VARIANT}",
            rollouts(plant, ctrl, op, n_mpc_step=4,
                     **dict(kw, iters=(4, 8, 2))), ins_v)
    B_r = B_VARIANT - 13
    variant(f"ragged B={B_r}", (run_k, run_p),
            tuple(a[:B_r] for a in ins))
    # Segmented: two halves, the second warm-started through
    # solver_state0. The second half derives its first solve's maps from
    # the carried state (the Gpre product) where the uninterrupted run
    # takes them from the in-kernel plant product, so the two differ by
    # float32 rounding, which the closed loop carries: that is held to
    # the float64 bar, the kernel to the plain version at atol 2e-5.
    half = T_ADMM // 2
    first = rollouts(plant, ctrl, op, T=half, **kw)
    second = rollouts(plant, ctrl, op, T=half, **dict(kw, cold_iters=0))
    segs = []
    for i in (0, 1):
        seg1 = first[i](*ins_v[:3], ins_v[3][:, :half])
        segs.append((seg1, second[i](
            seg1.x_final, seg1.u_past, seg1.y_past, ins_v[3][:, half:],
            solver_state0=seg1.solver_state,
        )))
    seg_err = max(compare_admm(f"segmented half {h}", segs[0][h],
                               segs[1][h])[0] for h in (0, 1))
    full = run_k(*ins_v)
    du_seg = max_abs(torch.cat([s.u_sys for s in segs[0]], 1), full.u_sys)
    if not du_seg < NORTH_STAR:
        raise AssertionError(f"segmented vs uninterrupted max |du| "
                             f"{du_seg:.3e} >= {NORTH_STAR}")
    dy_seg = max_abs(torch.cat([s.y_sys for s in segs[0]], 1), full.y_sys)
    log(f"ADMM variant segmented ({half} + {half} steps through "
        f"solver_state0) B={B_VARIANT}: kernel vs plain max |diff| "
        f"{seg_err:.3e}; vs the uninterrupted run max |du| {du_seg:.3e} "
        f"(< {NORTH_STAR}), |dy| {dy_seg:.3e}")
    for name in ("four_tank_convex_q4", "long_horizon_convex"):
        p_v, c_v, op_v, kw_v = admm_config(name)
        n_box = op_v["v_c"].shape[0]
        variant(f"{name} (nbox {n_box}) B=4096",
                rollouts(p_v, c_v, op_v, **kw_v), inputs(p_v, c_v, 4096))

    # 12. Timing at the main shape, in turns.
    solves = B_ADMM * T_ADMM
    runs = {
        "kernel": fa.make_amortized_admm_run(
            plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T_ADMM,
            device=dev, **kw,
        ),
        "plain": fa.make_amortized_admm_run(
            plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T_ADMM,
            device=dev, rollout=fa.fused_admm_reference, **kw,
        ),
    }
    ms = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        before = fa.fused_admm.launches
        t, R = time_amortized(runs[name], ins, min_reps=4)
        launched = fa.fused_admm.launches - before
        expected = R + 2 if name == "kernel" else 0
        if launched != expected:
            raise AssertionError(f"ADMM {name}: {launched} launches, "
                                 f"expected {expected}")
        ms[name].append(t)
        log(f"ADMM timing {name}: {t:.4f} ms/rollout over R={R} -> "
            f"{solves / (t * 1e-3):,.0f} solves/s [{smi}]")
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    log(f"ADMM solves/s (mean of 2 turns, four_tank_convex B={B_ADMM} x "
        f"T={T_ADMM}, {smi}): "
        + ", ".join(f"{k} {solves / (v * 1e-3):,.0f}"
                    for k, v in mean.items()))
    return {
        "name": "fused_admm",
        "route": "cuda",
        "source": "direct_data_driven_mpc_tpu_torch/ops/csrc/fused_admm.cu",
        "replaces": "direct_data_driven_mpc_tpu/ops/pallas_admm.py:702",
        "launches": main_launches,
        "max_abs_err": kernel_err,
        "ms": mean["kernel"],
        "plain_ms": mean["plain"],
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; nothing run")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
        build_linear_engine,
        make_linear_batched_rollout,
    )
    from direct_data_driven_mpc_tpu_torch.ops import _kernels
    from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )

    # 1. Device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {card}, count {torch.cuda.device_count()}")

    # 2. Build: one nvcc per kernel source, all started together.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = list(pool.map(_kernels.load, KERNELS))
    log(f"build: {len(libs)} kernels in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        log(f"  {lib.name}.cu -> {lib.path.name} in "
            f"{lib.build_seconds:.2f} s")
        for line in lib.compiler_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")

    # 3. Host build (float64), then the block maps on the card.
    t0 = time.perf_counter()
    plant, ctrl = build_four_tank_robust()
    if (ctrl.spec.nz, ctrl.spec.nc) != (571, 168):
        raise AssertionError(
            f"QP dims {ctrl.spec.nz}, {ctrl.spec.nc} != 571, 168"
        )
    log(f"host build: controller nz={ctrl.spec.nz} nc={ctrl.spec.nc}, "
        f"solve path {ctrl.solve_path}, "
        f"{time.perf_counter() - t0:.2f} s")
    K_kernel = fr.suggest_solves_per_block(
        plant.get_system_order(), ctrl.n, ctrl.m, ctrl.p, n_steps=T_MAIN
    )
    t0 = time.perf_counter()
    bm50 = build_linear_engine(
        ctrl, plant.as_params(), solves_per_block=K_kernel, device=dev
    )
    bm100 = build_linear_engine(
        ctrl, plant.as_params(), solves_per_block=100, device=dev
    )
    log(f"block maps K={K_kernel} and K=100: "
        f"{time.perf_counter() - t0:.2f} s")

    # 4. The main path, through the kernel.
    gen = torch.Generator(device=dev).manual_seed(0)
    Ws = draw_noise_batch(gen, B_MAIN, T_MAIN, ctrl.p,
                          plant.get_eps_max(), device=dev)
    x0s, ups, yps = scenario_batch(plant, ctrl, B_MAIN, dev)
    run_main = fr.make_fused_batched_rollout(bm50, T_MAIN)
    fr.fused_rollout.launches = 0
    res = run_main(x0s, ups, yps, Ws)
    torch.cuda.synchronize()
    main_launches = fr.fused_rollout.launches
    if main_launches < 1:
        raise AssertionError("the main path launched no kernel")
    log(f"main path: B={B_MAIN} T={T_MAIN} K={K_kernel}, "
        f"fused_rollout launches {main_launches}")
    if res.u_sys.shape != (B_MAIN, T_MAIN, 2) or res.costs.shape != (
        B_MAIN, T_MAIN
    ):
        raise AssertionError(f"main-path shapes {tuple(res.u_sys.shape)} "
                             f"{tuple(res.costs.shape)}")
    if not bool(res.converged.all()):
        raise AssertionError("non-finite costs on the main path")

    op = fr._build_fused_operator(bm50)
    n_outer = T_MAIN // K_kernel
    s0, W = fr._center_and_pack(bm50, x0s, ups, yps, Ws, n_outer,
                                K_kernel, 0)
    got = fr.fused_rollout(op, s0, W)
    want = fr.fused_rollout_reference(op, s0, W)
    err = {}
    for name, g, w in zip(("U", "Y", "s_fin"), got[:2] + got[3:],
                          want[:2] + want[3:]):
        err[name] = check_close(f"kernel vs plain {name}", g, w, ATOL)
    err_c = check_close("kernel vs plain C", got[2], want[2], COST_ATOL,
                        COST_RTOL)
    kernel_err = max(err.values())
    log(f"kernel vs plain (B={B_MAIN}, T={T_MAIN}): max |dU| "
        f"{err['U']:.3e}, |dY| {err['Y']:.3e}, |ds_fin| "
        f"{err['s_fin']:.3e} (atol {ATOL}); max |dC| {err_c:.3e} "
        f"(rtol {COST_RTOL}, atol {COST_ATOL})")

    classic = make_linear_batched_rollout(bm100, T_MAIN)(x0s, ups, yps, Ws)
    for field in ("u_sys", "y_sys", "x_final", "u_past", "y_past"):
        e = check_close(f"kernel vs classic {field}",
                        getattr(res, field), getattr(classic, field), ATOL)
        log(f"kernel vs classic engine (K=100) {field}: max |diff| "
            f"{e:.3e}")
    e = check_close("kernel vs classic costs", res.costs, classic.costs,
                    COST_ATOL, COST_RTOL)
    log(f"kernel vs classic engine costs: max |diff| {e:.3e}")

    # 5. Float64 truth for the first 64 scenarios.
    bm50_64 = build_linear_engine(
        ctrl, plant.as_params(), solves_per_block=K_kernel, device=dev,
        dtype=torch.float64,
    )
    op64 = fr._build_fused_operator(bm50_64)
    s0_64, W_64 = fr._center_and_pack(
        bm50_64, x0s[:64], ups[:64], yps[:64], Ws[:64], n_outer,
        K_kernel, 0,
    )
    U64 = fr.fused_rollout_reference(op64, s0_64, W_64)[0]
    du = max_abs(res.u_sys[:64], U64.reshape(64, -1, 2))
    if not du < NORTH_STAR:
        raise AssertionError(f"max |du| vs float64 {du:.3e} >= 1e-4")
    log(f"float64 truth (64 scenarios): kernel max |du| {du:.3e} "
        f"(< {NORTH_STAR})")

    # 6. Edges.
    Br = 4000
    got_r = fr.fused_rollout(op, s0[:Br].contiguous(), W[:Br].contiguous())
    want_r = fr.fused_rollout_reference(op, s0[:Br], W[:Br])
    for name, g, w in zip(("U", "Y", "s_fin"), got_r[:2] + got_r[3:],
                          want_r[:2] + want_r[3:]):
        check_close(f"ragged B={Br} {name}", g, w, ATOL)
    check_close(f"ragged B={Br} C", got_r[2], want_r[2], COST_ATOL,
                COST_RTOL)
    for name, g, full in zip(("U", "Y", "C", "s_fin"), got_r, got):
        if not torch.equal(g, full[:Br]):
            raise AssertionError(f"ragged B={Br} {name} differs from the "
                                 "same rows of the full batch")
    log(f"edge: ragged batch B={Br} matches the plain version and the "
        "full batch's rows")

    T_odd, K_odd = 37, 8
    bm8 = build_linear_engine(
        ctrl, plant.as_params(), solves_per_block=K_odd, device=dev
    )
    inputs_odd = (x0s, ups, yps, Ws[:, :T_odd].contiguous())
    fr.fused_rollout.launches = 0
    odd = fr.make_fused_batched_rollout(bm8, T_odd)(*inputs_odd)
    if fr.fused_rollout.launches != 1:
        raise AssertionError("T=37 run did not go through the kernel")
    op8 = fr._build_fused_operator(bm8)
    n_outer8 = math.ceil(T_odd / K_odd)
    s0_8, W_8 = fr._center_and_pack(bm8, *inputs_odd, n_outer8, K_odd,
                                    n_outer8 * K_odd - T_odd)
    U8 = fr.fused_rollout_reference(op8, s0_8, W_8)[0]
    check_close("T=37 K=8 u", odd.u_sys,
                U8.reshape(B_MAIN, -1, 2)[:, :T_odd], ATOL)
    classic8 = make_linear_batched_rollout(bm8, T_odd)(*inputs_odd)
    check_close("T=37 K=8 y vs classic", odd.y_sys, classic8.y_sys, ATOL)
    log(f"edge: T={T_odd}, K={K_odd} (ragged last block) matches the "
        "plain version and the classic engine")

    for w_off in (1, 3, n_outer - 1):
        rot = fr.fused_rollout(op, s0, W, w_off=w_off)
        rolled = fr.fused_rollout(
            op, s0, torch.roll(W, -w_off, dims=1).contiguous()
        )
        for g, w in zip(rot, rolled):
            if not torch.equal(g, w):
                raise AssertionError(f"w_off={w_off} rotation differs "
                                     "from torch.roll")
    log("edge: w_off rotation is bit-equal to torch.roll of the noise")

    # 7. Timing at the main shape.
    solves = B_MAIN * T_MAIN
    args = (x0s, ups, yps, Ws)
    kernel_run = fr.make_amortized_run(bm50, T_MAIN)
    plain_run = fr.make_amortized_run(
        bm50, T_MAIN, rollout=fr.fused_rollout_reference
    )
    classic_fn = make_linear_batched_rollout(bm100, T_MAIN)

    def classic_run(x0s, ups, yps, Ws, R):
        checksum = torch.zeros((), device=dev)
        for _ in range(R):
            r = classic_fn(x0s, ups, yps, Ws)
            checksum = checksum + r.costs[:, -1].sum() + r.x_final.sum() \
                + r.u_sys.sum() + r.y_sys.sum()
        return checksum, torch.isfinite(checksum)

    ms = {"kernel": [], "plain": [], "classic": []}
    runs = {"kernel": kernel_run, "plain": plain_run,
            "classic": classic_run}
    for name in ("kernel", "plain", "classic", "classic", "plain",
                 "kernel"):
        before = fr.fused_rollout.launches
        t, R = time_amortized(runs[name], args)
        launched = fr.fused_rollout.launches - before
        expected = R + 2 if name == "kernel" else 0
        if launched != expected:
            raise AssertionError(f"{name}: {launched} launches, expected "
                                 f"{expected}")
        ms[name].append(t)
        log(f"timing {name}: {t:.4f} ms/rollout over R={R} -> "
            f"{solves / (t * 1e-3):,.0f} solves/s [{smi}]")
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    log(f"solves/s (mean of 2 turns, B={B_MAIN} x T={T_MAIN}, {smi}): "
        + ", ".join(f"{k} {solves / (v * 1e-3):,.0f}"
                    for k, v in mean.items()))

    k1 = {
        "name": "fused_rollout",
        "route": "cuda",
        "source": "direct_data_driven_mpc_tpu_torch/ops/csrc/"
                  "fused_rollout.cu",
        "replaces": "direct_data_driven_mpc_tpu/ops/pallas_rollout.py:490",
        "launches": main_launches,
        "max_abs_err": kernel_err,
        "ms": mean["kernel"],
        "plain_ms": mean["plain"],
    }

    k4 = admm_phases(dev, smi)
    print(json.dumps({"kernels": [k1, k4]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
