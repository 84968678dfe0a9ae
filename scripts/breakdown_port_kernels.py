"""Where the time of the port's kernels K1 (``fused_rollout``), K4
(``fused_admm``), K5 (``fused_ladder``) and K3 (``fused_rollout_nocost``)
goes, on one NVIDIA card, and what K3's float32 add per ring tile does
for its accuracy.

K1 is timed as shipped, its two kernels apart (the state pass, the
product) and with its cost epilogue, its U/Y stores or its FMA loop cut,
beside one addmm of all its rows; with the device's busy share and time
by kernel over the amortized rollouts; and at K = 10 and 25 solves per
block beside 50 (the TPU's tuning constant, measured here, not changed).

K4 and K5 are timed as shipped, at 0 and at twice their iterations (the
fixed and per-iteration costs), and pinned to one block per SM; K4 also
alone at four_tank_convex x 400 steps at B = 4096, 8192, 12288 and 16384,
as shipped and held to each of its tiles (64 scenarios, 8 a warp; 32, 4
a warp), in turns. The wide
bodies K4w (``large_plant_convex``) and K5w (``large_plant_ladder``, both
B = 16384 x T = 400, as ``chip_smoke.py`` phase 48) are timed the same
way and in variants of their body (``WIDE``: a deeper ring, 8 consumer
warps, a shallower unroll, panel loads cut, products cut, each product
alone) beside the plain version. K3 with parts
of its work cut, held to its 32-row plan at K = 25, and at K = 50
solves per block, where that plan is the one it runs. Last, the largest
difference between K4 or K5 and its plain version over batch sizes (30
closed-loop steps): where cuBLAS sums the plain version's products as
one FMA chain, the two are bit-equal.

Run from the repository root: ``python3 scripts/breakdown_port_kernels.py
[k1] [k4] [k4tiles] [k5] [k3] [k4w] [k5w] [batch]`` (all eight parts when
none is named).
It builds patched copies of the kernel sources under
``build/breakdown/`` (one nvcc each, all together), swaps each in for
the shipped library and times it with CUDA events at the main shapes of
``chip_smoke.py``: ``four_tank_convex`` and ``four_tank_ladder``
(B = 65536 x T = 400 each) and
``large_plant`` (B = 65536 x T = 400, K = 25). Also timed: the
fixed-penalty kernel K4 on the ladder's top rung, the plain version's
per-block cuBLAS product, the cost post-pass (``F.conv1d``) and, as a
yardstick, the same post-pass as one window-unfold and a matrix
product; and the device's busy share over each path's amortized
rollouts (``torch.profiler``), printed beside the session's device
records and host launches and only where each launch and copy has its
device record, else as not read. Prints one line per measurement, with
the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control.linear_engine import (  # noqa: E402
    build_linear_engine,
)
from direct_data_driven_mpc_tpu_torch.ops import _kernels  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr  # noqa: E402
from direct_data_driven_mpc_tpu_torch.parallel.batch import (  # noqa: E402
    draw_noise_batch,
)
from direct_data_driven_mpc_tpu_torch.qp.box import (  # noqa: E402
    compute_box_admm_operator_np,
)

OUT = ROOT / "build" / "breakdown"


#: (library, tag, what is cut, patch) for every variant.
VARIANTS = [
    ("fused_rollout", "k1_state_only", "K1's state pass alone (the "
     "product not launched)",
     lambda t: t.replace(
         "  const dim3 grid((unsigned)((R + PR_BM - 1) / PR_BM), n_tiles);",
         "  return 0;\n"
         "  const dim3 grid((unsigned)((R + PR_BM - 1) / PR_BM), n_tiles);")),
    ("fused_rollout", "k1_product_only", "K1's product alone (the state "
     "pass not launched; its scratch as the previous call left it)",
     lambda t: t.replace("  fused_rollout_state_kernel<<<",
                         "  if (false) fused_rollout_state_kernel<<<")),
    ("fused_rollout", "k1_no_cost", "K1 without its cost epilogue",
     lambda t: t.replace("} else if (d.x == SLOT_COST) {",
                         "} else if (false) {")),
    ("fused_rollout", "k1_no_stores", "K1 without storing U and Y",
     lambda t: t.replace(
         "*reinterpret_cast<float4*>(o + 4 * e) =\n"
         "                make_float4(v[0], v[1], v[2], v[3]);", ";").replace(
         "if (4 * e + q < d.z) o[4 * e + q] = v[q];", ";")),
    ("fused_rollout", "k1_no_fma", "K1 without its product's FMA loop "
     "(the ring, the state pass and the epilogues only)",
     lambda t: t.replace("for (int h = 0; h < PR_BK / 4; ++h) {",
                         "for (int h = 0; h < 0; ++h) {")),
    ("fused_rollout", "k3_no_product", "K3 without its product (no mma, "
     "so no fragment loads or splits either)",
     lambda t: t.replace('  asm("mma.sync', '  if (false) asm("mma.sync')),
    ("fused_rollout", "k3_no_split", "K3 without the hi/lo splits (raw "
     "float32 bits into all three passes)",
     lambda t: t.replace("  hi = tf32(x);\n  lo = tf32(x - __uint_as_float(hi));",
                         "  hi = __float_as_uint(x);\n  lo = hi;")),
    ("fused_rollout", "k3_no_staging", "K3 without copying G into the ring",
     lambda t: t.replace(
         "__pipeline_memcpy_async(d + u * CR * NC_LDB,\n"
         "                                  s + (size_t)u * CR * ldg, 16);",
         ";")),
    ("fused_rollout", "k3_no_stores", "K3 without storing U and Y",
     lambda t: t.replace(
         "*reinterpret_cast<float2*>(u + j) = make_float2(v[0], v[1]);", ";"
     ).replace(
         "*reinterpret_cast<float2*>(y + j) = make_float2(v[0], v[1]);", ";"
     ).replace("(je < offY ? u : y)[je] = v[e];", ";")),
    ("fused_rollout", "k3_tensor_core_sum", "K3 summing every row in the "
     "tensor cores' own accumulators (no float32 add per ring tile)",
     lambda t: t.replace("            float d[4] = {};",
                         "            float (&d)[4] = acc[mi][ni];").replace(
         "            for (int e = 0; e < 4; ++e) acc[mi][ni][e] += d[e];",
         "            for (int e = 0; e < 0; ++e) acc[mi][ni][e] += d[e];")),
    ("fused_rollout", "k3_32_rows", "K3 held to its 32-row plan (twice "
     "the reads of G, a 32 x 32 warp tile)",
     lambda t: t.replace("for (int BM = 64; BM >= 32; BM /= 2)",
                         "for (int BM = 32; BM >= 32; BM /= 2)")),
    ("fused_admm", "k5_one_block_per_sm", "K5 pinned to one block per SM "
     "(the same code, its dynamic shared memory raised to a whole "
     "block's 232,448 bytes)",
     lambda t: t.replace(
         "launch(kernel_for<true>(nbox), kernel_smem_bytes<true>(d), P, d,",
         "launch(kernel_for<true>(nbox), SMEM_LIMIT, P, d,")),
    ("fused_admm", "k4_one_block_per_sm", "K4 pinned to one block per SM "
     "(the same code, its dynamic shared memory raised to a whole "
     "block's 232,448 bytes)",
     lambda t: t.replace(
         "launch(admm_kernel(tile, nbox), kernel_smem_bytes<false>(d), P, d,",
         "launch(admm_kernel(tile, nbox), SMEM_LIMIT, P, d,")),
    ("fused_admm", "k4tiles_full", "K4 on its 64-scenario tile at every "
     "batch",
     lambda t: t.replace("    if (TB == 64 && B > 0 &&\n",
                         "    if (false &&\n")),
    ("fused_admm", "k4tiles_half", "K4 on the half-height tile (32 "
     "scenarios, 4 a warp) wherever the 64-scenario tile fits",
     lambda t: t.replace(
         "        ((long long)B + SMALL_TB - 1) / SMALL_TB <= sm_count())\n",
         "        sm_count() >= 0)\n")),
]

def _skip(*calls):
    """Put ``if (false)`` before each call site (consumer and producer of
    one product, so both walk the same panels)."""
    def patch(t):
        for call in calls:
            t = t.replace(call, "if (false) " + call)
        return t
    return patch


_ITER = ("consume_product(dbuf, LDS, nbox, nbox,",
         "produce_product(P.Vop +")
_M1 = ("consume_product(\n        dbuf, LDS, nbox, W1,",
       "produce_product(P.M1 +")
_M2 = ("consume_product(\n        xin, LDS, D2, W2,",
       "produce_product(P.M2 +")

# The wide body (K4w, K5w): 16 consumer warps and a producer warp, an
# mbarrier ring of two stages, balanced windows, s and w in registers.
WIDE = [
    ("wide_warps8", "8 consumer warps (two 32-tile slots a warp at most) "
     "instead of 16",
     lambda t: t.replace("constexpr int WIDE_WARPS = 16;",
                         "constexpr int WIDE_WARPS = 8;")),
    ("wide_ring3", "a 3-stage ring (stages smaller)",
     lambda t: t.replace("constexpr int WIDE_STAGES = 2;",
                         "constexpr int WIDE_STAGES = 3;")),
    ("wide_ring4", "a 4-stage ring (stages smaller)",
     lambda t: t.replace("constexpr int WIDE_STAGES = 2;",
                         "constexpr int WIDE_STAGES = 4;")),
    ("wide_unroll4", "the k loop of the products unrolled 4 deep instead "
     "of 8",
     lambda t: t.replace(
         "    const int (&co)[WIDE_SLOTS], float (&acc)[WIDE_SLOTS][4][4]) {\n"
         "#pragma unroll 8\n",
         "    const int (&co)[WIDE_SLOTS], float (&acc)[WIDE_SLOTS][4][4]) {\n"
         "#pragma unroll 4\n")),
    ("wide_no_loads", "no panel loads (the producer arms each stage with "
     "no bytes; the products on whatever the ring holds)",
     lambda t: t.replace(
         "mbar_expect(ring.full + pos.s, (uint32_t)(rows * wl * "
         "sizeof(float)));",
         "mbar_arrive(ring.full + pos.s);").replace(
         "      if (wl == ld) {\n        if (lane == 0)\n",
         "      if (false) {\n        if (lane == 0)\n").replace(
         "for (int r = lane; r < rows; r += 32)",
         "for (int r = rows; r < rows; r += 32)")),
    ("wide_no_products", "no products (the panel loads, ring waits and "
     "epilogues only)",
     lambda t: t.replace("      if (WIDE_SLOTS == 2 && mine == 2)\n",
                         "      if (false)\n").replace(
         "      else if (mine >= 1)\n", "      else if (false)\n")),
    ("wide_iter_only", "the iteration product alone (no M1, no M2)",
     _skip(*_M1, *_M2)),
    ("wide_m1_only", "the extraction (M1) alone", _skip(*_ITER, *_M2)),
    ("wide_m2_only", "the plant step (M2) alone", _skip(*_ITER, *_M1)),
]

#: Variants that keep every product's arithmetic: bit-equal to shipped.
WIDE_SAME_BITS = ("wide_warps8", "wide_ring3", "wide_ring4", "wide_unroll4")


def build(variant):
    name, tag, _, patch = variant
    src = (_kernels._CSRC / f"{name}.cu").read_text()
    patched = patch(src)
    if patched == src:
        raise RuntimeError(f"patch {tag} changed nothing")
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{tag}.cu", OUT / f"lib{tag}.so"
    cu.write_text(patched)
    t0 = time.perf_counter()
    proc = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr}")
    return tag, _kernels.KernelLibrary(name, so, time.perf_counter() - t0,
                                       proc.stdout + proc.stderr)


def swapped(name, lib, fn):
    """Run ``fn()`` with ``lib`` in place of the shipped library."""
    shipped = _kernels._loaded[name]
    _kernels._loaded[name] = lib
    try:
        return fn()
    finally:
        _kernels._loaded[name] = shipped


def device_read(fn) -> tuple:
    """``(device ms, wall ms, session)`` of ``fn()`` under one
    torch.profiler session (``chip_smoke.profile_session``): the device
    time of the kernels and copies the host started, summed over their
    device records (one stream, so they do not overlap), against the
    host's wall clock. The device ms is None unless every launch and copy
    has its device record (``session.complete``): records lost in a
    session would read as idle time."""
    s, wall, _ = cs.profile_session(fn)
    return (sum(s.ms.values()) if s.complete else None), wall, s


def busy_line(tag, fn, reps, per_rollout_ms=None) -> str:
    """The device's busy share over ``fn()`` (``reps`` amortized
    rollouts), with the session's record and launch counts, or "not
    read"."""
    d_ms, w_ms, s = device_read(fn)
    if d_ms is None:
        return (f"{tag} device busy not read over {reps} amortized "
                f"rollouts ({w_ms:.2f} ms wall); {s.counts()}")
    line = (f"{tag} device busy {d_ms:.2f} ms of {w_ms:.2f} ms wall over "
            f"{reps} amortized rollouts under the profiler (idle "
            f"{1 - d_ms / w_ms:.1%})")
    if per_rollout_ms is not None:
        line += (f"; against the amortized {per_rollout_ms:.4f} ms per "
                 f"rollout without it, idle "
                 f"{1 - d_ms / reps / per_rollout_ms:.1%}")
    return f"{line}; {s.counts()}"


def bit_equality_by_batch(dev) -> None:
    """Max |diff| on u, y, the final state, s and w between the ADMM
    kernels and their plain versions, by batch size: K5 at nbox 52
    (L = 30) and 120 (L = 64), K4 at four_tank_convex (nbox 60) and
    long_horizon_convex (nbox 120)."""
    from direct_data_driven_mpc_tpu_torch.qp.admm import (
        compute_admm_operator_np,
    )

    T = 30
    for tag, L in (("K5 nbox 52", 30), ("K5 nbox 120", 64),
                   ("K4 nbox 60", 30), ("K4 nbox 120", 60)):
        k4 = tag.startswith("K4")
        plant, ctrl = cs.build_four_tank_robust(
            N=800 if L == 60 else 400, L=L,
            slack="CONVEX" if k4 else "NONE")
        if k4:
            op = compute_admm_operator_np(ctrl.spec)
            make, plain = fa.make_fused_admm_rollout, fa.fused_admm_reference
            kw = dict(iters=(4, 5, 2), cold_iters=24, tol=1e-5)
        else:
            op = compute_box_admm_operator_np(ctrl.spec,
                                              u_bounds=(-0.85, 0.85))
            make = fl.make_fused_ladder_rollout
            plain = fl.fused_ladder_reference
            kw = dict(iters=(0, 16, 4), cold_iters=80, tol=2e-5)
        args = (plant.as_params(), op, 4, 2, 2, T)
        run_k = make(*args, device=dev, **kw)
        run_p = make(*args, device=dev, rollout=plain, **kw)
        for B in (1000, 2043, 4083, 6131, 8179, 16381):
            ins = (*cs.scenario_batch(plant, ctrl, B, dev),
                   draw_noise_batch(0, B, T, ctrl.p, plant.get_eps_max(),
                                    device=dev))
            got, want = run_k(*ins), run_p(*ins)
            diff = max(float((getattr(got, f) - getattr(want, f)).abs().max())
                       for f in ("u_sys", "y_sys", "x_final"))
            diff_sw = max(float((a - b).abs().max()) for a, b in
                          zip(got.solver_state[:2], want.solver_state[:2]))
            print(f"bit-equality {tag} B={B}: kernel vs plain max |diff| "
                  f"u, y, state {diff:.3e}, s, w {diff_sw:.3e}", flush=True)


def k1_breakdown(dev, smi, patched, what) -> None:
    """K1 at four_tank_robust (B = 4096 x T = 400, K = 50): as shipped,
    its two kernels apart and with parts cut, beside the one-addmm
    yardstick; the device's busy share and the time by kernel over the
    amortized rollouts; then the same rollout at K = 10 and 25 solves per
    block."""
    plant, ctrl = cs.build_four_tank_robust()
    B, T = cs.B_MAIN, cs.T_MAIN
    Ws = draw_noise_batch(0, B, T, ctrl.p, plant.get_eps_max(),
                          device=dev)
    x0s, ups, yps = cs.scenario_batch(plant, ctrl, B, dev)
    for K in (50, 25, 10):
        bm = build_linear_engine(ctrl, plant.as_params(),
                                 solves_per_block=K, device=dev)
        op = fr._build_fused_operator(bm)
        s0, W = fr._center_and_pack(bm, x0s, ups, yps, Ws, T // K, K, 0)
        gflop = 2 * B * (T // K) * op.G.shape[0] * op.G.shape[1] / 1e9
        run = lambda: fr.fused_rollout(op, s0, W)  # noqa: E731
        amort = fr.make_amortized_run(bm, T)
        t_amort, R = cs.time_amortized(amort, (x0s, ups, yps, Ws))
        print(f"four_tank_robust K={K} (G {tuple(op.G.shape)}, "
              f"{gflop:.3f} GFLOP, {fr.k1_pack(op).slots.shape[0]} column "
              f"tiles): K1 {cs.cuda_ms(run, reps=20):.4f} ms per launch, "
              f"amortized {t_amort:.4f} ms per rollout over R={R} [{smi}]",
              flush=True)
        if K != 50:
            continue
        rows = [(what[tag], lambda tag=tag: swapped(
            "fused_rollout", patched[tag], run)) for tag in
            ("k1_state_only", "k1_product_only", "k1_no_cost",
             "k1_no_stores", "k1_no_fma")]
        A = cs.k1_rows(op, s0, W)
        rows += [("plain version (8 cuBLAS products + copies)",
                  lambda: fr.fused_rollout_reference(op, s0, W)),
                 (f"one addmm {tuple(A.shape)} x {tuple(op.G.shape)}",
                  lambda: torch.addmm(op.bias, A, op.G))]
        # Short launches are paced by the host (the wrapper's own ~0.06
        # ms), so each row also gives the device time of its kernels.
        for label, fn in rows:
            dev_ms, _, s = device_read(lambda: [fn() for _ in range(10)])
            device = ("device not read" if dev_ms is None else
                      f"device {dev_ms / 10:.4f} ms")
            print(f"four_tank_robust {label}: "
                  f"{cs.cuda_ms(fn, reps=20):.4f} ms per call, {device} "
                  f"({s.counts()}) [{smi}]", flush=True)
        del A
        print(busy_line("four_tank_robust",
                        lambda: amort(x0s, ups, yps, Ws, 20), 20, t_amort),
              flush=True)
        _, _, s = device_read(lambda: amort(x0s, ups, yps, Ws, 20))
        if not s.complete:
            print(f"four_tank_robust 20 amortized rollouts, device time by "
                  f"kernel not read; {s.counts()}", flush=True)
        for name, ms in sorted(s.ms.items() if s.complete else (),
                               key=lambda kv: -kv[1]):
            print(f"four_tank_robust 20 amortized rollouts, device time "
                  f"{name}: {ms:.3f} ms ({s.counts()})", flush=True)


def wide_breakdown(dev, smi, patched, what, ladder) -> None:
    """K4w at ``large_plant_convex`` or K5w at ``large_plant_ladder``
    (``chip_smoke.py`` phase 48's shapes, B = 16384 x T = 400): as
    shipped, at 0 and twice its iterations, each wide-body variant, and
    the plain version; the variants that keep the arithmetic are checked
    bit-equal to the shipped kernel. Each row: one warm-up, then one
    timed launch."""
    from direct_data_driven_mpc_tpu_torch.qp.admm import (
        compute_admm_operator_np,
    )

    name = "large_plant_ladder" if ladder else "large_plant_convex"
    plant, ctrl = cs.build_large_plant(slack="NONE" if ladder else "CONVEX")
    if ladder:
        op = compute_box_admm_operator_np(
            ctrl.spec, u_bounds=(-cs.WIDE_BOX, cs.WIDE_BOX))
        kw, make, wrapper = dict(cs.LADDER_KW), fl.make_fused_ladder_rollout, \
            fl.fused_ladder
        plain = fl.fused_ladder_reference
    else:
        op = compute_admm_operator_np(ctrl.spec)
        kw, make, wrapper = dict(cs.WIDE_CONVEX_KW), \
            fa.make_fused_admm_rollout, fa.fused_admm
        plain = fa.fused_admm_reference
    B, T = cs.B_WIDE, cs.T_WIDE
    ins = (*cs.scenario_batch(plant, ctrl, B, dev),
           draw_noise_batch(0, B, T, ctrl.p, plant.get_eps_max(),
                            device=dev))
    store = {}

    def keep(*args):
        store["args"] = args
        return wrapper(*args)

    make(plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T, device=dev,
         rollout=keep, **kw)(*ins)
    args = list(store["args"])
    n_iter = args[4]
    del ins, store

    def run(iters=n_iter, fn=wrapper):
        return lambda: fn(*args[:4], iters, *args[5:])

    shipped = run()()
    rows = [("as shipped", run(), False), ("0 iterations", run(0), False),
            (f"{2 * n_iter} iterations", run(2 * n_iter), False)]
    rows += [(what[tag], lambda tag=tag: swapped(
        "fused_admm", patched[tag], run()), tag in WIDE_SAME_BITS)
        for tag in patched if tag.startswith("wide_")]
    rows.append(("plain version (cuBLAS SGEMMs + elementwise)",
                 run(fn=plain), False))
    for label, fn, check in rows:
        ms = cs.cuda_ms(fn, reps=1)
        same = ""
        if check:
            out = fn()
            same = ("; bit-equal to shipped" if all(
                torch.equal(a, b) for a, b in zip(out, shipped))
                else "; DIFFERS from shipped")
        print(f"{name} K{5 if ladder else 4}w {label}: {ms:.2f} ms per "
              f"launch{same} [{smi}]", flush=True)
    del shipped, args


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("breakdown: CUDA is not available; nothing run")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    paths = sys.argv[1:] or ["k1", "k4", "k4tiles", "k5", "k3", "k4w", "k5w",
                             "batch"]
    wanted = [v for v in VARIANTS
              if any(v[1].startswith(f"{p}_") for p in paths)]
    if {"k4w", "k5w"} & set(paths):
        wanted += [("fused_admm", *v) for v in WIDE]
    with ThreadPoolExecutor(len(wanted) + 2) as pool:
        shipped = pool.map(_kernels.load, ("fused_rollout", "fused_admm"))
        patched = dict(pool.map(build, wanted))
        list(shipped)
    what = {tag: text for _, tag, text, _ in wanted}

    if "k1" in paths:
        k1_breakdown(dev, smi, patched, what)

    if "k4" in paths:
        # K4 at four_tank_convex: the rollout's own kernel arguments.
        plant, ctrl, op, kw = cs.admm_config("four_tank_convex")
        B, T = cs.B_ADMM, cs.T_ADMM
        ins = (*cs.scenario_batch(plant, ctrl, B, dev),
               draw_noise_batch(0, B, T, ctrl.p, plant.get_eps_max(),
                                device=dev))
        store = {}

        def keep4(*args):
            store["args"] = args
            return fa.fused_admm(*args)

        fa.make_fused_admm_rollout(plant.as_params(), op, 4, 2, 2, T,
                                   device=dev, rollout=keep4, **kw)(*ins)
        args = list(store["args"])
        n_iter = args[4]

        def k4(iters=n_iter):
            return lambda: fa.fused_admm(*args[:4], iters, *args[5:])

        for label, fn in (
            ("K4 as shipped", k4()), ("K4, 0 iterations", k4(0)),
            (f"K4, {2 * n_iter} iterations", k4(2 * n_iter)),
            (what["k4_one_block_per_sm"], lambda: swapped(
                "fused_admm", patched["k4_one_block_per_sm"], k4())),
        ):
            print(f"four_tank_convex {label}: "
                  f"{cs.cuda_ms(fn, reps=3):.3f} ms per launch [{smi}]",
                  flush=True)
        del store, args, ins

    if "k4tiles" in paths:
        # K4 alone at four_tank_convex by batch: as shipped, and held to
        # each of its two tiles, in turns.
        plant, ctrl, op, kw = cs.admm_config("four_tank_convex")
        T = cs.T_ADMM
        for B in (4096, 8192, 12288, 16384):
            ins = (*cs.scenario_batch(plant, ctrl, B, dev),
                   draw_noise_batch(0, B, T, ctrl.p, plant.get_eps_max(),
                                    device=dev))
            store = {}

            def keep_args(*args):
                store["args"] = args
                return fa.fused_admm(*args)

            fa.make_fused_admm_rollout(plant.as_params(), op, 4, 2, 2, T,
                                       device=dev, rollout=keep_args,
                                       **kw)(*ins)
            args = store["args"]
            rows = fa.admm_plan(args[1], B, fa.sm_count(dev))[0]
            ms = {"shipped": [], "k4tiles_full": [], "k4tiles_half": []}
            for _ in range(3):
                for tag in ms:
                    lib = patched.get(tag)
                    ms[tag].append(cs.cuda_ms(
                        (lambda: fa.fused_admm(*args)) if lib is None else
                        (lambda lib=lib: swapped(
                            "fused_admm", lib, lambda: fa.fused_admm(*args))),
                        reps=3))
            print(f"four_tank_convex K4 alone at B = {B} x T = {T} (ms a "
                  f"launch, three turns): shipped (the {rows}-scenario "
                  f"tile) {ms['shipped']}; the 64-scenario tile "
                  f"{ms['k4tiles_full']}; the 32-scenario tile "
                  f"{ms['k4tiles_half']} [{smi}]", flush=True)
            del store, args, ins

    if "k5" in paths:
        # K5 at four_tank_ladder: the rollout's own kernel arguments.
        plant, ctrl, op, kw = cs.admm_config("four_tank_ladder")
        B, T = cs.B_ADMM, cs.T_ADMM
        ins = (*cs.scenario_batch(plant, ctrl, B, dev),
               draw_noise_batch(0, B, T, ctrl.p, plant.get_eps_max(),
                                device=dev))
        store = {}

        def keep(*args):
            store["args"] = args
            return fl.fused_ladder(*args)

        fl.make_fused_ladder_rollout(plant.as_params(), op, 4, 2, 2, T,
                                     device=dev, rollout=keep, **kw)(*ins)
        args = list(store["args"])
        n_iter = args[4]

        def k5(iters=n_iter):
            return lambda: fl.fused_ladder(*args[:4], iters, *args[5:])

        rows = [("K5 as shipped", k5()), ("K5, 0 iterations", k5(0)),
                (f"K5, {2 * n_iter} iterations", k5(2 * n_iter))]
        top = compute_box_admm_operator_np(
            ctrl.spec, u_bounds=(-0.85, 0.85), rho=float(op["rhos"][-1])
        )
        ops4, dims4 = fa.build_fused_admm_operator(plant.as_params(), top, 4,
                                                   2, 2, device=dev)
        rows.append(("K4 at the top rung (no balancer, no re-staging)",
                     lambda: fa.fused_admm(ops4, dims4, args[2], args[3],
                                           n_iter)))
        rows.append((what["k5_one_block_per_sm"], lambda: swapped(
            "fused_admm", patched["k5_one_block_per_sm"], k5())))
        for label, fn in rows:
            print(f"four_tank_ladder {label}: "
                  f"{cs.cuda_ms(fn, reps=3):.3f} ms per launch [{smi}]",
                  flush=True)
        amort = fl.make_amortized_ladder_run(plant.as_params(), op, 4, 2, 2,
                                             T, device=dev, **kw)
        print(busy_line("four_tank_ladder", lambda: amort(*ins, 2), 2),
              flush=True)
        del store, args, ins

    if "k3" in paths:
        # K3 at large_plant.
        plant, ctrl = cs.build_large_plant()
        K = 25
        bm = build_linear_engine(ctrl, plant.as_params(), solves_per_block=K,
                                 device=dev)
        op3 = fr._build_fused_operator(bm, include_cost=False)
        Ws = draw_noise_batch(0, B, T, ctrl.p, plant.get_eps_max(),
                              device=dev)
        x0s, ups, yps = cs.scenario_batch(plant, ctrl, B, dev)
        s0, W = fr._center_and_pack(bm, x0s, ups, yps, Ws, T // K, K, 0)
        U, Y, _, _ = fr.fused_rollout(op3, s0, W)
        u_sys, y_sys = U.reshape(B, T, 10), Y.reshape(B, T, 10)
        post = fr._make_post_cost_fn(bm, 1)
        sw = torch.cat([W[:, 0], s0], dim=1)

        def k3(tag=None):
            run = lambda: fr.fused_rollout(op3, s0, W)  # noqa: E731
            return run if tag is None else (
                lambda: swapped("fused_rollout", patched[tag], run))

        # The same costs as one window unfold and a matrix product: window
        # slot j of channel c times [L | q] row (j, c), theta's layout.
        n, m, p = ups.shape[1], 10, 10
        P = bm.cost_P.double().cpu().numpy()
        evals, V = np.linalg.eigh(0.5 * (P + P.T))
        keep = evals > 1e-6 * evals.max()  # the post-pass's truncation
        L = V[:, keep] * np.sqrt(evals[keep])
        Lq = np.concatenate([L, bm.cost_q.double().cpu().numpy()[:, None]], 1)
        rank = L.shape[1]
        Kz = np.concatenate([Lq[: n * m].reshape(n, m, -1),
                             Lq[n * m:].reshape(n, p, -1)], 1)  # (n, C, r+1)
        Wmat = torch.as_tensor(Kz.transpose(1, 0, 2).reshape(-1, rank + 1),
                               dtype=torch.float32, device=dev)  # (C*n, r+1)
        r_c = float(bm.cost_r)
        x_full = torch.cat([torch.cat([ups, u_sys], 1),
                            torch.cat([yps, y_sys], 1)], 2).transpose(1, 2)

        def unfold_post():
            out = torch.empty((B, T), device=dev)
            for c0 in range(0, B, 2048):
                win = x_full[c0:c0 + 2048].unfold(2, n, 1)[:, :, :T]
                win = win.permute(0, 2, 1, 3).reshape(-1, (m + p) * n)
                z = win @ Wmat
                out[c0:c0 + 2048] = ((z[:, :rank] * z[:, :rank]).sum(1)
                                     + z[:, rank] + r_c).view(-1, T)
            return out

        ref = post(ups, yps, u_sys, y_sys)
        print(f"large_plant unfold yardstick vs post-pass: max |diff| "
              f"{float((unfold_post() - ref).abs().max()):.3e}", flush=True)
        rows = [("K3 as shipped", k3()),
                ("plain version (16 cuBLAS products + copies)",
                 lambda: fr.fused_rollout_reference(op3, s0, W)),
                ("one per-block cuBLAS product (addmm)",
                 lambda: torch.addmm(op3.bias, sw, op3.G)),
                ("cost post-pass (F.conv1d, TF32 off)",
                 lambda: post(ups, yps, u_sys, y_sys)),
                ("the same costs by window unfold + one SGEMM per 2048 "
                 "scenarios", unfold_post)]
        rows += [(what[tag], k3(tag)) for tag in
                 ("k3_no_product", "k3_no_split", "k3_no_staging",
                  "k3_no_stores", "k3_tensor_core_sum", "k3_32_rows")]
        for label, fn in rows:
            print(f"large_plant {label}: {cs.cuda_ms(fn, reps=3):.3f} ms "
                  f"[{smi}]", flush=True)
        # K = 50 solves per block, where the 64-row plan does not fit and
        # K3 runs its 32-row plan (8 blocks of 50 solves).
        bm50 = build_linear_engine(ctrl, plant.as_params(),
                                   solves_per_block=50, device=dev)
        op50 = fr._build_fused_operator(bm50, include_cost=False)
        s50, W50 = fr._center_and_pack(bm50, x0s, ups, yps, Ws, T // 50,
                                       50, 0)
        print(f"large_plant K=50 plan {fr.nocost_plan(op50.S, op50.nw)}",
              flush=True)
        for label, fn in (
            ("K3 at K=50 (32-row plan, as shipped)",
             lambda: fr.fused_rollout(op50, s50, W50)),
            ("plain version at K=50 (8 cuBLAS products + copies)",
             lambda: fr.fused_rollout_reference(op50, s50, W50)),
        ):
            print(f"large_plant {label}: {cs.cuda_ms(fn, reps=3):.3f} ms "
                  f"[{smi}]", flush=True)
        del bm50, op50, s50, W50
        # What the float32 add per ring tile buys: the largest |dU| of K3
        # and of K3 summing in the tensor cores against the plain version.
        want = fr.fused_rollout_reference(op3, s0, W)[0]
        for label, fn in (("K3 as shipped", k3()),
                          (what["k3_tensor_core_sum"],
                           k3("k3_tensor_core_sum"))):
            print(f"large_plant {label}: max |dU| against the plain version "
                  f"{float((fn()[0] - want).abs().max()):.3e}", flush=True)
        torch.backends.cudnn.benchmark = True
        print(f"large_plant cost post-pass with cudnn.benchmark: "
              f"{cs.cuda_ms(lambda: post(ups, yps, u_sys, y_sys), 3):.3f} ms "
              f"[{smi}]", flush=True)
        torch.backends.cudnn.benchmark = False
        amort = fr.make_amortized_run(bm, T, cost_mode="post")
        print(busy_line("large_plant", lambda: amort(x0s, ups, yps, Ws, 2),
                        2), flush=True)
    for path in ("k4w", "k5w"):
        if path in paths:
            wide_breakdown(dev, smi, patched, what, path == "k5w")
    if "batch" in paths:
        bit_equality_by_batch(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
