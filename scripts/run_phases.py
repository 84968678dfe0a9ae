"""Run some of ``chip_smoke.py``'s phases alone on one card, named by
their functions, in the order given, each phase's seconds printed. The
kernels are compiled first. A phase that returns records for the
``kernels`` line has them printed as one JSON object. A phase's inputs
are built once, as ``chip_smoke.py`` builds them, from the names of its
parameters: ``main_run`` or ``main``, the main path's (the four-tank
Robust controller of seed 0, the block maps at K = 50 and 100,
B = 4096 x T = 400 of seed-0 noise, and K1's and the plain version's
outputs on the K = 50 map, which the tracking phases compare with);
``runs``, the generic configurations of phases 27-29 (for phase 30,
``generic_timing``); ``sweep``, phase 32's sweep (for phase 35,
``profiling_phase``). ``k1_report_phase`` (defined here) runs phase 4's
``k1_report`` on the main path's fused operator and inputs.

Run from the repository root, for example:

    python3 scripts/run_phases.py multidevice_phases          # 40-42
    python3 scripts/run_phases.py example_phase reproduction_phase \\
        entry_phase                                           # 43-45
    python3 scripts/run_phases.py random_dims_phase long_horizon_phase
    python3 scripts/run_phases.py wide_admm_phase             # 48
    python3 scripts/run_phases.py last_options_phase          # 49
    python3 scripts/run_phases.py --repeat 20 time_parallel_phase  # 38
    python3 scripts/run_phases.py --repeat 20 k1_report_phase \\
        tracking_phases generic_timing profiling_phase         # 4, 22-26, 30, 35

``--repeat N`` runs the named phases N times in one process (one build,
one set of inputs) and prints how many of the N runs failed, with each
failure's traceback; it exits 1 if any did.
"""

import inspect
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main_run_inputs(cs, dev) -> dict:
    """The main path's inputs, as ``chip_smoke.main`` builds them, with
    the block map's K and phase 4's K1 and plain outputs."""
    from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
        build_linear_engine,
    )
    from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )

    plant, ctrl = cs.build_four_tank_robust()
    K = fr.suggest_solves_per_block(plant.get_system_order(), ctrl.n,
                                    ctrl.m, ctrl.p, n_steps=cs.T_MAIN)
    main = dict(
        plant=plant, ctrl=ctrl, K=K,
        inputs=(*cs.scenario_batch(plant, ctrl, cs.B_MAIN, dev),
                draw_noise_batch(0, cs.B_MAIN, cs.T_MAIN, ctrl.p,
                                 plant.get_eps_max(), dev)),
        bm50=build_linear_engine(ctrl, plant.as_params(),
                                 solves_per_block=K, device=dev),
        bm100=build_linear_engine(ctrl, plant.as_params(),
                                  solves_per_block=100, device=dev),
    )
    op, s0, W = k1_operands(cs, main)
    main["k1"] = fr.fused_rollout(op, s0, W)
    main["plain"] = fr.fused_rollout_reference(op, s0, W)
    return main


def k1_operands(cs, main) -> tuple:
    """Phase 4's fused operator and packed inputs on the K = 50 map."""
    from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr

    bm50, K = main["bm50"], main["K"]
    return (fr._build_fused_operator(bm50),
            *fr._center_and_pack(bm50, *main["inputs"], cs.T_MAIN // K, K,
                                 0))


def k1_report_phase(dev, smi, main):
    """Phase 4's ``k1_report``: K1's plan, attributes and launches per
    call, at the main path's shape."""
    import chip_smoke as cs

    cs.k1_report(*k1_operands(cs, main))


def phase_inputs(cs, dev, smi, names, built) -> list:
    """The inputs a phase takes after ``dev`` and ``smi``, by parameter
    name, each built once into ``built``."""
    makers = {
        "main": lambda: main_run_inputs(cs, dev),
        "runs": lambda: cs.generic_phases(dev, smi, get("main")),
        "sweep": lambda: cs.sweep_phase(dev, smi, get("main")),
    }

    def get(name):
        name = "main" if name == "main_run" else name
        if name not in built:
            built[name] = makers[name]()
        return built[name]

    return [get(n) for n in names if n in makers or n == "main_run"]


def main(names, repeat=1) -> int:
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import chip_smoke as cs
    from direct_data_driven_mpc_tpu_torch.ops import _kernels

    if not names:
        raise SystemExit("run_phases: name at least one phase function of "
                         "chip_smoke.py")
    phases = [globals()[name] if name == "k1_report_phase"
              else getattr(cs, name) for name in names]
    if not torch.cuda.is_available():
        raise SystemExit("run_phases: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.set_float32_matmul_precision("high")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    cs.log(f"card: {smi}; torch {torch.__version__}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cs.KERNELS)) as pool:
        list(pool.map(_kernels.load, cs.KERNELS))
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    built = {}
    failed = 0
    for run in range(repeat):
        try:
            for name, phase in zip(names, phases):
                t0 = time.perf_counter()
                params = list(inspect.signature(phase).parameters)[2:]
                out = phase(dev, smi,
                            *phase_inputs(cs, dev, smi, params, built))
                if isinstance(out, list):
                    print(json.dumps({"kernels": out}))
                cs.log(f"{name}: {time.perf_counter() - t0:.1f} s [{smi}]")
        except Exception:
            if repeat == 1:
                raise
            failed += 1
            cs.log(f"run {run + 1} of {repeat} failed:\n"
                   f"{traceback.format_exc()}")
    if repeat > 1:
        cs.log(f"{' '.join(names)}: {failed} of {repeat} runs failed")
    return 1 if failed else 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    repeat = 1
    if argv[:1] == ["--repeat"]:
        repeat, argv = int(argv[1]), argv[2:]
    sys.exit(main(argv, repeat))
