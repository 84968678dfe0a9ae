"""Run some of ``chip_smoke.py``'s phases alone on one card, named by
their functions, in the order given, each phase's seconds printed. The
kernels are compiled first. A phase that returns records for the
``kernels`` line has them printed as one JSON object. A phase that takes
the main path's inputs (``multidevice_phases``) gets them built as
``chip_smoke.py`` builds them (a parameter named ``main_run`` or ``main``):
the four-tank Robust controller of seed 0,
the block maps at K = 50 and 100, B = 4096 x T = 400 of seed-0 noise.

Run from the repository root, for example:

    python3 scripts/run_phases.py multidevice_phases          # 40-42
    python3 scripts/run_phases.py example_phase reproduction_phase \\
        entry_phase                                           # 43-45
    python3 scripts/run_phases.py random_dims_phase long_horizon_phase
    python3 scripts/run_phases.py wide_admm_phase             # 48
    python3 scripts/run_phases.py last_options_phase          # 49
    python3 scripts/run_phases.py --repeat 20 time_parallel_phase  # 38

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
    """The main path's inputs, as ``chip_smoke.main`` builds them."""
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
    return dict(
        plant=plant, ctrl=ctrl,
        inputs=(*cs.scenario_batch(plant, ctrl, cs.B_MAIN, dev),
                draw_noise_batch(0, cs.B_MAIN, cs.T_MAIN, ctrl.p,
                                 plant.get_eps_max(), dev)),
        bm50=build_linear_engine(ctrl, plant.as_params(),
                                 solves_per_block=K, device=dev),
        bm100=build_linear_engine(ctrl, plant.as_params(),
                                  solves_per_block=100, device=dev),
    )


def main(names, repeat=1) -> int:
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import chip_smoke as cs
    from direct_data_driven_mpc_tpu_torch.ops import _kernels

    if not names:
        raise SystemExit("run_phases: name at least one phase function of "
                         "chip_smoke.py")
    phases = [getattr(cs, name) for name in names]
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
    main_run = None
    failed = 0
    for run in range(repeat):
        try:
            for name, phase in zip(names, phases):
                t0 = time.perf_counter()
                args = [dev, smi]
                params = inspect.signature(phase).parameters
                if {"main_run", "main"} & set(params):
                    main_run = main_run or main_run_inputs(cs, dev)
                    args.append(main_run)
                out = phase(*args)
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
