"""Run ``chip_smoke.py``'s multi-device phases 40-42 alone on one card.

The main path's inputs are built as ``chip_smoke.py`` builds them (the
four-tank Robust controller of seed 0, the block maps at K = 50 and 100,
B = 4096 x T = 400 of seed-0 noise), the kernels are compiled, and
phases 40 (the sharded K1, K1 tracking, K4 and classic engine on a world
of one NCCL rank), 41 (two gloo ranks sharing the card) and 42 (the
alpha-sharded PMINRES) run with their checks, each phase's seconds
printed. Run from the repository root: ``python3
scripts/run_multidevice_phases.py``.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import chip_smoke as cs
    from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
        build_linear_engine,
    )
    from direct_data_driven_mpc_tpu_torch.ops import _kernels
    from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )

    if not torch.cuda.is_available():
        raise SystemExit("run_multidevice_phases: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.set_float32_matmul_precision("high")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    cs.log(f"card: {smi}; torch {torch.__version__}")
    with ThreadPoolExecutor(len(cs.KERNELS)) as pool:
        list(pool.map(_kernels.load, cs.KERNELS))
    plant, ctrl = cs.build_four_tank_robust()
    K = fr.suggest_solves_per_block(plant.get_system_order(), ctrl.n,
                                    ctrl.m, ctrl.p, n_steps=cs.T_MAIN)
    main_run = dict(
        plant=plant, ctrl=ctrl,
        inputs=(*cs.scenario_batch(plant, ctrl, cs.B_MAIN, dev),
                draw_noise_batch(0, cs.B_MAIN, cs.T_MAIN, ctrl.p,
                                 plant.get_eps_max(), dev)),
        bm50=build_linear_engine(ctrl, plant.as_params(),
                                 solves_per_block=K, device=dev),
        bm100=build_linear_engine(ctrl, plant.as_params(),
                                  solves_per_block=100, device=dev),
    )
    t0 = time.perf_counter()
    mesh = cs.sharded_phase(dev, smi, main_run)
    t1 = time.perf_counter()
    outs = cs.two_rank_phase(dev, smi, main_run, mesh)
    t2 = time.perf_counter()
    cs.pminres_phase(dev, smi, main_run, mesh, outs)
    t3 = time.perf_counter()
    torch.distributed.destroy_process_group()
    cs.log(f"phase 40 {t1 - t0:.1f} s, 41 {t2 - t1:.1f} s, 42 "
           f"{t3 - t2:.1f} s [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
