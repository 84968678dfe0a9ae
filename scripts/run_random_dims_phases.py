"""Run ``chip_smoke.py``'s phases 46-47 alone on one card: kernels K1,
K3, K4 and K5 at the seven random shapes of tests/test_random_dims.py
(B = 4096 x T = 400 each, against their plain versions and float64,
timed in turns), then ``bench.py``'s ``long_horizon`` through K1 and
``long_horizon_convex`` through K4 at B = 65536 x T = 400, with their
checks, each phase's seconds printed. The kernels are compiled first.
Run from the repository root: ``python3 scripts/run_random_dims_phases.py``.
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
    from direct_data_driven_mpc_tpu_torch.ops import _kernels

    if not torch.cuda.is_available():
        raise SystemExit("run_random_dims_phases: no CUDA device")
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
    t1 = time.perf_counter()
    cs.random_dims_phase(dev, smi)
    t2 = time.perf_counter()
    cs.long_horizon_phase(dev, smi)
    t3 = time.perf_counter()
    cs.log(f"build {t1 - t0:.1f} s, phase 46 {t2 - t1:.1f} s, 47 "
           f"{t3 - t2:.1f} s [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
