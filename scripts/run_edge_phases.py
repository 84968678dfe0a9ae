"""Run ``chip_smoke.py``'s phases 43-45 alone on one card: the example
CLIs' pipelines (the direct example on its four engines, Monte Carlo,
setpoint tracking, tuning), the paper reproduction and the top-level entry
points (``entry()`` and ``dryrun_multichip(2)``), with their checks,
each phase's seconds printed. The kernels are compiled first. Run from
the repository root: ``python3 scripts/run_edge_phases.py``.
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
        raise SystemExit("run_edge_phases: no CUDA device")
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
    t0 = time.perf_counter()
    cs.example_phase(dev, smi)
    t1 = time.perf_counter()
    cs.reproduction_phase(dev, smi)
    t2 = time.perf_counter()
    cs.entry_phase(dev, smi)
    t3 = time.perf_counter()
    cs.log(f"phase 43 {t1 - t0:.1f} s, 44 {t2 - t1:.1f} s, 45 "
           f"{t3 - t2:.1f} s [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
