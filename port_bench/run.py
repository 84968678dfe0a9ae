"""Run one cell of the port's benchmark and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the CUDA card(s) the cell
asks for. The program's kernel libraries build into ``build/kernels/``
of the checkout on its first run there; every other cache a library
could write goes under ``build/port_bench/`` there.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    cache = ROOT / "build" / "port_bench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(cache / sub)
    sys.path.insert(0, str(ROOT))
    from port_bench import harness

    return harness.main(sys.argv[1:] if argv is None else argv, T_START,
                        ROOT)


if __name__ == "__main__":
    sys.exit(main())
