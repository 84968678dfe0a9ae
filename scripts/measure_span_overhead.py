"""What the program's spans (``utils.profiling.span``) cost.

Off (no ``profiling.collect()`` block, no profiler session): times N
boundaries (``with span(name, device):`` around nothing) in a loop, less
the same loop with an empty body, three passes, and prints the
nanoseconds a boundary and a call of each entry at its count of
boundaries: 5 for the K1 entry (call, pack, rollout, kernel, result), 6
for the ADMM entry (and the cold start). Host CPU only.

On (``--on``, inside ``collect()``; on a machine with a card also with
``device=True``): the same loop over N / 50 boundaries, each kept, less
the empty loop.

    python3 scripts/measure_span_overhead.py [N] [--on]

(default N = 1,000,000).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from direct_data_driven_mpc_tpu_torch.utils import profiling  # noqa: E402

span = profiling.span


def boundaries(n: int, device: bool = True) -> float:
    t = time.perf_counter_ns()
    for _ in range(n):
        with span("ddmpc.pack", device):
            pass
    return time.perf_counter_ns() - t


def empty(n: int) -> float:
    t = time.perf_counter_ns()
    for _ in range(n):
        pass
    return time.perf_counter_ns() - t


def main(n: int, on: bool) -> None:
    assert profiling._record is None
    for i in range(3):
        ns = (boundaries(n) - empty(n)) / n
        print(f"off, pass {i}: {ns:.1f} ns a boundary; a call of the K1 "
              f"entry (5) {5 * ns / 1e3:.3f} us, of the ADMM entry (6) "
              f"{6 * ns / 1e3:.3f} us", flush=True)
    if not on:
        return
    import torch

    kinds = [False] + ([True] if torch.cuda.is_available() else [])
    m = max(n // 50, 1)
    for i in range(3):
        for device in kinds:
            with profiling.collect() as spans:
                t = boundaries(m, device)
            ns = (t - empty(m)) / m
            assert len(spans) == m
            print(f"on, pass {i}, device={device}: {ns / 1e3:.3f} us a "
                  f"boundary", flush=True)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--on"]
    main(int(args[0]) if args else 1_000_000, "--on" in sys.argv[1:])
