"""Readings of the output check's control: the plain reference put in
the program's place and computed in TF32 (every product's operands
rounded to TF32's 10-bit mantissa, float32 accumulation), the step below
the float32-with-TF32-off that the configurations state.

    python3 port_bench/control.py --workload <name> --seeds 11,12,13

runs, for each seed, the control over a whole evaluation at the cell's
size (B scenarios of the pool's first noise batch) and prints, as one
JSON line, the numbers the output check compares (``harness.gaps`` on
the judged scenarios, against the float64 reference). A limit has to
lie below every reading here. The benchmark's own runs never run it.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, device) -> dict:
    import torch

    from port_bench import harness, traffic as gen

    data = gen.data_run(cell.config, seed)
    W = gen.noise_pool(cell.config, cell.traffic, seed, device)[0]
    idx = torch.as_tensor(gen.judged_scenarios(cell.traffic, seed),
                          device=device)
    out = cell.engine.reference_run(cell.config, data, W, control=True)
    got = {f: out[r][idx.cpu().numpy()]
           for f, r in harness.REF_NAMES.items() if r in out}
    ref = cell.engine.reference_run(cell.config, data,
                                    W.index_select(0, idx).double())
    return {k: float(v.max()) for k, v in harness.gaps(got, ref).items()}


def main(argv=None) -> int:
    import argparse
    import json

    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(ROOT, args.workload)
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = readings(cell, seed, device)
        print(json.dumps({"workload": cell.name, "seed": seed, "control": r,
                          "limits": cell.config["limits"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
