"""Fingerprint the resident ADMM kernels' results, to show that two
checkouts give the same bits: K4 (``fused_admm_kernel``) at
``four_tank_convex`` (B = 65536), ``four_tank_box``,
``four_tank_admm_tracking`` (8192), ``four_tank_convex_q4`` and
``long_horizon_convex`` (4096), K5 (``fused_ladder_kernel``) at
``four_tank_ladder`` (65536), and both at the seven random shapes of
tests/test_random_dims.py (4096; K4 on the ROBUST ones), all at T = 400
from ``chip_smoke.py``'s inputs. Prints one JSON object: per case the
resident and wide launches and a SHA-256 of every output tensor's bytes.

Run on one card from the repository root, once per checkout (the
package and ``chip_smoke.py`` are imported from ROOT, the kernels built
under ROOT), then compare:

    python3 scripts/resident_bits.py ROOT > bits.json
    python3 scripts/resident_bits.py --compare A.json B.json
"""

import hashlib
import json
import os
import sys


def fingerprint(res) -> dict:
    """SHA-256 (16 hex digits) of each field of a ``ClosedLoopResult``
    and of its solver state."""
    out = {}
    fields = [(f, getattr(res, f)) for f in (
        "u_sys", "y_sys", "costs", "converged", "x_final", "u_past",
        "y_past")]
    fields += [(f"solver_state.{f}", t) for f, t in
               zip(res.solver_state._fields, res.solver_state)]
    for name, t in fields:
        data = t.detach().contiguous().cpu().numpy().tobytes()
        out[name] = hashlib.sha256(data).hexdigest()[:16]
    return out


def run(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs
    from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa
    from direct_data_driven_mpc_tpu_torch.ops import fused_ladder as fl
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )
    from direct_data_driven_mpc_tpu_torch.qp.admm import (
        compute_admm_operator_np,
    )
    from direct_data_driven_mpc_tpu_torch.qp.box import (
        compute_box_admm_operator_np,
    )

    if not torch.cuda.is_available():
        raise SystemExit("resident_bits: no CUDA device")
    if not fa.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"resident_bits: imported {fa.__file__}, not from "
                         f"{root}")
    dev = torch.device("cuda", 0)
    T = 400
    out = {}

    def counts():
        return (fa.fused_admm.launches,
                getattr(fa.fused_admm, "wide_launches", 0),
                fl.fused_ladder.launches,
                getattr(fl.fused_ladder, "wide_launches", 0))

    def record(key, make, plant, ctrl, op, B, **kw):
        ins = (*cs.scenario_batch(plant, ctrl, B, dev),
               draw_noise_batch(0, B, T, ctrl.p, plant.get_eps_max(),
                                device=dev))
        before = counts()
        res = make(plant.as_params(), op, ctrl.n, ctrl.m, ctrl.p, T,
                   device=dev, **kw)(*ins)
        torch.cuda.synchronize()
        launched = [a - b for a, b in zip(counts(), before)]
        out[key] = {"launches": launched, **fingerprint(res)}
        print(f"{key}: launches (K4, K4w, K5, K5w) {launched}",
              file=sys.stderr, flush=True)

    for name, B in (("four_tank_convex", 65536), ("four_tank_box", 8192),
                    ("four_tank_admm_tracking", 8192),
                    ("four_tank_convex_q4", 4096),
                    ("long_horizon_convex", 4096),
                    ("four_tank_ladder", 65536)):
        plant, ctrl, op, kw = cs.admm_config(name)
        make = (fl.make_fused_ladder_rollout if name == "four_tank_ladder"
                else fa.make_fused_admm_rollout)
        record(name, make, plant, ctrl, op, B, **kw)
    for case in cs.RANDOM_DIMS:
        nb = case[6]
        label = f"case{case[0]}"
        if case[7] == "ROBUST":
            plant, ctrl = cs.build_random_dims(case, slack="CONVEX")
            record(f"{label} K4", fa.make_fused_admm_rollout, plant, ctrl,
                   compute_admm_operator_np(ctrl.spec), 4096,
                   n_mpc_step=nb, **cs.CONVEX_KW)
        plant, ctrl = cs.build_random_dims(case)
        box = cs.RANDOM_DIMS_BOX
        record(f"{label} K5", fl.make_fused_ladder_rollout, plant, ctrl,
               compute_box_admm_operator_np(ctrl.spec, u_bounds=(-box, box)),
               4096, n_mpc_step=nb, **cs.LADDER_KW)
    return out


def compare(a_path: str, b_path: str) -> int:
    with open(a_path) as f:
        a = json.load(f)
    with open(b_path) as f:
        b = json.load(f)
    differ = [k for k in a if a[k] != b.get(k)] + [k for k in b
                                                   if k not in a]
    for k in differ:
        print(f"{k}: {a.get(k)} vs {b.get(k)}")
    print(f"{len(a)} cases: {len(a) - len(differ)} equal in every bit and "
          f"launch count, {len(differ)} differ")
    return 1 if differ else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--compare"]:
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    root = sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    print(json.dumps(run(root)))
