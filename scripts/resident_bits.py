"""Fingerprint the ADMM kernels' results, to show that two checkouts
give the same bits: K4 (``fused_admm_kernel``) at ``four_tank_convex``
(B = 65536), ``four_tank_box``, ``four_tank_admm_tracking`` (8192),
``four_tank_convex_q4`` and ``long_horizon_convex`` (4096), K5
(``fused_ladder_kernel``) at ``four_tank_ladder`` (65536), and both at
the seven random shapes of tests/test_random_dims.py (4096; K4 on the
ROBUST ones); then the wide bodies: K4w at ``large_plant_convex`` and
K5w at ``large_plant_ladder`` (16384, ``chip_smoke.py`` phase 48's
shapes), both at nbox 196 (8192; the plants of tests/test_torch_cuda.py's
``mid_wide`` cases, built here), and the wide body at
``four_tank_convex`` and ``four_tank_ladder`` (65536) through
``chip_smoke.wide_launcher``; all at T = 400 from ``chip_smoke.py``'s
inputs. Prints one JSON object: per case the resident and wide launches
and a SHA-256 of every output tensor's bytes. ``--wide`` fingerprints
the wide cases alone.

Run on one card from the repository root, once per checkout (the
package and ``chip_smoke.py`` are imported from ROOT, the kernels built
under ROOT), then compare:

    python3 scripts/resident_bits.py [--wide] ROOT > bits.json
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


def mid_wide_plant(slack, n, m, p, L, seed, N=600):
    """A random plant (``random_stable_lti(seed, ns=n, m, p)``) with a
    Robust controller built as ``chip_smoke.build_large_plant`` builds
    ``large_plant``'s (tests/test_torch_cuda.py's ``_mid_wide_plant``)."""
    import numpy as np

    from direct_data_driven_mpc_tpu_torch.control.controller import (
        DataDrivenMPCType,
        DirectDataDrivenMPCController,
        SlackVarConstraintTypes,
    )
    from direct_data_driven_mpc_tpu_torch.models.random_lti import (
        random_stable_lti,
    )

    plant = random_stable_lti(seed=seed, ns=n, m=m, p=p)
    eps = plant.get_eps_max()
    u_s = 0.5 * np.ones((m, 1))
    y_s = plant.get_equilibrium_output_from_input(u_s.ravel()).reshape(-1, 1)
    rng = np.random.default_rng(seed)
    u_d = rng.uniform(-1, 1, (N, m))
    y_d = plant.simulate(u_d, eps * rng.uniform(-1, 1, (N, p)), N)
    return plant, DirectDataDrivenMPCController(
        n=n, m=m, p=p, u_d=u_d, y_d=y_d, L=L, Q=3.0 * np.eye(p * L),
        R=1e-4 * np.eye(m * L), u_s=u_s, y_s=y_s, eps_max=eps,
        lamb_alpha=0.1 / eps, lamb_sigma=1000.0, c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes[slack],
        controller_type=DataDrivenMPCType.ROBUST,
    )


def run(root: str, wide_only: bool = False) -> dict:
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
        if wide_only:
            break
        plant, ctrl, op, kw = cs.admm_config(name)
        make = (fl.make_fused_ladder_rollout if name == "four_tank_ladder"
                else fa.make_fused_admm_rollout)
        record(name, make, plant, ctrl, op, B, **kw)
    for case in cs.RANDOM_DIMS if not wide_only else ():
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
    # The wide bodies, where the resident plans refuse the shape.
    for name, B in (("large_plant", 16384), ("mid_wide", 8192)):
        for ladder in (False, True):
            slack = "NONE" if ladder else "CONVEX"
            if name == "large_plant":
                plant, ctrl = cs.build_large_plant(slack=slack)
            elif ladder:
                plant, ctrl = mid_wide_plant(slack, n=4, m=7, p=4, L=32,
                                             seed=0)
            else:
                plant, ctrl = mid_wide_plant(slack, n=2, m=7, p=7, L=28,
                                             seed=7)
            if ladder:
                op = compute_box_admm_operator_np(
                    ctrl.spec, u_bounds=(-cs.WIDE_BOX, cs.WIDE_BOX))
                record(f"{name}_ladder K5w", fl.make_fused_ladder_rollout,
                       plant, ctrl, op, B, **cs.LADDER_KW)
            else:
                record(f"{name}_convex K4w", fa.make_fused_admm_rollout,
                       plant, ctrl, compute_admm_operator_np(ctrl.spec), B,
                       **cs.WIDE_CONVEX_KW)
    # The wide body at the resident shapes, through the library's launcher
    # (it counts no launch).
    for name in ("four_tank_convex", "four_tank_ladder"):
        ladder = name == "four_tank_ladder"
        plant, ctrl, op, kw = cs.admm_config(name)
        make = (fl.make_fused_ladder_rollout if ladder
                else fa.make_fused_admm_rollout)
        record(f"{name} wide launcher", make, plant, ctrl, op, 65536,
               rollout=cs.wide_launcher(ladder), **kw)
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
    args = sys.argv[1:]
    wide_only = args[:1] == ["--wide"]
    args = args[1:] if wide_only else args
    root = args[0] if args else os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    print(json.dumps(run(root, wide_only)))
