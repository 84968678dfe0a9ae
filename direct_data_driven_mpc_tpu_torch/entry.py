"""Top-level entry points on the port: one closed-loop step at the paper's
scale, and the multi-device dry run.

Counterpart of ``__graft_entry__.py``:

- :func:`entry` returns one closed-loop MPC step (the QP solve through
  the exact affine operator, the plant step, the window shift) as a
  plain function on tensors on the card, for the four-tank Robust
  controller at the paper's scale (N = 400, L = 30: 571 QP variables,
  168 constraints per step).
- :func:`dryrun_multichip` runs ``n`` ranks of ``torch.distributed``
  on a ``(n // 2, 2)`` ``(data, model)`` mesh (``(n, 1)`` when n < 4 or
  odd) and holds each of the port's sharded engines to
  ``__graft_entry__.py``'s checks on a tiny Robust problem: the generic
  mesh rollout, the fused condensed rollout (kernel K1 on the card), the
  tracking map at a zero setpoint delta, the fused ADMM (kernel K4 on
  the card), the alpha-sharded PMINRES solve and a 2-step distributed
  closed loop.

Run from the repository root: ``python -m
direct_data_driven_mpc_tpu_torch.entry`` (one step) or ``python -m
direct_data_driven_mpc_tpu_torch.entry dryrun 4`` (four ranks), each on
the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from datetime import timedelta
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from direct_data_driven_mpc_tpu_torch.device import resolve_device
from direct_data_driven_mpc_tpu_torch.ops.precision import ieee_float32

FOUR_TANK = dict(
    A=np.array(
        [
            [0.921, 0, 0.041, 0],
            [0, 0.918, 0, 0.033],
            [0, 0, 0.924, 0],
            [0, 0, 0, 0.937],
        ]
    ),
    B=np.array([[0.017, 0.001], [0.001, 0.023], [0, 0.061], [0.072, 0]]),
    C=np.array([[1.0, 0, 0, 0], [0, 1, 0, 0]]),
    D=np.zeros((2, 2)),
    eps_max=0.002,
)


def four_tank_controller():
    """``(plant, controller)``: the paper-scale four-tank Robust
    controller as ``__graft_entry__.py`` builds it (seed 0, N = 400,
    L = 30, slack NONE), host-side in float64."""
    from direct_data_driven_mpc_tpu_torch.control.controller import (
        DirectDataDrivenMPCController,
    )
    from direct_data_driven_mpc_tpu_torch.models.lti_model import LTIModel
    from direct_data_driven_mpc_tpu_torch.qp.spec import (
        DataDrivenMPCType,
        SlackVarConstraintTypes,
    )

    plant = LTIModel(**FOUR_TANK)
    rng = np.random.default_rng(0)
    N, L = 400, 30
    u_d = rng.uniform(-1, 1, (N, 2))
    w_d = 0.002 * rng.uniform(-1, 1, (N, 2))
    y_d = plant.simulate(u_d, w_d, N)
    ctrl = DirectDataDrivenMPCController(
        n=4, m=2, p=2, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(2 * L), R=1e-4 * np.eye(2 * L),
        u_s=np.array([[1.0], [1.0]]), y_s=np.array([[0.65], [0.77]]),
        eps_max=0.002, lamb_alpha=0.1 / 0.002, lamb_sigma=1000.0, c=1.0,
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
    )
    return plant, ctrl


def entry(device=None) -> Tuple[Callable, tuple]:
    """``(fn, example_args)``: one closed-loop MPC step of the paper's
    four-tank controller, float32 on ``device`` (None: the card, raising
    without one). ``fn(x (4,), u_past (4, 2), y_past (4, 2), w (2,)) ->
    (x_next, y, u0, u_past, y_past)`` solves from the window, applies
    ``u*[0]``, steps the plant and shifts the window."""
    from direct_data_driven_mpc_tpu_torch.ops.lti import lti_step
    from direct_data_driven_mpc_tpu_torch.qp.solution_map import solve_u

    device = resolve_device(device)
    plant_model, ctrl = four_tank_controller()
    sol_map = ctrl.solution_map(device=device, dtype=torch.float32)
    plant = plant_model.as_params().to(device, torch.float32)
    m = plant.B.shape[1]

    @ieee_float32()
    def mpc_step(x, u_past, y_past, w):
        """One Algorithm-1 step: solve, apply u*[0], step the plant,
        shift the measurement window."""
        theta = torch.cat([u_past.reshape(-1), y_past.reshape(-1)])
        u0 = solve_u(sol_map, theta).reshape(-1, m)[0]
        x_next, y = lti_step(plant, x, u0, w)
        u_past = torch.cat([u_past[1:], u0[None]])
        y_past = torch.cat([y_past[1:], y[None]])
        return x_next, y, u0, u_past, y_past

    like = dict(dtype=torch.float32, device=device)
    example_args = (
        torch.zeros(4, **like),
        torch.as_tensor(ctrl.u_past.reshape(4, 2), **like),
        torch.as_tensor(ctrl.y_past.reshape(4, 2), **like),
        torch.zeros(2, **like),
    )
    return mpc_step, example_args


def mesh_shape(n_devices: int) -> Tuple[int, int]:
    """``(n_data, n_model)``: ``(n // 2, 2)`` when n >= 4 and even,
    else ``(n, 1)``."""
    n_model = 2 if n_devices >= 4 and n_devices % 2 == 0 else 1
    return n_devices // n_model, n_model


def _tiny_problem():
    """The dry run's Robust problem (n = 2, m = p = 1, L = 6, N = 30,
    seed 0), slack NONE (c = 1) and CONVEX (c = 0.05): ``(plant, ctrl,
    ctrl_cvx)``. The controllers serve as operator factories; their
    per-step host solve is never called, so they take the numpy path and
    no rank builds the C extension."""
    from direct_data_driven_mpc_tpu_torch.control.controller import (
        DirectDataDrivenMPCController,
    )
    from direct_data_driven_mpc_tpu_torch.models.lti_model import LTIModel
    from direct_data_driven_mpc_tpu_torch.qp.spec import (
        DataDrivenMPCType,
        SlackVarConstraintTypes,
    )

    rng = np.random.default_rng(0)
    plant = LTIModel(
        A=np.array([[0.9, 0.2], [0.0, 0.8]]),
        B=np.array([[0.0], [1.0]]),
        C=np.array([[1.0, 0.3]]),
        D=np.array([[0.1]]),
        eps_max=0.002,
    )
    N, L, n = 30, 6, 2
    u_d = rng.uniform(-1, 1, (N, 1))
    w_d = 0.002 * rng.uniform(-1, 1, (N, 1))
    y_d = plant.simulate(u_d, w_d, N)
    y_s = plant.get_equilibrium_output_from_input(np.array([0.5]))

    def controller(slack, c):
        return DirectDataDrivenMPCController(
            n=n, m=1, p=1, u_d=u_d, y_d=y_d, L=L,
            Q=3.0 * np.eye(L), R=1e-4 * np.eye(L), u_s=np.array([[0.5]]),
            y_s=y_s.reshape(-1, 1), eps_max=0.002, lamb_alpha=50.0,
            lamb_sigma=1000.0, c=c, slack_var_constraint_type=slack,
            controller_type=DataDrivenMPCType.ROBUST, n_mpc_step=1,
            solve_path="numpy",
        )

    return (plant, controller(SlackVarConstraintTypes.NONE, 1.0),
            controller(SlackVarConstraintTypes.CONVEX, 0.05))


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_rank(n_devices: int, device=None) -> dict:
    """This rank's part of :func:`dryrun_multichip`, in a process group
    of at least ``n_devices`` ranks that exists already: every check of
    ``__graft_entry__.py`` on this rank's shard, each raising
    ``RuntimeError`` on failure (on the card, also when K1 or K4 did not
    launch). Returns the numbers JAX prints (the mesh, the global batch
    ``B``, ``mean_final_cost``, the PMINRES residual and iterations) and
    this rank's deviations and kernel launches; the metrics are the same
    on every rank."""
    from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
        build_linear_engine,
        build_tracking_engine,
    )
    from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa
    from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr
    from direct_data_driven_mpc_tpu_torch.parallel import mesh as pm
    from direct_data_driven_mpc_tpu_torch.parallel.batch import (
        draw_noise_batch,
    )
    from direct_data_driven_mpc_tpu_torch.qp.admm import (
        compute_admm_operator_np,
    )
    from direct_data_driven_mpc_tpu_torch.qp.distributed import (
        make_distributed_closed_loop,
        make_distributed_kkt_solver,
    )
    from direct_data_driven_mpc_tpu_torch.qp.solution_map import solve_u

    dev = resolve_device(device)
    n_data, n_model = mesh_shape(n_devices)
    mesh = pm.make_scenario_mesh(n_data, n_model, device=dev)
    plant, ctrl, ctrl_cvx = _tiny_problem()
    params = plant.as_params()
    n = ctrl.n
    sol = ctrl.solution_map(device=dev)

    B = 2 * n_data  # 2 scenarios per data shard
    n_steps = 4
    rows = pm.scenario_slice(B, mesh)
    b = rows.stop - rows.start
    like = dict(dtype=torch.float32, device=dev)

    def window(c):
        return (torch.as_tensor(c.u_past.reshape(1, n, 1), **like)
                .expand(b, n, 1).contiguous(),
                torch.as_tensor(c.y_past.reshape(1, n, 1), **like)
                .expand(b, n, 1).contiguous())

    x0s = torch.zeros((b, n), **like)
    ups, yps = window(ctrl)
    Ws = draw_noise_batch(0, b, n_steps, 1, 0.002, dev,
                          first_index=rows.start)
    k1_before, k4_before = fr.fused_rollout.launches, fa.fused_admm.launches

    result, metrics = pm.make_mesh_rollout(
        mesh, params, sol, n_steps=n_steps, model_parallel=n_model > 1,
    )(x0s, ups, yps, Ws)
    _require(tuple(result.u_sys.shape) == (b, n_steps, 1),
             f"mesh rollout shape {tuple(result.u_sys.shape)}")
    _require(bool(torch.isfinite(result.u_sys).all()),
             "mesh rollout not finite")
    _require(float(metrics["frac_converged"]) == 1.0,
             f"mesh rollout converged {float(metrics['frac_converged'])}")

    # The fused condensed rollout on the shard: K1 on the card.
    bm = build_linear_engine(ctrl, params, solves_per_block=2, device=dev)
    fused, fused_m = pm.make_sharded_fused_rollout(mesh, bm, n_steps)(
        x0s, ups, yps, Ws)
    _require(bool(torch.isfinite(fused.u_sys).all())
             and float(fused_m["frac_converged"]) == 1.0,
             "sharded fused rollout not finite or not converged")
    du_fused = float((fused.u_sys - result.u_sys).abs().max())
    # The north star's 1e-4 bar on the control inputs (BASELINE.json).
    _require(du_fused < 1e-4,
             f"sharded fused rollout off the mesh rollout by {du_fused}")

    # The tracking map with every scenario's schedule at the baked
    # setpoints (dr = 0) reproduces the plain fused rollout bit for bit.
    bm_track = build_tracking_engine(ctrl, params, solves_per_block=2,
                                     device=dev)
    sched = bm_track.r_bar.expand(b, n_steps // 2, -1)
    tracked, tracked_m = pm.make_sharded_fused_rollout(
        mesh, bm_track, n_steps)(x0s, ups, yps, Ws, sched)
    _require(float(tracked_m["frac_converged"]) == 1.0,
             "tracking rollout not converged")
    du_track = float((tracked.u_sys - fused.u_sys).abs().max())
    _require(du_track == 0.0,
             f"tracking at dr = 0 off the plain fused rollout by {du_track}")

    # The fused ADMM of the CONVEX slack box on the shard: K4 on the card.
    ups_c, yps_c = window(ctrl_cvx)
    admm, admm_m = pm.make_sharded_fused_admm_rollout(
        mesh, params, compute_admm_operator_np(ctrl_cvx.spec), n=n, m=1,
        p=1, n_steps=n_steps, iters=(2, 4, 2), cold_iters=16, device=dev,
    )(x0s, ups_c, yps_c, Ws)
    _require(bool(torch.isfinite(admm.u_sys).all())
             and float(admm_m["frac_converged"]) == 1.0,
             f"sharded fused ADMM: converged "
             f"{float(admm_m['frac_converged'])}")

    # One alpha-sharded PMINRES KKT solve over `model` against the exact
    # operator (refine=1: one restart pushes the float32 error below the
    # stagnated residual's floor), and a 2-step closed loop around it.
    theta = torch.as_tensor(
        np.concatenate([ctrl.u_past.ravel(), ctrl.y_past.ravel()]), **like)
    u_dist, res, iters = make_distributed_kkt_solver(
        ctrl.spec, mesh, axis="model", dtype=torch.float32, refine=1,
        device=dev,
    )(theta)
    du_kkt = float((u_dist - solve_u(sol, theta)).abs().max())
    _require(float(res) < 1e-4 and du_kkt < 1e-4,
             f"sharded KKT solve off: res={float(res)}, du={du_kkt}")
    loop = make_distributed_closed_loop(
        mesh, params, ctrl.spec, n_steps=2, dtype=torch.float32, device=dev,
    )(x0s, ups, yps, Ws[:, :2])
    _require(bool(torch.isfinite(loop.u_sys).all()),
             "distributed closed loop not finite")

    k1 = fr.fused_rollout.launches - k1_before
    k4 = fa.fused_admm.launches - k4_before
    if dev.type == "cuda":
        _require(k1 >= 2 and k4 >= 1,
                 f"kernels not launched on the card: K1 {k1}, K4 {k4}")
    return dict(
        mesh=[n_data, n_model], B=B,
        mean_final_cost=float(metrics["mean_final_cost"]),
        res=float(res), iters=int(iters), du_fused=du_fused,
        du_track=du_track, du_kkt=du_kkt, k1_launches=k1, k4_launches=k4,
    )


def _dryrun_process(rank: int, world: int, device: str, tmp: str) -> None:
    """One rank of :func:`dryrun_multichip` (a spawned process): NCCL on
    its own card where there is one per rank, else gloo (ranks sharing
    the card or the CPU); rank 0 writes the result to ``tmp``."""
    import torch.distributed as dist

    dev = torch.device(device)
    backend = "gloo"
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        dev, backend = torch.device("cuda", rank), "nccl"
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=timedelta(seconds=300),
    )
    try:
        out = dryrun_rank(world, dev)
        if rank == 0:
            with open(os.path.join(tmp, "result.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None,
                     timeout: float = 900.0) -> dict:
    """Run :func:`dryrun_rank` on ``n_devices`` ranks of
    ``torch.distributed``, each a process started with ``spawn``, joined
    on a ``FileStore`` in a temporary directory: on ``device`` (None:
    the card, raising without one), gloo ranks sharing it, or NCCL ranks
    one per card where there are as many cards as ranks; with
    ``device="cpu"``, gloo CPU ranks. A rank that raises makes this call
    raise with that rank's traceback; ranks still running after
    ``timeout`` seconds are killed and ``RuntimeError`` raised. Returns
    rank 0's numbers."""
    import torch.multiprocessing as mp

    if n_devices < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")
    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _dryrun_process, args=(n_devices, str(device), tmp),
            nprocs=n_devices, join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise RuntimeError(
                    f"dryrun_multichip: ranks still running after "
                    f"{timeout} s"
                )
        with open(os.path.join(tmp, "result.json")) as f:
            return json.load(f)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="One closed-loop step of the paper's controller, or "
        "the multi-device dry run (PyTorch port)"
    )
    parser.add_argument("mode", nargs="?", default="step",
                        choices=["step", "dryrun"])
    parser.add_argument("n_devices", nargs="?", type=int, default=8,
                        help="Ranks of the dry run.")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device (default: the CUDA card).")
    args = parser.parse_args(argv)
    if args.mode == "dryrun":
        out = dryrun_multichip(args.n_devices, device=args.device)
        n_data, n_model = out["mesh"]
        print(f"dryrun_multichip OK: mesh={{'data': {n_data}, 'model': "
              f"{n_model}}}, B={out['B']}, mean_final_cost="
              f"{out['mean_final_cost']:.5f}, sharded-KKT solve res="
              f"{out['res']:.1e} in {out['iters']} iters")
        return
    fn, example_args = entry(device=args.device)
    out = fn(*example_args)
    if out[0].device.type == "cuda":
        torch.cuda.synchronize(out[0].device)
    print("entry OK:", [tuple(o.shape) for o in out])


if __name__ == "__main__":
    main()
