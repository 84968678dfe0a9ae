"""What the gloo ranks of the port's multi-device tests run (see
tests/_torch_dist.py): torch, numpy and the port, no JAX. Each body
takes ``(rank, world, case)`` and returns a dict of numpy arrays, named
``"<case>/<field>"``."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from direct_data_driven_mpc_tpu_torch.ops.fused_admm import (
    fused_admm_reference,
)
from direct_data_driven_mpc_tpu_torch.ops.fused_rollout import (
    fused_rollout_reference,
)
from direct_data_driven_mpc_tpu_torch.parallel import collectives
from direct_data_driven_mpc_tpu_torch.parallel import mesh as pm
from direct_data_driven_mpc_tpu_torch.parallel import multihost as mh
from direct_data_driven_mpc_tpu_torch.parallel.batch import draw_noise_batch
from direct_data_driven_mpc_tpu_torch.qp import distributed as qd

RESULT_FIELDS = ("u_sys", "y_sys", "costs", "converged", "x_final",
                 "u_past", "y_past")


def _np(t):
    return t.detach().cpu().numpy()


def _result(out, name, res, metrics=None):
    for field in RESULT_FIELDS:
        out[f"{name}/{field}"] = _np(getattr(res, field))
    if res.solver_state is not None:
        for field, leaf in zip(res.solver_state._fields, res.solver_state):
            out[f"{name}/state/{field}"] = _np(leaf)
    for key, value in (metrics or {}).items():
        out[f"{name}/{key}"] = _np(value)


def _raises(fn, exc) -> np.ndarray:
    try:
        fn()
    except exc:
        return np.array(True)
    return np.array(False)


class _Meshes(dict):
    """One mesh per shape, built in the same order on every rank."""

    def __missing__(self, shape):
        self[shape] = pm.make_scenario_mesh(*shape, device="cpu")
        return self[shape]


def mesh_cases(rank, world, case):
    """The sharded engines of ``parallel.mesh``, each on its mesh; every
    rank gets the global inputs and runs its shard (``scenario_slice``).
    ``case``: name -> dict(kind, mesh, T, inputs, and the engine's
    own)."""
    out = {}
    meshes = _Meshes()
    for name, c in case.items():
        mesh = meshes[c["mesh"]]
        sl = pm.scenario_slice(c["inputs"][0].shape[0], mesh)
        x0s, ups, yps, Ws = (a[sl] for a in c["inputs"])
        kind, T = c["kind"], c["T"]
        metrics = None
        if kind == "generic":
            run = pm.make_mesh_rollout(
                mesh, c["plant"], c["solver"], T,
                admm_iters=c.get("admm_iters", 100),
                model_parallel=c.get("model_parallel", False),
            )
            res, metrics = run(x0s, ups, yps, Ws)
            out[f"{name}/model_parallel_refused"] = _raises(
                lambda: pm.make_mesh_rollout(mesh, c["plant"], c["solver"],
                                             T, model_parallel=True),
                ValueError,
            )
        elif kind == "fused":
            run = pm.make_sharded_fused_rollout(
                mesh, c["block_map"], T, rollout=fused_rollout_reference
            )
            sched = c.get("setpoints")
            if sched is None:
                res, metrics = run(x0s, ups, yps, Ws)
            else:
                res, metrics = run(x0s, ups, yps, Ws, sched[sl])
                out[f"{name}/shared_schedule_refused"] = _raises(
                    lambda: run(x0s, ups, yps, Ws, sched[0]), ValueError
                )
        elif kind == "fused_admm":
            run = pm.make_sharded_fused_admm_rollout(
                mesh, c["plant"], c["op"], 4, 2, 2, T, device="cpu",
                rollout=fused_admm_reference, **c["kw"],
            )
            res, metrics = run(x0s, ups, yps, Ws)
        else:  # "linear_rng": the classic engine's in-scan noise
            run = pm.make_sharded_linear_rollout(
                mesh, c["block_map"], T, use_rng_noise=True,
                eps_max=c["eps_max"],
                emit_trajectories=c.get("emit_trajectories", True),
            )
            res = run(x0s, ups, yps, torch.Generator().manual_seed(c["seed"]))
        _result(out, name, res, metrics)
    return out


def multihost_cases(rank, world, case):
    """The multi-process entry points on a world this body joins itself:
    first rank 0 alone as a world of one (``make_scenario_mesh`` with no
    group), then every rank through ``initialize_distributed`` with
    explicit arguments."""
    out = {}
    if rank == 0:
        one = pm.make_scenario_mesh(device="cpu")
        out["one/shape"] = np.array(one.shape)
        out["one/indices"] = mh.global_scenario_indices(6)
        dist.destroy_process_group()
    mh.initialize_distributed(case["address"], num_processes=world,
                              process_id=rank, device="cpu")
    out["world"] = np.array(dist.get_world_size())
    B = case["B"]
    idx = mh.global_scenario_indices(B)
    out["indices"] = idx
    out["noise"] = _np(draw_noise_batch(case["seed"], len(idx), case["T"],
                                        2, 0.002, "cpu",
                                        first_index=int(idx[0])))
    out["indivisible_refused"] = _raises(
        lambda: mh.global_scenario_indices(B + 1), ValueError
    )
    for name, n_model in (("data", 1), ("model", world)):
        mesh = mh.make_global_mesh(n_model=n_model, device="cpu")
        sl = pm.scenario_slice(B, mesh)
        out[f"{name}/shape"] = np.array(mesh.shape)
        out[f"{name}/slice"] = np.array([sl.start, sl.stop])
        x = torch.tensor([rank + 1.0, 10.0 * (rank + 1)])
        out[f"{name}/gather"] = _np(collectives.all_gather_cat(
            x[None], mesh.get_group("model")))
        out[f"{name}/x"] = _np(x).copy()  # the sum below is in place
        out[f"{name}/sum"] = _np(collectives.all_reduce_sum(
            x, mesh.get_group("data")))
    out["exceeds_world_refused"] = _raises(
        lambda: pm.make_scenario_mesh(world + 1, 1, device="cpu"),
        ValueError,
    )
    return out


def minres_cases(rank, world, case):
    """The alpha-sharded PMINRES: the operand's leaves (``case['leaves']``:
    spec, mesh shape), single solves (``case['solves']``: name -> (spec,
    theta, mesh shape, keywords)), the closed loop (``case['loop']``) and
    the CONVEX refusal (``case['convex']``)."""
    out = {}
    meshes = _Meshes()
    spec, shape = case["leaves"]
    operand, meta = qd.build_sharded_kkt(spec, meshes[shape],
                                         dtype=torch.float64, device="cpu")
    for field, leaf in zip(operand._fields, operand):
        out[f"leaves/{field}"] = _np(leaf)
    out["leaves/n_alpha_pad"] = np.array(meta["n_alpha_pad"])
    for name, (spec, theta, shape, kw) in case["solves"].items():
        solve = qd.make_distributed_kkt_solver(spec, meshes[shape],
                                               device="cpu", **kw)
        u, res, iters = solve(theta)
        out[f"{name}/u"] = _np(u)
        out[f"{name}/res"] = _np(res)
        out[f"{name}/iters"] = _np(iters)
    c = case["loop"]
    mesh = meshes[c["mesh"]]
    sl = pm.scenario_slice(c["inputs"][0].shape[0], mesh)
    run = qd.make_distributed_closed_loop(mesh, c["plant"], c["spec"],
                                          c["T"], device="cpu", **c["kw"])
    _result(out, "loop", run(*(a[sl] for a in c["inputs"])))
    out["convex_refused"] = _raises(
        lambda: qd.make_distributed_kkt_solver(case["convex"], mesh,
                                               device="cpu"), ValueError,
    )
    return out


def chip_smoke_phases(rank, world, case):
    """``chip_smoke.py``'s phases 40-42 on the CPU at a tiny size, in a
    process of their own (they open a world of one and spawn two ranks);
    returns the JAX modules this process imported (none)."""
    import sys

    import chip_smoke as cs
    from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
        build_linear_engine,
    )

    dev = torch.device("cpu")
    plant, ctrl = cs.build_four_tank_robust()
    B, T = case["B"], case["T"]
    ins = (*cs.scenario_batch(plant, ctrl, B, dev),
           draw_noise_batch(0, B, T, 2, plant.get_eps_max(), dev))
    main = dict(plant=plant, ctrl=ctrl, inputs=ins, **{
        f"bm{K}": build_linear_engine(ctrl, plant.as_params(),
                                      solves_per_block=K, device=dev)
        for K in (50, 100)})
    cs.B_MAIN = B
    mesh = cs.sharded_phase(dev, "cpu", main, B=2 * B, B_admm=B, T=T)
    outs = cs.two_rank_phase(dev, "cpu", main, mesh, B=B, T=T, T_iter=2,
                             T_loop=1, B_loop=2)
    cs.pminres_phase(dev, "cpu", main, mesh, outs, T_loop=2, B=2)
    jax = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib",
                                        "direct_data_driven_mpc_tpu"))
    return {"jax_modules": np.array(jax, dtype=str)}


def _numbers(out: dict) -> dict:
    return {key: np.asarray(value) for key, value in out.items()}


def dryrun_rank_case(rank, world, case):
    """``entry.dryrun_rank`` on this rank of the harness's gloo group."""
    from direct_data_driven_mpc_tpu_torch.entry import dryrun_rank

    return _numbers(dryrun_rank(world, device="cpu"))


def dryrun_multichip_case(rank, world, case):
    """``entry.dryrun_multichip(case)`` from a process of its own, which
    spawns ``case`` gloo CPU ranks."""
    from direct_data_driven_mpc_tpu_torch.entry import dryrun_multichip

    return _numbers(dryrun_multichip(case, device="cpu", timeout=150.0))


def chip_smoke_edges(rank, world, case):
    """``chip_smoke.py``'s phases 43-45 on the CPU at a tiny size, in a
    process of their own (phase 45 spawns the dry run's ranks); returns
    the JAX modules this process imported (none)."""
    import sys

    import chip_smoke as cs

    dev = torch.device("cpu")
    cs.example_phase(dev, "cpu", T=20, mc=(8, 20), track=(4, 40, 10),
                     tune=(2, 10, 2))
    cs.reproduction_phase(dev, "cpu", t_sim=30)
    cs.entry_phase(dev, "cpu", n_dryrun=2)
    jax = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib",
                                        "direct_data_driven_mpc_tpu"))
    return {"jax_modules": np.array(jax, dtype=str)}
