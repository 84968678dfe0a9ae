"""Scenario batches over a ``(data, model)`` mesh of ``torch.distributed``
ranks, one process per device.

Counterpart of ``direct_data_driven_mpc_tpu/parallel/mesh.py``. A
``DeviceMesh`` with the dims ``("data", "model")`` stands in for the JAX
``Mesh``, and a rank runs its own shard where JAX's ``shard_map`` runs a
device's: every function here takes and returns **this rank's shard**,
rows :func:`scenario_slice` of the global batch, chosen by the rank's
``data`` coordinate and replicated over ``model``. The scenario axis is
embarrassingly parallel, so the hot loop has no collective; the
aggregate metrics ``mean_final_cost`` and ``frac_converged`` come back
on every rank, from one ``all_reduce`` of the four partial sums (count,
final-cost sum, converged count, solve count) over ``data``, in float64.
With ``model_parallel=True`` the rows of a ``SolutionMap``'s gain are
split over ``model`` and each solve gathers them (``all_gather``).

Each engine is the port's own on the shard: the generic loop
(:func:`make_mesh_rollout`), K1 (:func:`make_sharded_fused_rollout`),
the classic condensed engine (:func:`make_sharded_linear_rollout`) and
K4 (:func:`make_sharded_fused_admm_rollout`). The generic loop carries
every solver's state batch-leading, so the ADMM, box (its rung per
scenario) and NON_CONVEX solvers shard with no code of their own. JAX's
mesh has no slot for the NON_CONVEX state, so a sharded NON_CONVEX run
is held against the port's unsharded run, not against JAX; the JAX
package has no sharded K5 and no sharded NON_CONVEX fused engine, and
neither has the port. JAX's ``backend="pallas" | "xla"`` is the port's
``rollout=`` (the kernel or its plain version); ``batch_block``,
``interpret`` and the pack factor ``q`` are TPU knobs with no meaning
here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
    linear_batched_rollout,
)
from direct_data_driven_mpc_tpu_torch.control.loop import ClosedLoopResult
from direct_data_driven_mpc_tpu_torch.device import resolve_device
from direct_data_driven_mpc_tpu_torch.ops.fused_admm import (
    fused_admm,
    make_fused_admm_rollout,
)
from direct_data_driven_mpc_tpu_torch.ops.fused_rollout import (
    fused_rollout,
    make_fused_batched_rollout,
)
from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams
from direct_data_driven_mpc_tpu_torch.parallel.batch import (
    batched_closed_loop,
)
from direct_data_driven_mpc_tpu_torch.parallel.collectives import (
    all_gather_cat,
    all_reduce_sum,
)
from direct_data_driven_mpc_tpu_torch.qp.solution_map import (
    SolutionMap,
    optimal_cost,
    solve_u,
)

AXES = ("data", "model")


def backend_for(device: torch.device) -> str:
    """The process group's backend for a device: NCCL on the card, gloo
    on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def make_scenario_mesh(
    n_data: Optional[int] = None, n_model: int = 1, device=None
) -> DeviceMesh:
    """A ``(data, model)`` mesh over the first ``n_data * n_model`` ranks
    (``n_data`` defaults to the world size over ``n_model``).

    ``device`` (None: the card, raising without one) picks the backend
    when no process group exists yet: then this process is a world of
    one, on a ``HashStore``, so the mesh works with no launcher. Raises
    ``ValueError`` when the mesh needs more ranks than the world has."""
    device = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device), store=dist.HashStore(),
                                rank=0, world_size=1)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > world:
        raise ValueError(f"Mesh {n_data}x{n_model} exceeds {world} ranks.")
    # The mesh's device type follows the backend: gloo runs its
    # collectives in host memory whatever the tensors' device.
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n_data * n_model).reshape(n_data, n_model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def mesh_layout(mesh: DeviceMesh):
    """``(sizes, coordinate)``: the size of each mesh dim and this rank's
    coordinate on it, by name. Raises ``ValueError`` on a rank outside the
    mesh."""
    coordinate = mesh.get_coordinate()
    if coordinate is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    names = mesh.mesh_dim_names
    return dict(zip(names, mesh.shape)), dict(zip(names, coordinate))


def scenario_slice(global_batch: int, mesh: DeviceMesh) -> slice:
    """The rows of a global batch that this rank's ``data`` coordinate
    holds; raises ``ValueError`` if the batch does not divide."""
    sizes, coord = mesh_layout(mesh)
    if global_batch % sizes["data"]:
        raise ValueError(
            f"global batch {global_batch} must divide over "
            f"{sizes['data']} data ranks."
        )
    local = global_batch // sizes["data"]
    return slice(coord["data"] * local, (coord["data"] + 1) * local)


def shard_metrics(result: ClosedLoopResult, mesh: DeviceMesh) -> dict:
    """``mean_final_cost`` and ``frac_converged`` of the global batch
    from this rank's shard, the same on every rank: one ``all_reduce``
    over ``data`` of the count, final-cost sum, converged count and
    solve count, in float64."""
    costs, conv = result.costs, result.converged
    # The counts are filled on the device: a host-to-device copy of a
    # Python number would wait for the rollout before returning.
    part = torch.stack([
        costs.new_full((), costs.shape[0], dtype=torch.float64),
        costs[:, -1].double().sum(),
        conv.sum(dtype=torch.float64),
        costs.new_full((), conv.numel(), dtype=torch.float64),
    ])
    n_b, cost, n_conv, n_solves = all_reduce_sum(
        part, mesh.get_group("data")
    ).unbind()
    return {"mean_final_cost": cost / n_b, "frac_converged": n_conv / n_solves}


def _row_shard_solution_map(sol_map: SolutionMap, n_model: int
                            ) -> SolutionMap:
    """Pad the u-gain rows to a multiple of ``n_model`` so they split
    evenly over the model axis (padding rows produce zeros that are
    dropped after the gather)."""
    rows = sol_map.u_base.shape[0]
    pad = (-rows) % n_model
    if pad == 0:
        return sol_map
    return sol_map._replace(
        u_base=torch.nn.functional.pad(sol_map.u_base, (0, pad)),
        U_gain=torch.nn.functional.pad(sol_map.U_gain, (0, 0, 0, pad)),
    )


def make_mesh_rollout(
    mesh: DeviceMesh,
    plant: LTIParams,
    solver,
    n_steps: int,
    n_mpc_step: int = 1,
    admm_iters: int = 100,
    model_parallel: bool = False,
):
    """The generic loop (``parallel.batch.batched_closed_loop``) on this
    rank's shard.

    Returns ``run(x0s, u_pasts, y_pasts, Ws) -> (ClosedLoopResult,
    metrics)``: the shard's result (an iterative solver's state rides
    with its scenarios) and the global metrics of :func:`shard_metrics`.
    ``solver`` is any solver of ``control.loop.make_solve_fn``.

    With ``model_parallel=True`` (a ``SolutionMap`` only) the gain's rows,
    padded to a multiple of the ``model`` size, are split over ``model``:
    each rank computes its rows of ``u`` and an ``all_gather`` over
    ``model`` reassembles them, the padding dropped; the plant steps
    replicated over ``model``."""
    sizes, coord = mesh_layout(mesh)
    n_model = sizes["model"]
    m = plant.B.shape[1]
    if model_parallel and not isinstance(solver, SolutionMap):
        raise ValueError(
            "model_parallel gain sharding requires a SolutionMap solver."
        )
    local_solver = solver
    if model_parallel and n_model > 1:
        u_rows = solver.u_base.shape[0]  # BEFORE padding: the gather
        # must drop the zero padding rows, not keep them
        padded = _row_shard_solution_map(solver, n_model)
        rows = padded.u_base.shape[0] // n_model
        mine = slice(coord["model"] * rows, (coord["model"] + 1) * rows)
        part_map = padded._replace(u_base=padded.u_base[mine],
                                   U_gain=padded.U_gain[mine])
        group = mesh.get_group("model")

        def solve(theta, state):
            u = all_gather_cat(solve_u(part_map, theta), group)[:, :u_rows]
            u_seq = u.reshape(theta.shape[0], -1, m)
            cost = optimal_cost(solver, theta)
            ok = torch.isfinite(u_seq).all(-1).all(-1) & torch.isfinite(cost)
            return u_seq, cost, state, ok

        local_solver = (solve, None)

    def run(x0s, u_pasts, y_pasts, Ws):
        result = batched_closed_loop(
            plant, local_solver, x0s, u_pasts, y_pasts, Ws,
            n_steps=n_steps, n_mpc_step=n_mpc_step, admm_iters=admm_iters,
        )
        return result, shard_metrics(result, mesh)

    return run


def make_sharded_fused_rollout(
    mesh: DeviceMesh,
    block_map,
    n_steps: int,
    n_mpc_step: int = 1,
    cost_precision: str = "high",
    rollout=fused_rollout,
):
    """The fused condensed rollout on this rank's shard: K1
    (``rollout=fused_rollout``, on CUDA tensors) or its plain version
    (``ops.fused_rollout.fused_rollout_reference``), with the metrics of
    :func:`shard_metrics`; no collective in the rollout itself.

    Returns ``run(x0s, u_pasts, y_pasts, Ws) -> (ClosedLoopResult,
    metrics)``. A tracking map (``block_map.n_r > 0``) is called as
    ``run(x0s, u_pasts, y_pasts, Ws, setpoints)`` with a per-scenario
    schedule ``(B_local, n_outer, n_r)``, sharded like the other scenario
    arrays (broadcast a shared schedule to the batch yourself); any other
    rank of array raises ``ValueError``."""
    mesh_layout(mesh)  # raises on a rank outside the mesh
    local_rollout = make_fused_batched_rollout(
        block_map, n_steps, n_mpc_step=n_mpc_step,
        cost_precision=cost_precision, rollout=rollout,
    )

    if block_map.n_r:
        def run(x0s, u_pasts, y_pasts, Ws, setpoints):
            if np.ndim(setpoints) != 3:
                raise ValueError(
                    "sharded tracking rollouts need a per-scenario "
                    "(B, n_outer, n_r) schedule; got shape "
                    f"{tuple(np.shape(setpoints))}"
                )
            result = local_rollout(x0s, u_pasts, y_pasts, Ws,
                                   setpoints=setpoints)
            return result, shard_metrics(result, mesh)

        return run

    def run(x0s, u_pasts, y_pasts, Ws):
        result = local_rollout(x0s, u_pasts, y_pasts, Ws)
        return result, shard_metrics(result, mesh)

    return run


def make_sharded_linear_rollout(
    mesh: DeviceMesh,
    block_map,
    n_steps: int,
    n_mpc_step: int = 1,
    use_rng_noise: bool = False,
    eps_max: float = 0.0,
    emit_trajectories: bool = True,
):
    """The classic condensed engine on this rank's shard, with no
    collective: ``run(x0s, u_pasts, y_pasts, noise) -> ClosedLoopResult``
    (``control.linear_engine.make_linear_batched_rollout``'s contract,
    ``emit_trajectories=False`` its aggregate mode).

    With ``use_rng_noise=True``, ``noise`` is a ``torch.Generator``
    seeded alike on every rank; each block draws the global batch's noise
    and keeps this shard's rows, so the shards of a sharded run draw what
    the unsharded run draws."""
    sizes, coord = mesh_layout(mesh)
    kw = dict(n_steps=n_steps, n_mpc_step=n_mpc_step,
              emit_trajectories=emit_trajectories)

    def run(x0s, u_pasts, y_pasts, noise):
        if use_rng_noise:
            B = x0s.shape[0]
            return linear_batched_rollout(
                block_map, x0s, u_pasts, y_pasts, None, generator=noise,
                eps_max=eps_max,
                noise_rows=(B * sizes["data"], B * coord["data"]), **kw,
            )
        return linear_batched_rollout(block_map, x0s, u_pasts, y_pasts,
                                      noise, **kw)

    return run


def make_sharded_fused_admm_rollout(
    mesh: DeviceMesh,
    plant: LTIParams,
    admm_op: dict,
    n: int,
    m: int,
    p: int,
    n_steps: int,
    n_mpc_step: int = 1,
    iters=(4, 5, 2),
    cold_iters: int = 24,
    tol: float = 1e-5,
    device=None,
    dtype=torch.float32,
    rollout=fused_admm,
):
    """The fused ADMM closed loop on this rank's shard: K4
    (``rollout=fused_admm``, on CUDA tensors) or its plain version
    (``ops.fused_admm.fused_admm_reference``), with the ADMM state
    ``(s, w)`` sharded with its scenarios and the metrics of
    :func:`shard_metrics`. Returns ``run(x0s, u_pasts, y_pasts, Ws) ->
    (ClosedLoopResult, metrics)``; the arguments are those of
    ``ops.fused_admm.make_fused_admm_rollout``."""
    mesh_layout(mesh)  # raises on a rank outside the mesh
    local_rollout = make_fused_admm_rollout(
        plant, admm_op, n, m, p, n_steps, n_mpc_step=n_mpc_step,
        iters=iters, cold_iters=cold_iters, tol=tol, device=device,
        dtype=dtype, rollout=rollout,
    )

    def run(x0s, u_pasts, y_pasts, Ws):
        result = local_rollout(x0s, u_pasts, y_pasts, Ws)
        return result, shard_metrics(result, mesh)

    return run
