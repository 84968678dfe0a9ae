"""Several processes, one per device, possibly on several hosts.

Counterpart of ``direct_data_driven_mpc_tpu/parallel/multihost.py`` on
``torch.distributed``. The scenario axis is embarrassingly parallel, so
scenarios stay local to their rank (each rank simulates its own shard
with no communication in the hot loop) and only the aggregate metrics
cross ranks (``parallel.mesh.shard_metrics``). Results do not depend on
the number of processes: scenario ``i``'s noise is a function of
``(seed, i)`` with ``i`` a global index (``parallel.batch.
draw_noise_batch`` with ``first_index``), so re-partitioning a batch
over another number of ranks reproduces every scenario's trajectory.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch.distributed as dist

from direct_data_driven_mpc_tpu_torch.device import resolve_device
from direct_data_driven_mpc_tpu_torch.parallel.mesh import (
    backend_for,
    make_scenario_mesh,
)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> None:
    """Join the process group of a multi-process launch.

    Explicit arguments win (a manual launch): ``num_processes > 1``
    initialises the group at ``coordinator_address`` (``host:port``, or a
    URL such as ``file:///shared/path``) as rank ``process_id``; one
    process is a no-op. With no ``num_processes``, a launch is detected
    from the environment (torchrun's ``TORCHELASTIC_RUN_ID``, or
    ``WORLD_SIZE > 1`` with ``MASTER_ADDR``), or named by
    ``coordinator_address``, and the group is initialised from the
    environment's ``WORLD_SIZE`` and ``RANK``; otherwise this is a no-op,
    so single-process runs and tests are unaffected. The backend follows
    ``device`` (None: the card, NCCL, raising without one; ``"cpu"``:
    gloo)."""
    if num_processes is not None:
        if num_processes > 1:
            dist.init_process_group(
                backend_for(resolve_device(device)),
                init_method=_init_method(coordinator_address),
                world_size=num_processes,
                rank=process_id,
            )
        return
    launched = bool(os.environ.get("TORCHELASTIC_RUN_ID")) or (
        int(os.environ.get("WORLD_SIZE", "1")) > 1
        and bool(os.environ.get("MASTER_ADDR"))
    )
    if coordinator_address is not None or launched:
        dist.init_process_group(
            backend_for(resolve_device(device)),
            init_method=_init_method(coordinator_address),
        )


def _init_method(address: Optional[str]) -> Optional[str]:
    if address is None or "://" in address:
        return address
    return f"tcp://{address}"


def _process_topology():
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_scenario_indices(global_batch: int) -> np.ndarray:
    """The global scenario indices of THIS process's shard of a global
    batch (host-count invariant), for ``draw_noise_batch(...,
    first_index=indices[0])``; raises ``ValueError`` when the batch does
    not divide over the processes."""
    n_proc, pid = _process_topology()
    if global_batch % n_proc:
        raise ValueError(
            f"global_batch={global_batch} must divide over "
            f"{n_proc} processes."
        )
    local = global_batch // n_proc
    return np.arange(pid * local, (pid + 1) * local)


def make_global_mesh(n_model: int = 1, device=None):
    """A ``(data, model)`` mesh spanning every rank of every process,
    ``n_data`` the world size over ``n_model``. One process with no group
    is a world of one (:func:`~direct_data_driven_mpc_tpu_torch.parallel.mesh.\
make_scenario_mesh`, which builds both)."""
    return make_scenario_mesh(n_model=n_model, device=device)
