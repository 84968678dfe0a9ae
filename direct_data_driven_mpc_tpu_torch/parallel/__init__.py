"""Scenario batches: the batch layer on one device, and the multi-device
path on ``torch.distributed`` (the ``(data, model)`` mesh, its
collectives and the multi-process entry points).

The names below are imported from their modules on first access:
``control.linear_engine`` imports ``parallel.batch``, and
``parallel.mesh`` imports ``control.linear_engine``, so importing them
here eagerly would close an import cycle.
"""

import importlib

_EXPORTS = {
    "batched_closed_loop": "batch",
    "draw_block_noise": "batch",
    "draw_noise_batch": "batch",
    "heterogeneous_closed_loop": "batch",
    "make_batched_rollout": "batch",
    "stack_plants": "batch",
    "stack_solution_maps": "batch",
    "all_gather_cat": "collectives",
    "all_reduce_sum": "collectives",
    "make_mesh_rollout": "mesh",
    "make_scenario_mesh": "mesh",
    "make_sharded_fused_admm_rollout": "mesh",
    "make_sharded_fused_rollout": "mesh",
    "make_sharded_linear_rollout": "mesh",
    "scenario_slice": "mesh",
    "shard_metrics": "mesh",
    "global_scenario_indices": "multihost",
    "initialize_distributed": "multihost",
    "make_global_mesh": "multihost",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
