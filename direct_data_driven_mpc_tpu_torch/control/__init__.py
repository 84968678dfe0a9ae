"""Closed-loop control: the controller, its factory and host loop, the
generic and condensed engines, segmented runs and differentiable
tuning.

The names below are imported from their modules on first access:
``parallel.batch`` imports ``control.loop``, and the condensed engine
and the segmented runs import ``parallel.batch``, so importing them
here eagerly would close an import cycle for a caller that imports
``parallel.batch`` first.
"""

import importlib

_EXPORTS = {
    "DirectDataDrivenMPCController": "controller",
    "create_data_driven_mpc_controller": "creation",
    "AffineBlockMap": "linear_engine",
    "build_affine_block_map": "linear_engine",
    "build_linear_engine": "linear_engine",
    "build_tracking_engine": "linear_engine",
    "closed_loop_spectrum": "linear_engine",
    "linear_closed_loop_rollout": "linear_engine",
    "make_linear_batched_rollout": "linear_engine",
    "time_parallel_rollout": "linear_engine",
    "ClosedLoopResult": "loop",
    "build_closed_loop": "loop",
    "closed_loop_rollout": "loop",
    "generate_initial_input_output_data": "operation",
    "randomize_initial_system_state": "operation",
    "simulate_data_driven_mpc_control_loop": "operation",
    "simulate_n_input_output_measurements": "operation",
    "SegmentState": "segmented",
    "resume_from_checkpoint": "segmented",
    "run_segmented": "segmented",
    "differentiable_solution_map": "tuning",
    "make_closed_loop_objective": "tuning",
    "tune_regularization": "tuning",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
