"""PyTorch / CUDA port of the direct data-driven MPC package.

Runs the closed loops of ``direct_data_driven_mpc_tpu`` (the JAX
reference, which stays beside it) on an NVIDIA H100: the float64 host
build (``control.controller``, ``qp``), the block-map condensation
(``control.linear_engine``), the fused condensed rollout
(``ops.fused_rollout``) and the fused ADMM closed loops with a fixed
penalty or the adaptive ladder (``ops.fused_admm``,
``ops.fused_ladder``), whose kernels are written by hand in CUDA C++
(``ops/csrc/``); around them the YAML host layer (``utils.config``,
``models``, ``control.creation``, ``control.operation``), the batched
build of one operator per data realisation (``qp.batch_build``),
differentiable tuning of the ridge weights (``control.tuning``),
segmented runs with checkpoints (``control.segmented``,
``utils.checkpoint``) and profiling (``utils.profiling``); for one
controller and one plant, the per-step solve in the C extension of
``native/``, the export of a controller to the C deployment runtime
(``utils.export``), the time-parallel rollout of one scenario
(``control.linear_engine.time_parallel_rollout``) and the device
Hankel, estimation and plant-step ops (``ops``); over several processes
on ``torch.distributed``, one per device, the scenario mesh, its
sharded engines and the multi-process entry points (``parallel.mesh``,
``parallel.multihost``) and the alpha-sharded KKT solver
(``qp.distributed``); at the edges, the example CLIs
(``examples``), the paper reproduction (``reproduction``), the figures
(``viz``, the one module that imports matplotlib, imported by nothing
else until a figure is drawn) and the top-level entry points (``entry``).
This package imports ``torch`` and numpy and never ``jax``; its entry
points run on the card unless given ``device="cpu"``. Importing it builds and loads no
kernel; each kernel library is compiled with ``nvcc`` at its first
launch.
"""

import importlib

from direct_data_driven_mpc_tpu_torch.ops.hankel import (
    evaluate_persistent_excitation,
    hankel_matrix,
)
from direct_data_driven_mpc_tpu_torch.qp.spec import (
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

__version__ = "0.1.0"

# Imported on first access: importing the package stays light.
_LAZY = {
    "DirectDataDrivenMPCController": "control.controller",
    "initialize_distributed": "parallel.multihost",
    "make_global_mesh": "parallel.multihost",
    "make_scenario_mesh": "parallel.mesh",
    "make_distributed_kkt_solver": "qp.distributed",
}

__all__ = [
    "DataDrivenMPCType",
    "SlackVarConstraintTypes",
    "hankel_matrix",
    "evaluate_persistent_excitation",
    *_LAZY,
]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    module = importlib.import_module(f"{__name__}.{_LAZY[name]}")
    return getattr(module, name)
