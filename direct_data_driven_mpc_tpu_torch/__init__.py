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
``utils.checkpoint``) and profiling (``utils.profiling``). This package
imports ``torch`` and numpy and never ``jax``; its entry points run on
the card unless given ``device="cpu"``. Importing it builds and loads no
kernel; each kernel library is compiled with ``nvcc`` at its first
launch.
"""

from direct_data_driven_mpc_tpu_torch.qp.spec import (
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

__version__ = "0.1.0"

__all__ = ["DataDrivenMPCType", "SlackVarConstraintTypes"]
