"""PyTorch / CUDA port of the direct data-driven MPC package.

Runs the condensed closed loop of ``direct_data_driven_mpc_tpu`` (the
JAX reference, which stays beside it) on an NVIDIA H100: the float64
host build (``control.controller``, ``qp``), the block-map condensation
(``control.linear_engine``) and the fused rollout, whose kernel is
written by hand in CUDA C++ (``ops.fused_rollout``,
``ops/csrc/fused_rollout.cu``). This package imports ``torch`` and
numpy and never ``jax``. Importing it builds and loads no kernel; the
kernel is compiled with ``nvcc`` at its first launch.
"""

from direct_data_driven_mpc_tpu_torch.qp.spec import (
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

__version__ = "0.1.0"

__all__ = ["DataDrivenMPCType", "SlackVarConstraintTypes"]
