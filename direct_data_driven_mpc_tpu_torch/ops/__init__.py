"""Host operations, plant matrices, the device Hankel, estimation and
plant-step ops, and the fused engines with their CUDA kernels (imported
from their modules: importing this package builds and loads no
kernel)."""

from direct_data_driven_mpc_tpu_torch.ops.estimation import (
    calculate_equilibrium_input_from_output,
    calculate_equilibrium_output_from_input,
    estimate_initial_state,
    observability_matrix,
    toeplitz_input_output_matrix,
)
from direct_data_driven_mpc_tpu_torch.ops.hankel import (
    evaluate_persistent_excitation,
    hankel_matrix,
)
from direct_data_driven_mpc_tpu_torch.ops.lti import lti_rollout, lti_step

__all__ = [
    "hankel_matrix",
    "evaluate_persistent_excitation",
    "lti_step",
    "lti_rollout",
    "observability_matrix",
    "toeplitz_input_output_matrix",
    "estimate_initial_state",
    "calculate_equilibrium_output_from_input",
    "calculate_equilibrium_input_from_output",
]
