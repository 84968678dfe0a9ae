"""Config loading and parameter derivation, checkpoints, and
profiling."""

from direct_data_driven_mpc_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from direct_data_driven_mpc_tpu_torch.utils.config import (
    get_data_driven_mpc_controller_params,
    load_yaml_config_params,
)
from direct_data_driven_mpc_tpu_torch.utils.profiling import (
    Timer,
    rollout_metrics,
    trace,
)

__all__ = [
    "load_checkpoint",
    "save_checkpoint",
    "get_data_driven_mpc_controller_params",
    "load_yaml_config_params",
    "Timer",
    "rollout_metrics",
    "trace",
]
