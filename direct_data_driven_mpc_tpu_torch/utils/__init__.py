"""Config loading and parameter derivation, checkpoints, profiling, and
controller export for the C runtime."""

from direct_data_driven_mpc_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from direct_data_driven_mpc_tpu_torch.utils.config import (
    get_data_driven_mpc_controller_params,
    load_yaml_config_params,
)
from direct_data_driven_mpc_tpu_torch.utils.export import export_controller
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
    "export_controller",
    "Timer",
    "rollout_metrics",
    "trace",
]
