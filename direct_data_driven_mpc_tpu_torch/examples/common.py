"""What the port's example CLIs share: the repository's YAML configs,
the ``--device`` flag, and the first steps of every pipeline (a random
initial state, the excitation data).

PyYAML is imported by the config loader alone (``utils.config``), and
matplotlib by each CLI's plotting step alone: a pipeline that is handed
its plant model and controller dict runs where neither is installed.
"""

from __future__ import annotations

import argparse
import os
from typing import Tuple

import numpy as np
import torch

from direct_data_driven_mpc_tpu_torch.control.operation import (
    generate_initial_input_output_data,
    randomize_initial_system_state,
)
from direct_data_driven_mpc_tpu_torch.models.lti_model import (
    LTIModel,
    LTISystemModel,
)
from direct_data_driven_mpc_tpu_torch.utils.config import (
    DataDrivenMPCParamsDictType,
    get_data_driven_mpc_controller_params,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG_DIR = os.path.join(REPO_ROOT, "examples", "config")
MODEL_CONFIG = os.path.join(CONFIG_DIR, "models",
                            "four_tank_system_params.yaml")
CONTROLLER_CONFIG = os.path.join(CONFIG_DIR, "controllers",
                                 "data_driven_mpc_example_params.yaml")
MODEL_KEY = "FourTankSystem"
CONTROLLER_KEY = "data_driven_mpc_params"


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", type=str, default=None,
        help="Torch device of the closed loop (default: the CUDA card, "
        "raising without one; 'cpu' runs the kernels' plain PyTorch "
        "versions).",
    )


def load_configs(
    model_config: str = MODEL_CONFIG,
    model_key: str = MODEL_KEY,
    controller_config: str = CONTROLLER_CONFIG,
    controller_key: str = CONTROLLER_KEY,
    verbose: int = 0,
) -> Tuple[LTISystemModel, DataDrivenMPCParamsDictType]:
    """The plant model and the controller parameter dict from the YAML
    files (needs PyYAML)."""
    system_model = LTISystemModel(config_file=model_config,
                                  model_key_value=model_key, verbose=verbose)
    config = get_data_driven_mpc_controller_params(
        config_file=controller_config, controller_key_value=controller_key,
        m=system_model.get_number_inputs(),
        p=system_model.get_number_outputs(), verbose=verbose,
    )
    return system_model, config


def initial_data(
    system_model: LTIModel,
    config: DataDrivenMPCParamsDictType,
    np_random: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Randomize the plant's initial state (set on the model), then run
    the excitation phase: ``(u_d, y_d)``."""
    x_0 = randomize_initial_system_state(system_model, config, np_random)
    system_model.set_state(x_0)
    return generate_initial_input_output_data(system_model, config,
                                              np_random)


def scenario_windows(system_model: LTIModel, controller, B: int, device,
                     dtype=torch.float32):
    """``(x0s (B, ns), u_pasts (B, n, m), y_pasts (B, n, p))``: every
    scenario starts from the plant's state and the controller's window,
    on ``device`` in ``dtype``."""
    n, m, p = controller.n, controller.m, controller.p

    def tile(a, shape):
        return torch.as_tensor(np.asarray(a).reshape(shape), dtype=dtype,
                               device=device).expand(B, *shape).contiguous()

    return (tile(system_model.get_state(), (system_model.n,)),
            tile(controller.u_past, (n, m)),
            tile(controller.y_past, (n, p)))
