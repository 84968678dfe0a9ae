"""Reproduction of the paper's Section V four-tank example (Fig. 2).

Capability parity with ``utilities/reproduction/paper_reproduction.py``:
the three Robust scheme variants (TEC / TEC n-step / UCON), equilibrium
state forcing for ``y_0 = [0.4, 0.4]``, per-scheme closed-loop
simulation from a shared initial plant state, and the overlaid
multi-scheme figure.

Counterpart of ``direct_data_driven_mpc_tpu/reproduction/paper.py``,
built on the port's controller (its per-step solve the C extension of
``native/`` by default), host loop and plant model. The figure's
modules (``viz``, matplotlib) are imported by
:func:`plot_input_output_reproduction` alone, so the simulations run
where matplotlib is absent.
"""

from __future__ import annotations

import enum
from typing import List, Optional, Tuple

import numpy as np
from numpy.random import Generator

from direct_data_driven_mpc_tpu_torch.control.controller import (
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_tpu_torch.control.creation import (
    create_data_driven_mpc_controller,
)
from direct_data_driven_mpc_tpu_torch.control.operation import (
    simulate_data_driven_mpc_control_loop,
)
from direct_data_driven_mpc_tpu_torch.models.lti_model import LTIModel
from direct_data_driven_mpc_tpu_torch.utils.config import (
    DataDrivenMPCParamsDictType,
)


class DataDrivenMPCScheme(enum.Enum):
    """Robust scheme variants from the paper example (reference enum:
    paper_reproduction.py:23-41)."""

    TEC = 0  # 1-step with terminal equality constraints
    TEC_N_STEP = 1  # n-step with terminal equality constraints
    UCON = 2  # 1-step without terminal equality constraints


DD_MPC_SCHEME_CONFIG = {
    DataDrivenMPCScheme.TEC: {
        "label": "TEC",
        "n_mpc_step": 1,
        "terminal_constraint": True,
    },
    DataDrivenMPCScheme.TEC_N_STEP: {
        "label": "TEC, n-step",
        "n_mpc_step": -1,  # placeholder meaning "n steps"
        "terminal_constraint": True,
    },
    DataDrivenMPCScheme.UCON: {
        "label": "UCON",
        "n_mpc_step": 1,
        "terminal_constraint": False,
    },
}

DD_MPC_SCHEME_LINE_PARAMS = {
    DataDrivenMPCScheme.TEC: {
        "color": "blue",
        "linestyle": "solid",
        "linewidth": 2,
    },
    DataDrivenMPCScheme.TEC_N_STEP: {
        "color": "lime",
        "linestyle": (0, (5, 5)),
        "linewidth": 2,
    },
    DataDrivenMPCScheme.UCON: {
        "color": "black",
        "linestyle": ":",
        "linewidth": 2,
    },
}


def get_equilibrium_state_from_output(
    system_model: LTIModel, y_eq: np.ndarray
) -> np.ndarray:
    """Plant state consistent with holding output ``y_eq`` at
    equilibrium: compute ``u_eq`` via the DC gain, tile the pair over n
    steps, LS-estimate the state (reference: paper_reproduction.py:
    80-116)."""
    n = system_model.get_system_order()
    u_eq = system_model.get_equilibrium_input_from_output(y_eq=y_eq)
    U_eq = np.tile(u_eq, n)
    Y_eq = np.tile(np.asarray(y_eq), n)
    return system_model.get_initial_state_from_trajectory(
        U=U_eq.flatten(), Y=Y_eq.flatten()
    )


def create_data_driven_mpc_controllers_reproduction(
    controller_config: DataDrivenMPCParamsDictType,
    u_d: np.ndarray,
    y_d: np.ndarray,
    data_driven_mpc_controller_schemes: List[DataDrivenMPCScheme],
) -> List[DirectDataDrivenMPCController]:
    """One controller per scheme from a shared base config (reference:
    paper_reproduction.py:118-201)."""
    controllers = []
    for scheme in data_driven_mpc_controller_schemes:
        if scheme not in DD_MPC_SCHEME_CONFIG:
            raise ValueError(
                f"Configuration for scheme {scheme} not found."
            )
        cfg = dict(controller_config)
        scheme_cfg = DD_MPC_SCHEME_CONFIG[scheme]
        cfg["n_mpc_step"] = (
            1 if scheme_cfg["n_mpc_step"] == 1 else cfg["n"]
        )
        controllers.append(
            create_data_driven_mpc_controller(
                controller_config=cfg,
                u_d=u_d,
                y_d=y_d,
                use_terminal_constraint=scheme_cfg["terminal_constraint"],
            )
        )
    return controllers


def simulate_data_driven_mpc_control_loops_reproduction(
    system_model: LTIModel,
    data_driven_mpc_controllers: List[DirectDataDrivenMPCController],
    n_steps: int,
    np_random: Generator,
    verbose: int,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Simulate each controller from the same saved plant state
    (reference: paper_reproduction.py:203-270; the shared RNG draws
    different noise per scheme, matching the reference's sequential
    draws)."""
    model_initial_state = system_model.get_state()
    u_sys_data, y_sys_data = [], []
    n_controllers = len(data_driven_mpc_controllers)
    for i, controller in enumerate(data_driven_mpc_controllers):
        if verbose:
            print(f"Simulating controller {i + 1}/{n_controllers}")
        system_model.set_state(state=model_initial_state)
        u_sys, y_sys = simulate_data_driven_mpc_control_loop(
            system_model=system_model,
            data_driven_mpc_controller=controller,
            n_steps=n_steps,
            np_random=np_random,
            verbose=verbose,
        )
        u_sys_data.append(u_sys)
        y_sys_data.append(y_sys)
    return u_sys_data, y_sys_data


def plot_input_output_reproduction(
    data_driven_mpc_controller_schemes: List[DataDrivenMPCScheme],
    u_data: List[np.ndarray],
    y_data: List[np.ndarray],
    u_s: np.ndarray,
    y_s: np.ndarray,
    u_ylimits: Optional[List[Tuple[float, float]]] = None,
    y_ylimits: Optional[List[Tuple[float, float]]] = None,
    figsize: Tuple[int, int] = (14, 8),
    dpi: int = 300,
    fontsize: int = 12,
    title: Optional[str] = None,
    show: bool = True,
):
    """Overlay all schemes in one figure with per-scheme line styles
    (reference: paper_reproduction.py:272-351)."""
    import matplotlib.pyplot as plt

    from direct_data_driven_mpc_tpu_torch.viz.plots import (
        create_input_output_figure,
        plot_input_output,
    )
    from direct_data_driven_mpc_tpu_torch.viz.styles import (
        LEGEND_PARAMS,
        SETPOINT_LINE_PARAMS,
    )

    m = u_data[0].shape[1]
    p = y_data[0].shape[1]
    fig, axs_u, axs_y = create_input_output_figure(
        m=m, p=p, figsize=figsize, dpi=dpi, fontsize=fontsize, title=title
    )
    for i, scheme in enumerate(data_driven_mpc_controller_schemes):
        scheme_cfg = DD_MPC_SCHEME_CONFIG[scheme]
        line_params = DD_MPC_SCHEME_LINE_PARAMS[scheme]
        plot_input_output(
            u_k=u_data[i],
            y_k=y_data[i],
            u_s=u_s,
            y_s=y_s,
            inputs_line_params=line_params,
            outputs_line_params=line_params,
            setpoints_line_params=SETPOINT_LINE_PARAMS,
            data_label=f" ({scheme_cfg['label']})",
            u_ylimits=u_ylimits,
            y_ylimits=y_ylimits,
            axs_u=axs_u,
            axs_y=axs_y,
            dpi=dpi,
            fontsize=fontsize,
            legend_params=LEGEND_PARAMS,
        )
    if show:
        plt.show()
    return fig
