"""Robust data-driven MPC paper reproduction CLI (paper Fig. 2) on the
port.

Counterpart of ``examples/robust_data_driven_mpc_reproduction.py``: the
three Robust schemes (TEC, TEC n-step, UCON) on the four-tank system
with the initial output forced to ``y_0 = [0.4, 0.4]``, overlaid in one
figure matching the paper's Fig. 2 axis limits. The closed loops run on
the host, each step one solve of the controller's C extension, as the
JAX CLI's run on its host solve: no device is used, so the CLI has no
``--device``.

Note (as in the reference): the UCON closed loop is unstable by design;
the default seed matches the paper, other seeds may diverge.

Run: ``python -m direct_data_driven_mpc_tpu_torch.examples.\
robust_data_driven_mpc_reproduction [--no_plot]``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence, Tuple

import numpy as np

from direct_data_driven_mpc_tpu_torch.control.operation import (
    simulate_n_input_output_measurements,
)
from direct_data_driven_mpc_tpu_torch.examples import common
from direct_data_driven_mpc_tpu_torch.models.lti_model import LTIModel
from direct_data_driven_mpc_tpu_torch.reproduction.paper import (
    DataDrivenMPCScheme,
    create_data_driven_mpc_controllers_reproduction,
    get_equilibrium_state_from_output,
    plot_input_output_reproduction,
    simulate_data_driven_mpc_control_loops_reproduction,
)
from direct_data_driven_mpc_tpu_torch.utils.config import (
    DataDrivenMPCParamsDictType,
)

Y_0 = [0.4, 0.4]  # initial system output for reproduction
U_YLIMITS = [(-15.0, 15.0), (-15.0, 15.0)]
Y_YLIMITS = [(0.4, 1.0), (0.4, 1.0)]
SCHEMES = [
    DataDrivenMPCScheme.TEC,
    DataDrivenMPCScheme.TEC_N_STEP,
    DataDrivenMPCScheme.UCON,
]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Data-Driven MPC Controller Reproduction (PyTorch port)"
    )
    parser.add_argument(
        "--t_sim", type=int, default=600,
        help="Simulation length in time steps.",
    )
    parser.add_argument(
        "--seed", type=int, default=4,
        help="RNG seed (default 4 closely matches the paper figure).",
    )
    parser.add_argument(
        "--no_plot", action="store_true", default=False,
        help="Skip the figure (headless runs).",
    )
    parser.add_argument(
        "--save_fig", type=str, default=None,
        help="Save the reproduction figure to this path instead of "
        "showing it.",
    )
    parser.add_argument(
        "--verbose", type=int, default=2, choices=[0, 1, 2],
        help="0 = silent, 1 = minimal, 2 = detailed.",
    )
    return parser.parse_args(argv)


def simulate(
    system_model: LTIModel,
    dd_mpc_config: DataDrivenMPCParamsDictType,
    args: argparse.Namespace,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """The reproduction's pipeline from the loaded configs: ``(u_data,
    y_data)``, one ``(t_sim + 1, m)`` and ``(t_sim + 1, p)`` array per
    scheme of :data:`SCHEMES`, the warm-up window at ``y_0`` first."""
    verbose = args.verbose
    np_random = np.random.default_rng(seed=args.seed)
    if verbose:
        print(f"Random number generator initialized with seed: {args.seed}")
        print("Randomizing initial system state")
        print("Generating initial input-output data")
    u_d, y_d = common.initial_data(system_model, dd_mpc_config, np_random)

    if verbose:
        print("Initializing Data-Driven MPC controllers per scheme")
    controllers = create_data_driven_mpc_controllers_reproduction(
        controller_config=dd_mpc_config, u_d=u_d, y_d=y_d,
        data_driven_mpc_controller_schemes=SCHEMES,
    )

    # Force the paper's initial output y_0: the equilibrium state for
    # y_0, n steps at the input setpoint, each controller's past window
    # re-seeded from them.
    if verbose:
        print(f"Setting initial system output to {Y_0}")
    x_rep0 = get_equilibrium_state_from_output(
        system_model=system_model, y_eq=np.array(Y_0).reshape(-1, 1)
    )
    system_model.set_state(state=x_rep0)
    U_n, Y_n = simulate_n_input_output_measurements(
        system_model=system_model, controller_config=dd_mpc_config,
        np_random=np_random,
    )
    for controller in controllers:
        controller.set_past_input_output_data(
            u_past=U_n.reshape(-1, 1), y_past=Y_n.reshape(-1, 1)
        )

    n_steps = args.t_sim + 1 - dd_mpc_config["n"]
    if verbose:
        print("Simulating Data-Driven MPC control loops")
    u_sys_data, y_sys_data = (
        simulate_data_driven_mpc_control_loops_reproduction(
            system_model=system_model,
            data_driven_mpc_controllers=controllers, n_steps=n_steps,
            np_random=np_random, verbose=verbose,
        )
    )
    u_data = [np.vstack([U_n, u]) for u in u_sys_data]
    y_data = [np.vstack([Y_n, y]) for y in y_sys_data]
    if verbose:
        for scheme, y in zip(SCHEMES, y_data):
            err = np.abs(y[-1] - dd_mpc_config["y_s"].flatten()).max()
            print(f"    {scheme.name}: final output error {err:.5f}")
    return u_data, y_data


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    if args.verbose:
        print("Loading system parameters from configuration file")
    system_model, dd_mpc_config = common.load_configs(verbose=args.verbose)
    u_data, y_data = simulate(system_model, dd_mpc_config, args)
    if args.no_plot and not args.save_fig:
        return
    if args.verbose:
        print("Displaying reproduction figure")
    fig = plot_input_output_reproduction(
        data_driven_mpc_controller_schemes=SCHEMES,
        u_data=u_data,
        y_data=y_data,
        u_s=dd_mpc_config["u_s"],
        y_s=dd_mpc_config["y_s"],
        u_ylimits=U_YLIMITS,
        y_ylimits=Y_YLIMITS,
        title="Robust Data-Driven MPC Schemes",
        show=args.save_fig is None,
    )
    if args.save_fig:
        fig.savefig(args.save_fig, dpi=150)
        if args.verbose:
            print(f"Figure saved to {args.save_fig}")


if __name__ == "__main__":
    main()
