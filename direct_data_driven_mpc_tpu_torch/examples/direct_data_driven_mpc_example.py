"""Direct data-driven MPC example CLI (four-tank system) on the port.

Counterpart of ``examples/direct_data_driven_mpc_example.py``: load the
plant and controller YAML configs, randomize the initial state, generate
persistently exciting data, build the controller, run the closed loop,
then plot and animate. The same flags, plus ``--device``; the engine
``kernel`` is the JAX CLI's ``pallas``.

Run: ``python -m direct_data_driven_mpc_tpu_torch.examples.\
direct_data_driven_mpc_example [--engine kernel] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from direct_data_driven_mpc_tpu_torch.control.creation import (
    create_data_driven_mpc_controller,
)
from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
    build_linear_engine,
    linear_closed_loop_rollout,
)
from direct_data_driven_mpc_tpu_torch.control.loop import (
    ClosedLoopResult,
    closed_loop_rollout,
)
from direct_data_driven_mpc_tpu_torch.control.operation import (
    simulate_data_driven_mpc_control_loop,
)
from direct_data_driven_mpc_tpu_torch.device import resolve_device
from direct_data_driven_mpc_tpu_torch.examples import common
from direct_data_driven_mpc_tpu_torch.models.lti_model import LTIModel
from direct_data_driven_mpc_tpu_torch.ops.fused_rollout import (
    fused_rollout,
    make_fused_batched_rollout,
)
from direct_data_driven_mpc_tpu_torch.qp.spec import (
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)
from direct_data_driven_mpc_tpu_torch.utils.config import (
    DataDrivenMPCParamsDictType,
)

DEFAULT_ANIM_PATH = os.path.join(common.REPO_ROOT, "animation_outputs",
                                 "data-driven_mpc_sim.gif")
CONTROLLER_TYPE_MAP = {
    "Nominal": DataDrivenMPCType.NOMINAL,
    "Robust": DataDrivenMPCType.ROBUST,
}
SLACK_TYPE_MAP = {
    "NonConvex": SlackVarConstraintTypes.NON_CONVEX,
    "Convex": SlackVarConstraintTypes.CONVEX,
    "None": SlackVarConstraintTypes.NONE,
}
ENGINES = ("host", "fused", "linear", "kernel")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Direct Data-Driven MPC Controller Example (PyTorch "
        "port)"
    )
    parser.add_argument(
        "--model_config_path", type=str, default=common.MODEL_CONFIG,
        help="Path to the YAML file with the plant model parameters.",
    )
    parser.add_argument(
        "--model_key_value", type=str, default=common.MODEL_KEY,
        help="Key of the model parameters in the config file.",
    )
    parser.add_argument(
        "--controller_config_path", type=str,
        default=common.CONTROLLER_CONFIG,
        help="Path to the YAML file with the controller parameters.",
    )
    parser.add_argument(
        "--controller_key_value", type=str, default=common.CONTROLLER_KEY,
        help="Key of the controller parameters in the config file.",
    )
    parser.add_argument(
        "--n_mpc_step", type=int, default=None,
        help="Consecutive optimal-input applications per solve "
        "(n-step scheme).",
    )
    parser.add_argument(
        "--controller_type", type=str, default=None,
        choices=["Nominal", "Robust"],
        help="Data-driven MPC controller type override.",
    )
    parser.add_argument(
        "--slack_var_const_type", type=str, default=None,
        choices=["None", "Convex", "NonConvex"],
        help="Slack variable constraint type override (Robust only).",
    )
    parser.add_argument(
        "--allow_nonconvex_slack", action="store_true", default=False,
        help="Actually SOLVE the NonConvex slack variant (paper Eq. 6d,"
        " convex-concave fixed point) instead of raising like the "
        "reference implementation.",
    )
    parser.add_argument(
        "--t_sim", type=int, default=400,
        help="Simulation length in time steps.",
    )
    parser.add_argument(
        "--seed", type=int, default=None,
        help="RNG seed for reproducible results.",
    )
    parser.add_argument(
        "--engine", type=str, default="host", choices=ENGINES,
        help="Closed-loop execution engine: host = stateful step loop "
        "(the C extension's per-step solve); fused = the generic batched "
        "loop on the device; linear = condensed affine engine; kernel = "
        "the fused condensed rollout, the hand-written CUDA kernel on the "
        "card (the JAX CLI's 'pallas' engine; slack-NONE controllers "
        "only, like linear).",
    )
    parser.add_argument(
        "--u_min", type=float, default=None,
        help="Lower actuator bound on every predicted input (requires "
        "--engine fused; the box-ADMM solver, qp/box.py).",
    )
    parser.add_argument(
        "--u_max", type=float, default=None,
        help="Upper actuator bound on every predicted input (requires "
        "--engine fused).",
    )
    parser.add_argument(
        "--save_anim", action="store_true", default=False,
        help="Save the animation via ffmpeg to --anim_path.",
    )
    parser.add_argument(
        "--anim_path", type=str, default=DEFAULT_ANIM_PATH,
        help="Output path for the animation (extension selects format).",
    )
    parser.add_argument("--anim_fps", type=float, default=50.0)
    parser.add_argument("--anim_bitrate", type=int, default=4500)
    parser.add_argument("--anim_points_per_frame", type=int, default=5)
    parser.add_argument(
        "--no_plot", action="store_true", default=False,
        help="Skip figures entirely (headless runs).",
    )
    parser.add_argument(
        "--verbose", type=int, default=2, choices=[0, 1, 2],
        help="0 = silent, 1 = minimal, 2 = detailed.",
    )
    common.add_device_argument(parser)
    return parser.parse_args(argv)


def _solver(controller, args, device):
    """The generic loop's solver as the JAX CLI picks it: the box ADMM
    under actuator bounds, else by the controller's effective slack."""
    if args.u_min is not None or args.u_max is not None:
        return controller.box_admm_solver(u_bounds=(args.u_min, args.u_max),
                                          device=device)
    slack = controller.spec.slack_var_constraint_type
    if slack == SlackVarConstraintTypes.CONVEX:
        return controller.admm_solver(device=device)
    if slack == SlackVarConstraintTypes.NON_CONVEX:
        return controller.nonconvex_admm_solver(device=device)
    return controller.solution_map(device=device)


def simulate(
    system_model: LTIModel,
    dd_mpc_config: DataDrivenMPCParamsDictType,
    args: argparse.Namespace,
    rollout=fused_rollout,
) -> dict:
    """The example's pipeline from the loaded configs to the closed
    loop's arrays (numpy): ``u_d``, ``y_d``, ``u_sys``, ``y_sys`` and,
    for the device engines, ``costs``, ``converged``, ``x_final``,
    ``u_past``, ``y_past``; ``title`` names the controller.

    ``args`` carries the CLI's overrides and engine; the config dict is
    not changed. ``rollout`` is the ``kernel`` engine's rollout: the
    kernel (``ops.fused_rollout.fused_rollout``, its plain version on
    CPU tensors) or ``fused_rollout_reference``. Raises ``SystemExit`` on
    the engine combinations the JAX CLI refuses."""
    verbose = args.verbose
    if (args.u_min is not None or args.u_max is not None) and \
            args.engine != "fused":
        raise SystemExit(
            "--u_min/--u_max require --engine fused (the box-ADMM "
            "solver runs in the generic loop)."
        )
    config = dict(dd_mpc_config)
    if args.n_mpc_step is not None:
        config["n_mpc_step"] = args.n_mpc_step
    if args.controller_type is not None:
        config["controller_type"] = CONTROLLER_TYPE_MAP[args.controller_type]
    if args.slack_var_const_type is not None:
        config["slack_var_constraint_type"] = SLACK_TYPE_MAP[
            args.slack_var_const_type
        ]

    n_steps = args.t_sim + 1
    np_random = np.random.default_rng(seed=args.seed)
    if verbose:
        print("Random number generator initialized with "
              + ("a random seed" if args.seed is None
                 else f"seed: {args.seed}"))
        print("Randomizing initial system state")
        print("Generating initial input-output data")
    u_d, y_d = common.initial_data(system_model, config, np_random)

    ctype = config["controller_type"].name.capitalize()
    if verbose:
        print(f"Initializing {ctype} Data-Driven MPC controller")
    controller = create_data_driven_mpc_controller(
        controller_config=config, u_d=u_d, y_d=y_d,
        allow_nonconvex_slack=args.allow_nonconvex_slack,
    )
    if verbose:
        print(f"Starting {ctype} Data-Driven MPC control system simulation "
              f"({args.engine} engine)")
    out = dict(u_d=u_d, y_d=y_d, title=f"{ctype} Data-Driven MPC")
    if args.engine == "host":
        out["u_sys"], out["y_sys"] = simulate_data_driven_mpc_control_loop(
            system_model=system_model,
            data_driven_mpc_controller=controller, n_steps=n_steps,
            np_random=np_random, verbose=verbose,
        )
    else:
        out.update(_device_engine(system_model, controller, args, n_steps,
                                  np_random, rollout))
    if verbose:
        y_err = np.abs(out["y_sys"][-1] - config["y_s"].flatten()).max()
        print(f"Simulation finished; final output error {y_err:.5f}")
    return out


def _device_engine(system_model, controller, args, n_steps, np_random,
                   rollout) -> dict:
    """One scenario through the ``fused``, ``linear`` or ``kernel``
    engine on ``args.device``, float32, as the JAX CLI's :333-380."""
    device = resolve_device(args.device)
    p = system_model.get_number_outputs()
    n_mpc_step = controller.n_mpc_step
    w_sys = system_model.get_eps_max() * np_random.uniform(
        -1.0, 1.0, (n_steps, p))
    x0, ups, yps = common.scenario_windows(system_model, controller, 1,
                                           device)
    W = torch.as_tensor(w_sys, dtype=torch.float32, device=device)[None]
    plant = system_model.as_params()
    if args.engine in ("linear", "kernel"):
        if controller.spec.slack_var_constraint_type in (
            SlackVarConstraintTypes.CONVEX,
            SlackVarConstraintTypes.NON_CONVEX,
        ):
            raise SystemExit(
                f"--engine {args.engine} requires a slack-NONE controller "
                "(the ADMM clip does not condense); use --engine fused."
            )
        bm = build_linear_engine(
            controller, plant, device=device,
            solves_per_block=min(50, -(-n_steps // n_mpc_step)),
        )
        if args.engine == "kernel":
            # One scenario on the kernel: B = 1, no tiling.
            result = _first(make_fused_batched_rollout(
                bm, n_steps, n_mpc_step=n_mpc_step, rollout=rollout,
            )(x0, ups, yps, W))
        else:
            result = linear_closed_loop_rollout(
                bm, x0[0], ups[0], yps[0], W=W[0], n_steps=n_steps,
                n_mpc_step=n_mpc_step,
            )
    else:
        result = _first(closed_loop_rollout(
            plant, _solver(controller, args, device), x0, ups, yps, W,
            n_steps=n_steps, n_mpc_step=n_mpc_step,
        ))
    out = {name: getattr(result, name).detach().cpu().numpy()
           for name in ("costs", "converged", "x_final", "u_past",
                        "y_past")}
    out["u_sys"] = result.u_sys.detach().cpu().double().numpy()
    out["y_sys"] = result.y_sys.detach().cpu().double().numpy()
    if args.verbose > 1:
        print(f"    Solves: {out['costs'].shape[0]}, final cost "
              f"{out['costs'][-1]:.4f}, all converged: "
              f"{bool(np.all(out['converged']))}")
    return out


def _first(result: ClosedLoopResult) -> ClosedLoopResult:
    """The one scenario of a batch of one (the solver state dropped)."""
    return ClosedLoopResult(*(f[0] for f in result[:7]))


def plot(out: dict, dd_mpc_config: DataDrivenMPCParamsDictType,
         args: argparse.Namespace) -> None:
    """The JAX CLI's figures: the closed loop, the closed loop after the
    excitation data, and the animation (saved with ``--save_anim``)."""
    import matplotlib.pyplot as plt

    from direct_data_driven_mpc_tpu_torch.viz.plots import (
        plot_input_output,
        plot_input_output_animation,
        save_animation,
    )
    from direct_data_driven_mpc_tpu_torch.viz.styles import (
        INPUT_OUTPUT_PLOT_PARAMS,
        INPUT_OUTPUT_PLOT_PARAMS_SMALL,
    )

    verbose = args.verbose
    N = dd_mpc_config["N"]
    u_s, y_s = dd_mpc_config["u_s"], dd_mpc_config["y_s"]
    title = out["title"]
    if verbose:
        print("Displaying control system inputs and outputs plot")
    plot_input_output(u_k=out["u_sys"], y_k=out["y_sys"], u_s=u_s, y_s=y_s,
                      figsize=(14, 8), dpi=100, title=title,
                      **INPUT_OUTPUT_PLOT_PARAMS)
    U = np.vstack([out["u_d"], out["u_sys"]])
    Y = np.vstack([out["y_d"], out["y_sys"]])
    if verbose:
        print("Displaying control system inputs and outputs including "
              "initial input-output measurements")
    plot_input_output(u_k=U, y_k=Y, u_s=u_s, y_s=y_s, initial_steps=N,
                      figsize=(14, 8), dpi=100, title=title,
                      **INPUT_OUTPUT_PLOT_PARAMS_SMALL)
    if verbose:
        print("Displaying animation from extended input-output data")
    anim = plot_input_output_animation(
        u_k=U, y_k=Y, u_s=u_s, y_s=y_s, initial_steps=N, figsize=(14, 8),
        dpi=100, interval=1000 / args.anim_fps,
        points_per_frame=args.anim_points_per_frame, title=title,
        **INPUT_OUTPUT_PLOT_PARAMS_SMALL,
    )
    plt.show()
    if args.save_anim:
        frames = math.ceil((len(U) - 1) / args.anim_points_per_frame) + 1
        if verbose:
            print("Saving extended input-output animation to file")
        save_animation(animation=anim, total_frames=frames,
                       fps=args.anim_fps, bitrate=args.anim_bitrate,
                       file_path=args.anim_path)
        if verbose:
            print("Animation file saved successfully")
    plt.close()


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    if args.verbose:
        print("Loading system parameters from configuration file")
        print("Loading Data-Driven MPC controller parameters from "
              "configuration file")
    system_model, dd_mpc_config = common.load_configs(
        args.model_config_path, args.model_key_value,
        args.controller_config_path, args.controller_key_value,
        verbose=args.verbose,
    )
    out = simulate(system_model, dd_mpc_config, args)
    if not args.no_plot:
        plot(out, dd_mpc_config, args)


if __name__ == "__main__":
    main()
