"""Gradient-based tuning of the robust MPC regularization on the port.

Counterpart of ``examples/regularization_tuning_example.py``: the
robust scheme's ridge weights (``lambda_alpha_epsilon_bar`` and
``lambda_sigma`` in the YAML schema) are tuned by Adam on the closed-loop
Monte-Carlo tracking objective, differentiated by autograd through the
KKT solve and the generic loop (``control.tuning``), in float64. The
JAX CLI pins its CPU; the port runs on the card unless given ``--device
cpu``.

Run: ``python -m direct_data_driven_mpc_tpu_torch.examples.\
regularization_tuning_example --batch 8 --t_sim 80 --steps 25``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from direct_data_driven_mpc_tpu_torch.control.creation import (
    create_data_driven_mpc_controller,
)
from direct_data_driven_mpc_tpu_torch.control.tuning import (
    make_closed_loop_objective,
    tune_regularization,
)
from direct_data_driven_mpc_tpu_torch.examples import common
from direct_data_driven_mpc_tpu_torch.models.lti_model import LTIModel
from direct_data_driven_mpc_tpu_torch.utils.config import (
    DataDrivenMPCParamsDictType,
)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description=(
            "Gradient-descend the robust MPC regularization against "
            "the closed-loop Monte-Carlo tracking objective (PyTorch port)"
        )
    )
    parser.add_argument("--batch", type=int, default=8,
                        help="Noise scenarios in the tuning objective.")
    parser.add_argument("--t_sim", type=int, default=80,
                        help="Closed-loop steps per scenario.")
    parser.add_argument("--steps", type=int, default=25,
                        help="Adam steps.")
    parser.add_argument("--lr", type=float, default=0.4,
                        help="Adam learning rate (log-space).")
    parser.add_argument(
        "--inflate", type=float, default=100.0,
        help="Multiply the YAML alpha ridge by this factor before "
        "tuning (demonstrates recovery from a bad initial guess).",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no_plot", action="store_true", default=False)
    parser.add_argument("--save_fig", type=str, default=None)
    parser.add_argument("--verbose", type=int, default=1,
                        choices=[0, 1, 2])
    common.add_device_argument(parser)
    return parser.parse_args(argv)


def simulate(
    system_model: LTIModel,
    mpc_params: DataDrivenMPCParamsDictType,
    args: argparse.Namespace,
) -> dict:
    """The example's pipeline from the loaded configs: the controller,
    a float64 batch of ``args.batch`` scenarios of ``args.t_sim`` steps
    (its noise from the same numpy generator, as the JAX CLI draws it),
    the objective on ``args.device``, and ``args.steps`` Adam steps from
    the YAML alpha ridge times ``args.inflate``.

    Returns ``tune_regularization``'s dict (the tuned ``alpha_reg`` and
    ``sigma_reg``, ``loss_history``, ``initial_loss``, ``final_loss``)
    with the YAML weights ``alpha_yaml``, ``sigma_yaml`` and their loss
    ``yaml_loss``."""
    rng = np.random.default_rng(args.seed)
    u_d, y_d = common.initial_data(system_model, mpc_params, rng)
    controller = create_data_driven_mpc_controller(mpc_params, u_d, y_d)

    B, T = args.batch, args.t_sim
    x0s, ups, yps = common.scenario_windows(system_model, controller, B,
                                            "cpu", dtype=torch.float64)
    eps = system_model.get_eps_max()
    Ws = rng.uniform(-eps, eps, (B, T, system_model.get_number_outputs()))
    loss = make_closed_loop_objective(
        controller.spec, system_model.as_params(), x0s, ups, yps, Ws,
        n_steps=T, n_mpc_step=controller.n_mpc_step, device=args.device,
    )

    a_yaml = controller.lamb_alpha * controller.eps_max
    s_yaml = controller.lamb_sigma
    a0 = args.inflate * a_yaml
    with torch.no_grad():
        yaml_loss = float(loss(torch.log(torch.tensor(
            [a_yaml, s_yaml], dtype=torch.float64))))
    print(f"YAML ridge: alpha_reg={a_yaml:.4e} sigma_reg={s_yaml:.4e} "
          f"(loss {yaml_loss:.6e})")
    print(f"tuning from inflated start alpha_reg={a0:.4e} "
          f"({args.steps} adam steps, lr={args.lr})...")
    out = tune_regularization(
        loss, alpha_reg0=a0, sigma_reg0=s_yaml, steps=args.steps,
        learning_rate=args.lr, verbose=args.verbose >= 2,
    )
    print(f"tuned: alpha_reg={out['alpha_reg']:.4e} "
          f"sigma_reg={out['sigma_reg']:.4e}; loss "
          f"{out['initial_loss']:.6e} -> {out['final_loss']:.6e} "
          f"({out['initial_loss'] / max(out['final_loss'], 1e-300):.2f}x "
          "better)")
    return dict(out, alpha_yaml=a_yaml, sigma_yaml=s_yaml,
                yaml_loss=yaml_loss)


def plot(out: dict, args: argparse.Namespace) -> None:
    """The JAX CLI's figure: the loss per Adam step."""
    import matplotlib

    if args.save_fig or args.no_plot:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 3.5), layout="constrained")
    ax.semilogy(out["loss_history"], marker="o", ms=3)
    ax.set_xlabel("adam step")
    ax.set_ylabel("closed-loop tracking loss")
    ax.set_title("Gradient tuning of the robust MPC regularization")
    if args.save_fig:
        fig.savefig(args.save_fig, dpi=150)
        print(f"figure saved to {args.save_fig}")
    if not args.no_plot:
        plt.show()


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    system_model, mpc_params = common.load_configs(verbose=args.verbose)
    out = simulate(system_model, mpc_params, args)
    if args.no_plot and not args.save_fig:
        return
    plot(out, args)


if __name__ == "__main__":
    main()
