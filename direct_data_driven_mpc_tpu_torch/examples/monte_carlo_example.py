"""Monte-Carlo closed-loop robustness study on the port.

Counterpart of ``examples/monte_carlo_example.py``: thousands of noise
scenarios of the four-tank Robust controller in one call of the classic
condensed engine (``control.linear_engine.make_linear_batched_rollout``),
each outer block's noise drawn inside the loop from a
``torch.Generator`` seeded with ``--seed`` (not the JAX CLI's threefry
keys, so the draws differ), then the tracking-error percentile bands and
the final solve-cost distribution.

Run: ``python -m direct_data_driven_mpc_tpu_torch.examples.\
monte_carlo_example --batch 4096 --t_sim 200 --save_fig mc.png``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from direct_data_driven_mpc_tpu_torch.control.creation import (
    create_data_driven_mpc_controller,
)
from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
    build_linear_engine,
    closed_loop_spectrum,
    make_linear_batched_rollout,
)
from direct_data_driven_mpc_tpu_torch.device import resolve_device
from direct_data_driven_mpc_tpu_torch.examples import common
from direct_data_driven_mpc_tpu_torch.models.lti_model import LTIModel
from direct_data_driven_mpc_tpu_torch.qp.spec import SlackVarConstraintTypes
from direct_data_driven_mpc_tpu_torch.utils.config import (
    DataDrivenMPCParamsDictType,
)
from direct_data_driven_mpc_tpu_torch.utils.profiling import Timer


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Monte-Carlo data-driven MPC robustness study "
        "(PyTorch port)"
    )
    parser.add_argument("--batch", type=int, default=4096,
                        help="Number of noise scenarios.")
    parser.add_argument("--t_sim", type=int, default=200,
                        help="Closed-loop steps per scenario.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--solves_per_block", type=int, default=50,
                        help="QP solves composed per block of the "
                        "condensed engine.")
    parser.add_argument("--no_plot", action="store_true", default=False)
    parser.add_argument("--save_fig", type=str, default=None)
    parser.add_argument("--verbose", type=int, default=1,
                        choices=[0, 1, 2])
    common.add_device_argument(parser)
    return parser.parse_args(argv)


def simulate(
    system_model: LTIModel,
    config: DataDrivenMPCParamsDictType,
    args: argparse.Namespace,
    noise: Optional[np.ndarray] = None,
) -> dict:
    """The study's pipeline from the loaded configs: the controller
    (one input applied per solve), the condensed engine on
    ``args.device`` and its spectral radius, then ``args.batch``
    scenarios of ``args.t_sim`` steps, timed after a warm-up
    (``utils.profiling.Timer``, which waits for the card).

    The noise is drawn in the loop from a generator seeded with
    ``args.seed`` (the same draws in the warm-up and the timed run), or
    is ``noise``, ``(batch, t_sim, p)``, given explicitly. Returns numpy
    ``y_sys``, ``u_sys``, ``costs``, the float ``spectral_radius``,
    ``stable`` and ``seconds``, and the ``y_s`` the errors are taken
    from."""
    verbose = args.verbose
    config = dict(config, n_mpc_step=1)
    rng = np.random.default_rng(args.seed)
    u_d, y_d = common.initial_data(system_model, config, rng)
    ctrl = create_data_driven_mpc_controller(config, u_d, y_d)
    if ctrl.slack_var_constraint_type == SlackVarConstraintTypes.CONVEX:
        raise SystemExit(
            "The Monte-Carlo example uses the condensed affine engine, "
            "which requires a slack-NONE controller (set "
            "slack_var_constraint_type: 0 in the controller config)."
        )
    device = resolve_device(args.device)
    bm = build_linear_engine(ctrl, system_model.as_params(),
                             solves_per_block=args.solves_per_block,
                             device=device)
    spectrum = closed_loop_spectrum(bm)
    if verbose:
        print(f"Closed-loop spectral radius: "
              f"{spectrum['spectral_radius']:.4f} "
              f"({'stable' if spectrum['stable'] else 'UNSTABLE'})")

    B, T = args.batch, args.t_sim
    x0s, ups, yps = common.scenario_windows(system_model, ctrl, B, device)
    eps = system_model.get_eps_max()
    if noise is None:
        run = make_linear_batched_rollout(bm, n_steps=T, use_rng_noise=True,
                                          eps_max=eps)

        def call():
            gen = torch.Generator(device=device).manual_seed(args.seed)
            return run(x0s, ups, yps, gen)
    else:
        run = make_linear_batched_rollout(bm, n_steps=T)
        W = torch.as_tensor(noise, dtype=torch.float32, device=device)

        def call():
            return run(x0s, ups, yps, W)

    timer = Timer()
    result = timer.timeit(call, iters=1, warmup=1)
    if verbose:
        print(f"Simulated {B} scenarios x {T} steps ({B * T} QP solves) "
              f"in {timer.best:.3f}s")

    out = {name: getattr(result, name).cpu().double().numpy()
           for name in ("u_sys", "y_sys", "costs")}
    out.update(spectral_radius=spectrum["spectral_radius"],
               stable=spectrum["stable"], seconds=timer.best,
               y_s=config["y_s"].flatten())
    if verbose:
        err = np.linalg.norm(out["y_sys"] - out["y_s"], axis=-1)
        costs = out["costs"]
        print(f"Final tracking error: p50 {np.percentile(err[:, -1], 50):.4f}"
              f", p95 {np.percentile(err[:, -1], 95):.4f}, "
              f"max {err[:, -1].max():.4f}")
        print(f"Final solve cost: p50 {np.percentile(costs[:, -1], 50):.4f}"
              f", p95 {np.percentile(costs[:, -1], 95):.4f}")
    return out


def plot(out: dict, args: argparse.Namespace) -> None:
    """The JAX CLI's figure: tracking-error percentile bands over time
    and the final solve-cost histogram."""
    import matplotlib.pyplot as plt

    err = np.linalg.norm(out["y_sys"] - out["y_s"], axis=-1)  # (B, T)
    costs = out["costs"]
    B, T = err.shape
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(13, 5))
    ts = np.arange(T)
    for lo, hi, alpha in ((5, 95, 0.2), (25, 75, 0.35)):
        ax1.fill_between(ts, np.percentile(err, lo, axis=0),
                         np.percentile(err, hi, axis=0), alpha=alpha,
                         color="tab:blue", label=f"p{lo}-p{hi}")
    ax1.plot(ts, np.percentile(err, 50, axis=0), color="tab:blue",
             label="median")
    ax1.set_yscale("log")
    ax1.set_xlabel("Time step $k$")
    ax1.set_ylabel(r"$\|y_k - y_s\|_2$")
    ax1.set_title(f"Tracking error across {B} noise scenarios")
    ax1.legend()
    ax2.hist(costs[:, -1], bins=60, color="tab:blue", alpha=0.8)
    ax2.set_xlabel("Final QP cost")
    ax2.set_ylabel("Scenarios")
    ax2.set_title("Terminal solve-cost distribution")
    fig.tight_layout()
    if args.save_fig:
        fig.savefig(args.save_fig, dpi=150)
        if args.verbose:
            print(f"Figure saved to {args.save_fig}")
    elif not args.no_plot:
        plt.show()


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    system_model, config = common.load_configs()
    out = simulate(system_model, config, args)
    if args.no_plot and not args.save_fig:
        return
    plot(out, args)


if __name__ == "__main__":
    main()
