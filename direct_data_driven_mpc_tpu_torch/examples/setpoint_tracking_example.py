"""Time-varying setpoint tracking through the fused condensed rollout on
the port.

Counterpart of ``examples/setpoint_tracking_example.py``: a batch of
noise scenarios tracks a staircase of output references, each phase's
equilibrium input from the plant's DC gain. The schedule rides extra
input lanes of the tracking block map (``build_tracking_engine``), so on
the card the whole batch runs through the hand-written fused rollout
kernel (``ops.fused_rollout.fused_rollout``, rank 20 with the four-tank
setpoint lanes); on CPU tensors through its plain version. The noise
comes from ``parallel.batch.draw_noise_batch(seed, ...)``, not the JAX
CLI's threefry keys, so the draws differ.

Run: ``python -m direct_data_driven_mpc_tpu_torch.examples.\
setpoint_tracking_example --batch 512 --t_sim 400 --save_fig tracking.png``.
"""

from __future__ import annotations

import argparse
import math
from typing import Optional, Sequence

import numpy as np
import torch

from direct_data_driven_mpc_tpu_torch.control.creation import (
    create_data_driven_mpc_controller,
)
from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
    build_tracking_engine,
)
from direct_data_driven_mpc_tpu_torch.device import resolve_device
from direct_data_driven_mpc_tpu_torch.examples import common
from direct_data_driven_mpc_tpu_torch.models.lti_model import LTIModel
from direct_data_driven_mpc_tpu_torch.ops.fused_rollout import (
    fused_rollout,
    make_fused_batched_rollout,
)
from direct_data_driven_mpc_tpu_torch.parallel.batch import draw_noise_batch
from direct_data_driven_mpc_tpu_torch.qp.spec import SlackVarConstraintTypes
from direct_data_driven_mpc_tpu_torch.utils.config import (
    DataDrivenMPCParamsDictType,
)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Setpoint-schedule tracking via the fused condensed "
        "rollout (PyTorch port)"
    )
    parser.add_argument("--batch", type=int, default=512,
                        help="Number of noise scenarios.")
    parser.add_argument("--t_sim", type=int, default=400,
                        help="Closed-loop steps per scenario.")
    parser.add_argument("--phases", type=int, default=4,
                        help="Number of staircase phases.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--solves_per_block", type=int, default=25,
                        help="QP solves per block (= the schedule "
                        "granularity in steps, for n_mpc_step=1).")
    parser.add_argument("--no_plot", action="store_true", default=False)
    parser.add_argument("--save_fig", type=str, default=None)
    parser.add_argument("--verbose", type=int, default=1,
                        choices=[0, 1, 2])
    common.add_device_argument(parser)
    return parser.parse_args(argv)


def staircase(system_model: LTIModel, y_s: np.ndarray, n_outer: int,
              phases: int, m: int, p: int) -> np.ndarray:
    """``(n_outer, m + p)`` absolute setpoints ``[u_ref; y_ref]``, one per
    outer block: output references from 1.0 down to 0.6 of ``y_s`` over
    ``phases`` equal phases, each input from the plant's DC gain."""
    scales = np.linspace(1.0, 0.6, phases)
    blocks_per_phase = max(n_outer // phases, 1)
    sched = np.zeros((n_outer, m + p))
    for i in range(n_outer):
        y_ref = scales[min(i // blocks_per_phase, phases - 1)] * y_s
        u_ref = system_model.get_equilibrium_input_from_output(y_ref)
        sched[i] = np.concatenate([u_ref, y_ref])
    return sched


def simulate(
    system_model: LTIModel,
    config: DataDrivenMPCParamsDictType,
    args: argparse.Namespace,
    noise: Optional[np.ndarray] = None,
    rollout=fused_rollout,
) -> dict:
    """The example's pipeline from the loaded configs: the controller
    (one input applied per solve), the tracking block map at
    ``args.solves_per_block`` on ``args.device``, the staircase, and
    ``args.batch`` scenarios through ``rollout`` (the kernel, or
    ``fused_rollout_reference``) with the noise of
    ``draw_noise_batch(args.seed, ...)`` or ``noise``, ``(batch, t_sim,
    p)``, given explicitly.

    Returns numpy ``u_sys``, ``y_sys`` (float32 values), ``x_final``,
    the schedule ``sched`` (float32 values), the reference per step
    ``y_ref_steps``, and the floats ``rmse`` and ``tail`` it prints."""
    verbose = args.verbose
    config = dict(config, n_mpc_step=1)
    rng = np.random.default_rng(args.seed)
    u_d, y_d = common.initial_data(system_model, config, rng)
    ctrl = create_data_driven_mpc_controller(config, u_d, y_d)
    if ctrl.slack_var_constraint_type != SlackVarConstraintTypes.NONE:
        raise SystemExit(
            "The tracking engine condenses slack-NONE controllers "
            "(set slack_var_constraint_type: 0 in the config)."
        )
    device = resolve_device(args.device)
    K = args.solves_per_block
    bm = build_tracking_engine(ctrl, system_model.as_params(),
                               solves_per_block=K, device=device)

    m, p = ctrl.m, ctrl.p
    T, B = args.t_sim, args.batch
    n_outer = math.ceil(T / K)
    sched = staircase(system_model, np.asarray(ctrl.y_s).ravel(), n_outer,
                      args.phases, m, p).astype(np.float32)
    x0s, ups, yps = common.scenario_windows(system_model, ctrl, B, device)
    if noise is None:
        Ws = draw_noise_batch(args.seed, B, T, p, system_model.get_eps_max(),
                              device=device)
    else:
        Ws = torch.as_tensor(noise, dtype=torch.float32, device=device)
    run = make_fused_batched_rollout(bm, n_steps=T, rollout=rollout)
    res = run(x0s, ups, yps, Ws, torch.as_tensor(sched, device=device))
    y = res.y_sys.cpu().numpy()  # (B, T, p)
    y_ref_steps = np.repeat(sched[:, m:], K, axis=0)[:T]  # (T, p)
    rmse = float(np.sqrt(np.mean((y - y_ref_steps[None]) ** 2)))
    tail = float(np.abs(y[:, -1] - y_ref_steps[-1]).max())
    if verbose:
        print(f"Tracked {B} scenarios x {T} steps through {args.phases} "
              f"reference phases; RMS tracking error {rmse:.4f} (noise "
              f"floor ~{system_model.get_eps_max()}).")
        print(f"max final-step deviation from the last reference: "
              f"{tail:.4f}")
    return dict(u_sys=res.u_sys.cpu().numpy(), y_sys=y,
                x_final=res.x_final.cpu().numpy(), sched=sched,
                y_ref_steps=y_ref_steps, rmse=rmse, tail=tail)


def plot(out: dict, args: argparse.Namespace) -> None:
    """The JAX CLI's figure: the 5-95 % band and median of each output
    against the reference schedule."""
    import matplotlib

    if args.no_plot or args.save_fig:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    y, y_ref_steps = out["y_sys"], out["y_ref_steps"]
    B, T, p = y.shape
    fig, axes = plt.subplots(p, 1, figsize=(9, 3 * p), sharex=True)
    axes = np.atleast_1d(axes)
    t = np.arange(T)
    for j, ax in enumerate(axes):
        lo, med, hi = np.percentile(y[:, :, j], [5, 50, 95], axis=0)
        ax.fill_between(t, lo, hi, alpha=0.25, label="5-95% of scenarios")
        ax.plot(t, med, label="median $y$")
        ax.step(t, y_ref_steps[:, j], where="post", linestyle="--",
                color="black", label="reference schedule")
        ax.set_ylabel(f"$y_{j + 1}$")
        ax.legend(loc="best", fontsize=8)
    axes[-1].set_xlabel("time step $k$")
    fig.suptitle(f"Setpoint-schedule tracking: {B} scenarios, "
                 f"{args.phases} phases (fused condensed rollout)")
    fig.tight_layout()
    if args.save_fig:
        fig.savefig(args.save_fig, dpi=120)
        if args.verbose:
            print(f"Figure saved to {args.save_fig}")
    if not args.no_plot and not args.save_fig:
        plt.show()


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    system_model, config = common.load_configs()
    out = simulate(system_model, config, args)
    if not args.no_plot or args.save_fig:
        plot(out, args)
    print("Simulation finished.")


if __name__ == "__main__":
    main()
