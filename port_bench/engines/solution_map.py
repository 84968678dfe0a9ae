"""Slack NONE: the exact solution map, condensed into blocks and run by
``ops/fused_rollout.py::make_fused_batched_rollout`` (kernel K1)."""

from __future__ import annotations

from port_bench import reference, work as _work
from port_bench.engines import Program, controller, plant

LIBRARY = "fused_rollout"


def work(config, B, T):
    return _work.k1(config, B, T)


def build(config: dict, data, T: int, device, wrap) -> Program:
    """The block map from ``build_linear_engine`` at the K of
    ``suggest_solves_per_block``, and the entry with ``rollout=
    wrap(fused_rollout)``."""
    from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
        build_linear_engine,
    )
    from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr

    ctrl = controller(config, data)
    params = plant(config)
    K = fr.suggest_solves_per_block(params.A.shape[0], ctrl.n, ctrl.m,
                                    ctrl.p, n_mpc_step=ctrl.n_mpc_step,
                                    n_steps=T)
    bm = build_linear_engine(ctrl, params, solves_per_block=K,
                             device=device)
    run = fr.make_fused_batched_rollout(bm, T, n_mpc_step=ctrl.n_mpc_step,
                                        rollout=wrap(fr.fused_rollout))
    return Program(run, lambda: fr.fused_rollout.launches,
                   lambda: fr.fused_rollout_nocost.launches)


def reference_run(config: dict, data, W, control: bool = False) -> dict:
    qp = reference.RobustQP(data.u_d, data.y_d, config["controller"])
    return reference.closed_loop(config["model"], reference.solution_maps(qp),
                                 None, data.x0, data.u_past, data.y_past, W,
                                 control=control)
