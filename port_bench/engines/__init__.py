"""How the benchmark drives each kind of configuration through the
program's public entries (one module per ``engine`` named in a
configuration file), and which plain reference judges it.

Each module gives ``LIBRARY`` (the kernel library the entry loads),
``work(config, B, T)`` (``port_bench.work``), ``build(config, data, T,
device, wrap) -> Program`` and ``reference_run(config, data, W, control)``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np


class Program(NamedTuple):
    """The program's entry as a user calls it, ``run(x0s, u_pasts,
    y_pasts, Ws) -> ClosedLoopResult``, and its kernel wrapper's launch
    counters: ``launches()`` of the hand kernel and ``others()`` of any
    other body that could stand in for it."""

    run: Callable
    launches: Callable
    others: Callable


def controller(config: dict, data):
    """The program's Robust controller on the data run, from the
    configuration's upstream keys as the upstream loader derives them
    (Q = Q_scalar I, R = R_scalar I, lamb_alpha = lambda_alpha_epsilon_bar
    / epsilon_bar). Its per-step host solve is numpy: the benchmark uses
    its QP only."""
    from direct_data_driven_mpc_tpu_torch.control.controller import (
        DirectDataDrivenMPCController,
    )
    from direct_data_driven_mpc_tpu_torch.qp.spec import (
        DataDrivenMPCType,
        SlackVarConstraintTypes,
    )

    c = config["controller"]
    m, p, L, eps = data.u_d.shape[1], data.y_d.shape[1], c["L"], \
        c["epsilon_bar"]
    slack = {0: "NONE", 1: "CONVEX"}[c["slack_var_constraint_type"]]
    return DirectDataDrivenMPCController(
        n=c["n"], m=m, p=p, u_d=data.u_d, y_d=data.y_d, L=L,
        Q=c["Q_scalar"] * np.eye(p * L), R=c["R_scalar"] * np.eye(m * L),
        u_s=np.asarray(c["u_s"], np.float64).reshape(-1, 1),
        y_s=np.asarray(c["y_s"], np.float64).reshape(-1, 1),
        eps_max=eps, lamb_alpha=c["lambda_alpha_epsilon_bar"] / eps,
        lamb_sigma=c["lambda_sigma"], c=c["c"],
        slack_var_constraint_type=SlackVarConstraintTypes[slack],
        controller_type=DataDrivenMPCType(c["controller_type"]),
        n_mpc_step=c["n_mpc_step"], solve_path="numpy",
    )


def plant(config: dict):
    """The program's ``LTIParams`` of the configuration's plant."""
    from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams

    return LTIParams(*(np.asarray(config["model"][k], np.float64)
                       for k in "ABCD"))
