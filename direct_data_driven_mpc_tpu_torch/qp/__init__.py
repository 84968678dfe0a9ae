"""Static QP spec, assembly and the affine solution operator (host,
float64 numpy); the operators on a device, the iterative solvers, the
batched build of one operator per data realisation, and the
alpha-sharded KKT solver over a mesh (``qp.distributed``, imported on
first access: it imports ``control.loop``, which imports this package).
"""

import importlib

from direct_data_driven_mpc_tpu_torch.qp.admm import (
    ADMMSolver,
    compute_admm_solver,
)
from direct_data_driven_mpc_tpu_torch.qp.assembly import build_qp_spec
from direct_data_driven_mpc_tpu_torch.qp.batch_build import (
    build_batched_solution_operators,
    build_solution_operators_fallback,
    stacked_solution_map,
)
from direct_data_driven_mpc_tpu_torch.qp.nonconvex import (
    NonConvexADMMSolver,
    compute_nonconvex_admm_solver,
    nonconvex_admm_solve,
)
from direct_data_driven_mpc_tpu_torch.qp.solution_map import (
    SolutionMap,
    TrackingMap,
    compute_solution_map,
    compute_tracking_map,
)
from direct_data_driven_mpc_tpu_torch.qp.spec import (
    DataDrivenMPCType,
    QPSpec,
    SlackVarConstraintTypes,
)

__all__ = [
    "ADMMSolver",
    "compute_admm_solver",
    "build_qp_spec",
    "build_batched_solution_operators",
    "build_solution_operators_fallback",
    "stacked_solution_map",
    "NonConvexADMMSolver",
    "compute_nonconvex_admm_solver",
    "nonconvex_admm_solve",
    "SolutionMap",
    "TrackingMap",
    "compute_solution_map",
    "compute_tracking_map",
    "DataDrivenMPCType",
    "QPSpec",
    "SlackVarConstraintTypes",
    "ShardedKKTOperand",
    "build_sharded_kkt",
    "make_distributed_closed_loop",
    "make_distributed_kkt_solver",
]

_DISTRIBUTED = {"ShardedKKTOperand", "build_sharded_kkt",
                "make_distributed_closed_loop", "make_distributed_kkt_solver"}


def __getattr__(name):
    if name not in _DISTRIBUTED:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.distributed"), name)
