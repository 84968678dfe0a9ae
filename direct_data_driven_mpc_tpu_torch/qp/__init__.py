"""Static QP spec, assembly and the affine solution operator (host,
float64 numpy); the operators on a device, the iterative solvers, and
the batched build of one operator per data realisation."""

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
]
