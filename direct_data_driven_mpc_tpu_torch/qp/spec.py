"""Static problem specification for the data-driven MPC QP.

The reference rebuilds a CVXPY problem every closed-loop step
(direct_data_driven_mpc_controller.py:389-407). Here the problem is
assembled ONCE into a static numeric spec: a quadratic cost
``z^T (H/2) z + g^T z + r0`` and equality constraints ``A z = b`` where
only the internal-state rows of ``b`` depend on the time-varying past
measurement window ``theta = [u_past; y_past]``:

    b(theta) = b_const + S @ theta.

Everything downstream (the exact affine solution map, the ADMM solver)
is derived from this spec at construction time; nothing is rebuilt in
the hot loop.

Variable ordering in ``z`` (matching the reference's variable roles at
direct_data_driven_mpc_controller.py:409-445)::

    z = [ alpha (n_alpha) | ubar ((L+n)m) | ybar ((L+n)p) | sigma ((L+n)p, robust only) ]

with ``n_alpha = N - L - n + 1``. Predicted time indices run
``k = -n .. L-1``: the first ``n`` blocks of ubar/ybar pin the initial
state (paper Definition 3).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class DataDrivenMPCType(enum.Enum):
    """Controller kind (reference enum at
    direct_data_driven_mpc_controller.py:11-13)."""

    NOMINAL = 0
    ROBUST = 1


class SlackVarConstraintTypes(enum.Enum):
    """Slack-variable constraint kind for the Robust scheme (reference
    enum at direct_data_driven_mpc_controller.py:16-20)."""

    NON_CONVEX = 0
    CONVEX = 1
    NONE = 2


@dataclasses.dataclass(frozen=True)
class QPDims:
    """Static dimensions of one data-driven MPC QP."""

    n: int  # estimated system order
    m: int  # number of inputs
    p: int  # number of outputs
    L: int  # prediction horizon
    N: int  # initial trajectory length

    @property
    def n_alpha(self) -> int:
        return self.N - self.L - self.n + 1

    @property
    def n_u(self) -> int:
        return (self.L + self.n) * self.m

    @property
    def n_y(self) -> int:
        return (self.L + self.n) * self.p

    @property
    def n_theta(self) -> int:
        """Length of the time-varying past window [u_past; y_past]."""
        return self.n * (self.m + self.p)


@dataclasses.dataclass(frozen=True)
class QPSpec:
    """Fully-assembled static QP (float64 host arrays).

    Cost: ``z^T (H/2) z + g^T z + r0`` (H is the FULL Hessian, i.e.
    2x the quadratic-form weight, so the objective matches the
    reference's ``quad_form(..., R) + quad_form(..., Q) + lamb * ||.||^2``
    exactly). Constraints: ``A z = b_const + S theta``; for the CONVEX
    slack variant additionally ``|sigma_pred,i| <= c * eps_max``.
    """

    dims: QPDims
    controller_type: DataDrivenMPCType
    slack_var_constraint_type: SlackVarConstraintTypes
    use_terminal_constraint: bool

    H: np.ndarray  # (nz, nz)
    g: np.ndarray  # (nz,)
    r0: float  # constant cost offset
    A: np.ndarray  # (nc, nz)
    b_const: np.ndarray  # (nc,)
    S: np.ndarray  # (nc, n_theta) selection of the past window into b

    # Index bookkeeping (slices into z)
    alpha_slice: slice
    ubar_slice: slice
    ybar_slice: slice
    sigma_slice: Optional[slice]

    # Box bound for the CONVEX slack variant: |sigma_pred| <= sigma_bound
    sigma_bound: Optional[float]

    # The setpoints baked into g / b_const / r0 (flattened (m,) / (p,)).
    # Kept so the setpoint-parametric tracking operator
    # (qp/solution_map.py::compute_tracking_operator_np) can verify its
    # derivation against the baked values.
    u_s: Optional[np.ndarray] = None
    y_s: Optional[np.ndarray] = None

    @property
    def nz(self) -> int:
        return self.H.shape[0]

    @property
    def nc(self) -> int:
        return self.A.shape[0]

    @property
    def u_pred_slice(self) -> slice:
        """Rows of z holding ubar[0, L-1] (the optimal-input segment,
        reference :797-805)."""
        d = self.dims
        start = self.ubar_slice.start + d.n * d.m
        return slice(start, self.ubar_slice.start + (d.L + d.n) * d.m)

    @property
    def y_pred_slice(self) -> slice:
        """Rows of z holding ybar[0, L-1] (the predicted-output
        segment)."""
        d = self.dims
        start = self.ybar_slice.start + d.n * d.p
        return slice(start, self.ybar_slice.start + (d.L + d.n) * d.p)

    @property
    def sigma_pred_slice(self) -> Optional[slice]:
        """Rows of z holding sigma[0, L-1] (the box-constrained segment
        for the CONVEX variant, reference :658-675)."""
        if self.sigma_slice is None:
            return None
        d = self.dims
        return slice(self.sigma_slice.start + d.n * d.p, self.sigma_slice.stop)
