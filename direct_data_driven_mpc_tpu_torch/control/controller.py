"""Direct data-driven MPC controller (Nominal / Robust, slack ``NONE``,
``CONVEX`` or, opted in, ``NON_CONVEX``).

Counterpart of ``direct_data_driven_mpc_tpu/control/controller.py``
with the same constructor, validation rules and method names.
Construction assembles the static QP once (float64) and derives either
the exact affine solution operator (slack ``NONE``; the per-step solve
is one matvec), the pre-factorised ADMM operator (``CONVEX``; the
per-step solve is a warm-started host ADMM)
or, with ``allow_nonconvex_slack=True``, the convex-concave operator of
the paper's Eq. 6d (``NON_CONVEX``; the per-step solve is
``qp.nonconvex.nonconvex_admm_solve_np``; without the flag the
reference's ``NotImplementedError`` is raised).
The condensed engine (``control.linear_engine``) takes the affine
operator from :meth:`DirectDataDrivenMPCController.solution_operator`
and, to track a setpoint schedule, the setpoint-parametric one from
:meth:`~DirectDataDrivenMPCController.tracking_operator`; the generic
loop (``control.loop``) takes them on a device as
:meth:`~DirectDataDrivenMPCController.solution_map` and
:meth:`~DirectDataDrivenMPCController.tracking_map`; the fused ADMM
engine (``ops.fused_admm``) takes
``qp.admm.compute_admm_operator_np(controller.spec)``; the generic loop
takes the iterative operators on a device as
:meth:`~DirectDataDrivenMPCController.admm_solver`,
:meth:`~DirectDataDrivenMPCController.box_admm_solver` and
:meth:`~DirectDataDrivenMPCController.nonconvex_admm_solver`.

The per-step solve of slack ``NONE`` and ``CONVEX`` runs by default in
the C extension of ``native/`` (``solve_path="native"``), as the JAX
controller's does wherever its extension builds; a failed build raises
and never falls back. ``solve_path="numpy"`` runs it in numpy on
request, and ``NON_CONVEX`` always does (it has no C solve).
:attr:`~DirectDataDrivenMPCController.solve_path` records which ran.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from direct_data_driven_mpc_tpu_torch import native
from direct_data_driven_mpc_tpu_torch.ops.host import (
    evaluate_persistent_excitation_np,
    hankel_matrix_np,
)
from direct_data_driven_mpc_tpu_torch.qp.admm import (
    ADMMSolver,
    admm_solve_np,
    compute_admm_operator_np,
    compute_admm_solver,
)
from direct_data_driven_mpc_tpu_torch.qp.assembly import build_qp_spec
from direct_data_driven_mpc_tpu_torch.qp.box import (
    BoxADMMSolver,
    compute_box_admm_solver,
)
from direct_data_driven_mpc_tpu_torch.qp.nonconvex import (
    NonConvexADMMSolver,
    compute_nonconvex_admm_solver,
    compute_nonconvex_operator_np,
    nonconvex_admm_solve_np,
)
from direct_data_driven_mpc_tpu_torch.qp.solution_map import (
    SolutionMap,
    TrackingMap,
    compute_solution_map,
    compute_solution_operator_np,
    compute_tracking_map,
    compute_tracking_operator_np,
)
from direct_data_driven_mpc_tpu_torch.qp.spec import (
    DataDrivenMPCType,
    QPDims,
    SlackVarConstraintTypes,
)

class DirectDataDrivenMPCController:
    """Nominal / Robust direct data-driven MPC controller.

    Attributes follow the reference: ``n, m, p, u_d, y_d, N, u_past,
    y_past, L, Q, R, u_s, y_s, eps_max, lamb_alpha, lamb_sigma, c,
    slack_var_constraint_type, n_mpc_step, use_terminal_constraint,
    HLn_ud, HLn_yd, optimal_u``.
    """

    def __init__(
        self,
        n: int,
        m: int,
        p: int,
        u_d: np.ndarray,
        y_d: np.ndarray,
        L: int,
        Q: np.ndarray,
        R: np.ndarray,
        u_s: np.ndarray,
        y_s: np.ndarray,
        eps_max: Optional[float] = None,
        lamb_alpha: Optional[float] = None,
        lamb_sigma: Optional[float] = None,
        c: Optional[float] = None,
        slack_var_constraint_type: SlackVarConstraintTypes = (
            SlackVarConstraintTypes.CONVEX
        ),
        controller_type: DataDrivenMPCType = DataDrivenMPCType.NOMINAL,
        n_mpc_step: int = 1,
        use_terminal_constraint: bool = True,
        admm_iters: int = 200,
        allow_nonconvex_slack: bool = False,
        solve_path: Optional[str] = None,
    ):
        self.controller_type = controller_type
        if controller_type not in (
            DataDrivenMPCType.NOMINAL,
            DataDrivenMPCType.ROBUST,
        ):
            raise ValueError("Unsupported controller type.")

        self.n = n
        self.m = m
        self.p = p
        self.u_d = np.asarray(u_d, dtype=np.float64)
        self.y_d = np.asarray(y_d, dtype=np.float64)
        self.N = self.u_d.shape[0]

        # Past windows seeded with the last n data samples (columns).
        self.u_past = self.u_d[-n:, :].reshape(-1, 1)
        self.y_past = self.y_d[-n:, :].reshape(-1, 1)

        self.L = L
        self.Q = np.asarray(Q, dtype=np.float64)
        self.R = np.asarray(R, dtype=np.float64)
        self.u_s = np.asarray(u_s, dtype=np.float64)
        self.y_s = np.asarray(y_s, dtype=np.float64)

        self.eps_max = eps_max
        self.lamb_alpha = lamb_alpha
        self.lamb_sigma = lamb_sigma
        self.c = c

        self.slack_var_constraint_type = slack_var_constraint_type
        if slack_var_constraint_type not in (
            SlackVarConstraintTypes.NON_CONVEX,
            SlackVarConstraintTypes.CONVEX,
            SlackVarConstraintTypes.NONE,
        ):
            raise ValueError("Unsupported slack variable constraint type.")

        if self.controller_type == DataDrivenMPCType.ROBUST:
            if None in (eps_max, lamb_alpha, lamb_sigma, c):
                raise ValueError(
                    "All robust MPC parameters (eps_max, lamb_alpha, "
                    "lamb_sigma, c) must be provided for a 'ROBUST' "
                    "controller."
                )

        if not 1 <= n_mpc_step <= L:
            raise ValueError(
                f"n_mpc_step ({n_mpc_step}) must be in [1, L={L}]."
            )
        self.n_mpc_step = n_mpc_step
        self.use_terminal_constraint = use_terminal_constraint
        #: Iteration cap of the per-step ADMM solve (CONVEX slack; the
        #: inner iterations of each NON_CONVEX bound update).
        self.admm_iters = admm_iters
        #: Opt-in to the NON_CONVEX (Eq. 6d) solver; without it that
        #: slack raises, as the reference does.
        self.allow_nonconvex_slack = allow_nonconvex_slack
        nonconvex = (
            slack_var_constraint_type == SlackVarConstraintTypes.NON_CONVEX
        )
        if solve_path is None:
            solve_path = "numpy" if nonconvex else "native"
        if solve_path not in ("native", "numpy"):
            raise ValueError(
                f"solve_path must be 'native' or 'numpy'; got {solve_path!r}"
            )
        if solve_path == "native" and nonconvex:
            raise ValueError(
                "The NON_CONVEX slack has no native per-step solve; use "
                "solve_path='numpy'."
            )
        #: Which implementation runs the per-step solve: ``"native"``
        #: (the C extension of ``native/``) or ``"numpy"``.
        self.solve_path = solve_path
        self._admm_state = None
        self._status = "unsolved"
        self._cost_value: Optional[float] = None

        self.evaluate_input_persistent_excitation()
        self.check_prediction_horizon_length()
        self.check_weighting_matrices_dimensions()
        self.initialize_data_driven_mpc()

    # --- validation (reference rules) ----------------------------------
    def evaluate_input_persistent_excitation(self) -> None:
        """Persistent excitation of order ``L + 2n``: the length bound
        and the Hankel rank check."""
        u_d_n = self.u_d.shape[1]
        if u_d_n != self.m:
            raise ValueError(
                f"The length of the elements of the data sequence ({u_d_n}) "
                f"should match the number of inputs of the system "
                f"({self.m})."
            )
        N_min = self.m * (self.L + 2 * self.n) + self.L + 2 * self.n - 1
        if self.N < N_min:
            raise ValueError(
                "Initial input trajectory data is not persistently exciting "
                "of order (L + 2 * n). It does not satisfy the inequality: "
                "N - L - 2 * n + 1 >= m * (L + 2 * n). The required minimum "
                f"N is {N_min}, but got {self.N}."
            )
        expected_order = self.L + 2 * self.n
        rank, ok = evaluate_persistent_excitation_np(
            self.u_d, order=expected_order
        )
        if not ok:
            raise ValueError(
                "Initial input trajectory data is not persistently exciting "
                "of order (L + 2 * n). The rank of its induced Hankel "
                f"matrix ({rank}) does not match the expected rank "
                f"({u_d_n * expected_order})."
            )

    def check_prediction_horizon_length(self) -> None:
        """Nominal: ``L >= n``; Robust: ``L >= 2n``."""
        if self.controller_type == DataDrivenMPCType.NOMINAL:
            if self.L < self.n:
                raise ValueError(
                    "The prediction horizon (`L`) must be greater than or "
                    "equal to the estimated system order `n`."
                )
        elif self.L < 2 * self.n:
            raise ValueError(
                "The prediction horizon (`L`) must be greater than or "
                "equal to two times the estimated system order `n`."
            )

    def check_weighting_matrices_dimensions(self) -> None:
        """Q must be ``(pL, pL)``, R must be ``(mL, mL)``."""
        if self.Q.shape != (self.p * self.L, self.p * self.L):
            raise ValueError(
                "Output weighting square matrix Q should be of order (p * L)"
            )
        if self.R.shape != (self.m * self.L, self.m * self.L):
            raise ValueError(
                "Input weighting square matrix R should be of order (m * L)"
            )

    # --- construction --------------------------------------------------
    def initialize_data_driven_mpc(self) -> None:
        """Build the Hankels, assemble the static QP, derive the affine
        solution operator (or, for CONVEX slack, the ADMM operator; for
        NON_CONVEX, the convex-concave one) and validate it with an
        initial solve."""
        self.HLn_ud = hankel_matrix_np(self.u_d, self.L + self.n)
        self.HLn_yd = hankel_matrix_np(self.y_d, self.L + self.n)

        dims = QPDims(n=self.n, m=self.m, p=self.p, L=self.L, N=self.N)
        self._spec = build_qp_spec(
            self.HLn_ud,
            self.HLn_yd,
            dims,
            Q=self.Q,
            R=self.R,
            u_s=self.u_s,
            y_s=self.y_s,
            controller_type=self.controller_type,
            eps_max=self.eps_max,
            lamb_alpha=self.lamb_alpha,
            lamb_sigma=self.lamb_sigma,
            c=self.c,
            slack_var_constraint_type=self.slack_var_constraint_type,
            use_terminal_constraint=self.use_terminal_constraint,
            allow_nonconvex_slack=self.allow_nonconvex_slack,
        )
        self._use_admm = (
            self._spec.slack_var_constraint_type
            == SlackVarConstraintTypes.CONVEX
        )
        self._use_nonconvex = (
            self._spec.slack_var_constraint_type
            == SlackVarConstraintTypes.NON_CONVEX
        )
        if self._use_nonconvex:
            self._op = compute_nonconvex_operator_np(self._spec)
        elif self._use_admm:
            self._op = compute_admm_operator_np(self._spec)
        else:
            self._op = compute_solution_operator_np(self._spec)
            if not self._op["feasible"]:
                raise ValueError(
                    "MPC problem is infeasible: the equality "
                    "constraints are inconsistent (primal residuals "
                    f"{self._op['primal_residual_const']:.2e} const / "
                    f"{self._op['primal_residual_gain']:.2e} gain)."
                )
        self._admm_state = None
        self._native = None
        if self.solve_path == "native":
            self._native = (
                native.NativeADMMSolver(self._op) if self._use_admm
                else native.NativeAffineSolver(self._op)
            )
        self.update_and_solve_data_driven_mpc()

    @property
    def spec(self):
        """The assembled static QP spec."""
        return self._spec

    def solution_operator(self) -> dict:
        """The float64 affine solution operator: the entry for
        ``control.linear_engine.build_affine_block_map``. Keys:
        ``z_base, Z, u_base, U_gain, cost_P, cost_q, cost_r``. A CONVEX
        or NON_CONVEX slack controller has none and raises."""
        self._no_affine_operator(
            "use qp.admm.compute_admm_operator_np(spec) with "
            "ops.fused_admm."
        )
        return self._op

    def _no_affine_operator(self, what: str) -> None:
        if self._use_admm or self._use_nonconvex:
            raise ValueError(
                "CONVEX/NON_CONVEX slack controllers do not condense to "
                f"an affine operator; {what}"
            )

    def solution_map(self, device=None, dtype=torch.float32
                     ) -> SolutionMap:
        """The affine operator on ``device`` (None: the CUDA card) in
        ``dtype``, for ``control.loop`` (slack NONE)."""
        self._no_affine_operator(
            "use qp.admm.compute_admm_operator_np(spec) with "
            "ops.fused_admm."
        )
        return compute_solution_map(self._spec, device=device, dtype=dtype)

    def tracking_operator(self) -> dict:
        """The float64 setpoint-parametric operator: the entry for
        ``control.linear_engine.build_tracking_engine`` (``tracking_op=``
        of ``build_affine_block_map``). Keys ``U_theta, U_r, cost_P, u_s,
        y_s, ...`` (``qp.solution_map.compute_tracking_operator_np``).
        A CONVEX slack controller raises."""
        self._no_affine_operator(
            "tracking schedules need a slack-NONE controller."
        )
        return compute_tracking_operator_np(self._spec)

    def tracking_map(self, device=None, dtype=torch.float32
                     ) -> TrackingMap:
        """The setpoint-parametric operator ``u*(theta, [u_s; y_s])`` on
        ``device`` (None: the CUDA card) in ``dtype``: a per-solve
        setpoint schedule through ``control.loop.closed_loop_rollout``
        retargets the controller with no rebuild."""
        self._no_affine_operator(
            "tracking schedules need a slack-NONE controller."
        )
        return compute_tracking_map(self._spec, device=device, dtype=dtype)

    def admm_solver(self, device=None, dtype=torch.float32) -> ADMMSolver:
        """The ADMM operator on ``device`` (None: the CUDA card) in
        ``dtype``, for ``control.loop`` (CONVEX slack)."""
        if not self._use_admm:
            raise ValueError(
                "admm_solver() is the CONVEX-slack operator; slack-NONE "
                "controllers use solution_map(), NON_CONVEX ones "
                "nonconvex_admm_solver()."
            )
        return compute_admm_solver(self._spec, device=device, dtype=dtype)

    def box_admm_solver(self, u_bounds=None, y_bounds=None, rho=None,
                        alpha: float = 1.6, device=None,
                        dtype=torch.float32) -> BoxADMMSolver:
        """The general-box ADMM operator (``qp.box``) on ``device``
        (None: the CUDA card) in ``dtype``: actuator saturation ``u_min
        <= u <= u_max`` and output corridors ``y_min <= y <= y_max``
        over the free prediction steps, beyond the reference (its only
        inequality is the CONVEX slack box, which is kept when present).
        Bounds are ``(lo, hi)`` pairs of scalars or per-channel arrays,
        None meaning unbounded; ``rho`` None builds the penalty ladder.
        """
        if self._use_nonconvex:
            raise ValueError(
                "box constraints with the NON_CONVEX slack variant are "
                "not supported (its bound is state-dependent)."
            )
        return compute_box_admm_solver(
            self._spec, u_bounds=u_bounds, y_bounds=y_bounds, rho=rho,
            alpha=alpha, device=device, dtype=dtype,
        )

    def nonconvex_admm_solver(self, device=None, dtype=torch.float32
                              ) -> NonConvexADMMSolver:
        """The convex-concave operator of the NON_CONVEX slack variant
        (the paper's Eq. 6d, ``qp.nonconvex``) on ``device`` (None: the
        CUDA card) in ``dtype``; only for a controller built with
        ``allow_nonconvex_slack=True``."""
        if not self._use_nonconvex:
            raise ValueError(
                "nonconvex_admm_solver() requires a NON_CONVEX slack "
                "controller (allow_nonconvex_slack=True)."
            )
        return compute_nonconvex_admm_solver(self._spec, device=device,
                                             dtype=dtype)

    # --- per-step solve ------------------------------------------------
    def _theta(self) -> np.ndarray:
        return np.concatenate(
            [self.u_past.reshape(-1), self.y_past.reshape(-1)]
        )

    def update_and_solve_data_driven_mpc(self) -> None:
        """Solve at the current past window and store the optimal
        input sequence."""
        self.solve_mpc_problem()
        self.get_optimal_control_input()

    def solve_mpc_problem(self) -> str:
        """Solve at the current past window. Status ``optimal``;
        ``optimal_inaccurate`` when the CONVEX ADMM run hit
        ``admm_iters`` before its residuals reached 1e-8, or the
        NON_CONVEX fixed point did not converge; ``infeasible`` for a
        non-finite input."""
        theta = self._theta()
        op = self._op
        converged = True
        if self._use_nonconvex:
            u, cost, self._admm_state, stats = nonconvex_admm_solve_np(
                op, theta, inner_iters=self.admm_iters,
                state=self._admm_state,
            )
            converged = stats[-1]
        elif self._use_admm and self._native is not None:
            # The C loop mutates s and w in place: the warm start.
            if self._admm_state is None:
                nbox = self._native.nbox
                self._admm_state = (np.zeros(nbox), np.zeros(nbox))
            s, w = self._admm_state
            u, cost, _, r_prim, r_dual = self._native.solve(
                theta, s, w, self.admm_iters, 1e-8
            )
            converged = r_prim <= 1e-8 and r_dual <= 1e-8
        elif self._use_admm:
            u, cost, self._admm_state, stats = admm_solve_np(
                op, theta, num_iters=self.admm_iters,
                state=self._admm_state,
            )
            converged = stats.converged
        elif self._native is not None:
            u, cost = self._native.solve(theta)
        else:
            u = op["u_base"] + op["U_gain"] @ theta
            cost = float(
                theta @ op["cost_P"] @ theta
                + op["cost_q"] @ theta
                + op["cost_r"]
            )
        self._u_opt = u
        self._cost_value = cost
        if not np.isfinite(u).all():
            self._status = "infeasible"
        else:
            self._status = "optimal" if converged else "optimal_inaccurate"
        return self._status

    def optimal_solution(self) -> np.ndarray:
        """The full optimal decision vector ``z*`` at the current past
        window (for KKT-residual checks; slack NONE only)."""
        return self.solution_operator()["z_base"] + (
            self._op["Z"] @ self._theta()
        )

    def get_problem_solve_status(self) -> str:
        return self._status

    def get_optimal_cost_value(self) -> float:
        return self._cost_value

    def get_optimal_control_input(self) -> np.ndarray:
        """Store and return ``ubar*[0, L-1]`` flattened."""
        if self._status in ("optimal", "optimal_inaccurate"):
            self.optimal_u = self._u_opt.flatten()
            return self.optimal_u
        raise ValueError("MPC problem was not solved optimally.")

    def get_optimal_control_input_at_step(
        self, n_step: int = 0
    ) -> np.ndarray:
        """The optimal input at prediction step ``n_step`` in
        ``[0, L-1]``."""
        if not 0 <= n_step < self.L:
            raise ValueError(
                f"The specified prediction time step ({n_step}) is out of "
                f"range. It should be within [0, {self.L - 1}]."
            )
        return self.optimal_u[n_step * self.m : (n_step + 1) * self.m]

    # --- measurement window --------------------------------------------
    def store_input_output_measurement(
        self, u_current: np.ndarray, y_current: np.ndarray
    ) -> None:
        """Shift the past-n window by one measurement."""
        expected_u0 = (self.m, 1)
        expected_y0 = (self.p, 1)
        if u_current.shape != expected_u0 or y_current.shape != expected_y0:
            raise ValueError(
                f"Incorrect dimensions. Expected dimensions are "
                f"{expected_u0} for u_current and {expected_y0} for "
                f"y_current, but got {u_current.shape} and "
                f"{y_current.shape} instead."
            )
        self.u_past = np.vstack([self.u_past[self.m :], u_current])
        self.y_past = np.vstack([self.y_past[self.p :], y_current])

    def set_past_input_output_data(
        self, u_past: np.ndarray, y_past: np.ndarray
    ) -> None:
        """Set the whole past window."""
        expected_u = (self.n * self.m, 1)
        expected_y = (self.n * self.p, 1)
        if u_past.shape != expected_u:
            raise ValueError(
                f"Incorrect dimensions. u_past must be shaped as "
                f"{expected_u}. Got {u_past.shape}. instead"
            )
        if y_past.shape != expected_y:
            raise ValueError(
                f"Incorrect dimensions. y_past must be shaped as "
                f"{expected_y}. Got {y_past.shape} instead."
            )
        self.u_past = np.asarray(u_past, dtype=np.float64)
        self.y_past = np.asarray(y_past, dtype=np.float64)

    def set_input_output_setpoints(
        self, u_s: np.ndarray, y_s: np.ndarray
    ) -> None:
        """Retarget: swap the setpoints and rebuild the QP and its
        operator (one KKT factorisation; the past window is kept)."""
        if u_s.shape != self.u_s.shape:
            raise ValueError(
                f"Incorrect dimensions. u_s must have shape "
                f"{self.u_s.shape}, got {u_s.shape}"
            )
        if y_s.shape != self.y_s.shape:
            raise ValueError(
                f"Incorrect dimensions. y_s must have shape "
                f"{self.y_s.shape}, got {y_s.shape}"
            )
        self.u_s = np.asarray(u_s, dtype=np.float64)
        self.y_s = np.asarray(y_s, dtype=np.float64)
        self.initialize_data_driven_mpc()
