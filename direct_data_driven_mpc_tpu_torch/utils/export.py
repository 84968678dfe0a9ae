"""Controller export for the standalone C deployment runtime.

A controller runs in deployment on an embedded or real-time host with
no Python. What it needs there is the condensed per-step operator that
the float64 build derived (``qp/solution_map.py``, ``qp/admm.py``) and
the measurement window. :func:`export_controller` writes exactly that
into a binary blob, which ``native/ddmpc_runtime.c`` (pure C99) loads
and runs: one ``ddmpc_solve`` and one ``ddmpc_observe`` per control
step. Counterpart of ``direct_data_driven_mpc_tpu/utils/export.py``;
the blob is the same, field for field.

Blob layout (little-endian, fixed order; see ddmpc_runtime.c):

    magic   8 bytes   b"DDMPCRT1"
    u32 x10           kind (0 affine / 1 admm), n, m, p, L,
                      n_mpc_step, ns (0 = no plant block), nbox,
                      admm_iters, reserved
    f64 x6            cost_r, bound, rho, alpha, tol, eps_max
    f64 arrays        u_past (n*m), y_past (n*p)
      kind 0:         u_base (L*m), U_gain (L*m, nt), cost_P (nt, nt),
                      cost_q (nt)                     [nt = n*(m+p)]
      kind 1:         v_c (nbox), V_theta (nbox, nt), V_s (nbox, nbox),
                      u_c (L*m), U_theta (L*m, nt), U_s (L*m, nbox),
                      cost_P (nt+nbox, nt+nbox), cost_q (nt+nbox)
      if ns > 0:      A (ns, ns), B (ns, m), C (p, ns), D (p, m),
                      x0 (ns)
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"DDMPCRT1"


def export_controller(
    controller,
    path: str,
    plant=None,
    x0: np.ndarray | None = None,
    tol: float = 1e-8,
) -> None:
    """Write ``controller``'s condensed per-step operator (and, given,
    a plant for closed-loop simulation and tests) in the C runtime's
    blob format.

    Args:
        controller: a
            :class:`~direct_data_driven_mpc_tpu_torch.control.controller.DirectDataDrivenMPCController`
            with slack ``NONE`` (the affine operator) or ``CONVEX`` (the
            ADMM operator). Its current measurement window is written,
            so the C runtime resumes where the Python controller stands.
        path: the file to write.
        plant: an optional
            :class:`~direct_data_driven_mpc_tpu_torch.models.lti_model.LTIModel`
            whose ``A, B, C, D`` and ``eps_max`` are embedded, so the C
            demo can run a whole closed loop; a deployment omits it (the
            physical system is the plant).
        x0: the plant state to embed (default: the plant's current
            state).
        tol: the ADMM exit tolerance of the blob (kind 1 only).

    Raises:
        ValueError: for a ``NON_CONVEX`` slack controller, which has no
            operator that the C runtime runs.
    """
    if controller._use_nonconvex:
        raise ValueError(
            "export_controller: the NON_CONVEX slack has no operator that "
            "the C runtime runs; export a slack NONE or CONVEX controller."
        )
    op = controller._op
    use_admm = controller._use_admm
    n, m, p, L = controller.n, controller.m, controller.p, controller.L
    nt = n * (m + p)
    nbox = int(op["v_c"].shape[0]) if use_admm else 0

    ns = 0
    plant_arrays: list[np.ndarray] = []
    eps_max = 0.0
    if plant is not None:
        A = np.asarray(plant.A, dtype=np.float64)
        ns = A.shape[0]
        x0_arr = np.asarray(
            plant.get_state() if x0 is None else x0, dtype=np.float64
        ).reshape(ns)
        eps_max = float(plant.get_eps_max())
        plant_arrays = [
            A,
            np.asarray(plant.B, dtype=np.float64).reshape(ns, m),
            np.asarray(plant.C, dtype=np.float64).reshape(p, ns),
            np.asarray(plant.D, dtype=np.float64).reshape(p, m),
            x0_arr,
        ]

    header = MAGIC + struct.pack(
        "<10I",
        1 if use_admm else 0,
        n, m, p, L,
        controller.n_mpc_step,
        ns,
        nbox,
        int(controller.admm_iters) if use_admm else 0,
        0,
    )
    scalars = struct.pack(
        "<6d",
        float(op["cost_r"]),
        float(op["bound"]) if use_admm else 0.0,
        float(op["rho"]) if use_admm else 0.0,
        float(op.get("alpha", 1.0)) if use_admm else 0.0,
        float(tol),
        eps_max,
    )

    arrays = [
        np.asarray(controller.u_past, dtype=np.float64).reshape(n * m),
        np.asarray(controller.y_past, dtype=np.float64).reshape(n * p),
    ]
    if use_admm:
        arrays += [
            op["v_c"].reshape(nbox),
            op["V_theta"].reshape(nbox, nt),
            op["V_s"].reshape(nbox, nbox),
            op["u_c"].reshape(L * m),
            op["U_theta"].reshape(L * m, nt),
            op["U_s"].reshape(L * m, nbox),
            op["cost_P"].reshape(nt + nbox, nt + nbox),
            op["cost_q"].reshape(nt + nbox),
        ]
    else:
        arrays += [
            op["u_base"].reshape(L * m),
            op["U_gain"].reshape(L * m, nt),
            op["cost_P"].reshape(nt, nt),
            op["cost_q"].reshape(nt),
        ]
    arrays += plant_arrays

    with open(path, "wb") as f:
        f.write(header)
        f.write(scalars)
        for a in arrays:
            f.write(np.ascontiguousarray(a, dtype="<f8").tobytes())
