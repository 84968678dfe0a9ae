"""Condensed linear closed-loop engine.

For slack-``NONE`` controllers the per-step QP solution is an exact
affine map of the past window, and the plant is linear, so the whole
closed loop (plant state plus measurement window under MPC feedback)
is an affine time-invariant recursion

    s_{t+1} = M s_t + c + N w_t,        s = [x; u_past; y_past]
    [u_t; y_t] = O_s s_t + o_c + O_w w_t

with ``s`` only ``ns + n(m+p)`` numbers (20 for the four-tank plant).
:func:`build_affine_block_map` composes it in float64 on the host over
``solves_per_block`` solves of ``n_mpc_step`` plant steps each, then
casts it onto one device. :func:`linear_batched_rollout` rolls it out
with the batch as the leading dimension of every product; it is the
plain reference that the fused engine (``ops.fused_rollout``) is held
against. :func:`linear_closed_loop_rollout` is its single-scenario form,
and :func:`time_parallel_rollout` computes one scenario's whole
trajectory in O(log T) depth: a prefix scan of the per-block affine
maps.

A tracking map (``tracking_op=``, :func:`build_tracking_engine`) has a
setpoint channel: the block's setpoint delta ``dr = [u_s; y_s] - r_bar``
rides ``n_r = m + p`` input lanes after the block's noise, and the
per-solve cost is the joint quadratic in ``[theta; dr]``. The engines
then take a setpoint schedule: constant ``(n_r,)``, per outer block
``(n_outer, n_r)`` or per scenario and block ``(B, n_outer, n_r)``.

Counterpart of ``direct_data_driven_mpc_tpu/control/linear_engine.py``
(``AffineBlockMap``, ``build_affine_block_map``, ``build_linear_engine``,
``build_tracking_engine``, ``closed_loop_spectrum``,
``linear_closed_loop_rollout`` with explicit noise or noise drawn block
by block, ``time_parallel_rollout``, ``make_linear_batched_rollout``),
with its Monte-Carlo aggregate mode (``emit_trajectories=False``) and its
``precision`` names (both IEEE float32 here, ``ops.precision``).
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from direct_data_driven_mpc_tpu_torch.control.loop import (
    ClosedLoopResult,
    setpoint_schedule,
)
from direct_data_driven_mpc_tpu_torch.device import resolve_device
from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams
from direct_data_driven_mpc_tpu_torch.ops.precision import (
    check_precision,
    ieee_float32,
)
from direct_data_driven_mpc_tpu_torch.parallel.batch import (
    draw_block_noise,
)


class AffineBlockMap(NamedTuple):
    """Condensed multi-solve block map, every tensor on one device.

    Row convention (batch leads):
        s'      = s @ M_T   + c    + w @ N_T
        u_block = s @ OuS_T + ou_c + w @ OuW_T   (K * nb * m outputs)
        y_block = s @ OyS_T + oy_c + w @ OyW_T   (K * nb * p outputs)
        s_stack = s @ OsS_T + os_c + w @ OsW_T   (K * S: the state at
                                                  each solve time)
    with ``w`` the flattened noise of the whole block (K * nb * p), and
    for a tracking map the block's setpoint delta after it (n_r more
    lanes). The cost of one solve at state ``s`` is, with ``xi =
    theta = s[ns:]`` (``xi = [theta; dr]`` for a tracking map),
    ``xi P xi + q . xi + r``.
    """

    M_T: torch.Tensor
    c: torch.Tensor
    N_T: torch.Tensor
    OuS_T: torch.Tensor
    ou_c: torch.Tensor
    OuW_T: torch.Tensor
    OyS_T: torch.Tensor
    oy_c: torch.Tensor
    OyW_T: torch.Tensor
    OsS_T: torch.Tensor
    os_c: torch.Tensor
    OsW_T: torch.Tensor
    cost_P: torch.Tensor  # (n_theta [+ n_r], n_theta [+ n_r])
    cost_q: torch.Tensor  # (n_theta [+ n_r],)
    cost_r: torch.Tensor  # ()
    s_star: torch.Tensor  # (S,) center point (zeros when uncentered)
    #: Setpoint-channel width; 0 for a plain map. When > 0 the last
    #: ``n_r`` rows of every ``*W_T`` operator act on the block's setpoint
    #: delta ``dr = [u_s; y_s] - r_bar`` and the cost is joint in
    #: ``[theta; dr]`` (``tracking_op=`` of build_affine_block_map).
    n_r: int = 0
    r_bar: Optional[torch.Tensor] = None  # (m+p,) center setpoints


def block_map_from_numpy(arrays: dict, device, dtype=torch.float32
                         ) -> AffineBlockMap:
    """An :class:`AffineBlockMap` from a dict of numpy arrays keyed by
    the field names (for instance the fields of the JAX package's
    ``AffineBlockMap``), cast onto ``device`` in ``dtype``."""
    fields = {}
    for name in AffineBlockMap._fields:
        value = arrays.get(name)
        if name == "n_r":
            fields[name] = int(value or 0)
        elif value is None:
            if name != "r_bar":
                raise KeyError(f"block map lacks field {name!r}")
            fields[name] = None
        else:
            fields[name] = torch.as_tensor(
                np.array(value), dtype=dtype, device=device
            )
    return AffineBlockMap(**fields)


def build_affine_block_map(
    plant: LTIParams,
    solution_op: dict,
    n: int,
    m: int,
    p: int,
    n_mpc_step: int = 1,
    solves_per_block: int = 1,
    center: bool = True,
    device=None,
    dtype=torch.float32,
    tracking_op: Optional[dict] = None,
) -> AffineBlockMap:
    """Compose ``solves_per_block`` solve blocks into one affine map
    (host, float64) and cast it onto ``device`` in ``dtype``.

    Args:
        plant: LTI plant matrices (the simulated true system; its state
            dimension may differ from the controller's model order).
        solution_op: the float64 operator dict of
            ``compute_solution_operator_np`` (slack-NONE controllers).
        n, m, p: controller model order / input / output dimensions.
        n_mpc_step: plant steps per QP solve.
        solves_per_block: QP solves composed per block.
        center: roll the deviation from the closed-loop fixed point.
        device: where the map lives; None means the CUDA card (raises
            without one), ``"cpu"`` runs the plain versions.
        tracking_op: the float64 dict of ``compute_tracking_operator_np``
            for a setpoint channel: ``n_r = m + p`` input lanes after the
            block noise carry ``dr = [u_s; y_s] - r_bar`` (``r_bar`` the
            spec's baked setpoints) through ``U_r``, and the cost becomes
            joint in ``[theta; dr]``. At ``dr = 0`` the map is the plain
            one (both checked here in float64).
    """
    device = resolve_device(device)
    A = np.asarray(plant.A, dtype=np.float64)
    B = np.asarray(plant.B, dtype=np.float64)
    C = np.asarray(plant.C, dtype=np.float64)
    Dm = np.asarray(plant.D, dtype=np.float64)
    ns = A.shape[0]
    n_theta = n * (m + p)
    S = ns + n_theta
    nb = n_mpc_step
    K = solves_per_block
    nw = K * nb * p
    n_r = (m + p) if tracking_op is not None else 0
    # Homogeneous coordinates [s; 1; w_block; dr].
    Dfull = S + 1 + nw + n_r

    # Each tracked quantity is a matrix acting on [s; 1; w; dr].
    X = np.zeros((ns, Dfull))
    X[:, :ns] = np.eye(ns)
    TH = np.zeros((n_theta, Dfull))
    TH[:, ns : ns + n_theta] = np.eye(n_theta)
    ONE = np.zeros(Dfull)
    ONE[S] = 1.0

    if nb * m > solution_op["U_gain"].shape[0]:
        raise ValueError(
            f"n_mpc_step ({nb}) exceeds the optimized horizon "
            f"(L = {solution_op['U_gain'].shape[0] // m})."
        )
    U_gain = solution_op["U_gain"][: nb * m]  # (nb*m, n_theta)
    u_base = solution_op["u_base"][: nb * m]
    if tracking_op is not None:
        U_r_all = np.asarray(tracking_op["U_r"], np.float64)
        U_r = U_r_all[: nb * m]
        r_bar = np.concatenate([
            np.asarray(tracking_op["u_s"], np.float64).ravel(),
            np.asarray(tracking_op["y_s"], np.float64).ravel(),
        ])
        # The tracking operator has no constant term: at r_bar it must
        # give the baked affine solve.
        if not np.allclose((U_r_all @ r_bar)[: nb * m], u_base, atol=1e-9):
            raise AssertionError(
                "tracking operator is inconsistent with the baked "
                "solution operator at the spec's own setpoints"
            )
        DR = np.zeros((n_r, Dfull))
        DR[:, S + 1 + nw :] = np.eye(n_r)

    out_u = np.zeros((K * nb * m, Dfull))
    out_y = np.zeros((K * nb * p, Dfull))
    out_s = np.zeros((K * S, Dfull))
    for k in range(K):
        # State at this solve time (pre-solve), for the per-solve cost.
        out_s[k * S : (k + 1) * S] = np.concatenate([X, TH], axis=0)
        USEQ = U_gain @ TH + np.outer(u_base, ONE)
        if tracking_op is not None:
            USEQ = USEQ + U_r @ DR
        for j in range(nb):
            t = k * nb + j
            Uj = USEQ[j * m : (j + 1) * m]  # (m, Dfull)
            Wj = np.zeros((p, Dfull))
            Wj[:, S + 1 + t * p : S + 1 + (t + 1) * p] = np.eye(p)
            Yj = C @ X + Dm @ Uj + Wj
            X = A @ X + B @ Uj
            # Shift the measurement window: drop oldest, append current.
            TH = np.concatenate(
                [TH[m : n * m], Uj, TH[n * m + p :], Yj], axis=0
            )
            out_u[t * m : (t + 1) * m] = Uj
            out_y[t * p : (t + 1) * p] = Yj

    SP = np.concatenate([X, TH], axis=0)  # (S, Dfull)

    def split(Mrows):
        return Mrows[:, :S], Mrows[:, S], Mrows[:, S + 1 :]

    M_, c_, N_ = split(SP)
    OuS, ou_c, OuW = split(out_u)
    OyS, oy_c, OyW = split(out_y)
    OsS, os_c, OsW = split(out_s)

    if center:
        # Re-center on the closed-loop fixed point s* = M s* + c, so the
        # float32 rollout carries the deviation, which decays toward
        # the noise floor, instead of setpoint-sized coordinates.
        #
        # Guard: with a closed-loop eigenvalue near 1 (an uncontrolled
        # integrator mode, or the UCON scheme) I - M is (near-)singular
        # and s* is huge or non-finite; the deviation would then be a
        # cancellation of two huge numbers. Fall back to the uncentered
        # map with a warning.
        IM = np.eye(S) - M_
        cond_IM = np.linalg.cond(IM)
        if np.isfinite(cond_IM) and cond_IM < 1e8:
            s_star = np.linalg.solve(IM, c_)
        else:
            s_star = np.full(S, np.nan)
        s_scale = 1.0 + float(np.abs(c_).max(initial=0.0))
        if not (
            np.all(np.isfinite(s_star))
            and float(np.abs(s_star).max(initial=0.0)) < 1e6 * s_scale
        ):
            warnings.warn(
                "closed-loop fixed point is ill-conditioned "
                f"(cond(I - M) = {cond_IM:.2e}); centering disabled -- "
                "the loop has an eigenvalue at/near 1 (marginally "
                "stable or unstable scheme). Rolling absolute "
                "coordinates instead.",
                RuntimeWarning,
                stacklevel=2,
            )
            s_star = np.zeros(S)
        ou_c = ou_c + OuS @ s_star
        oy_c = oy_c + OyS @ s_star
        os_c = os_c + OsS @ s_star
        c_ = c_ - (s_star - M_ @ s_star)
    else:
        s_star = np.zeros(S)

    if tracking_op is not None:
        # Joint cost in zeta = [theta; dr]: with xi = [theta; r_bar + dr]
        # and cost(xi) = xi' P xi, cost(zeta) = zeta' P zeta + (2 P e) .
        # zeta + e' P e, e = [0; r_bar], which at dr = 0 is the baked
        # theta-space cost.
        P_j = np.asarray(tracking_op["cost_P"], np.float64)
        e = np.concatenate([np.zeros(n_theta), r_bar])
        cost_P, cost_q = P_j, 2.0 * (P_j @ e)
        cost_r = np.float64(e @ P_j @ e)
        if not (
            np.allclose(P_j[:n_theta, :n_theta], solution_op["cost_P"],
                        atol=1e-9)
            and np.allclose(cost_q[:n_theta], solution_op["cost_q"],
                            atol=1e-9)
            and abs(cost_r - float(solution_op["cost_r"])) < 1e-7
        ):
            raise AssertionError(
                "joint tracking cost does not reduce to the baked "
                "theta-space cost at dr = 0"
            )
    else:
        r_bar = None
        cost_P = solution_op["cost_P"]
        cost_q = solution_op["cost_q"]
        cost_r = solution_op["cost_r"]

    def cast(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return AffineBlockMap(
        M_T=cast(M_.T),
        c=cast(c_),
        N_T=cast(N_.T),
        OuS_T=cast(OuS.T),
        ou_c=cast(ou_c),
        OuW_T=cast(OuW.T),
        OyS_T=cast(OyS.T),
        oy_c=cast(oy_c),
        OyW_T=cast(OyW.T),
        OsS_T=cast(OsS.T),
        os_c=cast(os_c),
        OsW_T=cast(OsW.T),
        cost_P=cast(cost_P),
        cost_q=cast(cost_q),
        cost_r=cast(cost_r),
        s_star=cast(s_star),
        n_r=n_r,
        r_bar=None if r_bar is None else cast(r_bar),
    )


def build_linear_engine(
    controller,
    plant: LTIParams,
    n_mpc_step: Optional[int] = None,
    solves_per_block: int = 1,
    center: bool = True,
    device=None,
    dtype=torch.float32,
) -> AffineBlockMap:
    """Block map straight from a slack-NONE
    ``DirectDataDrivenMPCController``: its dimensions, its solve cadence
    (unless ``n_mpc_step`` is given) and its float64 solution
    operator."""
    if n_mpc_step is None:
        n_mpc_step = controller.n_mpc_step
    return build_affine_block_map(
        plant,
        controller.solution_operator(),
        n=controller.n,
        m=controller.m,
        p=controller.p,
        n_mpc_step=n_mpc_step,
        solves_per_block=solves_per_block,
        center=center,
        device=device,
        dtype=dtype,
    )


def build_tracking_engine(
    controller,
    plant: LTIParams,
    n_mpc_step: Optional[int] = None,
    solves_per_block: int = 1,
    center: bool = True,
    device=None,
    dtype=torch.float32,
) -> AffineBlockMap:
    """Block map with a setpoint channel (``n_r = m + p``) straight from
    a slack-NONE controller: the engines then take a setpoint schedule,
    one ``[u_s; y_s]`` per outer block of ``solves_per_block *
    n_mpc_step`` plant steps (for a per-solve schedule, use
    ``control.loop.closed_loop_rollout`` with ``controller.tracking_map()``).
    """
    if n_mpc_step is None:
        n_mpc_step = controller.n_mpc_step
    return build_affine_block_map(
        plant,
        controller.solution_operator(),
        n=controller.n,
        m=controller.m,
        p=controller.p,
        n_mpc_step=n_mpc_step,
        solves_per_block=solves_per_block,
        center=center,
        device=device,
        dtype=dtype,
        tracking_op=controller.tracking_operator(),
    )


def closed_loop_spectrum(block_map: AffineBlockMap) -> dict:
    """Eigen-analysis of the condensed closed-loop transition matrix.

    The controller and plant condense to ``s' = M s + c + N w``, so the
    loop is asymptotically stable (per solve block) exactly when the
    spectral radius of ``M`` is below 1: a certificate at construction
    time, where the reference can only watch a run diverge (its UCON
    scheme).

    Returns ``{"spectral_radius", "stable", "eigenvalues"}``, the
    eigenvalues of ``M_T`` in float64, read back to the host (numpy).
    """
    M = block_map.M_T.detach().to("cpu", torch.float64).numpy().T
    eigs = np.linalg.eigvals(M)
    radius = float(np.abs(eigs).max())
    return {
        "spectral_radius": radius,
        "stable": bool(radius < 1.0),
        "eigenvalues": eigs,
    }


def _block_meta(block_map: AffineBlockMap, p: int):
    """``(S, K, nb)``: state width, solves per block and plant steps per
    solve, read off the operator shapes."""
    S = block_map.M_T.shape[0]
    K = block_map.os_c.shape[0] // S
    nb = block_map.oy_c.shape[0] // (K * p)
    return S, K, nb


def _setpoint_deltas(block_map: AffineBlockMap, setpoints, n_outer: int,
                     Bsz: int, where: str) -> Optional[torch.Tensor]:
    """Check a setpoint schedule against the map's setpoint channel and
    return the deltas ``dr = r - r_bar`` as ``(B or 1, n_outer, n_r)``
    on the map's device in its dtype; None for a plain map, which takes
    no schedule. A tracking map needs one: ``(n_r,)`` constant,
    ``(n_outer, n_r)`` per outer block or ``(B, n_outer, n_r)`` per
    scenario and block of absolute setpoints ``[u_s; y_s]``."""
    n_r = block_map.n_r
    if n_r == 0:
        if setpoints is not None:
            raise ValueError(
                f"{where}: `setpoints` schedules require a tracking "
                "block map (build with tracking_op=... / "
                "build_tracking_engine)."
            )
        return None
    if setpoints is None:
        raise ValueError(
            f"{where}: tracking block map (n_r > 0) requires a "
            f"`setpoints` schedule: ({n_r},) constant, ({n_outer}, {n_r}) "
            f"per outer block or ({Bsz}, {n_outer}, {n_r}) per scenario."
        )
    R = setpoint_schedule(
        setpoints, n_outer, n_r, Bsz, block_map.M_T.dtype,
        block_map.M_T.device,
        f"{where}: setpoints must have shape ({n_r},), ({n_outer}, {n_r}) "
        f"or ({Bsz}, {n_outer}, {n_r})",
    )
    return R - block_map.r_bar


@ieee_float32()
def linear_batched_rollout(
    block_map: AffineBlockMap,
    x0s: torch.Tensor,  # (B, ns)
    u_pasts: torch.Tensor,  # (B, n, m)
    y_pasts: torch.Tensor,  # (B, n, p)
    Ws: Optional[torch.Tensor],  # (B, n_steps, p)
    n_steps: int,
    n_mpc_step: int = 1,
    setpoints=None,
    generator: Optional[torch.Generator] = None,
    eps_max: float = 0.0,
    noise_rows: Optional[Tuple[int, int]] = None,
    emit_trajectories: bool = True,
) -> ClosedLoopResult:
    """Batched rollout of the condensed recursion.

    Each block is a handful of ``(B, S + K nb p)``-wide products
    covering K solves; outputs are trimmed to ``n_steps`` (and the
    per-solve costs to ``ceil(n_steps / n_mpc_step)``).

    Noise: ``Ws`` explicitly, or (``Ws=None``) ``eps_max * U[-1, 1]``
    drawn block by block from ``generator`` inside the loop
    (:func:`~direct_data_driven_mpc_tpu_torch.parallel.batch.draw_block_noise`,
    one ``(B, K nb p)`` draw per outer block, padded steps included), so
    the ``(B, n_steps, p)`` noise is never built. ``noise_rows=(B_all,
    first)``: this batch is rows ``first`` to ``first + B - 1`` of a
    batch of ``B_all`` (a shard, ``parallel.mesh``); each block draws the
    whole batch's noise and keeps these rows, so a sharded run draws what
    the unsharded one does. ``setpoints``: the
    schedule of a tracking map (see :func:`_setpoint_deltas`); its deltas
    ride the last ``n_r`` lanes of each block's ``w`` and each solve's
    cost is the joint ``[theta; dr]`` quadratic.

    ``emit_trajectories=False`` is the Monte-Carlo aggregate mode: the
    per-step u and y products are not computed and ``u_sys``/``y_sys``
    come back empty, ``(B, 0, m)`` and ``(B, 0, p)``. The costs and the
    final state are the same products in the same order, so they equal
    the full mode's bit for bit.
    """
    bm = block_map
    dtype, device = bm.M_T.dtype, bm.M_T.device
    Bsz, n, m = u_pasts.shape
    p = y_pasts.shape[2]
    S, K, nb = _block_meta(bm, p)
    if nb != n_mpc_step:
        raise ValueError(
            f"block map built for n_mpc_step={nb}, called with "
            f"{n_mpc_step}"
        )
    ns = S - n * (m + p)
    steps_per_outer = K * nb
    n_solves = math.ceil(n_steps / nb)
    n_outer = math.ceil(n_steps / steps_per_outer)
    DR = _setpoint_deltas(bm, setpoints, n_outer, Bsz,
                          "linear_batched_rollout")
    if DR is not None:
        DR = DR.expand(Bsz, n_outer, bm.n_r)

    if Ws is None:
        if generator is None:
            raise ValueError("Provide either Ws or a generator.")
    else:
        W = torch.zeros(
            (Bsz, n_outer * steps_per_outer, p), dtype=dtype,
            device=device,
        )
        W[:, :n_steps] = Ws.to(dtype)
        W = W.view(Bsz, n_outer, steps_per_outer * p)
    s = torch.cat(
        [x0s.reshape(Bsz, -1), u_pasts.reshape(Bsz, -1),
         y_pasts.reshape(Bsz, -1)], dim=1,
    ).to(dtype) - bm.s_star

    # The aggregate mode's trajectories are empty from the start.
    n_traj = n_outer if emit_trajectories else 0
    U = torch.empty((Bsz, n_traj, K * nb * m), dtype=dtype, device=device)
    Y = torch.empty((Bsz, n_traj, K * nb * p), dtype=dtype, device=device)
    Cst = torch.empty((Bsz, n_outer, K), dtype=dtype, device=device)
    for t in range(n_outer):
        if Ws is None:
            B_all, first = noise_rows or (Bsz, 0)
            w = draw_block_noise(generator, B_all, steps_per_outer * p,
                                 eps_max, device, dtype)[first:first + Bsz]
        else:
            w = W[:, t]
        st = s @ bm.OsS_T + bm.os_c
        if DR is None:
            st = st + w @ bm.OsW_T
            xi = st.view(Bsz, K, S)[:, :, ns:]
        else:
            w = torch.cat([w, DR[:, t]], dim=1)
            st = st + w @ bm.OsW_T
            xi = torch.cat([st.view(Bsz, K, S)[:, :, ns:],
                            DR[:, t, None].expand(Bsz, K, bm.n_r)], dim=2)
        Cst[:, t] = (
            ((xi @ bm.cost_P) * xi).sum(-1) + xi @ bm.cost_q + bm.cost_r
        )
        if emit_trajectories:
            U[:, t] = s @ bm.OuS_T + bm.ou_c + w @ bm.OuW_T
            Y[:, t] = s @ bm.OyS_T + bm.oy_c + w @ bm.OyW_T
        s = s @ bm.M_T + bm.c + w @ bm.N_T
    s_fin = s + bm.s_star
    costs = Cst.reshape(Bsz, -1)[:, :n_solves]
    return ClosedLoopResult(
        u_sys=U.reshape(Bsz, n_traj * K * nb, m)[:, :n_steps],
        y_sys=Y.reshape(Bsz, n_traj * K * nb, p)[:, :n_steps],
        costs=costs,
        converged=torch.isfinite(costs),
        x_final=s_fin[:, :ns],
        u_past=s_fin[:, ns : ns + n * m].reshape(Bsz, n, m),
        y_past=s_fin[:, ns + n * m :].reshape(Bsz, n, p),
    )


def make_linear_batched_rollout(
    block_map: AffineBlockMap,
    n_steps: int,
    n_mpc_step: int = 1,
    use_rng_noise: bool = False,
    eps_max: float = 0.0,
    emit_trajectories: bool = True,
    precision: str = "highest",
    setpoints=None,
):
    """``run(x0s, u_pasts, y_pasts, noise) -> ClosedLoopResult`` over the
    condensed recursion (see :func:`linear_batched_rollout`). ``noise``
    is the explicit ``(B, n_steps, p)`` noise or, with
    ``use_rng_noise=True``, a ``torch.Generator`` on the map's device
    from which each block's ``eps_max``-bounded noise is drawn.
    ``emit_trajectories=False``: the aggregate mode, ``u_sys`` and
    ``y_sys`` empty, ``(B, 0, m)`` and ``(B, 0, p)``. ``precision``:
    "highest" or "high", both IEEE float32
    (:func:`~direct_data_driven_mpc_tpu_torch.ops.precision.check_precision`).
    ``setpoints``: a tracking map's schedule, ``(n_r,)``, ``(n_outer,
    n_r)`` or per scenario ``(B, n_outer, n_r)``."""
    check_precision(precision)

    def run(x0s, u_pasts, y_pasts, noise):
        kw = dict(n_steps=n_steps, n_mpc_step=n_mpc_step,
                  setpoints=setpoints, emit_trajectories=emit_trajectories)
        if use_rng_noise:
            return linear_batched_rollout(
                block_map, x0s, u_pasts, y_pasts, None, generator=noise,
                eps_max=eps_max, **kw,
            )
        return linear_batched_rollout(
            block_map, x0s, u_pasts, y_pasts, noise, **kw,
        )

    return run


def _scenario(block_map: AffineBlockMap, x0, u_past, y_past):
    """One scenario's ``x0``, ``u_past (n, m)`` and ``y_past (n, p)`` as
    tensors on the map's device in its dtype."""
    like = dict(dtype=block_map.M_T.dtype, device=block_map.M_T.device)
    return (torch.as_tensor(x0, **like).reshape(-1),
            torch.as_tensor(u_past, **like),
            torch.as_tensor(y_past, **like))


def linear_closed_loop_rollout(
    block_map: AffineBlockMap,
    x0,
    u_past,
    y_past,
    W=None,
    n_steps: int = 0,
    n_mpc_step: int = 1,
    generator: Optional[torch.Generator] = None,
    eps_max: float = 0.0,
    emit_trajectories: bool = True,
    precision: str = "highest",
    setpoints=None,
) -> ClosedLoopResult:
    """One scenario through the condensed recursion: ``x0 (ns,)``,
    ``u_past (n, m)``, ``y_past (n, p)`` and noise ``W (n_steps, p)``
    explicitly, or drawn block by block from ``generator`` (bounded by
    ``eps_max``). :func:`linear_batched_rollout` at B = 1 on the map's
    device; the result's fields are unbatched: ``u_sys (n_steps, m)``
    (``(0, m)`` with ``emit_trajectories=False``), ``costs (ceil(n_steps
    / n_mpc_step),)``, ``x_final (ns,)``, ``u_past (n, m)`` and so on.
    ``precision``: as in :func:`make_linear_batched_rollout`.
    ``setpoints``: a tracking map's schedule, ``(n_r,)`` or ``(n_outer,
    n_r)``."""
    check_precision(precision)
    x0, u_past, y_past = _scenario(block_map, x0, u_past, y_past)
    if W is not None:
        W = torch.as_tensor(W, dtype=x0.dtype, device=x0.device)[None]
    res = linear_batched_rollout(
        block_map, x0[None], u_past[None], y_past[None], W, n_steps,
        n_mpc_step=n_mpc_step, setpoints=setpoints, generator=generator,
        eps_max=eps_max, emit_trajectories=emit_trajectories,
    )
    return ClosedLoopResult(*(f[0] for f in res[:7]))


@ieee_float32()
def time_parallel_rollout(
    block_map: AffineBlockMap,
    x0,
    u_past,
    y_past,
    W,
    n_steps: int,
    n_mpc_step: int = 1,
    setpoints=None,
) -> ClosedLoopResult:
    """One scenario's whole trajectory in O(log T) depth, on the map's
    device; the same result as :func:`linear_closed_loop_rollout` with
    explicit noise ``W (n_steps, p)``.

    Each outer block is the affine map ``s -> s @ M_T + b_t`` with ``b_t
    = c + w_t @ N_T``, and affine maps compose associatively: ``(A1, b1)
    then (A2, b2)`` is ``(A1 @ A2, b1 @ A2 + b2)``. A Hillis-Steele
    prefix scan turns the per-block pairs into the map from ``s0`` to
    the state after every block in ceil(log2 n_outer) rounds of one
    batched product each; the outputs and per-solve costs then come from
    the states before each block in a few products. That is O(T S^3)
    operations against the sequential O(T S^2), for a depth of log T.
    ``setpoints``: a tracking map's schedule, ``(n_r,)`` or ``(n_outer,
    n_r)``; its deltas are more input lanes, which the scan does not
    see.
    """
    bm = block_map
    dtype, device = bm.M_T.dtype, bm.M_T.device
    x0, u_past, y_past = _scenario(bm, x0, u_past, y_past)
    n, m = u_past.shape
    p = y_past.shape[1]
    S, K, nb = _block_meta(bm, p)
    if nb != n_mpc_step:
        raise ValueError(
            f"block map built for n_mpc_step={nb}, called with "
            f"{n_mpc_step}"
        )
    ns = S - n * (m + p)
    steps_per_outer = K * nb
    n_solves = math.ceil(n_steps / nb)
    n_outer = math.ceil(n_steps / steps_per_outer)
    DR = _setpoint_deltas(bm, setpoints, n_outer, 1,
                          "time_parallel_rollout")

    Wp = torch.zeros((n_outer * steps_per_outer, p), dtype=dtype,
                     device=device)
    Wp[:n_steps] = torch.as_tensor(W, dtype=dtype, device=device)
    Wp = Wp.view(n_outer, steps_per_outer * p)
    if DR is not None:
        Wp = torch.cat([Wp, DR[0]], dim=1)
    s0 = torch.cat([x0, u_past.reshape(-1), y_past.reshape(-1)]) - bm.s_star

    # Element t of the scan is the pair (M_T, b_t); after the round of
    # distance d, pair i maps the state before block i - 2d + 1 (or s0)
    # to the state after block i.
    A = bm.M_T.expand(n_outer, S, S).clone()
    b = bm.c + Wp @ bm.N_T  # (n_outer, S)
    d = 1
    while d < n_outer:
        # Both new halves from the old pairs, before either is written.
        b_new = torch.baddbmm(b[d:, None], b[:-d, None], A[d:])[:, 0]
        A_new = A[:-d] @ A[d:]
        A[d:] = A_new
        b[d:] = b_new
        d *= 2
    s_after = (s0 @ A) + b  # (n_outer, S): the state after each block
    s_before = torch.cat([s0[None], s_after[:-1]])

    U = s_before @ bm.OuS_T + bm.ou_c + Wp @ bm.OuW_T
    Y = s_before @ bm.OyS_T + bm.oy_c + Wp @ bm.OyW_T
    st = s_before @ bm.OsS_T + bm.os_c + Wp @ bm.OsW_T
    xi = st.reshape(n_outer * K, S)[:n_solves, ns:]
    if DR is not None:
        xi = torch.cat(
            [xi, DR[0].repeat_interleave(K, dim=0)[:n_solves]], dim=1
        )
    costs = ((xi @ bm.cost_P) * xi).sum(-1) + xi @ bm.cost_q + bm.cost_r
    s_fin = s_after[-1] + bm.s_star
    return ClosedLoopResult(
        u_sys=U.reshape(-1, m)[:n_steps],
        y_sys=Y.reshape(-1, p)[:n_steps],
        costs=costs,
        converged=torch.isfinite(costs),
        x_final=s_fin[:ns],
        u_past=s_fin[ns : ns + n * m].reshape(n, m),
        y_past=s_fin[ns + n * m :].reshape(n, p),
    )
