"""PyTorch port, condensed engine: the block-map composition and the
batched classic rollout against the JAX package, and against the
framework-free float64 goldens."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from direct_data_driven_mpc_tpu.control.linear_engine import (  # noqa: E402
    build_affine_block_map as jax_build_affine_block_map,
    make_linear_batched_rollout as jax_make_linear_batched_rollout,
)
from direct_data_driven_mpc_tpu_torch.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_tpu_torch.control.linear_engine import (  # noqa: E402
    AffineBlockMap,
    block_map_from_numpy,
    build_affine_block_map,
    build_linear_engine,
    make_linear_batched_rollout,
)
from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp.spec import (  # noqa: E402
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)

from tests.test_closed_loop import FOUR_TANK  # noqa: E402
from tests.test_torch_host import controller_kwargs, port_setup  # noqa: E402

PLANT = LTIParams(
    FOUR_TANK["A"], FOUR_TANK["B"], FOUR_TANK["C"], FOUR_TANK["D"]
)
GOLDEN = os.path.join(
    os.path.dirname(__file__), "golden", "four_tank_golden.npz"
)
#: scheme -> (n_mpc_step, use_terminal_constraint, n_steps), as in
#: tests/test_golden_parity.py.
SCHEMES = {
    "TEC": (1, True, 120),
    "TEC_N_STEP": (4, True, 120),
    "UCON": (1, False, 40),
}


def _assert_maps_equal(port: AffineBlockMap, ref, atol):
    for name in AffineBlockMap._fields:
        a, b = getattr(port, name), getattr(ref, name)
        if name == "n_r":
            assert a == b == 0
        elif name == "r_bar":
            assert a is None and b is None
        else:
            np.testing.assert_allclose(
                a.numpy(), np.asarray(b), rtol=0, atol=atol, err_msg=name
            )


@pytest.mark.parametrize(
    "n_mpc_step,use_terminal,K",
    [(1, True, 8), (4, True, 3), (1, False, 8)],
    ids=["TEC", "TEC_N_STEP", "UCON"],
)
def test_block_map_matches_jax_f64(n_mpc_step, use_terminal, K):
    jplant, jctrl, ctrl, _ = port_setup(
        n_mpc_step=n_mpc_step, use_terminal=use_terminal
    )
    kw = dict(n=4, m=2, p=2, n_mpc_step=n_mpc_step, solves_per_block=K)
    port = build_affine_block_map(
        jplant.as_params(), ctrl.solution_operator(), **kw,
        device="cpu", dtype=torch.float64,
    )
    ref = jax_build_affine_block_map(
        jplant.as_params(), jctrl.solution_operator(), **kw,
        dtype=jnp.float64,
    )
    _assert_maps_equal(port, ref, 1e-12)
    carried = block_map_from_numpy(
        {k: getattr(ref, k) for k in AffineBlockMap._fields}, "cpu",
        torch.float64,
    )
    _assert_maps_equal(carried, ref, 0.0)


@pytest.mark.parametrize("a_diag", [1.0, 1.0 - 1e-7])
def test_uncentered_fallback_matches_jax(a_diag):
    """A closed-loop eigenvalue at or near 1 (the UCON kind of loop):
    both packages warn, disable centering and give the same map."""
    from tests.test_linear_engine import _integrator_setup

    plant, op = _integrator_setup(a_diag)
    with pytest.warns(RuntimeWarning, match="centering disabled"):
        port = build_affine_block_map(
            LTIParams(*plant), op, n=1, m=1, p=1, solves_per_block=3,
            device="cpu", dtype=torch.float64,
        )
    with pytest.warns(RuntimeWarning, match="centering disabled"):
        ref = jax_build_affine_block_map(
            plant, op, n=1, m=1, p=1, solves_per_block=3,
            dtype=jnp.float64,
        )
    assert float(port.s_star.abs().max()) == 0.0
    _assert_maps_equal(port, ref, 1e-12)


def _batch_inputs(jplant, jctrl, rng, B, n_steps):
    x0s = np.tile(jplant.get_state()[None], (B, 1))
    ups = np.tile(jctrl.u_past.reshape(1, 4, 2), (B, 1, 1))
    yps = np.tile(jctrl.y_past.reshape(1, 4, 2), (B, 1, 1))
    Ws = 0.002 * rng.uniform(-1, 1, (B, n_steps, 2))
    return x0s, ups, yps, Ws


@pytest.mark.parametrize("n_steps", [40, 37])
@pytest.mark.parametrize(
    "dtype,jdtype,atol",
    [(torch.float32, jnp.float32, 2e-5), (torch.float64, jnp.float64,
                                          1e-10)],
    ids=["f32", "f64"],
)
def test_batched_rollout_matches_jax(n_steps, dtype, jdtype, atol):
    jplant, jctrl, ctrl, rng = port_setup()
    K, B = 8, 16
    bm = build_linear_engine(
        ctrl, jplant.as_params(), solves_per_block=K, device="cpu",
        dtype=dtype,
    )
    jbm = jax_build_affine_block_map(
        jplant.as_params(), jctrl.solution_operator(), n=4, m=2, p=2,
        solves_per_block=K, dtype=jdtype,
    )
    inputs = _batch_inputs(jplant, jctrl, rng, B, n_steps)
    res = make_linear_batched_rollout(bm, n_steps)(
        *(torch.as_tensor(a, dtype=dtype) for a in inputs)
    )
    ref = jax_make_linear_batched_rollout(jbm, n_steps=n_steps)(
        *(jnp.asarray(a, jdtype) for a in inputs)
    )
    assert res.u_sys.shape == (B, n_steps, 2)
    assert res.costs.shape == (B, n_steps)
    for field in ("u_sys", "y_sys", "x_final", "u_past", "y_past"):
        np.testing.assert_allclose(
            getattr(res, field).numpy(), np.asarray(getattr(ref, field)),
            rtol=0, atol=atol, err_msg=field,
        )
    np.testing.assert_allclose(
        res.costs.numpy(), np.asarray(ref.costs), rtol=1e-3 if
        dtype == torch.float32 else 1e-9, atol=1e-5,
    )
    assert bool(res.converged.all())


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize(
    "dtype,budget", [(torch.float64, 1e-9), (torch.float32, 1e-4)],
    ids=["f64", "f32"],
)
def test_classic_engine_matches_golden(golden, scheme, dtype, budget):
    n_mpc_step, use_terminal, n_steps = SCHEMES[scheme]
    ctrl = DirectDataDrivenMPCController(
        **controller_kwargs(golden["u_d"], golden["y_d"],
                            n_mpc_step=n_mpc_step,
                            use_terminal=use_terminal),
        slack_var_constraint_type=SlackVarConstraintTypes.NONE,
        controller_type=DataDrivenMPCType.ROBUST,
    )
    bm = build_linear_engine(ctrl, PLANT, solves_per_block=10,
                             device="cpu", dtype=dtype)

    def t(a):
        return torch.as_tensor(np.asarray(a)[None], dtype=dtype)

    res = make_linear_batched_rollout(bm, n_steps, n_mpc_step)(
        t(golden["x0"]), t(golden[f"{scheme}_u_past0"]),
        t(golden[f"{scheme}_y_past0"]), t(golden["w_sys"][:n_steps]),
    )
    du = np.abs(
        res.u_sys[0].double().numpy() - golden[f"{scheme}_u"]
    ).max()
    assert du < budget, du
