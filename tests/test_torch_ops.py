"""PyTorch port, the device ops: ``ops.hankel`` (Hankel matrix, rank,
persistent excitation), ``ops.estimation`` (observability and Toeplitz
matrices, the initial-state observer, the equilibrium pair) and
``ops.lti`` (plant step and rollout) on tensors, held against the JAX
package's functions on the same numpy inputs at the tolerances of
tests/test_hankel.py, test_estimation.py and test_lti.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from direct_data_driven_mpc_tpu.ops import estimation as jest  # noqa: E402
from direct_data_driven_mpc_tpu.ops import hankel as jhankel  # noqa: E402
from direct_data_driven_mpc_tpu.ops import lti as jlti  # noqa: E402
from direct_data_driven_mpc_tpu_torch import ops  # noqa: E402
from direct_data_driven_mpc_tpu_torch.models.lti_model import (  # noqa: E402
    LTIModel,
)
from direct_data_driven_mpc_tpu_torch.ops.hankel import matrix_rank  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops.host import (  # noqa: E402
    hankel_matrix_np,
)
from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams  # noqa: E402

from tests.test_closed_loop import FOUR_TANK  # noqa: E402

F64 = torch.float64
PLANT = tuple(FOUR_TANK[k] for k in "ABCD")


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


@pytest.mark.parametrize("N,n,L", [(10, 1, 3), (12, 3, 5), (400, 2, 34)])
def test_hankel_matches_jax_and_host(N, n, L):
    X = np.random.default_rng(N).normal(size=(N, n))
    H = ops.hankel_matrix(t64(X), L)
    assert H.shape == (L * n, N - L + 1) and H.dtype == F64
    np.testing.assert_array_equal(H.numpy(), hankel_matrix_np(X, L))
    np.testing.assert_allclose(H.numpy(),
                               np.asarray(jhankel.hankel_matrix(X, L)),
                               rtol=1e-12)
    H32 = ops.hankel_matrix(torch.as_tensor(X, dtype=torch.float32), L)
    assert H32.dtype == torch.float32
    np.testing.assert_array_equal(H32.numpy(),
                                  H.numpy().astype(np.float32))


def test_hankel_reference_example_and_errors():
    u_d = np.random.default_rng(0).uniform(-1, 1, (4, 2))
    expected = np.array([
        [0.27392337, -0.91805295, 0.62654048],
        [-0.46042657, -0.96694473, 0.82551115],
        [-0.91805295, 0.62654048, 0.21327155],
        [-0.96694473, 0.82551115, 0.45899312],
    ])
    np.testing.assert_allclose(ops.hankel_matrix(t64(u_d), 2).numpy(),
                               expected, atol=1e-8)
    with pytest.raises(ValueError, match="greater than or equal"):
        ops.hankel_matrix(torch.zeros(3, 2), 5)
    with pytest.raises(ValueError, match="2-D"):
        ops.hankel_matrix(torch.zeros(6), 2)


@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
def test_matrix_rank_uses_numpys_threshold(dtype):
    rng = np.random.default_rng(1)
    full = rng.normal(size=(12, 7))
    deficient = full[:, :3] @ rng.normal(size=(3, 7))
    for M in (full, deficient, np.zeros((4, 4))):
        Mt = torch.as_tensor(M, dtype=dtype)
        got = int(matrix_rank(Mt))
        assert got == np.linalg.matrix_rank(Mt.numpy())
        assert got == int(jhankel.matrix_rank(Mt.numpy()))
    assert int(matrix_rank(t64(full), tol=1e30)) == 0


def test_persistent_excitation_matches_jax():
    rng = np.random.default_rng(2)
    X = rng.uniform(-1, 1, (60, 2))
    assert ops.evaluate_persistent_excitation(t64(X), 8) == (16, True)
    assert jhankel.evaluate_persistent_excitation(X, 8) == (16, True)
    const = np.ones((60, 2))
    assert ops.evaluate_persistent_excitation(t64(const), 8) == (1, False)
    assert jhankel.evaluate_persistent_excitation(const, 8) == (1, False)
    with pytest.raises(ValueError, match="2-D"):
        ops.evaluate_persistent_excitation(torch.zeros(60), 8)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_persistent_excitation_float32_input_not_misranked(as_tensor):
    """Rank-deficient data in float32 must still fail: the rank is taken
    in float64, where float32 rounding does not inflate it."""
    base = np.random.default_rng(0).uniform(-1, 1, (60, 1))
    X = np.hstack([base, 2.0 * base]).astype(np.float32)
    arg = torch.as_tensor(X) if as_tensor else X
    rank, ok = ops.evaluate_persistent_excitation(arg, 8)
    assert not ok and rank < 16
    assert (rank, ok) == jhankel.evaluate_persistent_excitation(X, 8)


def test_observability_and_toeplitz_match_jax():
    A, B, C, D = PLANT
    Ot = ops.observability_matrix(t64(A), t64(C))
    np.testing.assert_allclose(
        Ot.numpy(), np.vstack([C @ np.linalg.matrix_power(A, i)
                               for i in range(4)]), rtol=1e-12)
    np.testing.assert_allclose(Ot.numpy(),
                               np.asarray(jest.observability_matrix(A, C)),
                               rtol=1e-12, atol=1e-15)
    for t in (1, 4, 7):
        Tt = ops.toeplitz_input_output_matrix(*map(t64, PLANT), t)
        np.testing.assert_allclose(
            Tt.numpy(),
            np.asarray(jest.toeplitz_input_output_matrix(*PLANT, t)),
            rtol=1e-12, atol=1e-15)
    with pytest.raises(ValueError, match="positive"):
        ops.toeplitz_input_output_matrix(*map(t64, PLANT), 0)


def test_toeplitz_reference_example():
    A = t64([[1, 2, 3], [4, 5, 6], [7, 8, 9]])
    Tt = ops.toeplitz_input_output_matrix(A, t64([[1], [1], [0]]),
                                          t64([[1, 0, 2], [0, 1, 0]]),
                                          t64([[0], [1]]), 3)
    expected = np.array([[0.0, 0, 0], [1, 0, 0], [1, 0, 0], [1, 1, 0],
                         [33, 1, 0], [9, 1, 1]])
    np.testing.assert_allclose(Tt.numpy(), expected, rtol=1e-12)


def test_estimate_initial_state_round_trip_and_jax():
    A, B, C, D = PLANT
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=4)
    U = rng.uniform(-1, 1, (4, 2))
    _, Y = ops.lti_rollout(LTIParams(*PLANT).to("cpu", F64), t64(x0),
                           t64(U), torch.zeros(4, 2, dtype=F64))
    Ot = ops.observability_matrix(t64(A), t64(C))
    Tt = ops.toeplitz_input_output_matrix(*map(t64, PLANT), 4)
    x_hat = ops.estimate_initial_state(Ot, Tt, t64(U).reshape(-1),
                                       Y.reshape(-1))
    np.testing.assert_allclose(x_hat.numpy(), x0, atol=1e-8)
    want = jest.estimate_initial_state(Ot.numpy(), Tt.numpy(),
                                       U.reshape(-1), Y.numpy().reshape(-1))
    np.testing.assert_allclose(x_hat.numpy(), np.asarray(want), atol=1e-12)
    with pytest.raises(ValueError, match="Ot has 8 rows"):
        ops.estimate_initial_state(Ot, Tt, t64(U).reshape(-1),
                                   Y.reshape(-1)[:6])
    with pytest.raises(ValueError, match="columns"):
        ops.estimate_initial_state(Ot, Tt, t64(U).reshape(-1)[:6],
                                   Y.reshape(-1))


def test_equilibrium_pair_round_trip_and_jax():
    A, B, C, D = PLANT
    y_eq = np.array([0.65, 0.77])
    u_eq = ops.calculate_equilibrium_input_from_output(*map(t64, PLANT),
                                                       t64(y_eq))
    y_back = ops.calculate_equilibrium_output_from_input(*map(t64, PLANT),
                                                         u_eq)
    np.testing.assert_allclose(y_back.numpy(), y_eq, atol=1e-10)
    np.testing.assert_allclose(
        u_eq.numpy(),
        np.asarray(jest.calculate_equilibrium_input_from_output(*PLANT,
                                                               y_eq)),
        atol=1e-12)
    # A fixed point of the plant: rolled from the implied steady state,
    # the output stays at y_eq.
    x_eq = np.linalg.solve(np.eye(4) - A, B @ u_eq.numpy())
    _, Y = ops.lti_rollout(LTIParams(*PLANT).to("cpu", F64), t64(x_eq),
                           u_eq.expand(10, 2), torch.zeros(10, 2, dtype=F64))
    np.testing.assert_allclose(Y.numpy(), np.tile(y_eq, (10, 1)),
                               atol=1e-10)


def test_lti_step_and_rollout_match_jax_and_the_model():
    rng = np.random.default_rng(4)
    x0 = rng.normal(size=4)
    U = rng.uniform(-1, 1, (25, 2))
    W = 0.002 * rng.uniform(-1, 1, (25, 2))
    params = LTIParams(*PLANT).to("cpu", F64)
    x_fin, Y = ops.lti_rollout(params, t64(x0), t64(U), t64(W))
    jx, jY = jlti.lti_rollout(jlti.LTIParams(*PLANT), x0, U, W)
    np.testing.assert_allclose(Y.numpy(), np.asarray(jY), atol=1e-12)
    np.testing.assert_allclose(x_fin.numpy(), np.asarray(jx), atol=1e-12)
    model = LTIModel(**FOUR_TANK)
    model.set_state(x0)
    np.testing.assert_allclose(Y.numpy(), model.simulate(U, W, 25),
                               atol=1e-10)
    x1, y0 = ops.lti_step(params, t64(x0), t64(U[0]), t64(W[0]))
    jx1, jy0 = jlti.lti_step(jlti.LTIParams(*PLANT), x0, U[0], W[0])
    np.testing.assert_allclose(x1.numpy(), np.asarray(jx1), atol=1e-15)
    np.testing.assert_allclose(y0.numpy(), np.asarray(jy0), atol=1e-15)


def test_package_exports():
    import direct_data_driven_mpc_tpu_torch as port
    from direct_data_driven_mpc_tpu import ops as jops

    assert sorted(ops.__all__) == sorted(jops.__all__)
    assert port.hankel_matrix is ops.hankel_matrix
    assert "DirectDataDrivenMPCController" in port.__all__
    from direct_data_driven_mpc_tpu_torch.control.controller import (
        DirectDataDrivenMPCController,
    )

    assert port.DirectDataDrivenMPCController is DirectDataDrivenMPCController
    with pytest.raises(AttributeError):
        port.no_such_name


def _numpy_calls():
    """Each device op on numpy inputs, with ``device`` passed through."""
    from direct_data_driven_mpc_tpu_torch.ops.estimation import dc_gain

    A, B, C, D = PLANT
    rng = np.random.default_rng(5)
    X, U, W = rng.normal(size=(40, 2)), rng.normal(size=(6, 2)), \
        np.zeros((6, 2))
    Ot = np.vstack([C @ np.linalg.matrix_power(A, i) for i in range(4)])
    Tt = np.asarray(jest.toeplitz_input_output_matrix(*PLANT, 4))
    return {
        "hankel_matrix": lambda d: ops.hankel_matrix(X, 5, device=d),
        "matrix_rank": lambda d: matrix_rank(X, device=d),
        "observability_matrix": lambda d: ops.observability_matrix(
            A, C, device=d),
        "toeplitz_input_output_matrix": lambda d: (
            ops.toeplitz_input_output_matrix(*PLANT, 3, device=d)),
        "estimate_initial_state": lambda d: ops.estimate_initial_state(
            Ot, Tt, U[:4].reshape(-1), X[:4].reshape(-1), device=d),
        "dc_gain": lambda d: dc_gain(*PLANT, device=d),
        "calculate_equilibrium_output_from_input": lambda d: (
            ops.calculate_equilibrium_output_from_input(
                *PLANT, np.ones(2), device=d)),
        "calculate_equilibrium_input_from_output": lambda d: (
            ops.calculate_equilibrium_input_from_output(
                *PLANT, np.ones(2), device=d)),
        "lti_step": lambda d: ops.lti_step(
            LTIParams(*PLANT), np.ones(4), U[0], W[0], device=d)[1],
        "lti_rollout": lambda d: ops.lti_rollout(
            LTIParams(*PLANT), np.ones(4), U, W, device=d)[1],
    }


@pytest.mark.parametrize("name", sorted(_numpy_calls()))
def test_numpy_input_with_no_device_means_the_card(name, monkeypatch):
    """A device op given numpy with no device puts it on the card, as
    ``jnp.asarray`` puts it on the accelerator; without a card it raises
    rather than run on the CPU. ``device="cpu"`` runs it there, equal to
    the same call on CPU tensors."""
    call = _numpy_calls()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(None)
    got = call("cpu")
    assert got.device.type == "cpu"
    assert got.dtype == (torch.int64 if name == "matrix_rank" else F64)
    assert torch.isfinite(got).all()
