"""PyTorch port, the batched build of one solution operator per data
realisation (``qp.batch_build``): the structured batched elimination in
torch float64 held against the JAX package's batched build and against
the port's serial fallback, its two rejections, and the stacked map
through ``parallel.batch.heterogeneous_closed_loop`` against each map
rolled out alone. The same numpy Hankel data go to both packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from direct_data_driven_mpc_tpu.qp import batch_build as jbb  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control.loop import (  # noqa: E402
    closed_loop_rollout,
)
from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams  # noqa: E402
from direct_data_driven_mpc_tpu_torch.parallel.batch import (  # noqa: E402
    heterogeneous_closed_loop,
    stack_plants,
)
from direct_data_driven_mpc_tpu_torch.qp import batch_build as bb  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp.solution_map import (  # noqa: E402
    SolutionMap,
)
from direct_data_driven_mpc_tpu_torch.qp.spec import (  # noqa: E402
    DataDrivenMPCType,
    QPDims,
)

from tests.test_batch_build import _realizations  # noqa: E402
from tests.test_torch_iterative import one_blas_thread  # noqa: E402,F401

TOL = 1e-9
FIELDS = ("z_base", "Z", "u_base", "U_gain", "cost_P", "cost_q", "cost_r")
PLANT = LTIParams(A=np.array([[0.9, 0.2], [0.0, 0.8]]),
                  B=np.array([[0.0], [1.0]]), C=np.array([[1.0, 0.3]]),
                  D=np.array([[0.1]]))


def _data(B, seed0=0):
    """``_realizations`` of tests/test_batch_build.py with the port's
    ``QPDims``."""
    Hu, Hy, dims, kw = _realizations(B=B, seed0=seed0)
    pdims = QPDims(n=dims.n, m=dims.m, p=dims.p, L=dims.L, N=dims.N)
    return Hu, Hy, dims, pdims, kw


def _fallback_kw(kw):
    return dict(Q=kw["Q"], R=kw["R"], u_s=kw["u_s"], y_s=kw["y_s"],
                eps_max=kw["eps_max"], lamb_alpha=kw["lamb_alpha"],
                lamb_sigma=kw["lamb_sigma"], c=1.0)


@pytest.mark.parametrize("use_terminal", [True, False])
def test_batched_matches_jax_and_the_fallback(use_terminal):
    """Within 1e-9 of the JAX package's batched build and of the serial
    dense-KKT fallback (itself within 1e-9 of JAX's), chunked or not."""
    Hu, Hy, dims, pdims, kw = _data(B=5)
    ops = bb.build_batched_solution_operators(
        Hu, Hy, pdims, use_terminal_constraint=use_terminal, device="cpu",
        **kw,
    )
    chunked = bb.build_batched_solution_operators(
        torch.as_tensor(Hu), torch.as_tensor(Hy), pdims,
        use_terminal_constraint=use_terminal, device="cpu", chunk=2, **kw,
    )
    want = jbb.build_batched_solution_operators(
        Hu, Hy, dims, use_terminal_constraint=use_terminal, **kw
    )
    serial = bb.build_solution_operators_fallback(
        Hu, Hy, pdims, use_terminal_constraint=use_terminal,
        **_fallback_kw(kw),
    )
    jserial = jbb.build_solution_operators_fallback(
        Hu, Hy, dims, use_terminal_constraint=use_terminal,
        **_fallback_kw(kw),
    )
    assert ops["feasible"].dtype == torch.bool
    assert bool(ops["feasible"].all()) and serial["feasible"].all()
    for key in FIELDS:
        got = ops[key]
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        assert tuple(got.shape) == want[key].shape
        for ref in (want[key], serial[key]):
            np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL,
                                       err_msg=key)
        np.testing.assert_allclose(serial[key], jserial[key], atol=TOL,
                                   rtol=TOL, err_msg=key)
        np.testing.assert_array_equal(chunked[key].numpy(), got.numpy())


def test_batched_rejects_nondiagonal_weights():
    Hu, Hy, _, pdims, kw = _data(B=2)
    Qfull = kw["Q"].copy()
    Qfull[0, 1] = 0.5
    with pytest.raises(NotImplementedError, match="diagonal"):
        bb.build_batched_solution_operators(
            Hu, Hy, pdims, device="cpu", **dict(kw, Q=Qfull)
        )


@pytest.mark.parametrize("weight", ["lamb_alpha", "eps_max", "lamb_sigma"])
def test_batched_rejects_nominal_family(weight):
    Hu, Hy, _, pdims, kw = _data(B=2)
    with pytest.raises(ValueError, match="ROBUST"):
        bb.build_batched_solution_operators(
            Hu, Hy, pdims, device="cpu", **dict(kw, **{weight: 0.0})
        )


def test_batched_rejects_hankels_of_another_shape():
    Hu, Hy, _, pdims, kw = _data(B=2)
    with pytest.raises(ValueError, match="Hankel batches"):
        bb.build_batched_solution_operators(Hu[:, 1:], Hy, pdims,
                                            device="cpu", **kw)


def test_fallback_takes_the_nominal_family():
    """The serial path builds what the batched one rejects (NOMINAL, no
    ridge weights), equal to the JAX package's."""
    Hu, Hy, dims, pdims, kw = _data(B=2)
    kw = dict(Q=kw["Q"], R=kw["R"], u_s=kw["u_s"], y_s=kw["y_s"],
              controller_type=DataDrivenMPCType.NOMINAL)
    from direct_data_driven_mpc_tpu.qp.spec import (
        DataDrivenMPCType as JaxType,
    )

    got = bb.build_solution_operators_fallback(Hu, Hy, pdims, **kw)
    want = jbb.build_solution_operators_fallback(
        Hu, Hy, dims, **dict(kw, controller_type=JaxType.NOMINAL)
    )
    for key in bb.BATCHED_OPERATOR_KEYS:
        np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=TOL,
                                   err_msg=key)


@pytest.mark.parametrize("dtype, atol", [(torch.float64, 1e-12),
                                         (torch.float32, 2e-5)])
def test_stacked_map_drives_heterogeneous_closed_loop(dtype, atol):
    """Batched operators -> stacked SolutionMap -> heterogeneous closed
    loop, against each realisation's map rolled out alone (and, in
    float64, against its serial operator)."""
    B, n_steps = 3, 10
    Hu, Hy, _, pdims, kw = _data(B=B)
    ops = bb.build_batched_solution_operators(Hu, Hy, pdims, device="cpu",
                                              **kw)
    stack = bb.stacked_solution_map(ops, dtype=dtype, device="cpu")
    assert stack.U_gain.shape == (B, 6, 4) and stack.cost_r.shape == (B,)
    assert all(f.dtype == dtype for f in stack)
    plants = stack_plants([PLANT] * B)

    rng = np.random.default_rng(1)
    x0s, ups, yps = (torch.as_tensor(0.1 * rng.normal(size=s), dtype=dtype)
                     for s in ((B, 2), (B, 2, 1), (B, 2, 1)))
    Ws = torch.as_tensor(0.002 * rng.uniform(-1, 1, (B, n_steps, 1)),
                         dtype=dtype)
    batch = heterogeneous_closed_loop(plants, stack, x0s, ups, yps, Ws,
                                      n_steps=n_steps)
    serial = bb.build_solution_operators_fallback(
        Hu, Hy, pdims, **_fallback_kw(kw)
    )
    for b in range(B):
        one = SolutionMap(*(f[b] for f in stack))
        ref = closed_loop_rollout(PLANT, one, x0s[b:b + 1], ups[b:b + 1],
                                  yps[b:b + 1], Ws[b:b + 1], n_steps=n_steps)
        for name in ("u_sys", "y_sys", "costs", "x_final"):
            np.testing.assert_allclose(getattr(batch, name)[b].numpy(),
                                       getattr(ref, name)[0].numpy(),
                                       atol=atol, rtol=0, err_msg=name)
        if dtype == torch.float64:
            own = SolutionMap(*(torch.as_tensor(serial[k][b])
                                for k in SolutionMap._fields))
            alone = closed_loop_rollout(PLANT, own, x0s[b:b + 1],
                                        ups[b:b + 1], yps[b:b + 1],
                                        Ws[b:b + 1], n_steps=n_steps)
            np.testing.assert_allclose(batch.u_sys[b].numpy(),
                                       alone.u_sys[0].numpy(), atol=TOL)


def test_stacked_map_takes_numpy_and_rejects_narrow_types():
    Hu, Hy, _, pdims, kw = _data(B=2)
    serial = bb.build_solution_operators_fallback(Hu, Hy, pdims,
                                                  **_fallback_kw(kw))
    stack = bb.stacked_solution_map(serial, dtype=torch.float64,
                                    device="cpu")
    np.testing.assert_array_equal(stack.Z.numpy(), serial["Z"])
    with pytest.raises(ValueError, match="float32 or torch.float64"):
        bb.stacked_solution_map(serial, dtype=torch.float16, device="cpu")
