"""PyTorch port, the top-level entry points (``direct_data_driven_mpc_tpu_
torch.entry``): one closed-loop step at the paper's scale against
``__graft_entry__.py``'s ``entry()`` on the same inputs, the card rule,
and ``dryrun_multichip`` on gloo CPU ranks through the spawn harness of
tests/_torch_dist.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as jax_entry  # noqa: E402
from direct_data_driven_mpc_tpu_torch import entry as port_entry  # noqa: E402

from tests import _torch_dist_bodies as bodies  # noqa: E402
from tests._torch_dist import run_ranks  # noqa: E402
from tests.test_torch_iterative import one_blas_thread  # noqa: E402,F401

ATOL = 2e-5  # float32 u, y, state (tests/test_pallas_rollout.py)
OUTPUTS = ("x_next", "y", "u0", "u_past", "y_past")


@pytest.fixture(scope="module")
def steps():
    """The port's step on the CPU and JAX's, jitted, with JAX's example
    inputs."""
    fn, args = port_entry.entry(device="cpu")
    jfn, jargs = jax_entry.entry()
    return fn, args, jax.jit(jfn), jargs


def _inputs(jargs, seed):
    """JAX's example inputs, or with a seeded state and noise."""
    x, u_past, y_past, w = (np.asarray(a) for a in jargs)
    if seed is not None:
        rng = np.random.default_rng(seed)
        x = rng.uniform(-1, 1, 4).astype(np.float32)
        w = (0.002 * rng.uniform(-1, 1, 2)).astype(np.float32)
    return x, u_past, y_past, w


@pytest.mark.parametrize("seed", [None, 1, 2])
def test_entry_step_matches_jax(steps, seed):
    """Every output of one step within 2e-5 of JAX's (float32 both)."""
    fn, args, jfn, jargs = steps
    for a, j in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    ins = _inputs(jargs, seed)
    got = fn(*(torch.tensor(a) for a in ins))
    want = jfn(*(jnp.asarray(a) for a in ins))
    for name, g, w in zip(OUTPUTS, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(got[3][-1].numpy(), got[2].numpy())


def test_entry_controller_is_the_paper_scale():
    _, ctrl = port_entry.four_tank_controller()
    assert (ctrl.spec.nz, ctrl.spec.nc) == (571, 168)


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.dryrun_multichip(2)
    with pytest.raises(ValueError, match="at least 1"):
        port_entry.dryrun_multichip(0, device="cpu")


@pytest.mark.parametrize("n,shape", [(1, (1, 1)), (2, (2, 1)), (3, (3, 1)),
                                     (4, (2, 2)), (6, (3, 2)), (8, (4, 2))])
def test_mesh_shape(n, shape):
    assert port_entry.mesh_shape(n) == shape


def _check_dryrun(out, n):
    n_data, n_model = port_entry.mesh_shape(n)
    assert out["mesh"].tolist() == [n_data, n_model]
    assert int(out["B"]) == 2 * n_data
    for key in ("mean_final_cost", "res", "du_fused", "du_kkt"):
        assert np.isfinite(out[key]), key
    assert float(out["res"]) < 1e-4 and float(out["du_kkt"]) < 1e-4
    assert float(out["du_fused"]) < 1e-4 and float(out["du_track"]) == 0.0
    assert int(out["iters"]) > 0
    # The CPU runs the kernels' plain versions.
    assert int(out["k1_launches"]) == int(out["k4_launches"]) == 0


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_gloo_cpu_ranks(n, tmp_path):
    """``dryrun_multichip(n, device="cpu")`` in a process of its own
    (which spawns the n ranks): mesh (2, 1), then (2, 2); every check
    passes and the numbers are finite."""
    out, = run_ranks(bodies.dryrun_multichip_case, 1, tmp_path, case=n,
                     timeout=180.0, init=False)
    _check_dryrun(out, n)


def test_dryrun_ranks_agree(tmp_path):
    """``dryrun_rank`` on four ranks of one gloo group: every rank
    passes, with the same global metrics and PMINRES result."""
    outs = run_ranks(bodies.dryrun_rank_case, 4, tmp_path, timeout=120.0)
    for out in outs:
        _check_dryrun(out, 4)
    for key in ("mean_final_cost", "res", "iters"):
        assert len({float(o[key]) for o in outs}) == 1, key


def test_chip_smoke_phases_43_to_45_on_the_cpu(tmp_path):
    """The card run's phases 43-45 at a tiny size on the CPU (the
    kernels' plain versions), in a process that imports no JAX."""
    out, = run_ranks(bodies.chip_smoke_edges, 1, tmp_path, timeout=240.0,
                     init=False)
    assert out["jax_modules"].size == 0, out["jax_modules"]
