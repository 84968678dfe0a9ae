"""PyTorch port, the multi-process entry points
(``parallel.multihost``) and the per-scenario noise they rely on:
``initialize_distributed``'s branches with ``init_process_group``
recorded (mirroring tests/test_multihost.py), the global scenario
indices and noise invariant to the number of processes (simulated
topologies, then two real gloo ranks), the global mesh, the world of
one, and the entry points' refusals; ``draw_noise_batch``'s contract
(tests/test_parallel.py::test_noise_batch_invariant_to_batch_size)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

from direct_data_driven_mpc_tpu_torch.control.segmented import (  # noqa: E402
    segment_noise,
)
from direct_data_driven_mpc_tpu_torch.parallel import mesh as pm  # noqa: E402
from direct_data_driven_mpc_tpu_torch.parallel import multihost  # noqa: E402
from direct_data_driven_mpc_tpu_torch.parallel.batch import (  # noqa: E402
    draw_noise_batch,
)
from direct_data_driven_mpc_tpu_torch.parallel.multihost import (  # noqa: E402
    global_scenario_indices,
    initialize_distributed,
)

from tests import _torch_dist_bodies as bodies  # noqa: E402
from tests._torch_dist import run_ranks  # noqa: E402
from tests.test_torch_iterative import one_blas_thread  # noqa: E402,F401

LAUNCH_VARS = ("TORCHELASTIC_RUN_ID", "WORLD_SIZE", "MASTER_ADDR", "RANK")


def _fake_topology(monkeypatch, n_proc, pid):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: n_proc)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: pid)


class _InitRecorder:
    def __init__(self):
        self.calls = []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))


@pytest.fixture
def record_init(monkeypatch):
    rec = _InitRecorder()
    monkeypatch.setattr(dist, "init_process_group", rec)
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    return rec


def test_initialize_distributed_noop_single_process(record_init):
    initialize_distributed(device="cpu")
    assert record_init.calls == []
    assert not dist.is_initialized()


def test_initialize_explicit_args_take_precedence(record_init, monkeypatch):
    monkeypatch.setenv("TORCHELASTIC_RUN_ID", "ignored")
    initialize_distributed(coordinator_address="host:1234",
                           num_processes=4, process_id=2, device="cpu")
    assert record_init.calls == [(("gloo",), dict(
        init_method="tcp://host:1234", world_size=4, rank=2))]


def test_initialize_single_process_explicit_is_noop(record_init):
    initialize_distributed(num_processes=1)
    assert record_init.calls == []


def test_initialize_clean_env_is_noop(record_init, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "1")  # one process, even with an
    monkeypatch.setenv("MASTER_ADDR", "h")  # address: no launch
    initialize_distributed()
    assert record_init.calls == []


@pytest.mark.parametrize("env", [
    {"TORCHELASTIC_RUN_ID": "job-7"},
    {"WORLD_SIZE": "2", "MASTER_ADDR": "somewhere"},
])
def test_initialize_env_detection_branches(record_init, monkeypatch, env):
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    initialize_distributed(device="cpu")
    assert record_init.calls == [(("gloo",), dict(init_method=None))]


def test_initialize_explicit_coordinator_triggers_autodetect(record_init):
    initialize_distributed(coordinator_address="file:///shared/rendezvous",
                           device="cpu")
    assert record_init.calls == [(("gloo",), dict(
        init_method="file:///shared/rendezvous"))]


def test_initialize_defaults_to_the_card(record_init, monkeypatch):
    """``device=None`` is the card with NCCL; with no card it raises
    before touching the process group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    initialize_distributed(num_processes=2, process_id=0,
                           coordinator_address="h:1")
    assert record_init.calls[0][0] == ("nccl",)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_distributed(num_processes=2, process_id=0,
                               coordinator_address="h:1")
    assert len(record_init.calls) == 1


def test_scenario_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.make_scenario_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.make_global_mesh()
    assert not dist.is_initialized()


def test_global_scenario_indices_single_process():
    np.testing.assert_array_equal(global_scenario_indices(16),
                                  np.arange(16))


@pytest.mark.parametrize("n_proc", [1, 2, 4, 8])
def test_global_scenario_indices_invariant_across_process_counts(
    monkeypatch, n_proc
):
    """THE determinism contract: re-partitioning one global batch over
    any process count reassembles the same indices, and each process's
    noise drawn from its first index is the same rows of the whole
    batch's."""
    B, T = 32, 10
    whole = draw_noise_batch(42, B, T, 2, 0.002, "cpu")
    indices, noise = [], []
    for pid in range(n_proc):
        _fake_topology(monkeypatch, n_proc, pid)
        idx = global_scenario_indices(B)
        assert len(idx) == B // n_proc
        indices.append(idx)
        noise.append(draw_noise_batch(42, len(idx), T, 2, 0.002, "cpu",
                                      first_index=int(idx[0])))
    np.testing.assert_array_equal(np.concatenate(indices), np.arange(B))
    assert torch.equal(torch.cat(noise), whole)


def test_global_scenario_indices_rejects_indivisible_batch(monkeypatch):
    _fake_topology(monkeypatch, 4, 0)
    with pytest.raises(ValueError, match="divide"):
        global_scenario_indices(30)


def test_noise_batch_invariant_to_batch_size():
    """Scenario i's draw depends only on (seed, i): growing the batch,
    lengthening it or taking a shard never changes a scenario's noise
    (tests/test_parallel.py::test_noise_batch_invariant_to_batch_size)."""
    W4 = draw_noise_batch(11, 4, 10, 2, 0.002, "cpu")
    W16 = draw_noise_batch(11, 16, 10, 2, 0.002, "cpu")
    assert torch.equal(W4, W16[:4])
    for k in (1, 5, 15):
        shard = draw_noise_batch(11, 16 - k, 10, 2, 0.002, "cpu",
                                 first_index=k)
        assert torch.equal(shard, W16[k:])
    longer = draw_noise_batch(11, 16, 25, 2, 0.002, "cpu")
    assert torch.equal(longer[:, :10], W16)
    assert not torch.equal(W16, draw_noise_batch(12, 16, 10, 2, 0.002,
                                                 "cpu"))
    rows = W16.reshape(16, -1)
    assert len({tuple(r.tolist()) for r in rows}) == 16


def test_noise_batch_is_uniform_and_bounded():
    W = draw_noise_batch(0, 512, 200, 2, 0.5, "cpu", dtype=torch.float64)
    assert W.dtype == torch.float64 and float(W.abs().max()) <= 0.5
    x = W.flatten() / 0.5
    assert abs(float(x.mean())) < 0.01
    assert abs(float(x.var()) - 1 / 3) < 0.01
    hist = torch.histc(x, bins=10, min=-1, max=1) / x.numel()
    assert float((hist - 0.1).abs().max()) < 0.005
    # the float64 draw is the float32 draw's 24-bit uniform, rounded once
    torch.testing.assert_close(
        W, draw_noise_batch(0, 512, 200, 2, 0.5, "cpu").double(),
        rtol=0, atol=0.5 * 2.0**-24)


def test_segment_noise_is_invariant_to_the_batch():
    assert torch.equal(segment_noise(7, 2, 3, 20, 2, 0.002, "cpu"),
                       segment_noise(7, 2, 9, 20, 2, 0.002, "cpu")[:3])


def test_two_ranks_partition_one_batch(tmp_path):
    """Two gloo ranks joined by ``initialize_distributed`` at a file URL:
    the indices and noise of the ranks reassemble the single process's,
    the global meshes (2, 1) and (1, 2) and their slices, the collectives,
    and the refusals; before that, rank 0 alone as a world of one."""
    B, T, seed = 16, 10, 5
    case = dict(address=f"file://{tmp_path}/rendezvous", B=B, T=T,
                seed=seed)
    outs = run_ranks(bodies.multihost_cases, 2, tmp_path / "ranks", case,
                     timeout=120, init=False)
    assert outs[0]["one/shape"].tolist() == [1, 1]
    np.testing.assert_array_equal(outs[0]["one/indices"], np.arange(6))
    assert all(int(o["world"]) == 2 for o in outs)
    np.testing.assert_array_equal(
        np.concatenate([o["indices"] for o in outs]), np.arange(B))
    np.testing.assert_array_equal(
        np.concatenate([o["noise"] for o in outs]),
        draw_noise_batch(seed, B, T, 2, 0.002, "cpu").numpy())
    for rank, o in enumerate(outs):
        assert bool(o["indivisible_refused"])
        assert bool(o["exceeds_world_refused"])
        assert o["data/shape"].tolist() == [2, 1]
        assert o["model/shape"].tolist() == [1, 2]
        assert o["data/slice"].tolist() == [8 * rank, 8 * (rank + 1)]
        assert o["model/slice"].tolist() == [0, B]
        np.testing.assert_array_equal(o["data/sum"], [3.0, 30.0])
        np.testing.assert_array_equal(o["model/sum"], o["model/x"])
        np.testing.assert_array_equal(o["model/gather"],
                                      [[1.0, 10.0, 2.0, 20.0]])
        np.testing.assert_array_equal(o["data/gather"], o["data/x"][None])
        np.testing.assert_array_equal(o["data/x"],
                                      [rank + 1.0, 10.0 * (rank + 1)])


@pytest.fixture(autouse=True)
def _no_process_group_left():
    yield
    assert not dist.is_initialized()


def test_chip_smoke_phases_40_to_42_on_the_cpu(tmp_path):
    """``chip_smoke.py``'s phases 40-42 at a tiny size on the CPU (gloo;
    the card's kernels replaced by their plain versions), in a process
    of their own, which imports no JAX: every check of the phases
    passes (B = 8, T = 100; PMINRES at B = 2, T = 2 and 1)."""
    outs = run_ranks(bodies.chip_smoke_phases, 1, tmp_path,
                     dict(B=8, T=100), timeout=300, init=False)
    assert outs[0]["jax_modules"].tolist() == []
