"""Runs a function on several gloo ranks, one spawned process each, for
the port's multi-device tests (tests/test_torch_mesh.py,
tests/test_torch_multihost.py, tests/test_torch_distributed_qp.py).

The ranks import no JAX: this module and the bodies it runs import
torch, numpy and the port alone (the bodies live in
tests/_torch_dist_bodies.py). A body is called as ``body(rank, world,
case)`` in every rank and returns a dict of numpy arrays, which comes
back to the test as ``outs[rank]``; ``case`` (any picklable object: the
port's operators, numpy inputs) goes to every rank. Each run has its own
time limit, after which its ranks are killed and the test fails.
"""

from __future__ import annotations

import multiprocessing
import os
import time
import traceback
from datetime import timedelta

import numpy as np


def run_ranks(body, world: int, tmp_path, case=None, timeout: float = 120.0,
              init: bool = True):
    """``[out_0, ..., out_{world-1}]``: what ``body`` returned on each
    rank. With ``init`` the ranks join one gloo group on a ``FileStore``
    under ``tmp_path`` (a 60 s collective timeout); without, the body
    starts with no group."""
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    store = os.path.join(tmp, "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(target=_entry,
                    args=(body, rank, world, store, case, tmp, init))
        for rank in range(world)
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [rank for rank, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = []
    for rank in range(world):
        path = os.path.join(tmp, f"err_{rank}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {rank}:\n{f.read()}")
    assert not hung, f"ranks {hung} still running after {timeout} s\n" + \
        "\n".join(errors)
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"exit codes {codes}\n" + "\n".join(errors)
    outs = []
    for rank in range(world):
        with np.load(os.path.join(tmp, f"out_{rank}.npz")) as f:
            outs.append(dict(f))
    return outs


def _entry(body, rank, world, store, case, tmp, init):
    # One thread per rank, and per process a rank starts in turn (the
    # variables reach them through the environment).
    os.environ["OMP_NUM_THREADS"] = os.environ["OPENBLAS_NUM_THREADS"] = "1"
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits

        threadpool_limits(limits=1)
    except ImportError:
        pass
    try:
        if init:
            dist.init_process_group(
                "gloo", store=dist.FileStore(store, world), rank=rank,
                world_size=world, timeout=timedelta(seconds=60),
            )
        out = body(rank, world, case)
        np.savez(os.path.join(tmp, f"out_{rank}.npz"), **(out or {}))
    except BaseException:
        with open(os.path.join(tmp, f"err_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
