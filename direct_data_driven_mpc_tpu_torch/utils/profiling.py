"""Tracing, timing and structured metrics.

- :func:`trace` -- context manager around ``torch.profiler`` (the host
  and, where there is a card, its CUDA activity) that writes a Chrome
  trace, viewable in Perfetto or ``chrome://tracing``.
- :class:`Timer` -- wall-clock timer that waits for the card
  (``torch.cuda.synchronize``) so device work is actually measured,
  keeping p50/p99 percentiles.
- :func:`rollout_metrics` -- structured per-run metric dict from a
  :class:`~direct_data_driven_mpc_tpu_torch.control.loop.ClosedLoopResult`
  (costs, tracking error, convergence lanes) for host-side logging.

Counterpart of ``direct_data_driven_mpc_tpu/utils/profiling.py``. The
card's own activity records can go missing from a trace, the host's
launch records do not (seen on an H100: some or all of a session's, more
the more sessions the process has run, and all of them after a cuDNN
convolution). :func:`trace` warns when the trace it wrote holds fewer
kernel events than kernel launches.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch


#: The CUDA runtime and driver calls that launch a kernel, as a trace
#: records them on the host.
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` and write a
    Chrome trace into ``log_dir`` (created if missing); yields the
    trace file's path. With the card's activity recorded, warns if the
    written trace holds fewer kernel events than the host launched
    kernels; the file stays as written."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"
    )
    with profile(activities=activities) as prof:
        yield path
        _synchronize()
    prof.export_chrome_trace(path)
    if ProfilerActivity.CUDA in activities:
        _warn_if_kernels_missing(path)


def _launches_and_kernels(events) -> tuple:
    """``(launches, kernels)`` of a Chrome trace's events: the host's
    kernel launch calls (categories ``cuda_runtime``, ``cuda_driver``)
    and the card's kernel events (category ``kernel``)."""
    launches = sum(e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and e.get("name") in _LAUNCH_CALLS for e in events)
    kernels = sum(e.get("cat") == "kernel" for e in events)
    return launches, kernels


def _warn_if_kernels_missing(path: str) -> None:
    """Warn, with both counts and the path, if the Chrome trace at
    ``path`` holds fewer kernel events than kernel launches."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches, kernels = _launches_and_kernels(events)
    if kernels < launches:
        warnings.warn(f"{path}: {kernels} kernel events for {launches} "
                      "kernel launches; the card's activity records are "
                      "incomplete", RuntimeWarning, stacklevel=3)


def _synchronize() -> None:
    """Wait for the card's queued work; without CUDA work in this
    process there is none to wait for."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Wall-clock timer for device work (waits for the card)."""

    def __init__(self):
        self.samples: List[float] = []

    @contextlib.contextmanager
    def measure(self):
        """Wall-clock a host-side block. For DEVICE work use
        :meth:`timeit`, which waits for the card before reading the
        clock."""
        t0 = time.perf_counter()
        yield
        self.samples.append(time.perf_counter() - t0)

    def timeit(self, fn, *args, iters: int = 3, warmup: int = 1):
        """Run ``fn(*args)`` ``warmup + iters`` times; record the timed
        iterations and return the last result."""
        out = None
        for _ in range(warmup):
            out = fn(*args)
            _synchronize()
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn(*args)
            _synchronize()
            self.samples.append(time.perf_counter() - t0)
        return out

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.samples, q))

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p99(self) -> float:
        return self.percentile(99)

    @property
    def best(self) -> float:
        return min(self.samples)

    def summary(self) -> Dict[str, float]:
        return {
            "n": len(self.samples),
            "best_s": self.best,
            "p50_s": self.p50,
            "p99_s": self.p99,
        }


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rollout_metrics(
    result,
    u_s: Optional[np.ndarray] = None,
    y_s: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """Aggregate metrics from a (possibly batched) ClosedLoopResult."""
    costs = _host(result.costs)
    conv = _host(result.converged)
    u = _host(result.u_sys)
    y = _host(result.y_sys)
    metrics = {
        "n_solves": int(costs.size),
        "final_cost_mean": float(costs[..., -1].mean()),
        "final_cost_max": float(costs[..., -1].max()),
        "frac_converged": float(conv.mean()),
        "finite": bool(np.isfinite(u).all() and np.isfinite(y).all()),
    }
    if y_s is not None:
        err = np.abs(y[..., -1, :] - _host(y_s).reshape(-1))
        metrics["final_output_error_mean"] = float(err.mean())
        metrics["final_output_error_max"] = float(err.max())
    if u_s is not None:
        erru = np.abs(u[..., -1, :] - _host(u_s).reshape(-1))
        metrics["final_input_error_mean"] = float(erru.mean())
    return metrics
