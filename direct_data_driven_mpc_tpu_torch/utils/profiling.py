"""Tracing, timing and structured metrics.

- :func:`span` -- a named phase of the program: the fused entries mark
  each call (``ddmpc.call``) and, inside it, the pack of the inputs
  (``ddmpc.pack``), the ADMM entry's cold start (``ddmpc.cold_start``),
  the kernel wrapper (``ddmpc.rollout``), the library's launch call
  alone (``ddmpc.kernel``) and the assembly of the result
  (``ddmpc.result``).
- :func:`collect` -- context manager that keeps every span opened in
  it, in memory, and yields them (:class:`Span`: name, own id, the id of
  the span it is nested in, the id of its call, host start and end from
  ``time.perf_counter_ns``, and, for phases marked ``device=True`` on
  the card, the card's milliseconds between two CUDA events on the
  current stream, read when the block ends). :func:`summarize` gives
  the median milliseconds by name.
- :func:`collecting` -- whether a :func:`collect` block is open, for
  the counters a kernel fills only then (K4's NON_CONVEX mode:
  ``ops.fused_admm.fused_admm_counters``).
- :func:`trace` -- context manager around ``torch.profiler`` (the host
  and, where there is a card, its CUDA activity) that writes a Chrome
  trace, viewable in Perfetto or ``chrome://tracing``. While any
  ``torch.profiler`` session is on, each span is also a range on the
  host's timeline (operator scope, as torch's own operators), so the
  trace shows the spans beside the launches and the card's records,
  with or without :func:`collect`.
- :class:`Timer` -- wall-clock timer that waits for the card
  (``torch.cuda.synchronize``) so device work is actually measured,
  keeping p50/p99 percentiles.
- :func:`rollout_metrics` -- structured per-run metric dict from a
  :class:`~direct_data_driven_mpc_tpu_torch.control.loop.ClosedLoopResult`
  (costs, tracking error, convergence lanes) for host-side logging.

Turning spans on, for an operator::

    with profiling.collect() as spans:
        for W in batches:
            run(x0s, u_pasts, y_pasts, W)
    print(profiling.summarize(spans))

Outside :func:`collect` and any profiler session a span is one check of
two module-level flags and a shared no-op: the entries issue the same
operations and launches as without spans, and record no event.

Counterpart of ``direct_data_driven_mpc_tpu/utils/profiling.py``. The
card's own activity records can go missing from a trace, the host's
launch records do not (seen on an H100: some or all of a session's, more
the more sessions the process has run, and all of them after a cuDNN
convolution). :func:`trace` warns when the trace it wrote holds fewer
kernel events than kernel launches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import statistics
import threading
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler


@dataclasses.dataclass
class Span:
    """One phase of one call, as :func:`collect` keeps it. ``call`` is
    the id of the outermost span open around it (its own id at the
    top); ``device_ms`` is the card's time between the span's two CUDA
    events, None for a host-only span or off the card."""

    name: str
    id: int
    parent: Optional[int]
    call: int
    start_ns: int
    end_ns: int = 0
    device_ms: Optional[float] = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Record:
    """What :func:`collect` fills: the spans by opening order, their
    ids, each thread's open spans, and the CUDA event pairs to read."""

    def __init__(self):
        self.spans: List[Span] = []
        self.ids = itertools.count(1)
        self.open = threading.local()
        self.events = []  # (span, start event, end event)
        self.cuda = torch.cuda.is_available()


#: The record of the open :func:`collect` block, None outside one.
_record: Optional[_Record] = None


class _Off:
    """The span of every boundary while nothing records: a shared
    context manager whose enter and exit are C calls, ``bool()`` and
    ``"".format(*exc_info)``, both falsy, so an exception passes on and
    no Python frame runs."""

    __slots__ = ()
    __enter__ = staticmethod(bool)
    __exit__ = staticmethod("".format)


_OFF = _Off()


class _On:
    """A span while :func:`collect` records or a profiler session is on."""

    __slots__ = ("name", "device", "rec", "kept", "stream", "end", "range")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device
        self.rec = self.kept = self.stream = self.end = self.range = None

    def __enter__(self):
        rec = self.rec = _record
        if rec is not None:
            stack = getattr(rec.open, "stack", None)
            if stack is None:
                stack = rec.open.stack = []
            up = stack[-1] if stack else None
            sid = next(rec.ids)
            self.kept = Span(self.name, sid, up.id if up else None,
                             up.call if up else sid, 0)
            rec.spans.append(self.kept)
            stack.append(self.kept)
            if self.device and rec.cuda:
                # Both events on the stream current at the start, looked
                # up once: the lookup costs the host about what a record
                # does.
                self.stream = torch.cuda.current_stream()
                start = torch.cuda.Event(enable_timing=True)
                self.end = torch.cuda.Event(enable_timing=True)
                start.record(self.stream)
                rec.events.append((self.kept, start, self.end))
            self.kept.start_ns = time.perf_counter_ns()
        if _autograd_profiler._is_profiler_enabled:
            # An operator-scope range, as torch's own operators are: a
            # ``record_function`` (user scope) range would also put a
            # device-side annotation into the session, under an id that
            # can equal a launch's correlation id.
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
        return self.kept

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.kept is not None:
            self.kept.end_ns = time.perf_counter_ns()
            if self.end is not None:
                self.end.record(self.stream)
            self.rec.open.stack.pop()
        return False


def span(name: str, device: bool = False):
    """Context manager marking a phase ``name`` of the program.

    Under :func:`collect` the phase is kept as a :class:`Span`; with
    ``device=True`` (pass whether the phase's tensors are on the card)
    it also records a pair of CUDA events on the stream current at its
    start, read only when the :func:`collect` block ends. While a
    ``torch.profiler`` session is on, the phase is also a range on the
    session's host timeline. Else it returns a shared no-op."""
    if _record is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _On(name, device)


@contextlib.contextmanager
def collect():
    """Keep every span opened in the block, in memory; yields the list
    of :class:`Span` (by opening order), complete when the block ends:
    then, and only then, the card's times are read (one wait for each
    span's end event). Blocks do not nest."""
    global _record
    if _record is not None:
        raise RuntimeError("profiling.collect() is already recording")
    rec = _record = _Record()
    try:
        yield rec.spans
    finally:
        _record = None
        for kept, start, end in rec.events:
            if kept.end_ns:
                end.synchronize()
                kept.device_ms = start.elapsed_time(end)


def collecting() -> bool:
    """Whether a :func:`collect` block is open: the kernels' wrappers fill
    their device counters only then, so a timed call does no extra work."""
    return _record is not None


def summarize(spans: List[Span]) -> Dict[str, Dict[str, float]]:
    """``{name: {"n", "host_ms", "device_ms"}}``: each span name's count
    and median host and device milliseconds (``device_ms`` None where a
    span of that name has no device time). Medians, as a host that
    stalls inside a span now and then lengthens its device time too
    (the card waits for the launch), and a mean would carry the stall."""
    out = {}
    for name in dict.fromkeys(s.name for s in spans):
        mine = [s for s in spans if s.name == name]
        dev = [s.device_ms for s in mine]
        out[name] = {
            "n": len(mine),
            "host_ms": statistics.median(s.host_ms for s in mine),
            "device_ms": None if None in dev else statistics.median(dev),
        }
    return out


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
