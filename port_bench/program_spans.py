"""The program's own spans (``utils.profiling``: ``ddmpc.call`` and,
inside it, ``ddmpc.pack``, ``ddmpc.cold_start``, ``ddmpc.rollout`` with
``ddmpc.kernel``, ``ddmpc.result``), read for the per-layer metrics of a
traced run, after the window and the output check:

- the tracer pass: the entry rebuilt from the run's data and seed, two
  warm-up calls, then ``profile_calls`` back-to-back calls with recording
  off, the same with recording on (``profiling.collect()``, no profiler),
  and again off, each closed by one synchronize; each span's median host
  and device milliseconds (one of each span a call), and the recording's
  cost;
- the profiled session (``run.profiled``, the process's first): the
  program enters each span as a ``record_function`` range while a
  profiler is on, so the session's host ops carry the ``ddmpc.*`` ranges
  on its own clock beside the launches and the card's records.

Every reading is None where the program has no spans (a checkout older
than them) or the run was not traced; a session reading also where the
session is not ``complete``. A ``--trace 0`` run reads none of this.
"""

from __future__ import annotations

import bisect
import time
from typing import NamedTuple, Optional

from port_bench import harness, records, traffic as gen

CALL, KERNEL = "ddmpc.call", "ddmpc.kernel"


class Read(NamedTuple):
    """One run's span readings: ``host_ms`` and ``device_ms``, the tracer
    pass's median milliseconds a call by span name (no device time off
    the card or for a host-only span), and the session's readings."""

    host_ms: dict
    device_ms: dict
    plain_launches: Optional[float]
    steady_idle_share: Optional[float]
    outside_kernel_device_ms: Optional[float]


def read(run) -> Optional[Read]:
    """The run's span readings, made once and kept on the run
    (``run.program_spans``); None without spans or outside a traced run."""
    if not run.trace:
        return None
    if not hasattr(run, "program_spans"):
        spans = tracer_pass(run)
        session = session_spans(run.profiled)
        if spans is None and session is None:
            run.program_spans = None
        else:
            host, device = spans if spans else ({}, {})
            run.program_spans = Read(
                host, device, plain_launches(session),
                steady_idle_share(run.profiled, session),
                outside_kernel_device_ms(run.profiled, session))
            describe(run, session)
    return run.program_spans


def tracer_pass(run):
    """``(host_ms, device_ms)`` by span name, the median a call, over
    ``profile_calls`` calls under ``profiling.collect()``; None where the
    program has no ``collect``."""
    from direct_data_driven_mpc_tpu_torch.utils import profiling

    if not hasattr(profiling, "collect"):
        return None
    cell, device = run.cell, run.device
    cfg, trf = cell.config, cell.traffic
    batches = list(gen.noise_pool(cfg, trf, run.seed, device).unbind(0))
    x0s, ups, yps = (harness.tile(a, run.B, device) for a in (
        run.data.x0, run.data.u_past, run.data.y_past))
    program = cell.engine.build(cfg, run.data, run.T, device, lambda k: k)

    def calls(n):
        t = time.perf_counter()
        for i in range(n):
            program.run(x0s, ups, yps, batches[i % len(batches)])
        harness.synchronize(device)
        return time.perf_counter() - t

    n = trf["profile_calls"]
    calls(harness.WARMUP_CALLS)
    off = calls(n)
    with profiling.collect() as spans:
        on = calls(n)
    off = (off + calls(n)) / 2
    host, device_ms = {}, {}
    for name, v in profiling.summarize(spans).items():
        host[name] = v["host_ms"]
        if v["device_ms"] is not None:
            device_ms[name] = v["device_ms"]
    harness.log(
        f"tracer pass, {n} calls: {1e3 * on / n:.6f} ms a call recording, "
        f"{1e3 * off / n:.6f} ms not (the mean of a pass before and one "
        f"after): {100 * (on / off - 1):+.4f} %")
    for name in host:
        mine = [s for s in spans if s.name == name]
        dev = ("-" if name not in device_ms else
               f"{device_ms[name]:.6f} (the longest "
               f"{max(s.device_ms for s in mine):.6f})")
        harness.log(f"  {name}, ms a call, median: host {host[name]:.6f} "
                    f"(the longest {max(s.host_ms for s in mine):.6f}), "
                    f"device {dev}")
    return host, device_ms


class Session(NamedTuple):
    """The ``ddmpc.*`` ranges of a profiled session by name, each as
    sorted ``(start_us, end_us)``, and the host's launch and copy calls
    (sorted starts, and whether each is a kernel launch)."""

    ranges: dict
    issued: list
    is_launch: list


def session_spans(p) -> Optional[Session]:
    """The session's spans, None without a session or without spans."""
    if p is None:
        return None
    ranges = {}
    for a, b, name in p.host_ops:
        if name.startswith("ddmpc."):
            ranges.setdefault(name, []).append((a, b))
    if CALL not in ranges:
        return None
    for v in ranges.values():
        v.sort()
    calls = sorted((a, name in records.LAUNCH_CALLS)
                   for a, _, name in p.host_ops
                   if name in records.LAUNCH_CALLS + records.COPY_CALLS)
    return Session(ranges, [a for a, _ in calls], [k for _, k in calls])


def inside(t: float, ranges: list) -> bool:
    """Whether ``t`` lies in one of the sorted, disjoint ``ranges``."""
    i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
    return i >= 0 and ranges[i][0] <= t < ranges[i][1]


def plain_launches(s: Optional[Session]) -> Optional[float]:
    """Kernel launches a call made inside ``ddmpc.call`` and outside
    ``ddmpc.kernel``: the plain PyTorch operations' launches."""
    if s is None:
        return None
    calls, kernels = s.ranges[CALL], s.ranges.get(KERNEL, [])
    n = sum(launch and inside(t, calls) and not inside(t, kernels)
            for t, launch in zip(s.issued, s.is_launch))
    return n / len(calls)


def _device(p, s: Optional[Session]):
    """The session's device records in issue order, or None unless the
    session is complete and has one record for each launch and copy (on
    one stream the card runs them in the order the host issued them)."""
    if s is None or not p.session.complete:
        return None
    dev = sorted(p.session.device, key=lambda e: e.time_range.start)
    return dev if len(dev) == len(s.issued) else None


def steady_idle_share(p, s: Optional[Session]) -> Optional[float]:
    """The device's idle share from the first record issued inside the
    second ``ddmpc.call`` to the session's end, in %."""
    dev = _device(p, s)
    if dev is None or len(s.ranges[CALL]) < 2:
        return None
    first = bisect.bisect_left(s.issued, s.ranges[CALL][1][0])
    if first == len(dev):
        return None
    t0, end = dev[first].time_range.start, p.t0_us + p.wall_s * 1e6
    busy, cursor = 0.0, t0
    for e in dev[first:]:
        a, b = max(e.time_range.start, cursor), min(e.time_range.end, end)
        if b > a:
            busy += b - a
            cursor = b
    return 100.0 * (1.0 - busy / (end - t0))


def outside_kernel_device_ms(p, s: Optional[Session]) -> Optional[float]:
    """Device milliseconds a call of the records issued inside a
    ``ddmpc.call`` but outside ``ddmpc.kernel``."""
    dev = _device(p, s)
    if dev is None:
        return None
    calls, kernels = s.ranges[CALL], s.ranges.get(KERNEL, [])
    us = sum(e.time_range.end - e.time_range.start
             for t, e in zip(s.issued, dev)
             if inside(t, calls) and not inside(t, kernels))
    return us / 1e3 / len(calls)


def describe(run, s: Optional[Session]) -> None:
    """The session's span readings and, against the first call's spans,
    where the session's first device idle gap lies, on standard error."""
    p = run.program_spans
    harness.log(f"program spans: plain launches a call {p.plain_launches},"
                f" steady idle share {p.steady_idle_share} %, device ms a "
                f"call outside the kernel {p.outside_kernel_device_ms}")
    dev = _device(run.profiled, s)
    if dev is None:
        return
    t0 = run.profiled.t0_us
    first = ", ".join(f"{name} {v[0][0] - t0:.1f}-{v[0][1] - t0:.1f}"
                      for name, v in s.ranges.items())
    harness.log(f"first call, us from the session's start: {first}; first "
                f"launch {s.issued[0] - t0:.1f}, first device record "
                f"{dev[0].time_range.start - t0:.1f}-"
                f"{dev[0].time_range.end - t0:.1f}")


def device_ms(run, name: str) -> Optional[float]:
    """Median device milliseconds a call of span ``name`` (tracer pass)."""
    r = read(run)
    return r.device_ms.get(name) if r else None


def host_ms(run, name: str) -> Optional[float]:
    """Median host milliseconds a call of span ``name`` (tracer pass)."""
    r = read(run)
    return r.host_ms.get(name) if r else None


def kernel_roofline(run, kernel: str) -> Optional[float]:
    """``kernel``'s share of its roofline in %: the least time of its work
    (``run.bound_ms``) over the median device time of ``ddmpc.kernel``;
    None in a cell of another kernel."""
    if run.kernel != kernel:
        return None
    ms = device_ms(run, KERNEL)
    return 100.0 * run.bound_ms / ms if ms else None
