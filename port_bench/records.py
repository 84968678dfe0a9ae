"""One ``torch.profiler`` session over back-to-back calls, read from the
host's launch and copy records, with the card's own records matched to
them by correlation id.

The card's records of a session can go missing, in part or in whole,
more with each session a process runs; the host's launch records never
do. So every count here comes from the host, and a device time, busy
share or kernel name is read only from a session whose every launch and
copy has its one device record (``complete``). ``Session`` and
``session_records`` are a frozen copy of the program's
``chip_smoke.session_records``.
"""

from __future__ import annotations

import collections
import re
import time
from typing import NamedTuple

import torch

#: The CUDA runtime and driver calls that start device work, as
#: ``torch.profiler`` records them on the host: kernel launches, then
#: copies and fills.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
COPY_CALLS = ("cudaMemcpy", "cudaMemcpyAsync", "cudaMemset",
              "cudaMemsetAsync")


class Session(NamedTuple):
    """What one session recorded of the device work it saw start.

    ``launches`` and ``copies`` are the host's calls; ``kernel_records``
    and ``copy_records`` the device's records matched to them, ``names``
    the kernel records by name and ``ms`` the matched records' device
    milliseconds by name; ``complete`` says each launch and copy has its
    one device record. ``stray`` counts device records of no call in the
    session. ``device`` holds the matched records themselves."""

    launches: int
    copies: int
    kernel_records: int
    copy_records: int
    names: collections.Counter
    ms: dict
    complete: bool
    matched_by: str
    stray: int
    device: list

    def counts(self) -> str:
        return (f"device records: {self.kernel_records} of {self.launches} "
                f"kernel launches, {self.copy_records} of {self.copies} "
                f"copies, {self.stray} of no call in the session (matched "
                f"by {self.matched_by})")


def session_records(events) -> Session:
    """Read one session's events (``prof.events()``): the host's launch
    and copy calls and the device's records of them, matched by
    correlation id where every host call carries a distinct positive
    one, else by count. Raises only if the host shows no device work."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name in LAUNCH_CALLS + COPY_CALLS]
    launches = sum(e.name in LAUNCH_CALLS for e in host)
    copies = len(host) - launches
    if not host:
        raise AssertionError("the profiled calls issued no device work")
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith("ProfilerStep")]
    ids = [getattr(e, "id", 0) for e in host]
    by_id = all(isinstance(i, int) and i > 0 for i in ids) \
        and len(set(ids)) == len(ids)
    stray = 0
    if by_id:
        kind = {e.id: e.name in LAUNCH_CALLS for e in host}
        stray = len(device)
        device = [e for e in device if getattr(e, "id", 0) in kind]
        stray -= len(device)
        is_kernel = [kind[e.id] for e in device]
        whole = all(n == 1 for n in
                    collections.Counter(e.id for e in device).values())
    else:
        is_kernel = [not e.name.startswith(("Memcpy", "Memset"))
                     for e in device]
        whole = True
    kernel_records = sum(is_kernel)
    copy_records = len(device) - kernel_records
    names, ms = collections.Counter(), {}
    for e, kernel in zip(device, is_kernel):
        name = (re.findall(r"\w+_kernel\b", e.name) or [e.name])[0]
        if kernel:
            names[name] += 1
        ms[name] = ms.get(name, 0.0) + e.device_time_total / 1e3
    return Session(launches, copies, kernel_records, copy_records, names,
                   ms, whole and (kernel_records, copy_records)
                   == (launches, copies),
                   "correlation id" if by_id else "count", stray, device)


class Profiled(NamedTuple):
    """A profiled run of calls: the session, the host's wall seconds
    from the first call to the closing synchronize, the device's busy
    seconds (the union of its matched records), and every host op's
    ``(start_us, end_us, name)`` for naming the idle gaps."""

    session: Session
    wall_s: float
    busy_s: float
    t0_us: float
    host_ops: list


def profile_calls(call, n: int) -> Profiled:
    """``n`` back-to-back calls of ``call(i)`` under one session, one
    synchronize at the end, as in the measured window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("port_bench.window"):
            t0 = time.perf_counter()
            for i in range(n):
                call(i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = prof.events()
    s = session_records(events)
    spans = sorted((e.time_range.start, e.time_range.end) for e in s.device)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU]
    mark = [h for h in host if h[2] == "port_bench.window"]
    t0_us = mark[0][0] if mark else min(h[0] for h in host)
    return Profiled(s, wall, busy / 1e6, t0_us, host)


def idle_gaps(p: Profiled, top: int = 10) -> list:
    """``[[host activity, seconds], ...]``: the device's idle time in the
    session, from its start, between its records and to its end, summed
    by the innermost host op running when each gap began (the launch
    and copy calls themselves count as what the host was doing)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in p.session.device)
    gaps, cursor = [], p.t0_us
    for a, b in spans:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    end = p.t0_us + p.wall_s * 1e6
    if end > cursor:
        gaps.append((cursor, end))
    by_name = collections.Counter()
    for a, b in gaps:
        live = [h for h in p.host_ops if h[0] <= a < h[1]]
        name = max(live, key=lambda h: h[0])[2] if live else "host, no op"
        by_name[name] += (b - a) / 1e6
    return [[k, v] for k, v in by_name.most_common(top)]
