"""CPU tests of the benchmark's readers of the program's spans
(``port_bench/program_spans.py`` and the metrics that use it): launches
attributed to spans, the steady idle share's window, None where there is
nothing to read, and what a ``--trace 0`` run leaves alone. Profiled
sessions are synthetic. Run from the repository root:
``python -m pytest port_bench/tests -q``.
"""

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from port_bench import harness, program_spans, records  # noqa: E402
from port_bench.tests.test_port_bench_harness import (  # noqa: E402
    CONFIGS,
    _threads,  # noqa: F401 (the autouse fixture, for this module too)
    cell,
    tiny,
)

#: The metrics that read the program's spans.
NEW = ("k1_roofline_kernel", "k4_roofline_kernel", "pack_ms", "result_ms",
       "cold_start_ms", "host_pack_ms", "host_rollout_ms", "host_result_ms",
       "plain_launches", "steady_idle_share", "device_idle_share_window")


def dev(start, end, corr):
    return SimpleNamespace(name="k", time_range=SimpleNamespace(
        start=start, end=end), id=corr)


def session(calls=3, complete=True):
    """A profiled session (microseconds): one launch before any call,
    then ``calls`` calls 100 us apart. Each call packs (2 launches at
    +11, +12), launches the kernel (2 launches inside ``ddmpc.kernel`` at
    +31, +32) and assembles the result (a launch at +51 and a copy at
    +52). The card runs each record for 5 us, the kernel's for 20, the
    first record starting 10 us after its launch and each later one at
    the earliest after the one before."""
    host = [(1.0, 2.0, "cudaLaunchKernel")]
    for i in range(calls):
        t = 10.0 + 100 * i
        host += [(t, t + 60, "ddmpc.call"), (t + 10, t + 20, "ddmpc.pack"),
                 (t + 11, t + 11.5, "cudaLaunchKernel"),
                 (t + 12, t + 12.5, "cudaLaunchKernel"),
                 (t + 30, t + 40, "ddmpc.rollout"),
                 (t + 30.5, t + 35, "ddmpc.kernel"),
                 (t + 31, t + 31.5, "cudaLaunchKernel"),
                 (t + 32, t + 32.5, "cudaLaunchKernel"),
                 (t + 50, t + 55, "ddmpc.result"),
                 (t + 51, t + 51.5, "cudaLaunchKernel"),
                 (t + 52, t + 52.5, "cudaMemcpyAsync")]
    issued = sorted((a, n) for a, _, n in host
                    if n in records.LAUNCH_CALLS + records.COPY_CALLS)
    device, free = [], 0.0
    for k, (a, _) in enumerate(issued):
        in_kernel = (a - 10.0) % 100 in (31.0, 32.0)
        start = max(a + 10, free)
        free = start + (20 if in_kernel else 5)
        device.append(dev(start, free, k + 1))
    n_launch = sum(n in records.LAUNCH_CALLS for _, n in issued)
    s = records.Session(n_launch, len(issued) - n_launch, n_launch,
                        len(issued) - n_launch, None, {}, complete,
                        "correlation id", 0, device)
    wall_us = device[-1].time_range.end + 8.0
    busy = sum(e.time_range.end - e.time_range.start for e in device)
    return records.Profiled(s, wall_us / 1e6, busy / 1e6, 0.0, host)


def run_of(p, trace=True, **kw):
    r = SimpleNamespace(trace=trace, profiled=p, kernel="K1", bound_ms=1.0,
                        n_eval=10, window_s=1e-3)
    r.program_spans = program_spans.Read(
        kw.get("host", {}), kw.get("device", {}),
        program_spans.plain_launches(program_spans.session_spans(p)),
        program_spans.steady_idle_share(p, program_spans.session_spans(p)),
        program_spans.outside_kernel_device_ms(
            p, program_spans.session_spans(p)))
    return r


def test_launches_are_attributed_to_their_spans():
    p = session()
    s = program_spans.session_spans(p)
    assert len(s.ranges["ddmpc.call"]) == 3
    assert len(s.issued) == 1 + 3 * 6 and sum(s.is_launch) == 1 + 3 * 5
    # The launch before every call and the two inside ddmpc.kernel are
    # not the plain operations'; the result's copy is not a launch.
    assert program_spans.plain_launches(s) == 3.0
    r = run_of(p)
    assert harness.load_metric("plain_launches").read(r) == 3.0
    assert harness.load_metric("plain_launches.host").read(r) == 3.0


def test_device_time_outside_the_kernel_a_call():
    p = session()
    s = program_spans.session_spans(p)
    # Four 5 us records a call outside ddmpc.kernel (two of the pack,
    # the result's launch and copy); the first record is no call's.
    assert program_spans.outside_kernel_device_ms(p, s) == \
        pytest.approx(4 * 5e-3)


def test_steady_idle_share_starts_at_the_second_call():
    p = session()
    s = program_spans.session_spans(p)
    dev_ = sorted(p.session.device, key=lambda e: e.time_range.start)
    # Issued before the second call: the lone launch and the first
    # call's six; the window starts at the seventh record.
    first = dev_[7]
    assert first.time_range.start == 110.0 + 11 + 10
    end = p.wall_s * 1e6
    busy = sum(e.time_range.end - e.time_range.start for e in dev_[7:])
    want = 100 * (1 - busy / (end - first.time_range.start))
    got = program_spans.steady_idle_share(p, s)
    assert got == pytest.approx(want)
    whole = 100 * (1 - p.busy_s / p.wall_s)
    assert got < whole  # the first call's empty queue is left out
    assert harness.load_metric("steady_idle_share").read(run_of(p)) == \
        pytest.approx(want)


def test_idle_share_of_the_window_from_device_durations():
    r = run_of(session(), device={"ddmpc.kernel": 0.06})
    got = harness.load_metric("device_idle_share_window.host").read(r)
    assert got == pytest.approx(100 * (1 - 10 * (0.06 + 0.02) / 1.0))


@pytest.mark.parametrize("case", ["incomplete", "one call", "no spans",
                                  "untraced"])
def test_none_where_there_is_nothing_to_read(case):
    if case == "incomplete":
        p = session(complete=False)
    elif case == "one call":
        p = session(calls=1)
    elif case == "no spans":
        p = session()
        p = p._replace(host_ops=[h for h in p.host_ops
                                 if not h[2].startswith("ddmpc.")])
    else:
        p = None
    s = program_spans.session_spans(p)
    assert program_spans.steady_idle_share(p, s) is None
    if case != "one call":
        assert program_spans.outside_kernel_device_ms(p, s) is None
    if case == "incomplete":
        # The host's launch records are never lost: the count stands.
        assert program_spans.plain_launches(s) == 3.0
    r = SimpleNamespace(trace=case != "untraced", profiled=p, kernel="K1",
                        bound_ms=1.0, n_eval=10, window_s=1e-3)
    r.program_spans = None if case in ("no spans", "untraced") else \
        run_of(p).program_spans
    for name in ("steady_idle_share", "device_idle_share_window"):
        assert harness.load_metric(name).read(r) is None


def test_an_untraced_run_reads_no_span(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("an untraced run calls the program again")

    monkeypatch.setattr(program_spans, "tracer_pass", fail)
    r = SimpleNamespace(trace=False, profiled=None, kernel="K1",
                        bound_ms=1.0)
    assert program_spans.read(r) is None
    for name in NEW:
        assert harness.load_metric(name).read(r) is None


def test_the_new_metrics_are_read_only_in_traced_runs():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        c = harness.load_cell(ROOT, w["name"])
        untraced = {m["name"].split(".")[0] for m in c.metrics[0]}
        assert not untraced & set(NEW)
    named = {m["name"].split(".")[0] for m in bench["per_layer"]}
    assert set(NEW) <= named


@pytest.mark.parametrize("config", CONFIGS)
def test_a_trace_0_run_makes_no_call_beyond_todays(tiny, config,
                                                   monkeypatch):
    from direct_data_driven_mpc_tpu_torch.utils import profiling

    def fail(*a, **k):
        raise AssertionError("recording in an untraced run")

    monkeypatch.setattr(profiling, "collect", fail)
    monkeypatch.setattr(program_spans, "read", fail)
    c = cell(tiny, config)
    calls = []
    build = c.engine.build

    def counted(*args):
        program = build(*args)

        def run(*a, **k):
            calls.append(1)
            return program.run(*a, **k)
        return program._replace(run=run)

    monkeypatch.setattr(c.engine, "build", counted)
    run = harness.measure(c, 2**31 + 5, 0.2, False, torch.device("cpu"),
                          time.perf_counter())
    assert harness.judge(run)
    assert len(calls) == harness.WARMUP_CALLS + run.n_eval
    assert not hasattr(run, "program_spans")


def traced_on_the_cpu(tiny, config, seed):
    """A run measured on the CPU and then read as a traced run (the
    harness's own kernel spans and session need the card)."""
    run = harness.measure(cell(tiny, config), seed, 0.2, False,
                          torch.device("cpu"), time.perf_counter())
    run.trace = True
    return run


@pytest.mark.parametrize("config", CONFIGS)
def test_the_tracer_pass_on_the_cpu(tiny, config):
    run = traced_on_the_cpu(tiny, config, 2**31 + 7)
    r = program_spans.read(run)
    names = {"ddmpc.call", "ddmpc.pack", "ddmpc.rollout", "ddmpc.result"}
    if config == "four_tank_convex":
        names.add("ddmpc.cold_start")
    assert set(r.host_ms) == names and all(v > 0 for v in r.host_ms.values())
    assert r.device_ms == {}  # no device times off the card
    assert r.plain_launches is None and r.steady_idle_share is None
    assert program_spans.read(run) is r  # read once, kept on the run
    for name in ("host_pack_ms", "host_rollout_ms", "host_result_ms"):
        assert harness.load_metric(name).read(run) > 0
    for name in ("pack_ms", "result_ms", "cold_start_ms",
                 "k1_roofline_kernel", "k4_roofline_kernel"):
        assert harness.load_metric(name).read(run) is None


def test_a_program_without_spans_reads_none(tiny, monkeypatch):
    from direct_data_driven_mpc_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "collect")
    run = traced_on_the_cpu(tiny, "four_tank_robust", 2**31 + 9)
    assert program_spans.read(run) is None
    for name in NEW:
        assert harness.load_metric(name).read(run) is None
