"""PyTorch port, the profiler reads of ``chip_smoke.py`` and of
``utils.profiling.trace`` on synthetic records: the card's own activity
records can go missing from a profiler session, the host's launch
records do not, so every check counts the host's and reads the card's
only where they are complete.

``chip_smoke.session_records`` gets event objects carrying what
``torch.profiler``'s ``FunctionEvent`` carries (a name, a device type, a
device time and, where torch exposes one, a correlation id);
``utils.profiling``'s trace check gets Chrome-trace event lists. No card
is needed.
"""

import json
import warnings
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.autograd import DeviceType  # noqa: E402

import chip_smoke as cs  # noqa: E402
from direct_data_driven_mpc_tpu_torch.utils import profiling  # noqa: E402

STATE = "void (anonymous namespace)::fused_rollout_state_kernel(float const*)"
PRODUCT = "(anonymous namespace)::fused_rollout_product_kernel(float const*)"


def host(name, corr=None):
    """A host record of a runtime call (``corr``: its correlation id)."""
    e = SimpleNamespace(name=name, device_type=DeviceType.CPU,
                        device_time_total=0.0)
    if corr is not None:
        e.id = corr
    return e


def device(name, us, corr=None):
    """A device record of ``us`` microseconds."""
    e = SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                        device_time_total=us)
    if corr is not None:
        e.id = corr
    return e


def k1_calls(n, with_ids, lost=()):
    """``n`` K1 calls: per call two launches (and a host operator that
    starts nothing), the device's two kernel records less those whose
    index is in ``lost``, and the per-step marker on the device track."""
    events, k = [], 0
    for i in range(n):
        events += [host("aten::empty"), host("cudaFuncSetAttribute")]
        for name, us in ((STATE, 50.0), (PRODUCT, 290.0)):
            corr = 100 + k if with_ids else None
            events.append(host("cudaLaunchKernel", corr))
            if k not in lost:
                events.append(device(name, us, corr))
            k += 1
        events.append(device("ProfilerStep*", 400.0, 900 + i
                             if with_ids else None))
    return events


@pytest.mark.parametrize("with_ids", [True, False],
                         ids=["correlation id", "count"])
def test_complete_session(with_ids):
    s = cs.session_records(k1_calls(3, with_ids))
    assert (s.launches, s.copies, s.kernel_records, s.copy_records) == \
        (6, 0, 6, 0)
    assert s.complete
    assert s.matched_by == ("correlation id" if with_ids else "count")
    assert dict(s.names) == {"fused_rollout_state_kernel": 3,
                             "fused_rollout_product_kernel": 3}
    assert s.ms == pytest.approx({"fused_rollout_state_kernel": 0.15,
                                  "fused_rollout_product_kernel": 0.87})
    assert "6 of 6 kernel launches, 0 of 0 copies, 0 of no call" in \
        s.counts()


@pytest.mark.parametrize("with_ids", [True, False],
                         ids=["correlation id", "count"])
def test_partly_lost_session_is_incomplete(with_ids):
    s = cs.session_records(k1_calls(3, with_ids, lost=(1, 2, 5)))
    assert (s.launches, s.kernel_records) == (6, 3)
    assert not s.complete
    assert "3 of 6 kernel launches" in s.counts()


@pytest.mark.parametrize("with_ids", [True, False],
                         ids=["correlation id", "count"])
def test_all_lost_with_host_launches_does_not_raise(with_ids):
    s = cs.session_records(k1_calls(2, with_ids, lost=range(4)))
    assert (s.launches, s.copies, s.kernel_records) == (4, 0, 0)
    assert not s.complete
    assert not s.names and not s.ms


def test_no_host_launches_raises():
    events = [host("aten::add"), host("cudaDeviceSynchronize"),
              device(STATE, 50.0), device("ProfilerStep*", 60.0)]
    with pytest.raises(AssertionError, match="no device work"):
        cs.session_records(events)


@pytest.mark.parametrize("with_ids", [True, False],
                         ids=["correlation id", "count"])
def test_copies_and_kernels_counted_apart(with_ids):
    def ids(i):
        return i if with_ids else None

    events = [host("cudaLaunchKernel", ids(1)), device(STATE, 50.0, ids(1)),
              host("cudaMemsetAsync", ids(2)),
              device("Memset (Device)", 1.0, ids(2)),
              host("cudaLaunchKernelExC", ids(3)),
              device("sm90_xmma_gemm_f32f32", 10.0, ids(3)),
              host("cudaMemcpyAsync", ids(4)),
              device("Memcpy DtoH (Device -> Pinned)", 3.0, ids(4)),
              host("cudaMemcpyAsync", ids(5))]
    s = cs.session_records(events)
    assert (s.launches, s.copies, s.kernel_records, s.copy_records) == \
        (2, 3, 2, 2)
    assert not s.complete  # the last copy's record is lost
    assert dict(s.names) == {"fused_rollout_state_kernel": 1,
                             "sm90_xmma_gemm_f32f32": 1}
    s = cs.session_records(
        events + [device("Memcpy DtoH (Device -> Pinned)", 3.0, ids(5))])
    assert s.complete
    assert sum(s.ms.values()) == pytest.approx(0.067)


def test_by_correlation_id_a_stray_record_does_not_stand_in_for_a_lost_one():
    """A device record of no call in the session (an earlier call's)
    leaves the counts equal but is no record of the lost launch."""
    events = k1_calls(2, True, lost=(3,)) + [device(PRODUCT, 290.0, 42)]
    s = cs.session_records(events)
    assert (s.launches, s.kernel_records, s.stray) == (4, 3, 1)
    assert not s.complete
    events = k1_calls(2, True) + [device(PRODUCT, 290.0, 103)]
    assert not cs.session_records(events).complete  # one launch, two records


def test_launch_calls_are_the_trace_checks():
    assert profiling._LAUNCH_CALLS == cs.LAUNCH_CALLS


def trace_events(launches, kernels, cu_launches=0):
    events = [{"cat": "cpu_op", "name": "aten::mm"},
              {"cat": "cuda_runtime", "name": "cudaDeviceSynchronize"},
              {"cat": "cuda_runtime", "name": "cudaFuncSetAttribute"}]
    events += [{"cat": "cuda_runtime", "name": "cudaLaunchKernel"}] * \
        launches
    events += [{"cat": "cuda_driver", "name": "cuLaunchKernel"}] * \
        cu_launches
    events += [{"cat": "kernel", "name": PRODUCT}] * kernels
    return events


def write_trace(path, events):
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_trace_counts_launches_and_kernel_events():
    assert profiling._launches_and_kernels(trace_events(5, 3, 2)) == (7, 3)
    assert profiling._launches_and_kernels(trace_events(0, 0)) == (0, 0)


@pytest.mark.parametrize("launches,kernels", [(6, 6), (0, 0), (4, 5)])
def test_trace_check_is_silent_when_no_kernel_event_is_missing(
        tmp_path, launches, kernels):
    path = write_trace(tmp_path / "t.json", trace_events(launches, kernels))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        profiling._warn_if_kernels_missing(path)


def test_trace_check_warns_with_both_counts_and_the_path(tmp_path):
    events = trace_events(6, 2)
    path = write_trace(tmp_path / "t.json", events)
    with pytest.warns(RuntimeWarning) as caught:
        profiling._warn_if_kernels_missing(path)
    message = str(caught[0].message)
    assert "2 kernel events for 6 kernel launches" in message
    assert path in message
    assert json.loads((tmp_path / "t.json").read_text()) == \
        {"traceEvents": events}  # left as written


def test_trace_on_the_cpu_runs_no_check_and_warns_nothing(tmp_path,
                                                          monkeypatch):
    def no_check(path):
        raise AssertionError(f"checked the CPU-only trace {path}")

    monkeypatch.setattr(profiling, "_warn_if_kernels_missing", no_check)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profiling.trace(str(tmp_path)) as path:
            torch.ones(4, 4).sum()
    assert not [w for w in caught if issubclass(w.category, RuntimeWarning)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert profiling._launches_and_kernels(events) == (0, 0)
