"""PyTorch port, the spans of the two fused entries (``utils.profiling``'s
``span`` and ``collect``) on the CPU: what a call keeps, how its spans
nest, that recording leaves the outputs bit-identical, and that the
spans reach a ``torch.profiler`` session and the Chrome trace of
``utils.profiling.trace``. The kernel's span is on the card only
(``tests/test_torch_cuda.py``).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from direct_data_driven_mpc_tpu_torch.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_tpu_torch.control.linear_engine import (  # noqa: E402
    build_linear_engine,
)
from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops.lti import LTIParams  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp.admm import (  # noqa: E402
    compute_admm_operator_np,
)
from direct_data_driven_mpc_tpu_torch.qp.spec import (  # noqa: E402
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)
from direct_data_driven_mpc_tpu_torch.utils import profiling  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "four_tank_box_golden.npz")
PLANT = LTIParams(
    A=np.array([[0.921, 0, 0.041, 0], [0, 0.918, 0, 0.033],
                [0, 0, 0.924, 0], [0, 0, 0, 0.937]]),
    B=np.array([[0.017, 0.001], [0.001, 0.023], [0, 0.061], [0.072, 0]]),
    C=np.array([[1.0, 0, 0, 0], [0, 1, 0, 0]]),
    D=np.zeros((2, 2)),
)
B, T = 6, 37
#: Each entry's spans of one call on the CPU, by opening order, with
#: the name of each one's parent.
PHASES = {
    "k1": [("ddmpc.call", None), ("ddmpc.pack", "ddmpc.call"),
           ("ddmpc.rollout", "ddmpc.call"), ("ddmpc.result", "ddmpc.call")],
    "k4": [("ddmpc.call", None), ("ddmpc.pack", "ddmpc.call"),
           ("ddmpc.cold_start", "ddmpc.call"),
           ("ddmpc.rollout", "ddmpc.call"), ("ddmpc.result", "ddmpc.call")],
}
ENTRIES = sorted(PHASES)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _controller(golden, slack):
    L = 30
    return DirectDataDrivenMPCController(
        n=4, m=2, p=2, u_d=golden["u_d"], y_d=golden["y_d"], L=L,
        Q=3.0 * np.eye(2 * L), R=1e-4 * np.eye(2 * L),
        u_s=np.array([[1.0], [1.0]]), y_s=np.array([[0.65], [0.77]]),
        eps_max=0.002, lamb_alpha=0.1 / 0.002, lamb_sigma=1000.0,
        c=float(golden["convex_c"]) if slack == "CONVEX" else 1.0,
        slack_var_constraint_type=SlackVarConstraintTypes[slack],
        controller_type=DataDrivenMPCType.ROBUST,
    )


@pytest.fixture(scope="module")
def entries(golden):
    """Both fused entries on the CPU (their plain versions) and the
    inputs of a call: the golden's CONVEX window, each scenario's own
    noise."""
    bm = build_linear_engine(_controller(golden, "NONE"), PLANT,
                             solves_per_block=8, device="cpu")
    k1 = fr.make_fused_batched_rollout(bm, T)
    k4 = fa.make_fused_admm_rollout(
        PLANT, compute_admm_operator_np(_controller(golden, "CONVEX").spec),
        4, 2, 2, T, iters=(4, 5, 2), cold_iters=24, tol=1e-5,
        device="cpu")

    def tile(a):
        a = np.asarray(a)
        return torch.as_tensor(np.tile(a[None], (B,) + (1,) * a.ndim),
                               dtype=torch.float32)

    W = 0.002 * np.random.default_rng(1).uniform(-1, 1, (B, T, 2))
    ins = (tile(golden["x0"]), tile(golden["CONVEX_u_past0"]),
           tile(golden["CONVEX_y_past0"]),
           torch.as_tensor(W, dtype=torch.float32))
    return {"k1": (k1, ins), "k4": (k4, ins)}


def _fields(res):
    out = {f: getattr(res, f) for f in res._fields
           if isinstance(getattr(res, f), torch.Tensor)}
    if getattr(res, "solver_state", None) is not None:
        out["solver_s"], out["solver_w"] = res.solver_state
    return out


def test_off_path_is_one_shared_no_op():
    assert profiling._record is None
    a = profiling.span("ddmpc.pack", True)
    assert a is profiling.span("ddmpc.call") is profiling._OFF
    with a as got:
        assert got is False
    with pytest.raises(ValueError, match="passes on"):
        with profiling.span("ddmpc.call"):
            raise ValueError("passes on")


@pytest.mark.parametrize("entry", ENTRIES)
def test_recording_off_keeps_no_span(entries, entry):
    run, ins = entries[entry]
    run(*ins)
    with profiling.collect() as spans:
        pass
    run(*ins)
    assert spans == [] and profiling._record is None


@pytest.mark.parametrize("entry", ENTRIES)
def test_each_call_nests_its_phases_in_order(entries, entry):
    run, ins = entries[entry]
    with profiling.collect() as spans:
        run(*ins)
        run(*ins)
    n = len(PHASES[entry])
    assert len(spans) == 2 * n
    calls = [spans[:n], spans[n:]]
    assert calls[0][0].id != calls[1][0].id
    for call in calls:
        top = call[0]
        by_id = {s.id: s for s in call}
        assert [(s.name, by_id[s.parent].name if s.parent else None)
                for s in call] == PHASES[entry]
        assert all(s.call == top.id for s in call)
        assert top.parent is None
        for s in call[1:]:
            assert top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns
        for a, b in zip(call[1:], call[2:]):
            assert a.end_ns <= b.start_ns
        assert all(s.host_ms > 0 for s in call)


@pytest.mark.parametrize("entry", ENTRIES)
def test_device_ms_is_none_on_the_cpu(entries, entry):
    run, ins = entries[entry]
    with profiling.collect() as spans:
        run(*ins)
    assert spans and all(s.device_ms is None for s in spans)
    summary = profiling.summarize(spans)
    assert set(summary) == {name for name, _ in PHASES[entry]}
    assert all(v["n"] == 1 and v["device_ms"] is None and v["host_ms"] > 0
               for v in summary.values())


@pytest.mark.parametrize("entry", ENTRIES)
def test_outputs_bit_identical_with_recording_on(entries, entry):
    run, ins = entries[entry]
    off = _fields(run(*ins))
    with profiling.collect():
        on = _fields(run(*ins))
    assert off.keys() == on.keys()
    for f in off:
        assert torch.equal(off[f], on[f]), f


def test_no_cold_start_span_with_a_solver_state(entries):
    run, ins = entries["k4"]
    first = run(*ins)
    with profiling.collect() as spans:
        again = run(*ins, solver_state0=first.solver_state)
    assert [s.name for s in spans] == [
        name for name, _ in PHASES["k4"] if name != "ddmpc.cold_start"]
    assert torch.isfinite(again.u_sys).all()


def test_summarize_takes_medians():
    """A rare stall of the host inside a span moves neither reading."""
    spans = [profiling.Span("ddmpc.kernel", i, None, i, 0, end, dev)
             for i, (end, dev) in enumerate(
                 [(10**6, 0.35), (10**6, 0.36), (3 * 10**8, 300.0)], 1)]
    spans.append(profiling.Span("ddmpc.call", 9, None, 9, 0, 2 * 10**6))
    got = profiling.summarize(spans)
    assert got["ddmpc.kernel"] == {"n": 3, "host_ms": 1.0,
                                   "device_ms": 0.36}
    assert got["ddmpc.call"] == {"n": 1, "host_ms": 2.0, "device_ms": None}


def test_collect_does_not_nest():
    with profiling.collect():
        with pytest.raises(RuntimeError, match="already recording"):
            with profiling.collect():
                pass
    assert profiling._record is None


@pytest.mark.parametrize("entry", ENTRIES)
def test_spans_reach_a_profiler_session(entries, entry):
    from torch.profiler import ProfilerActivity, profile

    run, ins = entries[entry]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(*ins)
    names = [e.name for e in prof.events()]
    for name, _ in PHASES[entry]:
        assert names.count(name) == 1, name


@pytest.mark.parametrize("recording", [False, True],
                         ids=["profiler alone", "under collect"])
def test_spans_reach_the_chrome_trace(entries, tmp_path, recording):
    run, ins = entries["k4"]
    with profiling.trace(str(tmp_path)) as path:
        if recording:
            with profiling.collect() as spans:
                run(*ins)
            assert len(spans) == len(PHASES["k4"])
        else:
            run(*ins)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {name for name, _ in PHASES["k4"]} <= names
