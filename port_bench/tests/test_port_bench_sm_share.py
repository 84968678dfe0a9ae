"""CPU tests of ``k4_sm_share``, the reader of K4's grid counters: the
share of the counters, and None wherever there is nothing to read (an
untraced run, another kernel's cell, no launch, a program without the
counters). Run from the repository root: ``python -m pytest
port_bench/tests -q``.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from port_bench import harness, program_spans  # noqa: E402
from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa  # noqa: E402


@pytest.fixture
def counters(monkeypatch):
    """Sets the counters, and makes the tracer pass a no-op."""
    monkeypatch.setattr(program_spans, "read", lambda run: None)

    def set_to(reached, total):
        monkeypatch.setattr(fa.fused_admm, "sms_reached", reached)
        monkeypatch.setattr(fa.fused_admm, "sms_total", total)
    return set_to


def run_of(trace=True, kernel="K4"):
    return SimpleNamespace(trace=trace, kernel=kernel)


def test_the_share_of_the_counters(counters):
    counters(128 * 7, 132 * 7)  # 4096 scenarios in 128 blocks of 32
    share = harness.load_metric("k4_sm_share").read(run_of())
    assert share == pytest.approx(100.0 * 128 / 132, rel=1e-12)
    counters(132 * 3, 132 * 3)  # 65536 in 1024 blocks of 64
    assert harness.load_metric("k4_sm_share").read(run_of()) == 100.0


@pytest.mark.parametrize("case", ["untraced", "K1", "K4nc", "no launch"])
def test_none_where_there_is_nothing_to_read(counters, case):
    counters(*((0, 0) if case == "no launch" else (128, 132)))
    run = run_of(trace=case != "untraced",
                 kernel=case if case in ("K1", "K4nc") else "K4")
    assert harness.load_metric("k4_sm_share").read(run) is None


def test_a_program_without_the_counters_reads_none(counters, monkeypatch):
    counters(128, 132)
    monkeypatch.delattr(fa.fused_admm, "sms_reached")
    monkeypatch.delattr(fa.fused_admm, "sms_total")
    assert harness.load_metric("k4_sm_share").read(run_of()) is None


def test_the_metric_is_declared_for_the_convex_cells():
    """``BENCHMARK.json`` lists it for the two Convex cells, in the K4
    layer, moving ``solves_per_s``."""
    import json

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in bench["per_layer"] if m["name"] == "k4_sm_share")
    assert entry["workloads"] == ["four_tank_convex.b65536",
                                  "four_tank_convex.b4096"]
    assert (entry["layer"], entry["moves"], entry["source"],
            entry["better"], entry["unit"]) == (
        "kernel K4", "solves_per_s", "program_counter", "higher", "%")
