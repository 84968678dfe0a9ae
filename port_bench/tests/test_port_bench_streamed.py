"""CPU tests of ``k1_streamed_share``, the reader of K1's slice
counters: the share of the counters, and None wherever there is nothing
to read (an untraced run, another kernel's cell, no launch, a program
without the counters). Run from the repository root: ``python -m pytest
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
from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr  # noqa: E402


@pytest.fixture
def counters(monkeypatch):
    """Sets the counters, and makes the tracer pass a no-op."""
    monkeypatch.setattr(program_spans, "read", lambda run: None)

    def set_to(streamed, dense):
        monkeypatch.setattr(fr.fused_rollout, "slices_streamed", streamed)
        monkeypatch.setattr(fr.fused_rollout, "slices_dense", dense)
    return set_to


def run_of(trace=True, kernel="K1"):
    return SimpleNamespace(trace=trace, kernel=kernel)


def test_the_share_of_the_counters(counters):
    counters(31 * 5, 40 * 5)
    assert harness.load_metric("k1_streamed_share").read(run_of()) == 77.5
    counters(40, 40)
    assert harness.load_metric("k1_streamed_share").read(run_of()) == 100.0


@pytest.mark.parametrize("case", ["untraced", "K4", "no launch"])
def test_none_where_there_is_nothing_to_read(counters, case):
    counters(0 if case == "no launch" else 31, 0 if case == "no launch"
             else 40)
    run = run_of(trace=case != "untraced",
                 kernel="K4" if case == "K4" else "K1")
    assert harness.load_metric("k1_streamed_share").read(run) is None


def test_a_program_without_the_counters_reads_none(counters, monkeypatch):
    counters(31, 40)
    monkeypatch.delattr(fr.fused_rollout, "slices_streamed")
    monkeypatch.delattr(fr.fused_rollout, "slices_dense")
    assert harness.load_metric("k1_streamed_share").read(run_of()) is None
