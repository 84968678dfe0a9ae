"""CPU tests of ``four_tank_nonconvex`` in the port's benchmark: its work
count, its plain reference against the program's plain version, the
TF32 control, and three faults of the bound update planted in the
program, each of which the output check has to catch. Run from the
repository root: ``python -m pytest port_bench/tests -q``.
"""

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "port_bench"
sys.path.insert(0, str(ROOT))

from port_bench import control, harness, work, work_nonconvex  # noqa: E402

CONFIG = "four_tank_nonconvex"
TINY = {"B": 32, "T": 40, "pool_min_bytes": 1,
        "judge_evaluations": 2, "judge_scenarios": 16, "profile_calls": 2}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(tmp_path):
    """A benchmark tree with the real configurations, engines and metric
    readers and a tiny traffic mix, one workload of the configuration."""
    for sub in ("configs", "metrics"):
        shutil.copytree(HERE / sub, tmp_path / sub)
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "tiny.json").write_text(json.dumps(TINY))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] = [dict(name=f"{CONFIG}.tiny", config=CONFIG,
                               traffic="tiny", chips=1, why="test")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def measure(tree, seed=2**31 + 11):
    c = harness.load_cell(tree, f"{CONFIG}.tiny", here=tree)
    run = harness.measure(c, seed, 0.2, False, torch.device("cpu"),
                          time.perf_counter())
    return run, harness.judge(run)


def test_work_count_by_hand():
    """2 [O I nbox^2 + O n_alpha nbox + n_alpha n_theta + nbox W1 + D2
    W2] + O n_alpha flop a solve: O = 4, I = 16, nbox = 60, n_alpha =
    367, n_theta = 16, W1 = 79, D2 = 24, W2 = 161."""
    cfg = json.loads((HERE / "configs" / f"{CONFIG}.json").read_text())
    assert work_nonconvex.n_alpha(cfg) == 367
    per_solve = (2 * (4 * 16 * 60 ** 2 + 4 * 367 * 60 + 367 * 16 + 60 * 79
                      + 24 * 161) + 4 * 367)
    assert per_solve == 667_380
    flops, nbytes = work_nonconvex.k4nc(cfg, 65536, 400)
    assert flops == per_solve * 65536 * 400
    assert f"{flops:.3e}" == "1.749e+13"
    k4_bytes = work.k4(cfg, 65536, 400)[1]
    assert nbytes == k4_bytes + 4 * (367 * (60 + 16 + 1) + 2 * 65536)
    ms, by = work.bound_ms(flops, nbytes)
    assert by == "operations" and abs(ms - 35.343) < 1e-3


def test_reference_agrees_with_the_programs_plain_version(tiny):
    run, correct = measure(tiny)
    assert correct, run.checks
    assert run.checks["du"][0] < 3e-5
    assert run.checks["dsolver"][0] < 1e-7
    assert run.checks["launch_gap"] == (0, 0)
    assert run.checks["conv_gap"] == (0, 0)


def test_control_fails_the_check(tiny):
    c = harness.load_cell(tiny, f"{CONFIG}.tiny", here=tiny)
    r = control.readings(c, 2**31 + 5, torch.device("cpu"))
    failed = [k for k, v in r.items() if not v <= c.config["limits"][k]]
    assert "du" in failed, r


def _update_skipped(fa, monkeypatch):
    """Every solve returns the bound it was given: the update is never
    applied."""
    kernel = fa.fused_admm

    def broken(ops, dims, carry, W, n_iter, adds=None, bound=None,
               n_outer=1):
        out = list(kernel(ops, dims, carry, W, n_iter, adds, bound,
                          n_outer))
        out[8] = torch.zeros_like(out[8])
        out[10] = bound[:, None].expand_as(out[10]).clone()
        out[11] = bound.clone()
        return tuple(out)

    broken.launches, broken.wide_launches = kernel.launches, \
        kernel.wide_launches
    monkeypatch.setattr(fa, "fused_admm", broken)


def _bound_frozen(fa, monkeypatch):
    """The bound held at c eps_bar, the Convex box: ||alpha||_1 read as
    0 in every update."""
    monkeypatch.setattr(fa, "alpha_l1",
                        lambda theta, t, nc, n: torch.zeros_like(t[:, 0]))


def _inf_norm(fa, monkeypatch):
    """||alpha||_inf in place of ||alpha||_1."""
    def inf_norm(theta, t, nc, n_alpha):
        a = torch.cat([theta, t], 1) @ nc.G[:, :n_alpha] + nc.a_c[:n_alpha]
        return a.abs().amax(1)

    monkeypatch.setattr(fa, "alpha_l1", inf_norm)


@pytest.mark.parametrize("fault", [_update_skipped, _bound_frozen,
                                   _inf_norm])
def test_faults_make_correct_false(tiny, fault, monkeypatch):
    """At c = 1 the bound never binds, so each fault shows in the bound
    the program returns (``dsolver``, ``[s | w | bound]``)."""
    from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa

    fault(fa, monkeypatch)
    run, correct = measure(tiny)
    assert not correct, run.checks
    assert run.failed > 0
    value, limit = run.checks["dsolver"]
    assert value > limit, run.checks
