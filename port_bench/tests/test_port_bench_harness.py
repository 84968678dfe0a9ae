"""CPU tests of the port's benchmark harness (``port_bench/``): lookups by
name, the work counts, the plain reference against the program's plain
versions, the output check's control and faults, and what the harness
may import. Run from the repository root:
``python -m pytest port_bench/tests -q``.
"""

import ast
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "port_bench"
sys.path.insert(0, str(ROOT))

from port_bench import control, harness, reference, traffic, work  # noqa: E402

CONFIGS = ("four_tank_robust", "four_tank_convex")
TINY = {"B": 64, "T": 100, "pool_min_bytes": 1,
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
    readers and a tiny traffic mix, one workload per configuration."""
    for sub in ("configs", "metrics"):
        shutil.copytree(HERE / sub, tmp_path / sub)
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "tiny.json").write_text(json.dumps(TINY))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] = [dict(name=f"{c}.tiny", config=c, traffic="tiny",
                               chips=1, why="test") for c in CONFIGS]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def cell(tree, config):
    return harness.load_cell(tree, f"{config}.tiny", here=tree)


def measure(tree, config, seed=2**31 + 11, seconds=0.3):
    c = cell(tree, config)
    run = harness.measure(c, seed, seconds, False, torch.device("cpu"),
                          time.perf_counter())
    return run, harness.judge(run)


# --- lookups by name ----------------------------------------------------

def test_every_workload_resolves_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        c = harness.load_cell(ROOT, w["name"])
        assert c.config == json.loads(
            (HERE / "configs" / f"{w['config']}.json").read_text())
        assert c.traffic == json.loads(
            (HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert c.engine.LIBRARY in ("fused_rollout", "fused_admm")
        for m in c.metrics[0] + c.metrics[1]:
            assert callable(harness.load_metric(m["name"]).read)
    names = {m["name"].split(".")[0]
             for m in bench["end_to_end"] + bench["per_layer"]}
    files = {p.stem for p in (HERE / "metrics").glob("*.py")}
    assert names == files


def test_new_files_add_a_cell_and_a_metric_without_edits(tiny):
    (tiny / "configs" / "other.json").write_text(
        (tiny / "configs" / "four_tank_robust.json").read_text())
    (tiny / "traffic" / "wider.json").write_text(json.dumps(
        dict(TINY, B=32)))
    (tiny / "metrics" / "evaluations.py").write_text(
        "def read(run):\n    return run.n_eval\n")
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="other.wider", config="other",
                                   traffic="wider", chips=1, why="test"))
    bench["per_layer"].append(dict(
        name="evaluations", unit="evaluations", better="higher",
        source="program_counter", layer="entry call", moves="solves_per_s",
        workloads=["other.wider"]))
    (tiny / "BENCHMARK.json").write_text(json.dumps(bench))
    c = harness.load_cell(tiny, "other.wider", here=tiny)
    assert c.traffic["B"] == 32 and c.config["engine"] == "solution_map"
    assert [m["name"] for m in c.metrics[1]][-1] == "evaluations"
    assert harness.load_metric("evaluations", here=tiny).read(
        type("R", (), {"n_eval": 7})) == 7
    other = harness.load_cell(tiny, "four_tank_robust.tiny", here=tiny)
    assert "evaluations" not in [m["name"] for m in other.metrics[1]]


# --- work counts --------------------------------------------------------

def tiny_config(engine):
    """A one-state plant, n = 1, m = p = 1, L = 2: small enough to count
    by hand."""
    c = json.loads((HERE / "configs" / "four_tank_convex.json").read_text())
    c["model"].update(A=[[0.5]], B=[[1.0]], C=[[1.0]], D=[[0.0]])
    c["controller"].update(n=1, L=2)
    c["engine"] = engine
    return c


def test_k1_counts_by_hand():
    # S = ns + n (m + p) = 3; a solve reads [w | s] (1 + 3 rows) into
    # [s' | u | y | z (rank 2) | q] (3 + 1 + 1 + 2 + 1 = 8 columns).
    flops, nbytes = work.k1(tiny_config("solution_map"), B=5, T=7)
    assert flops == (2 * 4 * 8 + 2 * 2) * 5 * 7
    # noise, u, y, cost per solve; initial and final state; operator.
    assert nbytes == 4 * (5 * 7 * 4 + 2 * 5 * 3 + 4 * 8)


def test_k4_counts_by_hand():
    # nbox = p L = 2, 11 iterations; Mw = 2, nxi = 2 + 2, W1 = 6;
    # D2 = 3 + 1 + 1 = 5, W2 = 3 + 1 + 1 + 1 + 2 + 4 = 12.
    flops, nbytes = work.k4(tiny_config("admm"), B=5, T=7)
    assert flops == 2 * (11 * 4 + 2 * 6 + 5 * 12) * 5 * 7
    carry = 3 + 2 + 2 + 4 + 2 * 2
    out = (1 + 1 + 3) * 7 + 3 + 2 * 2
    assert nbytes == 4 * (5 * (7 + carry + out) + 4 + 2 * 6 + 5 * 12 + 12)


def test_counts_ignore_the_kernels_plan():
    """The program picks K = 50 solves per block at T = 400 and K = 54 at
    T = 108; the counts are per solve all the same."""
    from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr

    assert fr.suggest_solves_per_block(4, 4, 2, 2, n_steps=400) == 50
    assert fr.suggest_solves_per_block(4, 4, 2, 2, n_steps=108) == 54
    cfg = json.loads((HERE / "configs" / "four_tank_robust.json").read_text())
    for fn in (work.k1, work.k4):
        c = cfg if fn is work.k1 else json.loads(
            (HERE / "configs" / "four_tank_convex.json").read_text())
        per400 = fn(c, 3, 400)[0] / (3 * 400)
        assert fn(c, 3, 108)[0] / (3 * 108) == per400
    assert work.k4(json.loads((HERE / "configs" / "four_tank_convex.json")
                              .read_text()), 65536, 400)[0] \
        == 96408 * 65536 * 400


def test_bound_names_what_binds_it():
    ms, by = work.bound_ms(495e12, 1.0)
    assert (ms, by) == (1e3, "operations")
    ms, by = work.bound_ms(1.0, 3.35e12)
    assert (ms, by) == (1e3, "bytes")


# --- the plain reference against the program's plain versions -------------

@pytest.mark.parametrize("config", CONFIGS)
def test_reference_agrees_with_the_programs_plain_version(tiny, config):
    run, correct = measure(tiny, config)
    assert correct, run.checks
    assert run.checks["du"][0] < 3e-5
    assert run.checks["launch_gap"] == (0, 0)
    assert run.checks["conv_gap"] == (0, 0)
    assert ("dsolver" in run.checks) == (config == "four_tank_convex")


def test_reference_qp_is_the_papers():
    """Slack NONE at a tiny data set: the solution map's input is the
    QP's optimum, which satisfies the initial-window and terminal rows."""
    cfg = json.loads((HERE / "configs" / "four_tank_robust.json").read_text())
    data = traffic.data_run(cfg, 3)
    qp = reference.RobustQP(data.u_d, data.y_d, cfg["controller"])
    theta = np.concatenate([data.u_past.ravel(), data.y_past.ravel()])
    nt = qp.n_theta
    x = qp.solve(qp.H, -qp.g[:, None],
                 (qp.b0 + qp.Bt @ theta)[:, None])[:, 0]
    assert np.abs(qp.Aeq @ x - qp.b0 - qp.Bt @ theta).max() < 1e-9
    maps = reference.solution_maps(qp)
    assert np.allclose(qp.u0 @ x, maps["u_c"] + maps["U"] @ theta,
                       atol=1e-9)
    f = 0.5 * x @ qp.H @ x + qp.g @ x + qp.r0
    assert np.isclose(f, theta @ maps["P"] @ theta + maps["q"] @ theta
                      + maps["r"], rtol=1e-8)
    assert qp.H.shape == (367 + 68, 367 + 68) and nt == 16


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -12])
    got = reference.tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2 ** -9, 1.0]


# --- the output check: the control and the faults -------------------------

@pytest.mark.parametrize("config", CONFIGS)
def test_control_fails_the_check(tiny, config):
    c = cell(tiny, config)
    r = control.readings(c, 2**31 + 5, torch.device("cpu"))
    failed = [k for k, v in r.items() if not v <= c.config["limits"][k]]
    assert "du" in failed, r


def _state_unchanged(kernel, name):
    """Every block starts again from the initial state, and the final
    state is the initial one: a step that returns its state unchanged."""
    def broken(*args, **kwargs):
        if name == "fused_rollout":
            op, s0, W = args[:3]
            outs = [kernel(op, s0, W[:, t:t + 1]) for t in range(W.shape[1])]
            return (*(torch.cat([o[i] for o in outs], 1) for i in range(3)),
                    s0.clone())
        ops, dims, carry, W, n_iter, adds = args
        outs = [kernel(ops, dims, carry, W[:, t:t + 1], n_iter, adds)
                for t in range(W.shape[1])]
        return (*(torch.cat([o[i] for o in outs], 1) for i in range(5)),
                carry.s.clone(), *outs[-1][6:])
    return broken


def _half_batch(kernel, name):
    """The second half of the batch left out, the first half's results
    standing in for it."""
    def broken(*args, **kwargs):
        out = list(kernel(*args, **kwargs))
        for i, t in enumerate(out):
            h = t.shape[0] // 2
            out[i] = torch.cat([t[:h], t[:h], t[2 * h:]], 0)
        return tuple(out)
    return broken


def _answer_altered(kernel, name):
    """One applied input of every scenario altered where it is
    produced, by 1e-3."""
    def broken(*args, **kwargs):
        out = list(kernel(*args, **kwargs))
        out[0] = out[0].clone()
        out[0][:, 1, 0] += 1e-3
        return tuple(out)
    return broken


def _residual_wrong(kernel, name):
    """The primal residual of every solve reported one too large, so
    each ``converged`` flag reads false."""
    def broken(*args, **kwargs):
        out = list(kernel(*args, **kwargs))
        out[3] = out[3] + 1.0
        return tuple(out)
    return broken


def _solver_state_stale(kernel, name):
    """The final ADMM state (s, w) returned as the one the kernel was
    given: the cold start's."""
    def broken(*args, **kwargs):
        out = list(kernel(*args, **kwargs))
        carry = args[2]
        out[6], out[7] = carry.sa.clone(), carry.wa.clone()
        return tuple(out)
    return broken


@pytest.mark.parametrize("config,fault", [
    (config, fault) for config in CONFIGS
    for fault in (_state_unchanged, _half_batch, _answer_altered)
] + [("four_tank_convex", _residual_wrong),
     ("four_tank_convex", _solver_state_stale)])
def test_faults_make_correct_false(tiny, config, fault, monkeypatch):
    from direct_data_driven_mpc_tpu_torch.ops import fused_admm as fa
    from direct_data_driven_mpc_tpu_torch.ops import fused_rollout as fr

    module, name = ((fr, "fused_rollout") if config == "four_tank_robust"
                    else (fa, "fused_admm"))
    kernel = getattr(module, name)
    broken = fault(kernel, name)
    for counter in ("launches", "wide_launches"):
        if hasattr(kernel, counter):
            setattr(broken, counter, getattr(kernel, counter))
    monkeypatch.setattr(module, name, broken)
    run, correct = measure(tiny, config)
    assert not correct, run.checks
    assert run.failed > 0
    caught = {_residual_wrong: "conv_gap", _solver_state_stale: "dsolver"}
    if fault in caught:
        value, limit = run.checks[caught[fault]]
        assert value > limit, run.checks


# --- what the benchmark may load -------------------------------------------

def test_no_module_of_the_benchmark_names_jax_or_the_jax_package():
    forbidden = set(harness.FORBIDDEN)
    program = "direct_data_driven_mpc_tpu_torch"
    for path in HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            for n in names:
                assert n.split(".")[0] not in forbidden, (path, n)
                if path.name in ("reference.py", "work.py", "traffic.py",
                                 "records.py", "control.py"):
                    assert n.split(".")[0] != program, (path, n)


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny):
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from pathlib import Path\n"
        "from port_bench import harness\n"
        f"tree = Path({str(tiny)!r})\n"
        "for c in ('four_tank_robust', 'four_tank_convex'):\n"
        "    cell = harness.load_cell(tree, c + '.tiny', here=tree)\n"
        "    run = harness.measure(cell, 7, 0.1, False, torch.device('cpu'),"
        " time.perf_counter())\n"
        "    assert harness.judge(run)\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert "jax" in harness.FORBIDDEN


def test_without_a_card_the_run_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "four_tank_robust.b4096", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_program_the_run_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "four_tank_robust.b4096", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "direct_data_driven_mpc_tpu_torch" in out.stderr


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card(tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for config in CONFIGS:
        c = cell(tiny, config)
        run = harness.measure(c, 5, 0.5, True, torch.device("cuda"),
                              time.perf_counter())
        assert harness.judge(run), run.checks
        assert run.launched == run.n_eval and run.others == 0
        assert run.spans_ms and run.profiled.session.launches > 0


def test_reservoir_keeps_a_uniform_sample():
    n, k, trials = 200, 4, 1500
    counts = np.zeros(n)
    for s in range(trials):
        r = traffic.Reservoir(k, s)
        kept = [None] * k
        for i in range(n):
            j = r.slot(i)
            if j is not None:
                kept[j] = i
        assert None not in kept and len(set(kept)) == k
        counts[kept] += 1
    expect = trials * k / n
    assert abs(counts[: n // 2].mean() - expect) < 0.1 * expect
    assert abs(counts[n // 2:].mean() - expect) < 0.1 * expect
