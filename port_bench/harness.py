"""The benchmark of ``direct_data_driven_mpc_tpu_torch``: a closed loop of
back-to-back Monte-Carlo evaluations, each one call of a public fused
entry of the program on the next noise batch of a pool, timed for
``--seconds``, then judged against the plain reference.

Driven by data. ``BENCHMARK.json`` at the checkout's root binds a
workload to a configuration (``port_bench/configs/<config>.json``, whose
``engine`` names a module of ``port_bench/engines/``) and a traffic mix
(``port_bench/traffic/<traffic>.json``), and lists the metrics each
workload reports; every metric is read by ``port_bench/metrics/<name>.py``
(``read(run)``, None where it finds nothing to read; a variant
``<base>.<cells>`` is read by its base's module). A new cell,
configuration or metric is a new file and edits none.

The last line of standard output is the result's JSON; everything else
goes to standard error, whose last lines are the numbers compared, each
beside its limit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from port_bench import records, traffic as gen, work

HERE = Path(__file__).resolve().parent
#: Top-level module names that no process of the benchmark may hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "direct_data_driven_mpc_tpu")
#: The ClosedLoopResult fields the output check compares, by the
#: reference's names of them (``solver_state`` flattened to ``[s | w]``,
#: where the engine returns one).
REF_NAMES = {"u_sys": "u", "y_sys": "y", "costs": "costs",
             "x_final": "x_final", "u_past": "u_past", "y_past": "y_past",
             "converged": "converged", "solver_state": "solver_state"}
#: Calls of the entry between the host build and the window.
WARMUP_CALLS = 2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    engine: object
    metrics: dict  # trace (0 or 1) -> [metric entry of BENCHMARK.json]


def load_cell(root: Path, workload: str, here: Path = HERE) -> Cell:
    """The workload's entry of ``root/BENCHMARK.json``, its configuration,
    traffic mix and engine, and the metrics it reports in each mode."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    config = load_json(here / "configs" / f"{entry['config']}.json")
    traffic = load_json(here / "traffic" / f"{entry['traffic']}.json")
    engine = importlib.import_module(f"port_bench.engines.{config['engine']}")

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    metrics = {0: [m for m in bench["end_to_end"] if applies(m)],
               1: [m for m in bench["per_layer"] if applies(m)]}
    return Cell(workload, entry["chips"], config, traffic, engine, metrics)


def load_metric(name: str, here: Path = HERE):
    """The reader of metric ``name``: ``metrics/<name>.py``, or for a
    variant ``<base>.<cells>`` without a file of its own, the base's
    reader (the same quantity, moving another end-to-end metric)."""
    path = here / "metrics" / f"{name}.py"
    if not path.exists():
        path = here / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spans:
    """CUDA events around each kernel call (``rollout=`` of the entry),
    recorded from the benchmark's side while ``active``."""

    def __init__(self):
        self.pairs = []
        self.active = False

    def wrap(self, kernel):
        def rollout(*args, **kwargs):
            if not self.active:
                return kernel(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = kernel(*args, **kwargs)
            end.record()
            self.pairs.append((start, end))
            return out
        return rollout

    def ms(self) -> list:
        return [a.elapsed_time(b) for a, b in self.pairs]


class Run:
    """What one run measured, for the metric readers: set-up parts,
    the window, spans, the profiled session, the work and the checks."""

    def __init__(self, cell: Cell, seed: int, trace: bool,
                 device: torch.device):
        self.cell, self.seed, self.trace, self.device = \
            cell, seed, trace, device
        self.B, self.T = cell.traffic["B"], cell.traffic["T"]
        self.kernel = cell.config["kernel"]
        self.flops, self.nbytes = cell.engine.work(cell.config, self.B,
                                                   self.T)
        self.bound_ms, self.bound_by = work.bound_ms(self.flops, self.nbytes)
        self.spans_ms = []
        self.profiled = None
        self.checks = {}

    def interval_p95_ms(self):
        """The nearest-rank 95th percentile of the intervals between
        consecutive completions in the window (None on the CPU)."""
        if not self.intervals_ms:
            return None
        s = sorted(self.intervals_ms)
        return s[math.ceil(0.95 * len(s)) - 1]

    def mean_span_ms(self):
        return sum(self.spans_ms) / len(self.spans_ms) \
            if self.spans_ms else None


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tile(a: np.ndarray, B: int, device) -> torch.Tensor:
    t = torch.as_tensor(a, dtype=torch.float32, device=device)
    return t.reshape(1, *t.shape).expand(B, *t.shape).contiguous()


def gather(res, idx: torch.Tensor) -> dict:
    out = {}
    for f in REF_NAMES:
        value = getattr(res, f)
        if f == "solver_state" and value is not None:
            value = torch.cat([v.reshape(len(v), -1) for v in value], 1)
        if value is not None:
            out[f] = value.index_select(0, idx)
    return out


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> Run:
    """Set up, warm up, time the window, and (traced) profile a fixed
    count of calls. Returns the run with the judged evaluations kept
    (``run.kept``) for :func:`judge`."""
    from direct_data_driven_mpc_tpu_torch.ops import _kernels

    run = Run(cell, seed, trace, device)
    cfg, trf = cell.config, cell.traffic
    B, T = run.B, run.T
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    t = time.perf_counter()
    data = gen.data_run(cfg, seed)
    pool = gen.noise_pool(cfg, trf, seed, device)
    batches = list(pool.unbind(0))
    P = len(batches)
    idx = torch.as_tensor(gen.judged_scenarios(trf, seed), device=device)
    x0s, ups, yps = (tile(a, B, device)
                     for a in (data.x0, data.u_past, data.y_past))
    synchronize(device)
    run.inputs_s = time.perf_counter() - t

    t = time.perf_counter()
    lib = _kernels.load(cell.engine.LIBRARY) if cuda else None
    run.kernel_load_s = time.perf_counter() - t
    run.kernel_build_s = lib.build_seconds if lib else 0.0

    spans = Spans() if trace else None
    t = time.perf_counter()
    program = cell.engine.build(cfg, data, T, device,
                                spans.wrap if trace else (lambda k: k))
    run.host_build_s = time.perf_counter() - t

    t = time.perf_counter()
    for i in range(WARMUP_CALLS):
        t1 = time.perf_counter()
        res = program.run(x0s, ups, yps, batches[i % P])
        del res
        synchronize(device)
        per_call = time.perf_counter() - t1
    run.warmup_s = time.perf_counter() - t

    events = None
    if cuda:
        n_est = int(seconds / max(per_call, 1e-5) * 1.25) + 64
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(n_est + 1)]
    reservoir = gen.Reservoir(trf["judge_evaluations"], seed)
    kept = [None] * reservoir.k
    launches0, others0 = program.launches(), program.others()
    if spans:
        spans.active = True
    synchronize(device)
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    if cuda:
        events[0].record()
    i, host = 0, 0.0
    while True:
        h0 = time.perf_counter()
        res = program.run(x0s, ups, yps, batches[i % P])
        h1 = time.perf_counter()
        host += h1 - h0
        if cuda:
            if i + 1 == len(events):
                events.append(torch.cuda.Event(enable_timing=True))
            events[i + 1].record()
        slot = reservoir.slot(i)
        if slot is not None:
            kept[slot] = (gather(res, idx),
                          batches[i % P].index_select(0, idx))
        del res
        i += 1
        if h1 - t0 >= seconds:
            break
    synchronize(device)
    run.window_s = time.perf_counter() - t0
    run.n_eval, run.host_call_s = i, host
    run.launched = program.launches() - launches0
    run.others = program.others() - others0
    run.expected_launches = i if cuda else 0
    if spans:
        spans.active = False
        run.spans_ms = spans.ms()
    run.intervals_ms = ([events[j].elapsed_time(events[j + 1])
                         for j in range(i)] if cuda else [])
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated(device)
                             if cuda else 0)
    if trace and cuda:
        run.profiled = records.profile_calls(
            lambda j: program.run(x0s, ups, yps, batches[j % P]),
            trf["profile_calls"])
    run.kept = [k for k in kept if k is not None]
    run.data = data
    return run


def gaps(got: dict, ref: dict) -> dict:
    """The numbers compared, one per row (scenario): the widest gap of the
    applied inputs (``du``), the measured outputs (``dy``), the costs
    relative to one plus the reference's (``dcost``), the final plant
    state and windows (``dstate``) and, where the engine returns one,
    the final solver state (``dsolver``); and the count of solves whose
    ``converged`` flag differs from the reference's (``conv_gap``).
    ``got`` holds the program's fields as numpy (floats as float64),
    rows first; ``ref`` the reference's outputs."""
    d = {f: np.abs(got[f] - ref[REF_NAMES[f]]).reshape(len(got[f]), -1)
         for f in got if f != "converged"}
    d["costs"] = d["costs"] / (1.0 + np.abs(ref["costs"]))
    out = {"du": d["u_sys"].max(1), "dy": d["y_sys"].max(1),
           "dcost": d["costs"].max(1),
           "dstate": np.concatenate(
               [d[f] for f in ("x_final", "u_past", "y_past")], 1).max(1)}
    if "solver_state" in d:
        out["dsolver"] = d["solver_state"].max(1)
    out["conv_gap"] = (got["converged"] != ref["converged"]).reshape(
        len(got["converged"]), -1).sum(1)
    return out


def judge(run: Run) -> bool:
    """Recompute the judged scenarios of the kept evaluations with the
    plain reference in float64 on the run's device, and hold the
    program's outputs to the configuration's limits. Fills
    ``run.checks`` and ``run.failed``."""
    limits = run.cell.config["limits"]
    n = len(run.kept)
    got = {}
    for f in run.kept[0][0] if run.kept else ():
        t = torch.cat([out[f] for out, _ in run.kept])
        got[f] = (t if t.dtype == torch.bool else t.double()).cpu().numpy()
    W = torch.cat([w for _, w in run.kept]).double()
    ref = run.cell.engine.reference_run(run.cell.config, run.data, W)
    bad = np.zeros(n, dtype=bool)
    for name, per_row in gaps(got, ref).items():
        value = per_row.max().item() if per_row.size else float("nan")
        run.checks[name] = (value, limits[name])
        bad |= ~(per_row.reshape(n, -1).max(1) <= limits[name])
    run.checks["launch_gap"] = (abs(run.launched - run.expected_launches)
                                + run.others, 0)
    run.failed = int(bad.sum())
    conv = got.get("converged", np.zeros(0))
    run.converged_share = float(conv.mean()) if conv.size else float("nan")
    run.residual = ref.get("residual")
    return n > 0 and all(v <= lim for v, lim in run.checks.values())


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "nvidia-smi not read"


def describe(run: Run, smi: str) -> None:
    """The set-up parts, the window and the bounds, on earlier lines."""
    log(f"cell {run.cell.name} seed {run.seed}: B={run.B} T={run.T}, "
        f"{run.n_eval} evaluations in {run.window_s:.6f} s [{smi}]")
    log(f"set-up {run.setup_s:.6f} s: imports {run.import_s:.6f}, CUDA "
        f"init {run.cuda_init_s:.6f}, inputs {run.inputs_s:.6f}, kernel "
        f"load {run.kernel_load_s:.6f} (nvcc {run.kernel_build_s:.6f}), "
        f"host build {run.host_build_s:.6f}, warm-up {run.warmup_s:.6f}")
    fma_ms, fma_by = work.bound_ms(run.flops, run.nbytes,
                                   work.FP32_FMA_FLOP_PER_S)
    log(f"{run.kernel} work per evaluation: {run.flops:.6e} flop, "
        f"{run.nbytes:.6e} bytes; bound at the float32 FMA rate (67 "
        f"TFLOP/s): {fma_ms:.6f} ms ({fma_by})")
    span = run.mean_span_ms()
    share = (f"the mean kernel span {span:.6f} ms: "
             f"{100 * run.bound_ms / span:.4f} %" if span
             else "no kernel span (untraced run)")
    log(f"{run.kernel} roofline: bound {run.bound_ms:.6f} ms by "
        f"{run.bound_by} (495 TFLOP/s TF32, 3.35 TB/s) against {share} "
        f"[{smi}]")
    log(f"host per call {1e3 * run.host_call_s / run.n_eval:.6f} ms, "
        f"window per evaluation {1e3 * run.window_s / run.n_eval:.6f} ms")
    log(f"launches: {run.launched} of the hand kernel for {run.n_eval} "
        f"calls (expected {run.expected_launches}), {run.others} of any "
        f"other body")
    if run.profiled is not None:
        p = run.profiled
        log(f"profiled {run.cell.traffic['profile_calls']} calls: wall "
            f"{p.wall_s:.6f} s, device busy {p.busy_s:.6f} s; "
            f"{p.session.counts()}; complete {p.session.complete}")


def result_line(run: Run, correct: bool) -> dict:
    metrics = {}
    for m in run.cell.metrics[int(run.trace)]:
        value = load_metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(
        run.device), "count": run.cell.chips,
        "memory_peak_bytes": run.memory_peak_bytes}
    line = {"correct": correct, "attempted": run.n_eval,
            "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace:
        p = run.profiled
        device["busy_s"] = p.busy_s
        device["window_s"] = p.wall_s
        if p.session.complete:
            line["breakdown"] = {
                "device_ops": [[k, v / 1e3] for k, v in sorted(
                    p.session.ms.items(), key=lambda kv: -kv[1])[:10]],
                "idle_gaps": records.idle_gaps(p),
            }
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in run.checks.items()}
    return line


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float, root: Path) -> int:
    t_imported = time.perf_counter()
    args = parse(argv)
    # The system under test is the checkout's own: without it, no result.
    importlib.import_module("direct_data_driven_mpc_tpu_torch")
    cell = load_cell(root, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.init()
    t_cuda = time.perf_counter()
    run = measure(cell, args.seed, args.seconds, bool(args.trace), device,
                  t_start)
    run.import_s, run.cuda_init_s = t_imported - t_start, t_cuda - t_imported
    smi = power_limit()
    describe(run, smi)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    correct = judge(run)
    log(f"output check: {len(run.kept)} evaluations x "
        f"{len(run.kept[0][1]) if run.kept else 0} scenarios x {run.T} "
        f"steps against the float64 reference in {time.perf_counter() - t:.3f}"
        f" s; converged share {run.converged_share:.6f}")
    if run.residual is not None:
        r, conv = run.residual, run.residual <= 1.0
        top = r[conv].max() if conv.any() else np.nan
        low = r[~conv].min() if not conv.all() else np.nan
        log(f"reference residual over tol: converged solves up to {top:.6e},"
            f" the others from {low:.6e}")
    line = result_line(run, correct)
    found = forbidden_modules()
    if found:
        log(f"the process holds {', '.join(found)} after the window: the "
            "benchmark may load neither JAX nor the JAX package")
        return 4
    for name, (value, limit) in run.checks.items():
        log(f"check {name}: {value!r} (limit {limit!r})")
    print(json.dumps(line), flush=True)
    return 0
