"""PyTorch port, segmented runs, checkpoints and profiling: resume from a
checkpoint bit-identical to the uninterrupted run (``control.segmented``,
``utils.checkpoint``) with the exact map, the device ADMM and the box
ADMM's ladder (integer rung lanes) carried across segments; noise that
does not depend on how a run is split; the checkpoint's checks; the
profiler's trace, ``Timer`` and ``rollout_metrics``
(``utils.profiling``) against the JAX package's on the same numpy
results; and the new device entry points, which raise without a card
unless given ``device="cpu"``."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from direct_data_driven_mpc_tpu.control.loop import (  # noqa: E402
    ClosedLoopResult as JaxClosedLoopResult,
)
from direct_data_driven_mpc_tpu.utils import profiling as jprof  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control import segmented as sg  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control import tuning  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control.loop import (  # noqa: E402
    ClosedLoopResult,
)
from direct_data_driven_mpc_tpu_torch.parallel.batch import (  # noqa: E402
    batched_closed_loop,
)
from direct_data_driven_mpc_tpu_torch.qp import batch_build  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp.admm import ADMMState  # noqa: E402
from direct_data_driven_mpc_tpu_torch.qp.box import BoxADMMState  # noqa: E402
from direct_data_driven_mpc_tpu_torch.utils import checkpoint as ck  # noqa: E402
from direct_data_driven_mpc_tpu_torch.utils import profiling  # noqa: E402

from tests.test_torch_batch_build import _data  # noqa: E402
from tests.test_torch_host import port_setup  # noqa: E402
from tests.test_torch_iterative import one_blas_thread  # noqa: E402,F401

B, SEG, EPS = 3, 10, 0.002
F64 = torch.float64
FIELDS = ("u_sys", "y_sys", "costs", "converged", "x_final", "u_past",
          "y_past")


@pytest.fixture(scope="module")
def setups():
    return {"NONE": port_setup(), "CONVEX": port_setup(slack="CONVEX")}


def _solver(setups, kind, dtype=F64):
    """``(plant, solver, admm_iters, zero solver state)`` of one kind."""
    jplant, _, ctrl, _ = setups["CONVEX" if kind == "admm" else "NONE"]
    if kind == "exact":
        return jplant, ctrl.solution_map(device="cpu", dtype=dtype), 1, None
    if kind == "admm":
        solver = ctrl.admm_solver(device="cpu", dtype=dtype)
        nbox = solver.v_c.shape[0]
        zero = ADMMState(s=torch.zeros(B, nbox, dtype=dtype),
                         w=torch.zeros(B, nbox, dtype=dtype))
        return jplant, solver, 16, zero
    solver = ctrl.box_admm_solver(u_bounds=(-0.85, 0.85), device="cpu",
                                  dtype=dtype)
    nbox = solver.lo.shape[0]
    zero = BoxADMMState(s=torch.zeros(B, nbox, dtype=dtype),
                        w=torch.zeros(B, nbox, dtype=dtype),
                        rho_idx=torch.zeros(B, dtype=torch.int32))
    return jplant, solver, 40, zero


def _state(setups, kind="exact", seed=42, dtype=F64, solver_state=None):
    jplant, _, ctrl, _ = setups["CONVEX" if kind == "admm" else "NONE"]

    def tile(a, shape):
        return torch.as_tensor(a, dtype=dtype).reshape(shape).repeat(
            B, *([1] * (len(shape) - 1)))

    return sg.SegmentState(
        x=tile(jplant.get_state(), (1, 4)),
        u_past=tile(ctrl.u_past, (1, 4, 2)),
        y_past=tile(ctrl.y_past, (1, 4, 2)),
        segment=0, seed=seed, solver_state=solver_state,
    )


def _assert_equal(got, want, fields=FIELDS):
    for name in fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _assert_states_equal(got, want):
    assert (got.segment, got.seed) == (want.segment, want.seed)
    for name in ("x", "u_past", "y_past"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    if want.solver_state is None:
        assert got.solver_state is None
        return
    assert type(got.solver_state) is type(want.solver_state)
    for g, w in zip(got.solver_state, want.solver_state):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("kind", ["exact", "admm", "box"])
def test_resume_is_bit_identical(setups, tmp_path, kind):
    """Four segments in one run; two, a checkpoint, a resume into a zero
    template and two more: every field bit-identical, the solver state
    (the box ladder's integer rungs included) too; and both equal to one
    ``batched_closed_loop`` over the segments' concatenated noise."""
    plant, solver, iters, zero = _solver(setups, kind)
    kw = dict(eps_max=EPS, segment_steps=SEG, admm_iters=iters, dtype=F64)
    ckpt = str(tmp_path / "state.npz")

    end, full = sg.run_segmented(plant.as_params(), solver,
                                 _state(setups, kind), n_segments=4, **kw)
    _, part1 = sg.run_segmented(plant.as_params(), solver,
                                _state(setups, kind), n_segments=2,
                                checkpoint_path=ckpt, **kw)
    template = _state(setups, kind, seed=0, solver_state=zero)
    template.x = torch.zeros_like(template.x)
    restored = sg.resume_from_checkpoint(ckpt, template)
    assert restored.segment == 2 and restored.seed == 42
    end2, part2 = sg.run_segmented(plant.as_params(), solver, restored,
                                   n_segments=2, **kw)
    for name in ("u_sys", "y_sys", "costs", "converged"):
        joined = torch.cat([getattr(part1, name), getattr(part2, name)], 1)
        assert torch.equal(joined, getattr(full, name)), name
    _assert_equal(part2, full, FIELDS[4:])
    _assert_states_equal(end2, end)
    if kind == "box":
        assert end.solver_state.rho_idx.dtype == torch.int32

    W = torch.cat([sg.segment_noise(42, i, B, SEG, 2, EPS, "cpu", F64)
                   for i in range(4)], 1)
    s0 = _state(setups, kind)
    once = batched_closed_loop(plant.as_params(), solver, s0.x, s0.u_past,
                               s0.y_past, W, n_steps=4 * SEG,
                               admm_iters=iters)
    _assert_equal(full, once)


def test_resume_then_checkpoint_again(setups, tmp_path):
    """A resumed run checkpoints in turn, and its resume still continues
    the uninterrupted run."""
    plant, solver, _, _ = _solver(setups, "exact")
    kw = dict(eps_max=EPS, segment_steps=SEG, dtype=F64)
    ckpt = str(tmp_path / "a" / "state.npz")
    _, full = sg.run_segmented(plant.as_params(), solver, _state(setups),
                               n_segments=3, **kw)
    state = _state(setups)
    parts = []
    for _ in range(3):
        _, part = sg.run_segmented(plant.as_params(), solver, state,
                                   n_segments=1, checkpoint_path=ckpt, **kw)
        parts.append(part.u_sys)
        state = sg.resume_from_checkpoint(ckpt, _state(setups))
    assert state.segment == 3
    assert torch.equal(torch.cat(parts, 1), full.u_sys)
    _, meta = ck.load_checkpoint(ckpt, _state(setups))
    assert meta == {"segment": 3}
    assert os.listdir(tmp_path / "a") == ["state.npz"]  # no temp file left


def test_noise_does_not_depend_on_the_split(setups):
    """The same seed draws the same noise whatever the split; another
    seed or segment draws other noise."""
    plant, solver, _, _ = _solver(setups, "exact", torch.float32)
    kw = dict(eps_max=EPS, dtype=torch.float32)
    state = _state(setups, dtype=torch.float32)
    _, whole = sg.run_segmented(plant.as_params(), solver, state,
                                segment_steps=SEG, n_segments=2, **kw)
    _, again = sg.run_segmented(plant.as_params(), solver, state,
                                segment_steps=SEG, n_segments=2, **kw)
    _assert_equal(whole, again)
    parts = []
    for _ in range(2):
        state, part = sg.run_segmented(plant.as_params(), solver, state,
                                       segment_steps=SEG, n_segments=1,
                                       **kw)
        parts.append(part.y_sys)
    assert torch.equal(torch.cat(parts, 1), whole.y_sys)

    W = sg.segment_noise(7, 1, B, SEG, 2, EPS, "cpu")
    assert W.shape == (B, SEG, 2) and W.dtype == torch.float32
    assert float(W.abs().max()) <= EPS
    assert torch.equal(W, sg.segment_noise(7, 1, B, SEG, 2, EPS, "cpu"))
    assert not torch.equal(W, sg.segment_noise(8, 1, B, SEG, 2, EPS, "cpu"))
    assert not torch.equal(W, sg.segment_noise(7, 2, B, SEG, 2, EPS, "cpu"))


def test_segments_must_align_with_the_solve_cadence(setups):
    plant, solver, _, _ = _solver(setups, "exact")
    with pytest.raises(ValueError, match="multiple of n_mpc_step"):
        sg.run_segmented(plant.as_params(), solver, _state(setups), EPS,
                         segment_steps=10, n_segments=1, n_mpc_step=4)


@pytest.mark.parametrize("change, match", [
    ("batch", "Leaf 0 mismatch"),
    ("dtype", "Leaf 0 mismatch"),
    ("rung_dtype", "Leaf 7 mismatch"),
    ("solver_state", "leaves"),
    ("state_type", "structure"),
])
def test_checkpoint_rejects_another_template(setups, tmp_path, change,
                                             match):
    """Shape, dtype (integer rung lanes included), leaf count and
    structure are all checked against the template."""
    _, _, _, zero = _solver(setups, "box")
    path = str(tmp_path / "s.npz")
    ck.save_checkpoint(path, _state(setups, solver_state=zero))
    template = _state(setups, solver_state=zero)
    if change == "batch":
        template.x = template.x[:2]
    elif change == "dtype":
        template.x = template.x.float()
    elif change == "rung_dtype":
        template.solver_state = zero._replace(rho_idx=zero.rho_idx.long())
    elif change == "solver_state":
        template.solver_state = None
    else:
        template.solver_state = ADMMState(zero.s, zero.w), zero.rho_idx
    with pytest.raises(ValueError, match=match):
        ck.load_checkpoint(path, template)


def test_checkpoint_round_trips_leaves_and_metadata(tmp_path):
    """Tensors come back in their dtype, numpy arrays as numpy, Python
    scalars as Python scalars, ``None`` as ``None``; metadata holding
    tensors and numpy scalars is written as JSON."""
    state = {"a": 1}  # a dict is a leaf: saved as an object array, refused
    with pytest.raises(ValueError):
        ck.save_checkpoint(str(tmp_path / "x.npz"), state)
    tree = (torch.arange(6, dtype=torch.int32).reshape(2, 3),
            [np.float32(2.5) * np.ones(2, np.float32), None, 3, 0.25],
            ADMMState(s=torch.ones(2, dtype=torch.bool), w=None))
    path = str(tmp_path / "t.npz")
    ck.save_checkpoint(path, tree, metadata={
        "step": torch.tensor(4), "scale": np.float64(0.5), "name": "x"})
    zero = (torch.zeros(2, 3, dtype=torch.int32),
            [np.zeros(2, np.float32), None, 0, 0.0],
            ADMMState(s=torch.zeros(2, dtype=torch.bool), w=None))
    got, meta = ck.load_checkpoint(path, zero)
    assert meta == {"step": 4, "scale": 0.5, "name": "x"}
    assert torch.equal(got[0], tree[0]) and got[0].dtype == torch.int32
    assert isinstance(got[1], list) and got[1][1] is None
    np.testing.assert_array_equal(got[1][0], tree[1][0])
    assert got[1][2] == 3 and isinstance(got[1][2], int)
    assert got[1][3] == 0.25 and isinstance(got[1][3], float)
    assert isinstance(got[2], ADMMState) and got[2].w is None
    assert torch.equal(got[2].s, tree[2].s)


def test_profiler_trace_writes_its_file(setups, tmp_path):
    plant, solver, _, _ = _solver(setups, "exact")
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir) as path:
        sg.run_segmented(plant.as_params(), solver, _state(setups), EPS,
                         segment_steps=SEG, n_segments=1, dtype=F64)
    assert os.path.dirname(path) == log_dir and os.path.isfile(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert any("matmul" in e["name"] or "mm" in e["name"] for e in ops)


def test_timer_matches_jax():
    """``Timer``'s percentiles and summary equal the JAX package's on the
    same samples; ``timeit`` records ``iters`` samples after the warm-up
    and returns the last result; ``measure`` one sample."""
    samples = [0.5, 0.125, 0.25, 1.0, 0.75]
    timer, jtimer = profiling.Timer(), jprof.Timer()
    timer.samples, jtimer.samples = list(samples), list(samples)
    assert timer.summary() == jtimer.summary()
    assert (timer.p50, timer.p99, timer.best) == (jtimer.p50, jtimer.p99,
                                                  jtimer.best)
    calls = []
    timer = profiling.Timer()
    out = timer.timeit(lambda x: calls.append(x) or torch.ones(2) * x, 3.0,
                       iters=4, warmup=2)
    assert len(calls) == 6 and len(timer.samples) == 4
    assert torch.equal(out, torch.full((2,), 3.0))
    with timer.measure():
        pass
    assert timer.summary()["n"] == 5


def test_rollout_metrics_match_jax():
    rng = np.random.default_rng(0)
    arrays = dict(u_sys=rng.normal(size=(3, 6, 2)),
                  y_sys=rng.normal(size=(3, 6, 2)),
                  costs=rng.uniform(size=(3, 6)),
                  converged=rng.uniform(size=(3, 6)) > 0.2,
                  x_final=rng.normal(size=(3, 4)),
                  u_past=rng.normal(size=(3, 4, 2)),
                  y_past=rng.normal(size=(3, 4, 2)))
    res = ClosedLoopResult(**{k: torch.as_tensor(v)
                              for k, v in arrays.items()})
    jres = JaxClosedLoopResult(**arrays)
    u_s, y_s = np.array([[1.0], [1.0]]), np.array([[0.65], [0.77]])
    for kw in ({}, {"u_s": u_s, "y_s": y_s},
               {"u_s": torch.as_tensor(u_s), "y_s": torch.as_tensor(y_s)}):
        got = profiling.rollout_metrics(res, **kw)
        want = jprof.rollout_metrics(
            jres, **{k: np.asarray(v) for k, v in kw.items()})
        assert got == want
    arrays["y_sys"][1, 2, 0] = np.nan
    assert not profiling.rollout_metrics(
        res._replace(y_sys=torch.as_tensor(arrays["y_sys"])))["finite"]


@pytest.mark.parametrize("entry", [
    "build_batched_solution_operators", "stacked_solution_map",
    "differentiable_solution_map", "make_closed_loop_objective",
])
def test_new_entry_points_run_on_the_card_by_default(setups, monkeypatch,
                                                     entry):
    """Without ``device`` each means the CUDA card: with none present it
    raises (naming ``device='cpu'``), never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Hu, Hy, _, pdims, kw = _data(B=2)
    jplant, _, ctrl, _ = setups["NONE"]
    if entry == "build_batched_solution_operators":
        call = lambda: batch_build.build_batched_solution_operators(  # noqa: E731
            Hu, Hy, pdims, **kw)
    elif entry == "stacked_solution_map":
        ops = batch_build.build_batched_solution_operators(
            Hu, Hy, pdims, device="cpu", **kw)
        call = lambda: batch_build.stacked_solution_map(ops)  # noqa: E731
    elif entry == "differentiable_solution_map":
        call = lambda: tuning.differentiable_solution_map(  # noqa: E731
            ctrl.spec, 1.0, 1.0)
    else:
        s = _state(setups)
        call = lambda: tuning.make_closed_loop_objective(  # noqa: E731
            ctrl.spec, jplant.as_params(), s.x, s.u_past, s.y_past,
            torch.zeros(B, 4, 2, dtype=F64), n_steps=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_chip_smoke_sweep_and_tuning_phases_run_on_the_cpu(capsys):
    """``chip_smoke.py``'s phases 31-35 at a tiny size on the CPU (the
    profiler's host operator events stand in for the card's kernel
    events): every check passes."""
    from chip_smoke import (
        build_four_tank_robust,
        host_layer_phase,
        profiling_phase,
        scenario_batch,
        segmented_phase,
        sweep_phase,
        tuning_phase,
    )
    from direct_data_driven_mpc_tpu_torch.control.linear_engine import (
        build_linear_engine,
    )

    dev = torch.device("cpu")
    plant, ctrl = build_four_tank_robust()
    W = torch.as_tensor(0.002 * np.random.default_rng(0).uniform(
        -1, 1, (6, 12, 2)), dtype=torch.float32)
    main = dict(plant=plant, ctrl=ctrl,
                inputs=(*scenario_batch(plant, ctrl, 6, dev), W),
                bm50=build_linear_engine(ctrl, plant.as_params(),
                                         solves_per_block=50, device=dev))
    host_layer_phase(dev, "cpu", main, n_steps=12)
    sweep = sweep_phase(dev, "cpu", main, B=6, T=12, n_alone=2,
                        n_fallback=2)
    segmented_phase(dev, "cpu", main, B=4, B_lad=3, seg=3)
    tuning_phase(dev, "cpu", main, B=2, T=8, steps=2)
    profiling_phase(dev, "cpu", sweep, T=4)
    out = capsys.readouterr().out
    for line in ("TEC stable", "UCON unstable", "every feasible lane true",
                 "solver state (torch.float32, torch.float32, torch.int32) "
                 "bit-equal", "cpu_op events"):
        assert line in out, line
