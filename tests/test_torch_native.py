"""PyTorch port, the C runtime: the CPython extension that runs the
controller's per-step solve (``native/``), the controller's
``solve_path`` (native by default for slack NONE and CONVEX, an error and
never a silent numpy fallback when the build fails), the export of a
controller (``utils.export``) and the standalone C99 runtime's demo
closed loop, held against the port's numpy and Python loops and against
the JAX package's controller and export on the same numpy data."""

import os
import re
import subprocess
import sysconfig
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from direct_data_driven_mpc_tpu import native as jax_native  # noqa: E402
from direct_data_driven_mpc_tpu.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController as JaxController,
)
from direct_data_driven_mpc_tpu.control.operation import (  # noqa: E402
    simulate_data_driven_mpc_control_loop as jax_simulate_loop,
)
from direct_data_driven_mpc_tpu.models.lti_model import (  # noqa: E402
    LTIModel as JaxLTIModel,
)
from direct_data_driven_mpc_tpu.qp.spec import (  # noqa: E402
    DataDrivenMPCType as JaxType,
    SlackVarConstraintTypes as JaxSlack,
)
from direct_data_driven_mpc_tpu.utils.export import (  # noqa: E402
    export_controller as jax_export_controller,
)
from direct_data_driven_mpc_tpu_torch import native  # noqa: E402
from direct_data_driven_mpc_tpu_torch.control.controller import (  # noqa: E402
    DirectDataDrivenMPCController,
)
from direct_data_driven_mpc_tpu_torch.control.operation import (  # noqa: E402
    simulate_data_driven_mpc_control_loop,
)
from direct_data_driven_mpc_tpu_torch.models.lti_model import (  # noqa: E402
    LTIModel,
)
from direct_data_driven_mpc_tpu_torch.qp.admm import (  # noqa: E402
    admm_solve_np,
)
from direct_data_driven_mpc_tpu_torch.qp.spec import (  # noqa: E402
    DataDrivenMPCType,
    SlackVarConstraintTypes,
)
from direct_data_driven_mpc_tpu_torch.utils.export import (  # noqa: E402
    export_controller,
)

from tests._torch_jax_native import (  # noqa: E402,F401
    jax_c_solve,
    reference_c_solve,
)
from tests.test_closed_loop import FOUR_TANK  # noqa: E402

STEPS = 20
#: (slack, n_mpc_step) of tests/test_c_runtime.py.
LOOPS = [("NONE", 1), ("NONE", 4), ("CONVEX", 1)]
LOOP_IDS = ["NONE-1", "NONE-4", "CONVEX-1"]
#: Against the JAX controller on the same C loop, and against the
#: port's numpy loop (both exit at 1e-8 on their own residuals, so a
#: CONVEX exit may fall one iteration apart).
JAX_ATOL = {"NONE": 1e-12, "CONVEX": 1e-10}
NUMPY_ATOL = {"NONE": 1e-12, "CONVEX": 1e-7}
#: The JAX package's shared build of its extension, which every worker
#: of a run may write (tests/_torch_jax_native.py).
SHARED_LIB = jax_native._LIB


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """The host float64 builds on one BLAS thread (see
    tests/test_torch_iterative.py)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(limits=1):
        yield


def _data(seed=0, N=120):
    """Four-tank data as tests/test_c_runtime.py draws it."""
    rng = np.random.default_rng(seed)
    plant = LTIModel(**FOUR_TANK)
    u_d = rng.uniform(-1, 1, (N, 2))
    w_d = 0.002 * rng.uniform(-1, 1, (N, 2))
    return u_d, plant.simulate(u_d, w_d, N)


def _kwargs(u_d, y_d, n_mpc_step=1, L=10):
    return dict(
        n=4, m=2, p=2, u_d=u_d, y_d=y_d, L=L,
        Q=3.0 * np.eye(2 * L), R=1e-4 * np.eye(2 * L),
        u_s=np.array([[1.0], [1.0]]), y_s=np.array([[0.65], [0.77]]),
        eps_max=0.002, lamb_alpha=0.1 / 0.002, lamb_sigma=1000.0, c=1.0,
        n_mpc_step=n_mpc_step,
    )


def _port(slack="NONE", n_mpc_step=1, **kw):
    u_d, y_d = _data()
    return DirectDataDrivenMPCController(
        **_kwargs(u_d, y_d, n_mpc_step),
        slack_var_constraint_type=SlackVarConstraintTypes[slack],
        controller_type=DataDrivenMPCType.ROBUST, **kw,
    )


def _jax(slack="NONE", n_mpc_step=1):
    u_d, y_d = _data()
    return JaxController(
        **_kwargs(u_d, y_d, n_mpc_step),
        slack_var_constraint_type=JaxSlack[slack],
        controller_type=JaxType.ROBUST,
    )


def _loop(ctrl, simulate, model, T=STEPS):
    """``T`` closed-loop steps from x = 0 on seeded noise: ``(u, y)``."""
    plant = model(**FOUR_TANK)
    plant.set_state(np.zeros(4))
    w = 0.002 * np.random.default_rng(7).uniform(-1, 1, (T, 2))
    return simulate(plant, ctrl, T, np.random.default_rng(0), verbose=0,
                    w_sys=w)


def test_native_affine_matches_numpy():
    ctrl = _port("NONE")
    op = ctrl.solution_operator()
    theta = np.random.default_rng(1).uniform(-1, 1, 16)
    u_c, cost_c = native.NativeAffineSolver(op).solve(theta)
    u_np = op["u_base"] + op["U_gain"] @ theta
    cost_np = float(theta @ op["cost_P"] @ theta + op["cost_q"] @ theta
                    + op["cost_r"])
    np.testing.assert_allclose(u_c, u_np, rtol=1e-13, atol=1e-13)
    assert cost_c == pytest.approx(cost_np, rel=1e-12)
    with pytest.raises(ValueError, match="theta"):
        native.NativeAffineSolver(op).solve(theta[:-1])


def test_native_admm_matches_numpy():
    ctrl = _port("CONVEX")
    op = ctrl._op
    theta = np.concatenate([ctrl.u_past.ravel(), ctrl.y_past.ravel()])
    solver = native.NativeADMMSolver(op)
    s, w = np.zeros(solver.nbox), np.zeros(solver.nbox)
    u_c, cost_c, _, r_prim, _ = solver.solve(theta, s, w, 500, 1e-10)
    u_np, cost_np, state, stats = admm_solve_np(op, theta, num_iters=500,
                                                tol=1e-10)
    assert stats.converged and r_prim <= 1e-10
    np.testing.assert_allclose(u_c, u_np, atol=1e-10)
    np.testing.assert_allclose(s, state[0], atol=1e-10)
    assert cost_c == pytest.approx(cost_np, abs=1e-9)
    with pytest.raises(ValueError, match="s and w"):
        solver.solve(theta, s[:-1], w, 5, 1e-10)


def _check_loop_matches_jax(slack, n_mpc_step):
    """The port's controller on its C solve against the JAX controller
    on its own, over a closed loop on the same plant and noise."""
    ctrl, jctrl = _port(slack, n_mpc_step), _jax(slack, n_mpc_step)
    assert ctrl.solve_path == "native" and jctrl._native is not None
    u, y = _loop(ctrl, simulate_data_driven_mpc_control_loop, LTIModel)
    ju, jy = _loop(jctrl, jax_simulate_loop, JaxLTIModel)
    np.testing.assert_allclose(u, ju, rtol=0, atol=JAX_ATOL[slack])
    np.testing.assert_allclose(y, jy, rtol=0, atol=JAX_ATOL[slack])
    assert ctrl.get_problem_solve_status() == "optimal"
    assert ctrl.get_optimal_cost_value() == pytest.approx(
        jctrl.get_optimal_cost_value(), abs=1e-8)


@pytest.mark.parametrize("slack,n_mpc_step", LOOPS, ids=LOOP_IDS)
def test_native_loop_matches_jax_controller(slack, n_mpc_step, jax_c_solve):
    """:func:`_check_loop_matches_jax`, with the JAX package's C extension
    loaded whatever this worker's build race did."""
    _check_loop_matches_jax(slack, n_mpc_step)


def _lose_the_reference_build(monkeypatch):
    """What the JAX package's ``get_lib()`` keeps after ``load failed
    (... file too short)``: no module, and no second attempt. Returns a
    reader of the shared extension's ``os.stat`` (None when absent)."""
    monkeypatch.setattr(jax_native, "_ext", None)
    monkeypatch.setattr(jax_native, "_load_attempted", True)

    def shared():
        if not os.path.exists(SHARED_LIB):
            return None
        st = os.stat(SHARED_LIB)
        return st.st_ino, st.st_size, st.st_mtime_ns

    return shared


@pytest.mark.parametrize("slack,n_mpc_step", LOOPS, ids=LOOP_IDS)
def test_lost_reference_build_still_runs_the_c_solve(
        slack, n_mpc_step, monkeypatch, tmp_path):
    """A worker whose reference build was lost to another worker's (the
    shared ``_ddmpc_ext.so`` read half-written) still holds the port's
    loop against the JAX controller's C solve, through a private build
    that leaves the shared file as it was."""
    shared = _lose_the_reference_build(monkeypatch)
    before = shared()
    ext = reference_c_solve(monkeypatch, tmp_path)
    assert jax_native.get_lib() is ext
    _check_loop_matches_jax(slack, n_mpc_step)
    assert shared() == before and jax_native._LIB == SHARED_LIB


def test_lost_reference_build_with_no_compiler_raises(monkeypatch, tmp_path):
    """With the reference's build lost and no working compiler, the
    helper raises the build's ``RuntimeError``: it neither skips nor
    leaves the JAX controller on its numpy solve."""
    shared = _lose_the_reference_build(monkeypatch)
    before = shared()
    monkeypatch.setenv("CC", "/bin/false")
    with pytest.raises(RuntimeError, match="/bin/false"):
        reference_c_solve(monkeypatch, tmp_path)
    monkeypatch.setenv("CC", "/nonexistent/cc")
    with pytest.raises(RuntimeError, match="nonexistent"):
        reference_c_solve(monkeypatch, tmp_path)
    assert jax_native._ext is None and jax_native.get_lib() is None
    assert shared() == before and jax_native._LIB == SHARED_LIB


@pytest.mark.parametrize("slack,n_mpc_step", LOOPS, ids=LOOP_IDS)
def test_native_loop_matches_numpy_loop(slack, n_mpc_step):
    ctrl = _port(slack, n_mpc_step)
    ref = _port(slack, n_mpc_step, solve_path="numpy")
    assert (ctrl.solve_path, ref.solve_path) == ("native", "numpy")
    u, y = _loop(ctrl, simulate_data_driven_mpc_control_loop, LTIModel)
    ru, ry = _loop(ref, simulate_data_driven_mpc_control_loop, LTIModel)
    np.testing.assert_allclose(u, ru, rtol=0, atol=NUMPY_ATOL[slack])
    np.testing.assert_allclose(y, ry, rtol=0, atol=NUMPY_ATOL[slack])


@pytest.mark.parametrize("slack,asked,expected", [
    ("NONE", None, "native"), ("CONVEX", None, "native"),
    ("NON_CONVEX", None, "numpy"), ("NONE", "numpy", "numpy"),
    ("CONVEX", "native", "native"),
])
def test_solve_path_default_and_read_back(slack, asked, expected):
    ctrl = _port(slack, solve_path=asked,
                 allow_nonconvex_slack=slack == "NON_CONVEX")
    assert ctrl.solve_path == expected
    assert (ctrl._native is not None) == (expected == "native")
    assert ctrl.get_problem_solve_status() == "optimal"


def test_nonconvex_native_and_unknown_paths_raise():
    with pytest.raises(ValueError, match="NON_CONVEX"):
        _port("NON_CONVEX", solve_path="native", allow_nonconvex_slack=True)
    with pytest.raises(ValueError, match="solve_path"):
        _port("NONE", solve_path="c")


def test_failed_build_raises_and_never_falls_back(monkeypatch):
    """With a compiler that fails, ``load()`` and a default controller
    raise the build's ``RuntimeError``; numpy runs when asked by name."""
    monkeypatch.setenv("CC", "/bin/false")
    with pytest.raises(RuntimeError, match="/bin/false"):
        native.load()
    with pytest.raises(RuntimeError, match="/bin/false"):
        _port("NONE")
    with pytest.raises(RuntimeError, match="/bin/false"):
        native.build_runtime_demo()
    ctrl = _port("CONVEX", solve_path="numpy")
    assert ctrl.get_problem_solve_status() == "optimal"
    monkeypatch.setenv("CC", "/nonexistent/cc")
    with pytest.raises(RuntimeError, match="nonexistent"):
        native.load()


def test_builds_land_in_build_native_with_hashed_names():
    root = Path(__file__).resolve().parents[1]
    ext = native.load()
    assert ext.path.parent == root / "build" / "native"
    suffix = re.escape(sysconfig.get_config_var("EXT_SUFFIX"))
    assert re.fullmatch(rf"_ddmpc_ext-[0-9a-f]{{16}}{suffix}", ext.path.name)
    assert ext.compiler == os.environ.get("CC", "cc")
    assert ext.build_seconds >= 0.0
    assert native.load() is ext
    demo = Path(native.build_runtime_demo())
    assert demo.parent == root / "build" / "native"
    assert re.fullmatch(r"ddmpc_demo-[0-9a-f]{16}", demo.name)
    assert os.access(demo, os.X_OK)
    package = Path(native.__file__).parent
    assert not list(package.glob("*.so")) and not (package / "ddmpc_demo"
                                                   ).exists()


def test_build_name_tracks_the_cpu_and_the_compiler_version(monkeypatch):
    """``-march=native`` ties a build to its CPU: a tree shared between
    hosts of another CPU or compiler release must not load this one."""
    args = ("_ddmpc_ext", [Path(native.__file__).parent / "_ddmpc_ext.c"],
            native.EXT_FLAGS, ".so")
    here = native._build_path(*args)
    assert native._build_path(*args) == here
    monkeypatch.setattr(native, "_cpu_identity", lambda: "another CPU")
    other_cpu = native._build_path(*args)
    monkeypatch.setattr(native, "_compiler_version", lambda cc: "cc 99.0")
    other_cc = native._build_path(*args)
    assert len({here, other_cpu, other_cc}) == 3


@pytest.mark.parametrize("slack", ["NONE", "CONVEX"])
def test_export_matches_jax_export(tmp_path, slack):
    """The blob's 48-byte header equals the JAX package's byte for byte;
    its float64 payload has the same length and agrees to the operators'
    1e-12."""
    port_blob, jax_blob = tmp_path / "port.blob", tmp_path / "jax.blob"
    plant = LTIModel(**FOUR_TANK)
    plant.set_state(np.arange(4) * 0.1)
    export_controller(_port(slack), str(port_blob), plant=plant)
    jplant = JaxLTIModel(**FOUR_TANK)
    jplant.set_state(np.arange(4) * 0.1)
    jax_export_controller(_jax(slack), str(jax_blob), plant=jplant)
    got, want = port_blob.read_bytes(), jax_blob.read_bytes()
    assert got[:48] == want[:48]
    assert len(got) == len(want)
    np.testing.assert_allclose(
        np.frombuffer(got[48:], dtype="<f8"),
        np.frombuffer(want[48:], dtype="<f8"), rtol=0, atol=1e-12,
    )


def test_export_nonconvex_raises(tmp_path):
    ctrl = _port("NON_CONVEX", allow_nonconvex_slack=True)
    with pytest.raises(ValueError, match="NON_CONVEX"):
        export_controller(ctrl, str(tmp_path / "x.blob"))


def _run_demo(blob, noise, T, out):
    return subprocess.run(
        [native.build_runtime_demo(), str(blob), str(noise), str(T),
         str(out)],
        capture_output=True, text=True, timeout=120,
    )


@pytest.mark.parametrize("slack,n_mpc_step", LOOPS, ids=LOOP_IDS)
def test_c_runtime_closed_loop_matches_python(tmp_path, slack, n_mpc_step):
    """The exported controller and plant, run for T steps by the C demo
    with no Python in the loop, against the port's Python loop on the
    same noise."""
    T = 40
    plant = LTIModel(**FOUR_TANK)
    ctrl = _port(slack, n_mpc_step)
    blob = tmp_path / "ctrl.blob"
    export_controller(ctrl, str(blob), plant=plant, x0=np.zeros(4))
    w_sys = 0.002 * np.random.default_rng(7).uniform(-1.0, 1.0, (T, 2))
    noise = tmp_path / "noise.f64"
    np.ascontiguousarray(w_sys, dtype="<f8").tofile(noise)
    out = tmp_path / "out.f64"
    proc = _run_demo(blob, noise, T, out)
    assert proc.returncode == 0, proc.stderr
    raw = np.fromfile(out, dtype="<f8")
    assert raw.size == T * 5
    u_c, y_c = raw[: T * 2].reshape(T, 2), raw[T * 2 : T * 4].reshape(T, 2)
    costs_c = raw[T * 4 :]
    plant.set_state(np.zeros(4))
    u_py, y_py = simulate_data_driven_mpc_control_loop(
        plant, ctrl, T, np.random.default_rng(0), verbose=0, w_sys=w_sys)
    atol = 1e-10 if slack == "NONE" else 1e-7
    np.testing.assert_allclose(u_c, u_py, rtol=0, atol=atol)
    np.testing.assert_allclose(y_c, y_py, rtol=0, atol=atol)
    assert np.isfinite(costs_c).all()
    assert costs_c[-1] == pytest.approx(ctrl.get_optimal_cost_value(),
                                        abs=1e-6)


def test_c_runtime_rejects_bad_and_truncated_blobs(tmp_path):
    bad = tmp_path / "bad.blob"
    bad.write_bytes(b"NOTDDMPC" + b"\x00" * 64)
    noise = tmp_path / "noise.f64"
    np.zeros(8).tofile(noise)
    proc = _run_demo(bad, noise, 2, tmp_path / "o.f64")
    assert proc.returncode != 0 and "bad header" in proc.stderr
    blob = tmp_path / "ctrl.blob"
    export_controller(_port("NONE"), str(blob), plant=LTIModel(**FOUR_TANK))
    trunc = tmp_path / "trunc.blob"
    data = blob.read_bytes()
    trunc.write_bytes(data[: len(data) // 2])
    proc = _run_demo(trunc, noise, 2, tmp_path / "o.f64")
    assert proc.returncode != 0 and "truncated" in proc.stderr
