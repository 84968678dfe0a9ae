"""The C runtime: the interactive per-step solve and the standalone
deployment runtime.

``_ddmpc_ext.c`` is a CPython extension (a ctypes call costs ~10 us,
more than the arithmetic it wraps; ``METH_FASTCALL`` and the buffer
protocol cost ~100 ns) that holds one controller's per-step solve:
the affine matvec and cost of slack ``NONE``, the warm-started ADMM
iterations of ``CONVEX``. ``ddmpc_runtime.c`` with ``ddmpc_demo.c`` is
the pure C99 runtime that runs an exported controller
(``utils.export.export_controller``) with no Python at all.

Both are host code by nature: a deployment runs them on an embedded or
real-time host. They are compiled with the system C compiler (``CC``,
else ``cc``) at first use into ``build/native/`` at the repository root
(listed in ``.gitignore``), under a name that carries a hash of the
sources, the compiler and its ``--version``, the flags, the
interpreter's extension suffix and the host CPU's identity (vendor,
family, model and feature flags: ``-march=native`` ties a build to its
CPU, so a tree shared between hosts builds once for each kind).
A failed build or load raises ``RuntimeError`` with the compiler's
output; nothing falls back to numpy here. Nothing happens at import.
Counterpart of ``direct_data_driven_mpc_tpu/native/__init__.py``.
"""

from __future__ import annotations

import hashlib
import importlib.util
import functools
import os
import platform
import subprocess
import sysconfig
import tempfile
import time
from pathlib import Path
from typing import Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
EXT_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
DEMO_FLAGS = ["-O2", "-std=c99", "-Wall"]

_loaded: dict = {}


def _compiler() -> str:
    return os.environ.get("CC", "cc")


@functools.lru_cache(maxsize=None)
def _compiler_version(cc: str) -> str:
    """``cc --version``'s output (or why there is none); it goes into
    the build's hash, and a compiler that cannot run fails the build."""
    try:
        proc = subprocess.run([cc, "--version"], capture_output=True,
                              text=True, timeout=60)
        return f"{proc.returncode}:{proc.stdout}{proc.stderr}"
    except (OSError, subprocess.SubprocessError) as e:
        return repr(e)


@functools.lru_cache(maxsize=None)
def _cpu_identity() -> str:
    """The first CPU's vendor, family, model and feature flags from
    ``/proc/cpuinfo``; the platform's names where there is none."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    keys = ("vendor_id", "cpu family", "model", "flags", "Features",
            "CPU implementer", "CPU part")
    found = [f"{k}={info[k]}" for k in keys if k in info]
    return ";".join(found) or f"{platform.machine()};{platform.processor()}"


def _build_path(stem: str, srcs: list, args: list, suffix: str,
                headers: tuple = ()) -> Path:
    """``build/native/<stem>-<hash><suffix>``, the hash over ``srcs``,
    ``headers``, the compiler, its version, ``args``, ``suffix`` and the
    CPU."""
    cc = _compiler()
    key = hashlib.sha256()
    for src in (*srcs, *headers):
        key.update(src.read_bytes())
    key.update(" ".join([cc, *args, suffix]).encode())
    key.update(_compiler_version(cc).encode())
    key.update(_cpu_identity().encode())
    return BUILD_DIR / f"{stem}-{key.hexdigest()[:16]}{suffix}"


def _build(stem: str, srcs: list, args: list, suffix: str,
           headers: tuple = ()) -> Tuple[Path, float]:
    """Compile ``srcs`` with ``args`` into :func:`_build_path` unless
    that file exists; ``(path, seconds compiling)``."""
    cc = _compiler()
    out = _build_path(stem, srcs, args, suffix, headers)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a private file, then rename: concurrent builds never
    # load a half-written file.
    fd, tmp = tempfile.mkstemp(suffix=suffix, dir=BUILD_DIR)
    os.close(fd)
    cmd = [cc, *args, *map(str, srcs), "-o", tmp, "-lm"]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed: {e}") from e
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"{' '.join(cmd)} exited with {proc.returncode}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.chmod(tmp, 0o755)
    os.replace(tmp, out)
    return out, seconds


def load():
    """The extension module, built and loaded at first use; it records
    ``compiler``, ``build_seconds`` (0.0 when an earlier build of the
    same sources was on disk) and ``path``. Raises ``RuntimeError`` when
    the build or the load fails."""
    include = sysconfig.get_paths()["include"]
    path, seconds = _build(
        "_ddmpc_ext", [_SRC / "_ddmpc_ext.c"],
        [*EXT_FLAGS, f"-I{include}"],
        sysconfig.get_config_var("EXT_SUFFIX"),
    )
    if path in _loaded:
        return _loaded[path]
    try:
        # The module name must be the one of its PyInit__ddmpc_ext
        # symbol, whatever the file is called.
        spec = importlib.util.spec_from_file_location("_ddmpc_ext", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except ImportError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
    mod.compiler = _compiler()
    mod.build_seconds = seconds
    mod.path = path
    _loaded[path] = mod
    return mod


def build_runtime_demo() -> str:
    """Build the standalone C runtime and its closed-loop demo
    (``ddmpc_runtime.c`` + ``ddmpc_demo.c``) and return the executable's
    path. Usage: ``ddmpc_demo <controller.blob> <noise.f64> <T>
    <out.f64>``. Raises ``RuntimeError`` when the build fails."""
    path, _ = _build(
        "ddmpc_demo",
        [_SRC / "ddmpc_demo.c", _SRC / "ddmpc_runtime.c"],
        DEMO_FLAGS, "", headers=(_SRC / "ddmpc_runtime.h",),
    )
    return str(path)


class NativeAffineSolver:
    """The C per-step affine solve and cost of one slack-``NONE``
    controller: C-contiguous float64 copies of the operator and a
    preallocated output, so a solve is one foreign call and allocates
    nothing. ``solve`` returns that output buffer, which the next solve
    overwrites."""

    def __init__(self, op: dict):
        self._ext = load()
        self.u_base = np.ascontiguousarray(op["u_base"], dtype=np.float64)
        self.U_gain = np.ascontiguousarray(op["U_gain"], dtype=np.float64)
        self.cost_P = np.ascontiguousarray(op["cost_P"], dtype=np.float64)
        self.cost_q = np.ascontiguousarray(op["cost_q"], dtype=np.float64)
        self.cost_r = float(op["cost_r"])
        self.nu, self.nt = self.U_gain.shape
        self._u_out = np.empty(self.nu, dtype=np.float64)

    def solve(self, theta: np.ndarray) -> Tuple[np.ndarray, float]:
        # The C loops take their lengths from the buffers: check them.
        if theta.shape != (self.nt,):
            raise ValueError(f"theta must have shape ({self.nt},); got "
                             f"{theta.shape}")
        cost = self._ext.affine_solve(
            self.u_base, self.U_gain, self.cost_P, self.cost_q,
            self.cost_r, theta, self._u_out,
        )
        return self._u_out, cost


class NativeADMMSolver:
    """The C warm-started ADMM loop of one ``CONVEX`` slack controller
    (the operator of ``qp.admm.compute_admm_operator_np``)."""

    def __init__(self, op: dict):
        self._ext = load()
        for k in ("v_c", "V_theta", "V_s", "u_c", "U_theta", "U_s",
                  "cost_P", "cost_q"):
            setattr(self, k, np.ascontiguousarray(op[k], dtype=np.float64))
        self.cost_r = float(op["cost_r"])
        self.bound = float(op["bound"])
        self.rho = float(op["rho"])
        self.alpha = float(op.get("alpha", 1.0))
        self.nbox = self.v_c.shape[0]
        self._scratch = np.empty(self.nbox, dtype=np.float64)

    def solve(self, theta: np.ndarray, s: np.ndarray, w: np.ndarray,
              max_iters: int, tol: float):
        """Mutates ``s`` and ``w`` in place (the warm start; C-contiguous
        writable float64 of length ``nbox``); returns ``(u, cost, iters,
        r_prim, r_dual)``."""
        theta = np.ascontiguousarray(theta, dtype=np.float64)
        if s.shape != (self.nbox,) or w.shape != (self.nbox,):
            raise ValueError(f"s and w must have shape ({self.nbox},); got "
                             f"{s.shape} and {w.shape}")
        v_theta = np.ascontiguousarray(self.V_theta @ theta)
        iters, r_prim, r_dual = self._ext.admm_iterate(
            self.v_c, v_theta, self.V_s, s, w, self._scratch,
            self.bound, self.rho, int(max_iters), float(tol), self.alpha,
        )
        t = s - w
        u = self.u_c + self.U_theta @ theta + self.U_s @ t
        tt = np.concatenate([theta, t])
        cost = float(tt @ self.cost_P @ tt + self.cost_q @ tt + self.cost_r)
        return u, cost, iters, r_prim, r_dual
