"""Build and load the package's CUDA kernels.

Each kernel source under ``ops/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface,
at first use, into ``build/kernels/`` at the repository root (listed
in ``.gitignore``). The library's file name carries a hash of the
source and the flags, so an edited source is rebuilt. Nothing here
runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signatures: name -> (argtypes, restype).
_SIGNATURES = {
    "fused_rollout": {
        "fused_rollout_launch": ([_P] * 14 + [_I] * 10 + [_P], ctypes.c_int),
        "fused_rollout_plan": ([_I, _I, ctypes.POINTER(_I)], ctypes.c_int),
        "fused_rollout_blocks_per_sm": ([_I] * 3, ctypes.c_int),
        "fused_rollout_kernel_attributes": (
            [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)], ctypes.c_int
        ),
        "fused_rollout_nocost_smem_bytes": ([_I] * 2, ctypes.c_int),
        "fused_rollout_nocost_tile_rows": ([_I] * 2, ctypes.c_int),
        "fused_rollout_nocost_launch": (
            [_P] * 7 + [_I] * 8 + [_P], ctypes.c_int
        ),
    },
    "fused_admm": {
        "fused_admm_tile_rows": ([_I] * 6, ctypes.c_int),
        "fused_admm_smem_bytes": ([_I] * 6, ctypes.c_int),
        "fused_admm_launch": (
            [_P] * 24 + [_I] * 8 + [_F] * 3 + [_P], ctypes.c_int
        ),
        "fused_admm_blocks_per_sm": ([_I] * 6, ctypes.c_int),
        "fused_admm_kernel_attributes": (
            [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)], ctypes.c_int
        ),
        "fused_admm_nonconvex_tile_rows": ([_I] * 6, ctypes.c_int),
        "fused_admm_nonconvex_smem_bytes": ([_I] * 6, ctypes.c_int),
        "fused_admm_nonconvex_blocks_per_sm": ([_I] * 6, ctypes.c_int),
        "fused_admm_nonconvex_kernel_attributes": (
            [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)], ctypes.c_int
        ),
        "fused_admm_nonconvex_launch": (
            [_P] * 31 + [_I] * 10 + [_F] * 4 + [_P], ctypes.c_int
        ),
        "fused_ladder_tile_rows": ([_I] * 5, ctypes.c_int),
        "fused_ladder_smem_bytes": ([_I] * 5, ctypes.c_int),
        "fused_ladder_launch": (
            [_P] * 26 + [_I] * 9 + [_F] * 3 + [_P], ctypes.c_int
        ),
        "fused_ladder_blocks_per_sm": ([_I] * 5, ctypes.c_int),
        "fused_ladder_kernel_attributes": (
            [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)], ctypes.c_int
        ),
        "fused_wide_tile_rows": ([_I] * 5, ctypes.c_int),
        "fused_wide_smem_bytes": ([_I] * 5, ctypes.c_int),
        "fused_admm_wide_launch": (
            [_P] * 24 + [_I] * 8 + [_F] * 3 + [_P], ctypes.c_int
        ),
        "fused_ladder_wide_launch": (
            [_P] * 26 + [_I] * 9 + [_F] * 3 + [_P], ctypes.c_int
        ),
        "fused_wide_kernel_attributes": (
            [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)], ctypes.c_int
        ),
        "fused_wide_stage_floats": ([_I] * 5, ctypes.c_int),
    },
}


class KernelLibrary:
    """A loaded kernel library, with how it was built."""

    def __init__(self, name: str, path: Path, build_seconds: float,
                 compiler_log: str):
        self.name = name
        self.path = path
        #: Seconds spent in nvcc by this process (0.0 when an earlier
        #: build of the same source was found on disk).
        self.build_seconds = build_seconds
        #: nvcc's output (``-Xptxas=-v``: registers, shared memory and
        #: spills per kernel); empty when nothing was compiled.
        self.compiler_log = compiler_log
        self.lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(self.lib, fn).argtypes = argtypes
            getattr(self.lib, fn).restype = restype


_loaded: dict[str, KernelLibrary] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from source at first "
        "use and need the CUDA toolkit"
    )


def load(name: str) -> KernelLibrary:
    """Build (if needed) and load the kernel library ``name``
    (``ops/csrc/<name>.cu``)."""
    if name in _loaded:
        return _loaded[name]
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Compile to a private file, then rename: concurrent builds
        # never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        os.replace(tmp, out)
    lib = KernelLibrary(name, out, seconds, log)
    _loaded[name] = lib
    return lib
