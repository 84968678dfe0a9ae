"""The JAX package's C extension, loaded for the port's parity tests that
hold the port's C solve against the JAX controller's.

The JAX package builds its extension onto one shared path,
``direct_data_driven_mpc_tpu/native/_ddmpc_ext.so``, with a compiler
writing straight to it, and ``get_lib()`` loads any file at that path
newer than the source. A process that opens the file while another one
is still writing it fails to load it, prints ``[ddmpc-native] load
failed``, and keeps ``None`` for its whole life: every JAX controller it
builds then takes the numpy solve. Under pytest-xdist each worker
imports ``tests/test_native.py``, whose module-level ``skipif`` calls
``get_lib()``, so the workers of one run race on that build.

:func:`reference_c_solve` gives the calling test the reference's C
extension whatever its worker's race did: the module ``get_lib()``
already holds, else a build of the reference's own source by the
reference's own ``_build`` into a private directory. It never writes the
shared file, and a failed build raises; nothing skips.
"""

from __future__ import annotations

import contextlib
import io
import os
import subprocess
import types

import pytest

from direct_data_driven_mpc_tpu import native as jax_native


def _run_keeping_output(said):
    """``subprocess.run`` that also writes the command's output to
    ``said``: the reference's ``_build`` captures the compiler's output
    and prints only the exception."""
    def run(cmd, **kwargs):
        try:
            proc = subprocess.run(cmd, **kwargs)
        except subprocess.CalledProcessError as e:
            said.write(f"{os.fsdecode(e.stdout or b'')}"
                       f"{os.fsdecode(e.stderr or b'')}")
            raise
        return proc

    return types.SimpleNamespace(run=run,
                                 SubprocessError=subprocess.SubprocessError)


def reference_c_solve(monkeypatch, build_dir):
    """The JAX package's extension module, installed through
    ``monkeypatch`` as what ``native.get_lib()`` returns until teardown,
    so that every JAX controller built in the test takes the C solve.

    Where ``get_lib()`` already returned a module, that module. Else
    (the race was lost, or nothing has loaded yet) the reference's
    ``get_lib()`` runs once with ``_LIB`` pointed into ``build_dir``: its
    ``_build`` compiles ``_SRC`` there and it loads the result. Raises
    ``RuntimeError`` with the build's output when that fails."""
    if jax_native._ext is not None:
        return jax_native._ext
    said = io.StringIO()
    private = os.path.join(str(build_dir), os.path.basename(jax_native._LIB))
    with pytest.MonkeyPatch.context() as build, \
            contextlib.redirect_stderr(said):
        build.setattr(jax_native, "_LIB", private)
        build.setattr(jax_native, "_ext", None)
        build.setattr(jax_native, "_load_attempted", False)
        build.setattr(jax_native, "subprocess", _run_keeping_output(said))
        ext = jax_native.get_lib()
    if ext is None:
        raise RuntimeError(
            f"the JAX package's C extension did not build or load into "
            f"{private}:\n{said.getvalue()}"
        )
    monkeypatch.setattr(jax_native, "_ext", ext)
    monkeypatch.setattr(jax_native, "_load_attempted", True)
    return ext


@pytest.fixture
def jax_c_solve(monkeypatch, tmp_path_factory):
    """The JAX controllers built in the test take the reference's C
    solve (:func:`reference_c_solve`)."""
    return reference_c_solve(monkeypatch,
                             tmp_path_factory.mktemp("jax_native"))
