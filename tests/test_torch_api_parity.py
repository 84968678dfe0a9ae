"""The port's API held to the JAX package's, read from the sources.

Both packages are parsed with ``ast`` and neither is imported, so this
file runs with no JAX, no card and no kernel build. For each module of
the JAX package (parametrised), every public function, class, method,
NamedTuple or dataclass field and module-level name must have a
counterpart in the port's module of the same path (``MODULE_MAP`` names
the two that moved), each function or method accepting every parameter
of the JAX one (a ``**kwargs`` accepts any); a package's ``__all__``
must list every name the JAX package's does. What the port leaves out
on purpose, or names otherwise, stands in ``EXEMPT``, one entry each
with its kind and reason, and ``test_exemptions_are_current`` fails on
an entry that names nothing in the JAX package, that the port no longer
needs, or whose new name the port lacks.
"""

import ast
import os
from typing import NamedTuple, Optional

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "direct_data_driven_mpc_tpu")
PORT_PKG = os.path.join(ROOT, "direct_data_driven_mpc_tpu_torch")
#: JAX module -> the port's modules that hold its counterparts (every
#: other module keeps its path).
MODULE_MAP = {
    "ops/pallas_rollout.py": ("ops/fused_rollout.py",),
    "ops/pallas_admm.py": ("ops/fused_admm.py", "ops/fused_ladder.py"),
}
KINDS = ("tpu-only", "jax-only", "renamed", "redesigned")


class Exempt(NamedTuple):
    """``kind``: "tpu-only" or "jax-only" (the port has no counterpart),
    "renamed" (the counterpart is ``target``; a function's parameters are
    still compared) or "redesigned" (the counterpart is ``target``, with
    another contract; parameters not compared)."""

    kind: str
    reason: str
    target: Optional[str] = None


#: Keys: ``module::name``, ``module::Class.member``, ``module::f(param)``
#: or ``module::*(param)`` (that parameter of every function and method
#: of the module). A renamed parameter's or field's target is its new
#: name; a renamed function's is ``port module::name``.
EXEMPT = {
    # The TPU's batch tiling, VMEM budget and bf16 precision passes.
    "ops/pallas_rollout.py::pick_batch_block": Exempt(
        "tpu-only", "TPU batch blocks; each CUDA kernel picks its tile"),
    "ops/pallas_rollout.py::pallas_vmem_bytes": Exempt(
        "tpu-only", "VMEM sizing; the kernels' plans size shared memory"),
    "ops/pallas_rollout.py::VMEM_LIMIT_BYTES": Exempt(
        "tpu-only", "the TPU's scoped VMEM limit"),
    "ops/pallas_rollout.py::*(batch_block)": Exempt(
        "tpu-only", "TPU batch blocks; the kernels take any batch"),
    "ops/pallas_rollout.py::*(interpret)": Exempt(
        "tpu-only", "Pallas interpret mode; CPU tensors run the plain version"),
    "ops/pallas_rollout.py::*(backend)": Exempt(
        "tpu-only", "Pallas or XLA twin; the port passes rollout= instead"),
    "ops/pallas_rollout.py::make_amortized_pallas_run(stacked_highest)":
        Exempt("tpu-only", "six bf16 passes for HIGHEST on the MXU"),
    "ops/pallas_rollout.py::make_pallas_rollout": Exempt(
        "redesigned", "the wrapper takes the built operator and packed "
        "inputs, not a block map", "ops/fused_rollout.py::fused_rollout"),
    "ops/pallas_rollout.py::make_amortized_pallas_run": Exempt(
        "renamed", "the harness drives any rollout, not only Pallas",
        "ops/fused_rollout.py::make_amortized_run"),
    "ops/pallas_admm.py::pick_pack_factor": Exempt(
        "tpu-only", "the 128-lane pack factor; the port has none"),
    "ops/pallas_admm.py::FusedADMMDims.q": Exempt(
        "tpu-only", "the pack factor"),
    "ops/pallas_admm.py::FusedADMMDims.seg": Exempt(
        "tpu-only", "the packed lane segment of one scenario"),
    "ops/pallas_admm.py::FusedADMMDims.Wb": Exempt(
        "tpu-only", "the packed box width q * seg"),
    "ops/pallas_admm.py::FusedADMMDims.Wz": Exempt(
        "tpu-only", "the packed cost-factor width"),
    "ops/pallas_admm.py::*(q)": Exempt(
        "tpu-only", "the pack factor; operators are per scenario"),
    "ops/pallas_admm.py::*(batch_block)": Exempt(
        "tpu-only", "TPU batch blocks; the kernels take any batch"),
    "ops/pallas_admm.py::*(interpret)": Exempt(
        "tpu-only", "Pallas interpret mode; CPU tensors run the plain version"),
    "ops/pallas_admm.py::*(backend)": Exempt(
        "tpu-only", "Pallas or XLA twin; the port passes rollout= instead"),
    "ops/pallas_admm.py::*(pipeline)": Exempt(
        "tpu-only", "independent row chains for the TPU's VPU latency"),
    "parallel/mesh.py::*(backend)": Exempt(
        "tpu-only", "Pallas or XLA twin; the port passes rollout= instead"),
    "parallel/mesh.py::*(batch_block)": Exempt(
        "tpu-only", "TPU batch blocks; the kernels take any batch"),
    "parallel/mesh.py::*(interpret)": Exempt(
        "tpu-only", "Pallas interpret mode; CPU tensors run the plain version"),
    "parallel/mesh.py::make_sharded_fused_admm_rollout(q)": Exempt(
        "tpu-only", "the pack factor; operators are per scenario"),
    # JAX's random keys and array types.
    "parallel/batch.py::draw_noise_batch(key)": Exempt(
        "renamed", "a 32-bit hash of (seed, scenario, element), not "
        "threefry, the same bits on every device and shard", "seed"),
    "parallel/batch.py::draw_noise_batch(batch)": Exempt(
        "renamed", "the hash design's signature names the batch B", "B"),
    "parallel/batch.py::draw_noise_batch(n_steps)": Exempt(
        "renamed", "the hash design's signature names the steps T", "T"),
    "parallel/multihost.py::global_scenario_keys": Exempt(
        "renamed", "scenario indices feed the seeded hash, not keys",
        "parallel/multihost.py::global_scenario_indices"),
    "parallel/multihost.py::global_scenario_keys(base_key)": Exempt(
        "jax-only", "a threefry key; the hash takes its seed elsewhere"),
    "control/linear_engine.py::linear_closed_loop_rollout(noise_key)":
        Exempt("renamed", "block noise drawn from a torch.Generator",
               "generator"),
    "control/segmented.py::SegmentState.key": Exempt(
        "renamed", "a segment's noise is seeded by (seed, segment)", "seed"),
    "control/loop.py::SolveFn": Exempt(
        "jax-only", "a typing alias over jax.Array"),
    "utils/checkpoint.py::jnp_asarray_u32": Exempt(
        "jax-only", "rebuilds PRNG key data as jnp uint32"),
    "native/__init__.py::get_lib": Exempt(
        "renamed", "builds or raises, never returns None",
        "native/__init__.py::load"),
}


def _params(fn: ast.FunctionDef) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append("*")
    if a.kwarg:
        names.append("**")
    return [n for n in names if n not in ("self", "cls")]


def _static(node, binds) -> set:
    """The names a static ``__all__`` expression lists: string literals,
    ``*NAME`` and ``list(NAME)`` of a literal bound in the module."""
    if isinstance(node, ast.Name):
        return _static(binds[node.id], binds)
    if isinstance(node, ast.Call):
        return _static(node.args[0], binds)
    if isinstance(node, ast.Dict):
        return {k.value for k in node.keys}
    if isinstance(node, ast.Starred):
        return _static(node.value, binds)
    if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
        out = set()
        for e in node.elts:
            out |= ({e.value} if isinstance(e, ast.Constant)
                    else _static(e, binds))
        return out
    raise ValueError(f"__all__ is not static: {ast.unparse(node)}")


def _api(path: str) -> dict:
    """Public names of one module: ``name -> parameter list`` for
    functions and methods, None for classes, fields and module-level
    names; ``__all__`` under its own key as a set."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out, binds = {}, {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            if node.name.startswith("_"):
                continue
            out[node.name] = None
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and (b.name == "__init__"
                             or not b.name.startswith("_")):
                    out[f"{node.name}.{b.name}"] = _params(b)
                elif isinstance(b, ast.AnnAssign) and isinstance(
                        b.target, ast.Name) and not b.target.id.startswith(
                        "_"):
                    out[f"{node.name}.{b.target.id}"] = None
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name):
                    binds[t.id] = node.value
                    if not t.id.startswith("_"):
                        out[t.id] = None
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                name = (alias.asname or alias.name).split(".")[0]
                binds.setdefault(name, None)
    if "__all__" in binds:
        out["__all__"] = _static(binds["__all__"], binds)
    # Names bound by imports count as present in the port (re-exports).
    out["<bound>"] = set(binds) | set(out)
    return out


def _jax_modules() -> list:
    mods = []
    for dirpath, _, files in os.walk(JAX_PKG):
        for f in files:
            if f.endswith(".py"):
                mods.append(os.path.relpath(os.path.join(dirpath, f),
                                            JAX_PKG))
    return sorted(mods)


JAX_MODULES = _jax_modules()


def _jax_api(module: str) -> dict:
    return _api(os.path.join(JAX_PKG, module))


def _port_api(module: str) -> dict:
    """The merged API of the port's counterparts of a JAX module."""
    merged = {"<bound>": set()}
    for rel in MODULE_MAP.get(module, (module,)):
        path = os.path.join(PORT_PKG, rel)
        if not os.path.exists(path):
            continue
        api = _api(path)
        merged["<bound>"] |= api.pop("<bound>")
        merged.update(api)
    return merged


def _accepts(params: list, name: str) -> bool:
    return name in params or "**" in params


def _exempt(module: str, name: str, param: Optional[str] = None):
    key = f"{module}::{name}" if param is None else (
        f"{module}::{name}({param})")
    if key in EXEMPT:
        return EXEMPT[key]
    if param is not None:
        return EXEMPT.get(f"{module}::*({param})")
    return None


def _port_target(target: str):
    """``(port API, name)`` of a renamed function's target."""
    module, name = target.split("::")
    return _api(os.path.join(PORT_PKG, module)), name


def _missing(module: str) -> list:
    """Every JAX name of ``module`` the port lacks, or whose counterpart
    does not take one of its parameters, that no entry of ``EXEMPT``
    covers."""
    jax_api, port_api = _jax_api(module), _port_api(module)
    missing = []
    for name in sorted(jax_api.get("__all__", ())):
        if name not in port_api.get("__all__", ()) and not _exempt(
                module, name):
            missing.append(f"__all__ lacks {name}")
    for name, params in jax_api.items():
        if name in ("__all__", "<bound>"):
            continue
        api, port_name = port_api, name
        ex = _exempt(module, name)
        if ex is not None:
            if ex.kind in ("tpu-only", "jax-only", "redesigned"):
                continue
            if "::" in ex.target:
                api, port_name = _port_target(ex.target)
            else:
                port_name = f"{name.rsplit('.', 1)[0]}.{ex.target}"
        if port_name not in api and port_name not in api["<bound>"]:
            missing.append(f"no counterpart of {name}")
            continue
        theirs = api.get(port_name)
        if params is None or theirs is None:
            continue
        for param in params:
            want = param
            ex = _exempt(module, name, param)
            if ex is not None:
                if ex.kind != "renamed":
                    continue
                want = ex.target
            if param in ("*", "**"):
                if param not in theirs:
                    missing.append(f"{port_name} takes no {param}args")
            elif not _accepts(theirs, want):
                missing.append(f"{port_name} does not take {want!r}")
    return missing


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    assert os.path.exists(os.path.join(
        PORT_PKG, MODULE_MAP.get(module, (module,))[0])), module
    assert _missing(module) == [], module


def _jax_has(module: str, name: str, param: Optional[str]) -> bool:
    api = _jax_api(module)
    if name == "*":
        return any(p is not None and param in p for p in api.values()
                   if isinstance(p, list))
    if name not in api:
        return False
    return param is None or param in (api[name] or ())


def _port_has(module: str, name: str, param: Optional[str]) -> bool:
    api = _port_api(module)
    if param is None:
        return name in api or name in api["<bound>"]
    names = ([n for n, p in _jax_api(module).items()
              if isinstance(p, list) and param in p]
             if name == "*" else [name])
    return any(isinstance(api.get(n), list) and _accepts(api[n], param)
               for n in names)


def _split(key: str):
    module, rest = key.split("::")
    name, _, param = rest.partition("(")
    return module, name, param.rstrip(")") or None


@pytest.mark.parametrize("key", sorted(EXEMPT))
def test_exemptions_are_current(key):
    """An entry has a known kind and a one-line reason; it names
    something of the JAX package; a name the port leaves out is still
    missing from the port (else the entry is stale); a renamed or
    redesigned name's target exists in the port."""
    ex = EXEMPT[key]
    module, name, param = _split(key)
    assert ex.kind in KINDS, key
    assert ex.reason and "\n" not in ex.reason, key
    assert module in JAX_MODULES, key
    assert _jax_has(module, name, param), f"{key}: not in the JAX package"
    if ex.kind in ("tpu-only", "jax-only"):
        assert ex.target is None, key
        assert not _port_has(module, name, param), (
            f"{key}: the port has it, the entry is stale")
        return
    assert ex.target, key
    if "::" in ex.target:
        api, target = _port_target(ex.target)
        assert target in api, f"{key}: the port lacks {ex.target}"
    elif param is not None:
        assert _port_has(module, name, ex.target), (
            f"{key}: the port's {name} does not take {ex.target!r}")
    else:
        owner = name.rsplit(".", 1)[0]
        assert f"{owner}.{ex.target}" in _port_api(module), (
            f"{key}: the port lacks {owner}.{ex.target}")
    assert ex.kind == "renamed" or param is None, key
