"""Checkpoint / resume for closed-loop rollout state.

The rollout state between segments is a small tree of tensors: plant
state, measurement windows, the iterative solver's warm start
(``ADMMState``, ``BoxADMMState``, ``NonConvexState``), the segment index
and the base seed. Checkpointing flattens it into an atomic ``.npz``
with the tree's structure beside the leaves; resume checks both against
a template of the same shape. Dataclasses and NamedTuples are walked in
field order, tuples and lists in order; ``None`` is a node with no leaf.
Every other value is a leaf: a tensor (restored on the template's
device, in its dtype), a numpy array or a Python scalar.

Counterpart of ``direct_data_driven_mpc_tpu/utils/checkpoint.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, List, Tuple

import numpy as np
import torch


def _children(node) -> Tuple[str, list] | None:
    """``(label, children)`` of an inner node of the state tree, or None
    for a leaf."""
    if node is None:
        return "None", []
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        fields = [f.name for f in dataclasses.fields(node)]
        return (f"{type(node).__name__}({', '.join(fields)})",
                [getattr(node, f) for f in fields])
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return (f"{type(node).__name__}({', '.join(node._fields)})",
                list(node))
    if isinstance(node, (tuple, list)):
        return f"{type(node).__name__}[{len(node)}]", list(node)
    return None


def _flatten(node, leaves: List[Any]) -> str:
    """Append ``node``'s leaves to ``leaves`` in order and return its
    structure string."""
    inner = _children(node)
    if inner is None:
        leaves.append(node)
        return "*"
    label, kids = inner
    if not kids:
        return label
    return f"{label}{{{', '.join(_flatten(k, leaves) for k in kids)}}}"


def _rebuild(node, leaves):
    """``node``'s tree with its leaves taken, in order, from the
    iterator ``leaves``."""
    inner = _children(node)
    if inner is None:
        return next(leaves)
    if node is None:
        return None
    kids = [_rebuild(k, leaves) for k in inner[1]]
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(
            node, **{f.name: v for f, v in zip(dataclasses.fields(node),
                                               kids)})
    if hasattr(node, "_fields"):
        return type(node)(*kids)
    return type(node)(kids)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _shape_dtype(leaf) -> Tuple[tuple, np.dtype]:
    """A leaf's shape and numpy dtype, without copying a tensor off its
    device."""
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape),
                torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    a = np.asarray(leaf)
    return a.shape, a.dtype


def _jsonable(v):
    # Metadata values routinely arrive as numpy scalars or tensors (a
    # segment index loaded from a previous checkpoint); plain json.dumps
    # rejects them.
    if isinstance(v, (np.generic, np.ndarray, torch.Tensor)):
        return _host(v).tolist()
    return v


def save_checkpoint(path: str, state: Any, metadata: dict | None = None):
    """Atomically save ``state`` to ``path`` (.npz): a temporary file in
    the same directory, then ``os.replace``.

    Raises:
        ValueError: if a leaf is not numeric (a dict, a string, ...).
    """
    leaves: List[Any] = []
    structure = _flatten(state, leaves)
    arrays = {}
    for i, leaf in enumerate(leaves):
        arrays[f"leaf_{i}"] = _host(leaf)
        if arrays[f"leaf_{i}"].dtype == object:
            raise ValueError(
                f"leaf {i} is not numeric (a {type(leaf).__name__}): a "
                "checkpoint holds tensors, arrays and scalars in "
                "dataclasses, NamedTuples, tuples and lists."
            )
    meta = {
        "structure": structure,
        "n_leaves": len(leaves),
        "metadata": {
            k: _jsonable(v) for k, v in (metadata or {}).items()
        },
    }
    out_dir = os.path.dirname(os.path.abspath(path))
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(path: str, like: Any) -> Tuple[Any, dict]:
    """Load a checkpoint saved by :func:`save_checkpoint`.

    ``like`` is a template of the same structure, shapes and dtypes (for
    instance a zero-filled state); tensor leaves come back on its
    device. Returns ``(state, metadata)``.

    Raises:
        ValueError: if the leaf count, the structure, or a leaf's shape
            or dtype differs from the template's.
    """
    tmpl_leaves: List[Any] = []
    structure = _flatten(like, tmpl_leaves)
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        if meta["n_leaves"] != len(tmpl_leaves):
            raise ValueError(
                f"Checkpoint has {meta['n_leaves']} leaves; template has "
                f"{len(tmpl_leaves)}."
            )
        if meta["structure"] != structure:
            raise ValueError(
                "Checkpoint structure does not match the template: "
                f"stored {meta['structure']}, template {structure}."
            )
        leaves = []
        for i, tmpl in enumerate(tmpl_leaves):
            stored = data[f"leaf_{i}"]
            shape, dtype = _shape_dtype(tmpl)
            if stored.shape != shape or stored.dtype != dtype:
                raise ValueError(
                    f"Leaf {i} mismatch: checkpoint {stored.shape} "
                    f"{stored.dtype} vs template {shape} {dtype}."
                )
            if isinstance(tmpl, torch.Tensor):
                leaves.append(torch.from_numpy(stored).to(tmpl.device))
            elif isinstance(tmpl, np.ndarray):
                leaves.append(stored)
            else:
                leaves.append(stored.item())
    return _rebuild(like, iter(leaves)), meta["metadata"]
