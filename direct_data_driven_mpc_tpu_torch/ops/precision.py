"""IEEE float32 products on the parity-bound paths, scoped.

The JAX package runs its solves under ``jax.default_matmul_precision(
"highest")``. On an H100, cuBLAS and cuDNN may round float32 operands to
TF32 when the caller allows it (``torch.set_float32_matmul_precision(
"high")``), which moves u by more than the 1e-4 bar against float64.
:func:`ieee_float32` sets both back ends to IEEE float32 for the span of
a call and then restores what the caller had, through the
``fp32_precision`` settings alone: the legacy ``allow_tf32`` flags, once
written, make ``torch.get_float32_matmul_precision()`` raise.

The JAX package's precision keywords (``precision`` of the classic
engine, ``cost_precision`` of the fused one) name TPU matmul passes:
"highest" (six bf16 passes) and "high" (three). :func:`check_precision`
accepts both names, and every path runs both in IEEE float32, with
identical results: TF32 for "high" would move u past the parity bar.
"""

from __future__ import annotations

import contextlib

import torch

#: The precision names the port accepts, for parity with the JAX package.
PRECISIONS = ("highest", "high")


def check_precision(value: str, keyword: str = "precision") -> None:
    """Raise ``ValueError`` unless ``value`` is one of
    :data:`PRECISIONS` (``keyword`` names the argument in the message)."""
    if value not in PRECISIONS:
        raise ValueError(
            f"{keyword} must be one of {sorted(PRECISIONS)}, got {value!r}"
        )


@contextlib.contextmanager
def ieee_float32():
    """Context manager (and, called, a decorator) under which float32
    matrix products and convolutions run in IEEE float32 on the card; the
    caller's settings are back on exit."""
    matmul = torch.backends.cuda.matmul
    conv = torch.backends.cudnn.conv
    saved = matmul.fp32_precision, conv.fp32_precision
    matmul.fp32_precision = conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision, conv.fp32_precision = saved
