"""Monte-Carlo measurement noise for scenario batches.

Counterpart of ``direct_data_driven_mpc_tpu/parallel/batch.py::
draw_noise_batch``. The draw comes from an explicit ``torch.Generator``
on the device, not from JAX's threefry, so the two packages give
different numbers for the same seed: parity tests feed both the same
numpy noise instead.
"""

from __future__ import annotations

import torch


def draw_noise_batch(
    generator: torch.Generator,
    B: int,
    T: int,
    p: int,
    eps_max: float,
    device,
    dtype=torch.float32,
) -> torch.Tensor:
    """Bounded uniform measurement noise ``eps_max * U[-1, 1]`` of shape
    ``(B, T, p)`` on ``device``; ``generator`` must live on the same
    device."""
    W = torch.empty((B, T, p), device=device, dtype=dtype)
    W.uniform_(-1.0, 1.0, generator=generator)
    return W.mul_(eps_max)
