"""Monte-Carlo measurement noise for scenario batches.

Counterpart of ``direct_data_driven_mpc_tpu/parallel/batch.py::
draw_noise_batch`` and of the classic engine's in-scan draw
(:func:`draw_block_noise`). The draw comes from an explicit ``torch.Generator``
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
    return draw_block_noise(generator, B, T * p, eps_max, device,
                            dtype).view(B, T, p)


def draw_block_noise(
    generator: torch.Generator,
    B: int,
    width: int,
    eps_max: float,
    device,
    dtype=torch.float32,
) -> torch.Tensor:
    """One outer block's noise, ``eps_max * U[-1, 1]`` of shape ``(B,
    width)``: the classic engine draws it inside its block loop, so
    ``n_outer`` calls on a generator seeded alike give the same noise
    for an explicit-noise run."""
    w = torch.empty((B, width), device=device, dtype=dtype)
    w.uniform_(-1.0, 1.0, generator=generator)
    return w.mul_(eps_max)
