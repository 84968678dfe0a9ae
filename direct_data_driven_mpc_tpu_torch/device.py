"""Where the port's entry points put their tensors.

The port runs on the CUDA card unless the caller asks for the CPU: an
entry point's ``device=None`` means ``torch.device("cuda")``. The CPU
runs the kernels' plain PyTorch versions, and only when asked for by
name: there is no silent fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card, and
    raises ``RuntimeError`` when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless told "
            "otherwise; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU"
        )
    return torch.device("cuda")


def as_device_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays on its device unless ``device``
    names another; anything else goes to ``resolve_device(device)``, so
    numpy input with no device lands on the card (and raises without
    one), as ``jnp.asarray`` puts it on the accelerator."""
    if isinstance(x, torch.Tensor) and device is None:
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))
