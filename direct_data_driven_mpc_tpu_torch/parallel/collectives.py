"""The collectives of the multi-device path, over one mesh dimension.

``all_reduce_sum`` stands in for JAX's ``psum`` (in place, on a
temporary) and ``all_gather_cat`` for ``all_gather(..., tiled=True)``
(a new tensor).

The backend chooses where a collective runs. NCCL reduces CUDA tensors
on the card. Gloo reduces in host memory: a CUDA tensor given to a gloo
group (two ranks that share one card, where NCCL refuses a second rank
on the device) is copied to the host, reduced there and copied back, by
design and for every collective alike, so no collective depends on which
CUDA tensors a gloo build accepts.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _through_host(tensor: torch.Tensor, group) -> bool:
    return tensor.device.type != "cpu" and dist.get_backend(group) == "gloo"


def all_reduce_sum(tensor: torch.Tensor, group) -> torch.Tensor:
    """In place: ``tensor`` (a temporary of the caller's) becomes its sum
    over the ranks of ``group``; returns it."""
    if _through_host(tensor, group):
        host = tensor.detach().cpu()
        dist.all_reduce(host, group=group)
        return tensor.copy_(host)
    dist.all_reduce(tensor, group=group)
    return tensor


def all_gather_cat(tensor: torch.Tensor, group, dim: int = -1
                   ) -> torch.Tensor:
    """Every rank's ``tensor`` of ``group``, concatenated along ``dim`` in
    rank order."""
    n = dist.get_world_size(group)
    src = tensor.detach().contiguous()
    if _through_host(tensor, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(tensor.device)
