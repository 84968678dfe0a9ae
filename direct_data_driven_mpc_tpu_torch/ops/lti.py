"""Plant matrices of a discrete-time LTI system.

Semantics (output computed before the state update)::

    y(k) = C x(k) + D u(k) + w(k)
    x(k+1) = A x(k) + B u(k)

The matrices stay float64 numpy on the host, where the condensed
engine composes them; :meth:`LTIParams.to` hands out device tensors.
:func:`lti_step` and :func:`lti_rollout` step on the device of their
state when it is a tensor, else on the card.
Counterpart of ``direct_data_driven_mpc_tpu/ops/lti.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from direct_data_driven_mpc_tpu_torch.device import as_device_tensor
from direct_data_driven_mpc_tpu_torch.ops.precision import ieee_float32


class LTIParams(NamedTuple):
    """State-space matrices ``A (n, n)``, ``B (n, m)``, ``C (p, n)``,
    ``D (p, m)``."""

    A: np.ndarray
    B: np.ndarray
    C: np.ndarray
    D: np.ndarray

    def to(self, device, dtype=torch.float32) -> "LTIParams":
        """The same matrices as tensors on ``device`` in ``dtype``."""
        return LTIParams(
            *(torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
              for a in self)
        )


def _on_device(params: LTIParams, x, others, device):
    """``x`` by :func:`~direct_data_driven_mpc_tpu_torch.device.as_device_tensor`,
    then ``params`` and ``others`` as tensors on its device in its
    dtype."""
    x = as_device_tensor(x, device)
    params = LTIParams(*(torch.as_tensor(a, dtype=x.dtype, device=x.device)
                         for a in params))
    return params, x, [torch.as_tensor(a, dtype=x.dtype, device=x.device)
                       for a in others]


@ieee_float32()
def lti_step(params: LTIParams, x, u, w, device=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One plant step ``(x_next, y)`` of ``x (n,)`` under ``u (m,)`` and
    output noise ``w (p,)``, on ``x``'s device when it is a tensor, else
    on ``device`` (None: the card)."""
    params, x, (u, w) = _on_device(params, x, (u, w), device)
    y = params.C @ x + params.D @ u + w
    x_next = params.A @ x + params.B @ u
    return x_next, y


@ieee_float32()
def lti_rollout(params: LTIParams, x0, U, W, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x_final, Y)``: the plant rolled from ``x0 (n,)`` over the inputs
    ``U (T, m)`` with output noise ``W (T, p)``, ``Y`` of shape ``(T,
    p)``, on ``x0``'s device when it is a tensor, else on ``device``
    (None: the card); one :func:`lti_step` per step (a build-time
    helper, not a closed-loop engine)."""
    params, x, (U, W) = _on_device(params, x0, (U, W), device)
    Y = torch.empty((U.shape[0], params.C.shape[0]), dtype=x.dtype,
                    device=x.device)
    for t in range(U.shape[0]):
        x, Y[t] = lti_step(params, x, U[t], W[t])
    return x, Y
