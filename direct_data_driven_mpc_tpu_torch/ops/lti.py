"""Plant matrices of a discrete-time LTI system.

Semantics (output computed before the state update)::

    y(k) = C x(k) + D u(k) + w(k)
    x(k+1) = A x(k) + B u(k)

The matrices stay float64 numpy on the host, where the condensed
engine composes them; :meth:`LTIParams.to` hands out device tensors.
Counterpart of ``direct_data_driven_mpc_tpu/ops/lti.py::LTIParams``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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
