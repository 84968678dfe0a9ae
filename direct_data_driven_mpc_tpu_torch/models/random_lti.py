"""Random stable LTI plants (the ``large_plant`` configuration's
10-state, 10-input, 10-output plant, and families of plants for
Monte-Carlo sweeps).

Host-side float64 and seeded: a given ``(seed, dims)`` always gives the
same plant, the same one as the JAX package's. Counterpart of
``direct_data_driven_mpc_tpu/models/random_lti.py``.
"""

from __future__ import annotations

import numpy as np

from direct_data_driven_mpc_tpu_torch.models.lti_model import LTIModel


def random_stable_lti(
    seed: int,
    ns: int,
    m: int,
    p: int,
    spectral_radius: float = 0.9,
    eps_max: float = 0.002,
    min_dc_gain_sv: float = 0.1,
) -> LTIModel:
    """A random discrete-time LTI plant, stable and with a
    well-conditioned DC gain.

    ``A`` is a Gaussian matrix rescaled to ``spectral_radius``; ``B`` and
    ``C`` are Gaussian with ``1/sqrt(ns)`` scaling; ``D = 0``. ``B`` is
    rescaled so the smallest singular value of the DC gain ``C (I -
    A)^-1 B`` is at least ``min_dc_gain_sv`` (the equilibrium input
    stays well defined and the loop does not demand huge inputs).
    """
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(ns, ns)) / np.sqrt(ns)
    A = A * (spectral_radius / max(abs(np.linalg.eigvals(A))))
    B = rng.normal(size=(ns, m)) / np.sqrt(ns)
    C = rng.normal(size=(p, ns)) / np.sqrt(ns)
    D = np.zeros((p, m))

    M = C @ np.linalg.solve(np.eye(ns) - A, B)
    sv_min = np.linalg.svd(M, compute_uv=False).min()
    if sv_min < min_dc_gain_sv:
        B = B * (min_dc_gain_sv / sv_min)
    return LTIModel(A=A, B=B, C=C, D=D, eps_max=eps_max)
