"""Operations and bytes of kernel K4's NON_CONVEX mode (the Robust
scheme's Eq. 6d through the fused ADMM entry), from the configuration's
own dimensions, as ``port_bench/work.py`` counts the other kernels.

Per solve, with O bound updates (``outer_iters``) of I iterations
(``sum(iters)``) on the ``nbox = p L`` box rows, alpha ``n_alpha = N - L
- n + 1`` long (one Hankel column each) and ``work.k4``'s widths W1, D2
and W2::

    2 [O I nbox^2 + O n_alpha nbox + n_alpha n_theta + nbox W1 + D2 W2]
      + O n_alpha

the iterations, alpha's products with ``t = s - w`` after each block of
iterations and with theta once, the extraction and the plant step, and
the 1-norm's absolute sums. Bytes: ``work.k4``'s, plus the alpha maps
(``A_s``, ``A_theta``, ``a_c``) read once and each scenario's bound read
and written.
"""

from __future__ import annotations

from port_bench import work


def n_alpha(config: dict) -> int:
    """Alpha's length: the Hankel matrices' columns, ``N - L - n + 1``."""
    c = config["controller"]
    return c["N"] - c["L"] - c["n"] + 1


def k4nc(config: dict, B: int, T: int) -> tuple:
    """``(flops, bytes)`` of one NON_CONVEX closed loop through K4."""
    d = work.dims(config)
    s = config["solver"]
    O, I = s["outer_iters"], sum(s["iters"])
    nbox, na = d["p"] * d["L"], n_alpha(config)
    W1 = d["m"] + 1 + d["n_theta"] + nbox
    D2 = d["S"] + d["m"] + d["p"]
    W2 = D2 + 1 + nbox + d["n_theta"] + nbox
    per_solve = (2 * (O * I * nbox ** 2 + O * na * nbox + na * d["n_theta"]
                      + nbox * W1 + D2 * W2) + O * na)
    _, nbytes = work.k4(config, B, T)
    nbytes += work.FLOAT * (na * (nbox + d["n_theta"] + 1) + 2 * B)
    return per_solve * B * T, nbytes
