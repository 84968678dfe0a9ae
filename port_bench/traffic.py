"""The benchmark's inputs, all drawn from ``--seed``: the data run that
defines the controller, the noise pool the evaluations take their
measurement noise from, and the sample of scenarios and evaluations the
output check judges.

One general generator for every traffic mix: a mix is a file of
parameters (``port_bench/traffic/<name>.json``):

- ``B``, ``T``: scenarios per evaluation and closed-loop steps;
- ``pool_min_bytes``: the noise pool holds whole batches of ``B x T x
  p`` float32 until it is at least this large (and at least two), so
  the evaluations' noise does not sit in the card's 50 MB L2 cache;
- ``judge_evaluations``, ``judge_scenarios``: evaluations kept from the
  window by a uniform reservoir sample, and the scenarios of each that
  the reference recomputes;
- ``profile_calls``: calls in the traced run's profiler session.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from port_bench import reference

#: Independent streams of one seed (``numpy.random.SeedSequence``).
DATA, SAMPLE, RESERVOIR = 0, 1, 2


class Data(NamedTuple):
    """The data run and the closed loop's common start: input and output
    data ``(N, m)``, ``(N, p)``, the plant's state after it, and the
    controller's initial windows (the last ``n`` samples)."""

    u_d: np.ndarray
    y_d: np.ndarray
    x0: np.ndarray
    u_past: np.ndarray
    y_past: np.ndarray


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, stream])


def data_run(config: dict, seed: int) -> Data:
    """Uniform input data over ``u_d_range`` and output noise uniform in
    ``[-eps_max, eps_max]``, simulated from a zero state."""
    mod, ctrl = config["model"], config["controller"]
    A, B, C, D = (np.asarray(mod[k], np.float64) for k in "ABCD")
    g = rng(seed, DATA)
    lo, hi = ctrl["u_d_range"]
    N, n = ctrl["N"], ctrl["n"]
    u_d = g.uniform(lo, hi, (N, B.shape[1]))
    w_d = mod["eps_max"] * g.uniform(-1.0, 1.0, (N, C.shape[0]))
    y_d, x0 = reference.simulate(A, B, C, D, u_d, w_d, np.zeros(A.shape[0]))
    return Data(u_d, y_d, x0, u_d[-n:].copy(), y_d[-n:].copy())


def pool_size(traffic: dict, p: int) -> int:
    batch = traffic["B"] * traffic["T"] * p * 4
    return max(2, math.ceil(traffic["pool_min_bytes"] / batch))


def noise_pool(config: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """``(P, B, T, p)`` float32 output noise uniform in ``[-eps_max,
    eps_max]``, drawn on ``device`` in one call from a generator seeded
    with ``seed``."""
    p = np.asarray(config["model"]["C"]).shape[0]
    shape = (pool_size(traffic, p), traffic["B"], traffic["T"], p)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    pool = torch.rand(shape, generator=g, device=device)
    return pool.mul_(2 * config["model"]["eps_max"]).sub_(
        config["model"]["eps_max"])


def judged_scenarios(traffic: dict, seed: int) -> np.ndarray:
    """The sorted scenario indices the reference recomputes."""
    B = traffic["B"]
    k = min(traffic["judge_scenarios"], B)
    return np.sort(rng(seed, SAMPLE).choice(B, size=k, replace=False))


class Reservoir:
    """A uniform sample of ``k`` of the evaluations seen, decided on the
    host from the seed by Li's Algorithm L: ``slot(i)`` says where the
    ``i``-th evaluation is kept, or None. Between replacements it only
    compares ``i`` with the next index it drew, so the window's loop
    pays almost nothing for it."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = rng(seed, RESERVOIR)
        self.w = math.exp(math.log(self._u()) / k)
        self.next = k + self._skip()

    def _u(self) -> float:
        return max(self.rng.random(), 1e-300)

    def _skip(self) -> int:
        return int(math.log(self._u()) / math.log1p(-self.w))

    def slot(self, i: int):
        if i < self.k:
            return i
        if i < self.next:
            return None
        self.w *= math.exp(math.log(self._u()) / self.k)
        self.next = i + 1 + self._skip()
        return int(self.rng.integers(self.k))
