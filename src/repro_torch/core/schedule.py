"""Threshold functions K(t) — the heart of the Smooth Switch algorithm.

The paper controls the async→sync transition with a *monotonically
increasing* threshold K(t): the number of gradients that must accumulate in
the server's buffer before a (synchronous) flush.  K=1 ⇒ fully async,
K=num_workers ⇒ fully sync.  The paper uses a step function whose step
*size* is expressed in multiples of 1/lr (their §6: "step sizes in
multiples of 3 and 5 of reciprocal of learning rate"); we provide that plus
the monotone families the paper's future-work section asks about.

All schedules map an update counter t (number of parameter updates applied
so far) to an integer K in [1, num_workers].  A copy of
``src/repro/core/schedule.py`` (without its deprecated ``SCHEDULES``
dict): the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable


@dataclasses.dataclass(frozen=True)
class ThresholdSchedule:
    """K(t): update counter -> aggregation threshold."""
    name: str
    num_workers: int
    fn: Callable[[int], float]

    def __call__(self, t: int) -> int:
        k = int(self.fn(t))
        return max(1, min(self.num_workers, k))

    def phases(self, horizon: int):
        """[(t_start, K)] distinct phases within [0, horizon) — used by the
        SPMD layer to pick compiled variants."""
        out = []
        prev = None
        for t in range(horizon):
            k = self(t)
            if k != prev:
                out.append((t, k))
                prev = k
        return out


def step_schedule(num_workers: int, step_size: int) -> ThresholdSchedule:
    """The paper's schedule: K grows by 1 every `step_size` updates.

    The paper sets step_size = c / lr for c in {3, 5} (e.g. lr=0.01 ->
    step sizes 300 and 500).
    """
    return ThresholdSchedule(
        f"step({step_size})", num_workers,
        lambda t: 1 + t // max(1, step_size))


def linear_schedule(num_workers: int, horizon: int) -> ThresholdSchedule:
    return ThresholdSchedule(
        f"linear({horizon})", num_workers,
        lambda t: 1 + (num_workers - 1) * min(1.0, t / max(1, horizon)))


def cosine_schedule(num_workers: int, horizon: int) -> ThresholdSchedule:
    return ThresholdSchedule(
        f"cosine({horizon})", num_workers,
        lambda t: 1 + (num_workers - 1) * 0.5
        * (1 - math.cos(math.pi * min(1.0, t / max(1, horizon)))))


def exponential_schedule(num_workers: int, horizon: int,
                         rate: float = 5.0) -> ThresholdSchedule:
    return ThresholdSchedule(
        f"exp({horizon},{rate})", num_workers,
        lambda t: 1 + (num_workers - 1)
        * (1 - math.exp(-rate * min(1.0, t / max(1, horizon))))
        / (1 - math.exp(-rate)))


def constant_schedule(num_workers: int, k: int) -> ThresholdSchedule:
    """K fixed: k=1 ≙ pure async, k=num_workers ≙ pure sync."""
    return ThresholdSchedule(f"const({k})", num_workers, lambda t: k)


def group_size_phases(schedule: ThresholdSchedule, horizon: int,
                      axis_size: int):
    """Map threshold phases onto power-of-two reduction-group sizes for the
    SPMD adaptation: K workers aggregating ≙ a reduction group of size
    g = min pow2 >= K * axis_size / num_workers (clamped to divisors of
    axis_size).  Returns [(t_start, g)]."""
    out = []
    prev = None
    for t_start, k in schedule.phases(horizon):
        frac = k / schedule.num_workers
        g = 1
        while g < axis_size and g < frac * axis_size:
            g *= 2
        g = min(g, axis_size)
        if g != prev:
            out.append((t_start, g))
            prev = g
    return out
