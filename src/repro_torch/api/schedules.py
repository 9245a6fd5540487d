"""Threshold-schedule spec mini-language and registry.

The paper's single knob — the threshold schedule K(t) — is named by a
compact string so every surface (simulator, SPMD driver, CLI, JSON
specs) describes it the same way:

    "step:300"                  K grows by 1 every 300 updates (paper)
    "linear:2000"               linear ramp to W over 2000 updates
    "cosine:horizon=2000"       half-cosine ramp
    "exp:horizon=2000,rate=5"   exponential saturation
    "const:4"                   fixed K (1 ≙ async, W ≙ sync)

Grammar: ``family[:arg,...,key=value,...]``.  Bare args fill the
family's declared positional slots in order; ``key=value`` pairs are
keyword arguments.  Numbers are coerced (int where int-like, float
otherwise).

``parse_schedule(spec, num_workers)`` binds a spec to a worker count and
returns a :class:`repro_torch.core.schedule.ThresholdSchedule`; new families
plug in via :func:`register_schedule` without touching any driver.
A copy of ``src/repro/api/schedules.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from repro_torch.core.schedule import (ThresholdSchedule,
                                       constant_schedule, cosine_schedule,
                                       exponential_schedule,
                                       linear_schedule, step_schedule)


@dataclasses.dataclass(frozen=True)
class ScheduleFamily:
    """One registered K(t) family.

    ``factory(num_workers, **kwargs) -> ThresholdSchedule``;
    ``positional`` names the kwargs that bare (non ``key=value``) spec
    arguments bind to, in order.
    """
    name: str
    factory: Callable[..., ThresholdSchedule]
    positional: Tuple[str, ...] = ()
    doc: str = ""


SCHEDULE_FAMILIES: Dict[str, ScheduleFamily] = {}


def register_schedule(name: str, factory: Callable[..., ThresholdSchedule],
                      positional: Tuple[str, ...] = (), doc: str = "",
                      overwrite: bool = False) -> ScheduleFamily:
    """Register a schedule family under ``name`` for the spec language."""
    if name in SCHEDULE_FAMILIES and not overwrite:
        raise ValueError(f"schedule family {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    fam = ScheduleFamily(name, factory, tuple(positional), doc)
    SCHEDULE_FAMILIES[name] = fam
    return fam


def _coerce(token: str):
    try:
        return int(token)
    except ValueError:
        pass
    try:
        return float(token)
    except ValueError:
        return token


def parse_schedule(spec: str, num_workers: int) -> ThresholdSchedule:
    """Parse ``"family:args"`` and bind it to ``num_workers`` workers."""
    if not isinstance(spec, str) or not spec.strip():
        raise ValueError(f"empty schedule spec: {spec!r}")
    name, _, argstr = spec.strip().partition(":")
    name = name.strip()
    fam = SCHEDULE_FAMILIES.get(name)
    if fam is None:
        known = ", ".join(sorted(SCHEDULE_FAMILIES))
        raise ValueError(f"unknown schedule family {name!r} in {spec!r} "
                         f"(known: {known})")
    kwargs = {}
    pos_used = 0
    for raw in filter(None, (t.strip() for t in argstr.split(","))):
        if "=" in raw:
            key, _, val = raw.partition("=")
            key = key.strip()
            if key in kwargs:
                raise ValueError(f"duplicate argument {key!r} in {spec!r}")
            kwargs[key] = _coerce(val.strip())
        else:
            if pos_used >= len(fam.positional):
                raise ValueError(
                    f"too many positional arguments in {spec!r}: "
                    f"{name!r} takes {len(fam.positional)} "
                    f"({', '.join(fam.positional) or 'none'})")
            key = fam.positional[pos_used]
            if key in kwargs:
                raise ValueError(f"duplicate argument {key!r} in {spec!r}")
            kwargs[key] = _coerce(raw)
            pos_used += 1
    try:
        sched = fam.factory(num_workers, **kwargs)
    except TypeError as e:
        raise ValueError(f"bad arguments for schedule {spec!r}: {e}") from e
    if not isinstance(sched, ThresholdSchedule):
        raise TypeError(f"factory for {name!r} returned "
                        f"{type(sched).__name__}, not ThresholdSchedule")
    return sched


def schedule_help() -> str:
    """One line per registered family (CLI help text)."""
    return "\n".join(f"  {f.name:8s} {f.doc}"
                     for f in SCHEDULE_FAMILIES.values())


# --------------------------------------------------------------- builtins

register_schedule(
    "step", lambda w, step_size: step_schedule(w, int(step_size)),
    positional=("step_size",),
    doc='"step:300" — K grows by 1 every step_size updates (the paper\'s; '
        'paper uses step_size = c/lr, c ∈ {3, 5})')
register_schedule(
    "linear", lambda w, horizon: linear_schedule(w, int(horizon)),
    positional=("horizon",),
    doc='"linear:2000" — linear ramp 1 → W over horizon updates')
register_schedule(
    "cosine", lambda w, horizon: cosine_schedule(w, int(horizon)),
    positional=("horizon",),
    doc='"cosine:horizon=2000" — half-cosine ramp 1 → W')
register_schedule(
    "exp",
    lambda w, horizon, rate=5.0: exponential_schedule(w, int(horizon),
                                                      float(rate)),
    positional=("horizon",),
    doc='"exp:horizon=2000,rate=5" — exponential saturation 1 → W')
register_schedule(
    "const", lambda w, k: constant_schedule(w, int(k)),
    positional=("k",),
    doc='"const:4" — fixed K (1 ≙ async, num_workers ≙ sync)')
