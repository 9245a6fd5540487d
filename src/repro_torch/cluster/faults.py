"""Fault plans for the wall-clock cluster runtime.

A :class:`FaultPlan` is the declarative description of everything that
goes wrong during a cluster run: stragglers (per-worker extra seconds per
gradient), worker kills at wall-clock times (with optional respawn after
a fixed delay), a server-side checkpoint cadence, and an optional
mid-run restore of the latest checkpoint (simulated server recovery).

A copy of ``src/repro/cluster/faults.py``.  :mod:`repro_torch.api.spec`
embeds a plan in an ``ExperimentSpec`` without pulling in the runtime;
pair lists are stored as tuples so the plan stays hashable and JSON
round-trips (JSON lists are coerced back on construction).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Tuple

Pairs = Tuple[Tuple[int, float], ...]


def _pairs(raw: Iterable, what: str) -> Pairs:
    out = []
    for item in raw:
        wid, val = item
        wid, val = int(wid), float(val)
        if wid < 0 or val < 0:
            raise ValueError(f"{what} entries must be (worker_id >= 0, "
                             f"seconds >= 0), got {item!r}")
        out.append((wid, val))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """What goes wrong, and when (wall-clock seconds from run start)."""
    stragglers: Pairs = ()        # (worker_id, extra seconds per gradient)
    kill: Pairs = ()              # (worker_id, kill at wall second t)
    respawn_after_s: float = 0.0  # respawn killed workers after this; 0=off
    checkpoint_every_s: float = 0.0   # server checkpoint cadence; 0=off
    restore_at_s: float = 0.0     # restore latest checkpoint mid-run; 0=off

    def __post_init__(self):
        object.__setattr__(self, "stragglers",
                           _pairs(self.stragglers, "stragglers"))
        object.__setattr__(self, "kill", _pairs(self.kill, "kill"))
        for f in ("respawn_after_s", "checkpoint_every_s", "restore_at_s"):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be >= 0, "
                                 f"got {getattr(self, f)!r}")

    # ------------------------------------------------------------ queries
    def validate_worker_ids(self, limit: int) -> None:
        """Raise when the plan names a worker id the fleet can never
        hold.  ``limit`` is the *admission ceiling* (``max_workers`` on
        an elastic fleet, the fleet size otherwise): a fault aimed at a
        not-yet-joined elastic worker is legitimate — it simply finds
        nobody to kill if the worker never arrives."""
        bad_ids = sorted({wid for wid, _ in (*self.stragglers,
                                             *self.kill)
                          if wid >= limit})
        if bad_ids:
            raise ValueError(
                f"FaultPlan names worker ids {bad_ids} but the fleet "
                f"can hold at most {limit} workers (ids 0.."
                f"{limit - 1})")

    def straggle_s(self, worker_id: int) -> float:
        """Extra seconds this worker sleeps per gradient (0 = healthy)."""
        return dict(self.stragglers).get(worker_id, 0.0)

    def kill_events(self) -> List[Tuple[float, int]]:
        """[(t_s, worker_id)] sorted by kill time."""
        return sorted((t, wid) for wid, t in self.kill)

    @property
    def empty(self) -> bool:
        return not (self.stragglers or self.kill
                    or self.checkpoint_every_s or self.restore_at_s)


def parse_fault_pairs(s: str) -> Pairs:
    """CLI helper: ``"0:0.2,3:0.5"`` -> ``((0, 0.2), (3, 0.5))``."""
    out = []
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        wid, sep, val = part.partition(":")
        if not sep:
            raise ValueError(f"expected WORKER:SECONDS, got {part!r}")
        out.append((int(wid), float(val)))
    return _pairs(out, "fault pairs")
