"""The common result a Trainer returns.

:class:`RunResult` is a metric grid (``grid`` in ``grid_unit`` units —
virtual seconds for the simulator, wall seconds for the cluster) with
aligned per-metric series, plus update / gradient counters and
provenance (the spec that produced it).  ``averaged()`` is the paper's
headline statistic — every metric averaged over the entire training
interval.  The JSON form is the reference's
(``src/repro/api/result.py``); the SPMD builder is not ported yet.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RunResult:
    backend: str                       # "sim" | "cluster"
    mode: str                          # "sync" | "async" | "hybrid"
    schedule: Optional[str]            # schedule spec string (hybrid)
    grid_unit: str                     # "virtual_s" | "wall_s"
    grid: Tuple[float, ...]            # metric sample points
    metrics: Dict[str, Tuple[float, ...]]  # name -> series, len == len(grid)
    num_updates: int = 0               # parameter updates applied
    num_gradients: int = 0             # gradients computed
    wall_s: float = 0.0                # real (host) seconds
    spec: Optional[Dict[str, Any]] = None  # ExperimentSpec.to_dict()
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        for name, series in self.metrics.items():
            if len(series) != len(self.grid):
                raise ValueError(
                    f"metric {name!r} has {len(series)} samples for a "
                    f"grid of {len(self.grid)}")

    # ----------------------------------------------------------- queries
    def averaged(self) -> Dict[str, float]:
        """Paper-style 'averaged over the entire training interval'."""
        return {k: float(sum(v) / len(v))
                for k, v in self.metrics.items() if len(v)}

    def final(self) -> Dict[str, float]:
        """Last sample of each metric."""
        return {k: float(v[-1]) for k, v in self.metrics.items() if len(v)}

    def series(self, name: str) -> Tuple[float, ...]:
        return self.metrics[name]

    # ------------------------------------------------------ serialization
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["grid"] = list(self.grid)
        d["metrics"] = {k: list(v) for k, v in self.metrics.items()}
        d["averaged"] = self.averaged()
        d["final"] = self.final()
        return d

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunResult":
        d = dict(d)
        d.pop("averaged", None)   # derived on the way out
        d.pop("final", None)
        d["grid"] = tuple(d.get("grid", ()))
        d["metrics"] = {k: tuple(v)
                        for k, v in d.get("metrics", {}).items()}
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "RunResult":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    # ---------------------------------------------------------- builders
    @classmethod
    def from_sim(cls, sim, spec=None, wall_s: float = 0.0,
                 extra: Optional[Dict[str, Any]] = None) -> "RunResult":
        """Adapt a :class:`repro_torch.core.simulator.SimResult`."""
        return cls(
            backend="sim", mode=sim.mode,
            schedule=getattr(spec, "schedule", None)
            if sim.mode == "hybrid" else None,
            grid_unit="virtual_s", grid=tuple(float(t) for t in sim.times),
            metrics={
                "train_loss": tuple(float(x) for x in sim.train_loss),
                "test_loss": tuple(float(x) for x in sim.test_loss),
                "test_acc": tuple(float(x) for x in sim.test_acc),
            },
            num_updates=int(sim.num_updates),
            num_gradients=int(sim.num_gradients),
            wall_s=float(wall_s),
            spec=spec.to_dict() if spec is not None else None,
            extra=dict(extra or {}))

    @classmethod
    def from_cluster(cls, cres, spec=None, wall_s: float = 0.0
                     ) -> "RunResult":
        """Adapt a :class:`repro_torch.cluster.runtime.ClusterResult`.

        ``num_gradients`` is the server's applied-gradient counter,
        exactly; the conservation ledger and the fault/checkpoint
        timeline ride along in ``extra``."""
        mode = cres.mode
        return cls(
            backend="cluster", mode=mode,
            schedule=getattr(spec, "schedule", None)
            if mode == "hybrid" else None,
            grid_unit="wall_s",
            grid=tuple(float(t) for t in cres.times),
            metrics={
                "train_loss": tuple(float(x) for x in cres.train_loss),
                "test_loss": tuple(float(x) for x in cres.test_loss),
                "test_acc": tuple(float(x) for x in cres.test_acc),
            },
            num_updates=int(cres.num_updates),
            num_gradients=int(cres.num_gradients),
            wall_s=float(wall_s),
            spec=spec.to_dict() if spec is not None else None,
            extra={"accounting": dict(cres.accounting),
                   "events": list(cres.events),
                   "start_version": int(cres.start_version),
                   # the training window only (the clock starts after
                   # set-up): the denominator for gradients per second
                   "serve_wall_s": float(cres.wall_s)})
