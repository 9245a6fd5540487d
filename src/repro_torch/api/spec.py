"""The one experiment description every backend consumes.

:class:`ExperimentSpec` is a frozen dataclass naming *what* to run —
workload, backend, aggregation mode, threshold schedule (a
:mod:`repro_torch.api.schedules` spec string), worker pool, seed and
flush options.  It has every field of the reference's
``src/repro/api/spec.py`` and the same JSON, so a spec written by either
package loads in the other:

    spec = ExperimentSpec(arch="mlp", backend="sim", mode="hybrid",
                          schedule="step:300", horizon=8.0)
    result = repro_torch.api.run(spec, device="cuda")

The port runs all three backends: ``sim``, ``spmd`` (launched under
``torchrun`` for more than one rank; ``steps``, ``seq``, ``merge_alpha``,
``mesh_model`` and ``log_every`` are its fields; ``mesh_model`` M must
divide the world size, and M > 1, the tensor-parallel ``model`` axis,
covers every family without a frontend: attention, MLA, MLP, MoE,
mamba, mLSTM and sLSTM blocks) and ``cluster``.  The cluster backend runs all four transports:
``inproc``, ``socket``, ``proc`` and ``host`` (``listen``, ``heartbeat_s`` and the
elastic ceiling ``max_workers`` are the host transport's, and so is
``serve_every``, which down-samples the params pushes to read-only
serve clients).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

from repro_torch.api.schedules import parse_schedule
from repro_torch.cluster.faults import FaultPlan
from repro_torch.cluster.transport import TRANSPORTS
from repro_torch.core.simulator import WorkerPool
from repro_torch.optim.slab_form import OPTIMIZER_NAMES, SlabOptimizer

BACKENDS = ("sim", "spmd", "cluster")
MODES = ("sync", "async", "hybrid")
FLUSH_MODES = ("sum", "mean")


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """Declarative description of one training experiment."""
    # what + where
    arch: str = "mlp"              # sim: workload name; spmd: registry arch
    backend: str = "sim"
    mode: str = "hybrid"
    schedule: Optional[str] = "step:300"   # spec string; None for sync/async
    seed: int = 0
    # optimization
    lr: float = 0.01
    batch: int = 32
    optimizer: str = "sgd"         # server-side slab optimizer:
    #                                "sgd" | "momentum" | "adamw" —
    #                                moments live as f32 slab buffers
    #                                updated by the fused flush kernel
    beta1: float = 0.9             # momentum decay / AdamW b1
    beta2: float = 0.95            # AdamW b2 (second-moment decay)
    weight_decay: float = 0.0      # AdamW decoupled weight decay
    # simulator backend (virtual time)
    horizon: float = 20.0          # virtual seconds
    sample_every: float = 0.5      # metric-grid spacing (virtual seconds)
    pool: WorkerPool = WorkerPool()
    flush_mode: str = "sum"        # buffer flush: "sum" | "mean"
    staleness_decay: float = 1.0   # <1 = staleness-weighted flush
    # SPMD backend (steps)
    steps: int = 100
    seq: int = 128
    merge_alpha: float = 1.0       # partial (Lookahead-style) merges
    mesh_model: int = 1            # model axis: divides the world size
    smoke: bool = True             # reduced config / dataset sizes
    log_every: int = 10
    # cluster backend (wall clock, real concurrent workers)
    cluster_workers: int = 4
    wall_budget_s: float = 5.0     # real seconds of training
    wall_sample_every_s: float = 0.25   # metric-grid spacing (real s)
    max_gradients: Optional[int] = None  # stop after N applied gradients
    faults: FaultPlan = FaultPlan()      # stragglers / kills / checkpoints
    transport: str = "inproc"  # worker wire: inproc | socket | proc | host
    listen: str = "127.0.0.1:0"    # host transport: leader bind address
    #                                HOST:PORT (port 0 = pick; the
    #                                resolved address is printed and
    #                                recorded in the run's events)
    heartbeat_s: float = 2.0       # host transport: leader-liveness PING
    #                                cadence (0 disables; workers and
    #                                serve clients size their hung-leader
    #                                watchdog from it)
    serve_every: int = 1           # serving plane: push every Nth params
    #                                version to serve clients (the
    #                                staleness-vs-bandwidth knob; 1 =
    #                                every version)
    max_workers: Optional[int] = None   # host transport: elastic
    #                                admission ceiling — JOINs beyond
    #                                cluster_workers grow the fleet up
    #                                to this many ids; None = fixed
    #                                membership (pre-elastic behavior,
    #                                bit for bit)
    slab_dtype: str = "f32"        # gradient/params slab precision on
    #                                the staging buffer and the wire:
    #                                "f32" (pinned v1 layout, bitwise-
    #                                reproducible) | "bf16" (half the
    #                                wire bytes; master params + flush
    #                                reduction stay f32)
    zoo_scale: float = 0.25        # zoo:* workloads: width multiplier
    #                                applied to the registry config
    #                                (1.0 = the full published tier)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, "
                             f"got {self.mode!r}")
        if self.flush_mode not in FLUSH_MODES:
            raise ValueError(f"flush_mode must be one of {FLUSH_MODES}, "
                             f"got {self.flush_mode!r}")
        if self.transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, "
                             f"got {self.transport!r}")
        if self.transport == "host":
            from repro_torch.cluster.hostlink import parse_hostport
            parse_hostport(self.listen)
        if isinstance(self.pool, dict):   # from_json convenience
            object.__setattr__(self, "pool", WorkerPool(**self.pool))
        if isinstance(self.faults, dict):  # from_json convenience
            object.__setattr__(self, "faults", FaultPlan(**self.faults))
        if self.mode == "hybrid":
            if not self.schedule:
                raise ValueError("hybrid mode requires a schedule spec "
                                 '(e.g. "step:300")')
            # validate the spec string eagerly; worker count is irrelevant
            # for syntax, any plausible value will do
            parse_schedule(self.schedule, max(2, self.pool.num_workers))
        for field in ("steps", "horizon", "sample_every", "batch", "seq",
                      "mesh_model", "log_every", "cluster_workers",
                      "wall_budget_s", "wall_sample_every_s"):
            if getattr(self, field) <= 0:
                raise ValueError(f"{field} must be > 0, "
                                 f"got {getattr(self, field)!r}")
        if self.max_gradients is not None and self.max_gradients <= 0:
            raise ValueError(f"max_gradients must be None or > 0, "
                             f"got {self.max_gradients!r}")
        if self.heartbeat_s < 0:
            raise ValueError(f"heartbeat_s must be >= 0 (0 disables), "
                             f"got {self.heartbeat_s!r}")
        if self.serve_every < 1:
            raise ValueError(f"serve_every must be >= 1, "
                             f"got {self.serve_every!r}")
        if self.slab_dtype not in ("f32", "bf16"):
            raise ValueError('slab_dtype must be "f32" or "bf16", '
                             f"got {self.slab_dtype!r}")
        if self.optimizer not in OPTIMIZER_NAMES:
            raise ValueError(f"optimizer must be one of "
                             f"{OPTIMIZER_NAMES}, got {self.optimizer!r}")
        if not (0.0 <= self.beta1 < 1.0 and 0.0 <= self.beta2 < 1.0):
            raise ValueError(f"beta1/beta2 must be in [0, 1), got "
                             f"{self.beta1!r}/{self.beta2!r}")
        if self.weight_decay < 0:
            raise ValueError(f"weight_decay must be >= 0, "
                             f"got {self.weight_decay!r}")
        if self.zoo_scale <= 0:
            raise ValueError(f"zoo_scale must be > 0, "
                             f"got {self.zoo_scale!r}")
        if self.max_workers is not None:
            if self.transport != "host":
                raise ValueError(
                    "max_workers (elastic admission) requires "
                    'transport="host", got '
                    f"transport={self.transport!r}")
            if self.max_workers < self.cluster_workers:
                raise ValueError(
                    f"max_workers must be >= cluster_workers "
                    f"({self.cluster_workers}), "
                    f"got {self.max_workers!r}")

    # --------------------------------------------------------- derivation
    def with_(self, **changes) -> "ExperimentSpec":
        """Functional update (``dataclasses.replace`` with validation)."""
        return dataclasses.replace(self, **changes)

    def slab_optimizer(self):
        """The server-side optimizer config
        (:class:`repro_torch.optim.SlabOptimizer`) this spec names."""
        return SlabOptimizer(self.optimizer, beta1=self.beta1,
                             beta2=self.beta2,
                             weight_decay=self.weight_decay)

    # ------------------------------------------------------ serialization
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)   # recurses into pool and faults
        # canonical JSON form for the fault pair lists (tuples would
        # come back as lists and break dict-level equality)
        d["faults"] = {**d["faults"],
                       "stragglers": [list(p) for p
                                      in d["faults"]["stragglers"]],
                       "kill": [list(p) for p in d["faults"]["kill"]]}
        return d

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentSpec":
        d = dict(d)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown ExperimentSpec fields: "
                             f"{sorted(unknown)}")
        return cls(**d)   # __post_init__ coerces a dict pool

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "ExperimentSpec":
        with open(path) as f:
            return cls.from_json(f.read())
