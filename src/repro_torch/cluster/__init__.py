"""Wall-clock parameter-server runtime (``backend="cluster"``).

Where :mod:`repro_torch.core.simulator` runs the paper's parameter
server in *virtual* time, this package runs it for real: worker threads
computing gradients concurrently against one live server, with stale
reads, server contention, stragglers, worker kill/respawn and server
checkpoint/restore.  A port of ``src/repro/cluster`` with its
in-process transport; the wire transports (``socket``, ``proc``,
``host``) come with ROADMAP A10.

Pieces:
  * :class:`~repro_torch.cluster.transport.InProcTransport` — threads +
    a bounded queue, carrying gradient/params slabs;
  * :class:`~repro_torch.cluster.server.ParameterServer` — live params
    and the slab aggregator (the flush kernels) driven by K(t), under a
    lock;
  * :class:`~repro_torch.cluster.worker.Worker` — one thread per worker,
    real gradients on a deterministic data shard;
  * :class:`~repro_torch.cluster.faults.FaultPlan` — stragglers, kills,
    respawns, the checkpoint cadence;
  * :class:`~repro_torch.cluster.runtime.ClusterRuntime` — wiring and
    wall-clock metric sampling;
  * :class:`~repro_torch.cluster.trainer.ClusterTrainer` — the
    :mod:`repro_torch.api` adapter.
"""
# Only the light pieces load eagerly: repro_torch.api.spec imports
# FaultPlan from here, and a spec round trip must not drag in the
# runtime.  The rest resolve on first attribute access (PEP 562).
from repro_torch.cluster.faults import FaultPlan, parse_fault_pairs  # noqa: F401
from repro_torch.cluster.transport import (TRANSPORTS,  # noqa: F401
                                           GradientMsg, InProcTransport,
                                           ParamsMsg, Transport)

_LAZY = {
    "ParameterServer": "repro_torch.cluster.server",
    "Worker": "repro_torch.cluster.worker",
    "ClusterRuntime": "repro_torch.cluster.runtime",
    "ClusterResult": "repro_torch.cluster.runtime",
    "ClusterTrainer": "repro_torch.cluster.trainer",
}

__all__ = ["FaultPlan", "parse_fault_pairs", "Transport", "TRANSPORTS",
           "InProcTransport", "GradientMsg", "ParamsMsg", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
