"""Wall-clock parameter-server runtime (``backend="cluster"``).

Where :mod:`repro_torch.core.simulator` runs the paper's parameter
server in *virtual* time, this package runs it for real: worker threads
computing gradients concurrently against one live server, with stale
reads, server contention, stragglers, worker kill/respawn and server
checkpoint/restore.  A port of ``src/repro/cluster`` with all four of
its transports: in-process, ``socket``, ``proc`` and ``host`` (remote
workers joining a listening leader, the fleet growing while the run
goes on).

Pieces:
  * :class:`~repro_torch.cluster.transport.InProcTransport` — threads +
    a bounded queue, carrying gradient/params slabs;
  * :mod:`~repro_torch.cluster.mptransport` — the same channels as slab
    frames over sockets (``SocketTransport``), and one worker process
    per worker (``ProcTransport``);
  * :mod:`~repro_torch.cluster.hostlink` — the multi-host leader
    (``HostTransport``: worker-id leases, the generation fence, HMAC
    admission, elastic growth) and the joiner's side (``join_main``,
    ``spawn_join_process``);
  * :class:`~repro_torch.cluster.server.ParameterServer` — live params
    and the slab aggregator (the flush kernels) driven by K(t), under a
    lock;
  * :class:`~repro_torch.cluster.worker.Worker` — one thread (or
    process) per worker, real gradients on a deterministic data shard;
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
    "SocketTransport": "repro_torch.cluster.mptransport",
    "SocketWorkerClient": "repro_torch.cluster.mptransport",
    "ProcTransport": "repro_torch.cluster.mptransport",
    "WireProtocolError": "repro_torch.cluster.mptransport",
    "HostTransport": "repro_torch.cluster.hostlink",
    "negotiate_join": "repro_torch.cluster.hostlink",
    "run_joined_worker": "repro_torch.cluster.hostlink",
    "join_main": "repro_torch.cluster.hostlink",
    "spawn_join_process": "repro_torch.cluster.hostlink",
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
