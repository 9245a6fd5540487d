"""The wall-clock cluster runtime: server + workers + faults + metrics.

A port of ``src/repro/cluster/runtime.py``.  :class:`ClusterRuntime`
wires one :class:`~repro_torch.cluster.server.ParameterServer`, a worker
fleet, a transport and the :class:`~repro_torch.cluster.faults.
FaultPlan` injector, then runs until a wall-clock budget elapses or an
applied-gradient budget is hit.  The params, the data and every
gradient live on ``device`` (``cuda`` unless the caller asks for the
CPU); the flushes run the port's flush kernels.

Four transports (``transport_kind``, = ``ExperimentSpec.transport``):

  * ``inproc`` — worker *threads* and an in-process queue (the parity
    baseline): gradient compute shares one interpreter lock;
  * ``socket`` — worker threads, but every message crosses a real TCP
    socket as a length-prefixed slab frame;
  * ``proc``   — one OS *process* per worker over Unix-domain sockets
    (:mod:`repro_torch.cluster.mptransport`), computing on the parent's
    device: on the card, the children share it.  FaultPlan kills are
    SIGKILL, and the fleet-ready barrier starts the clock only once
    every child has built its data, warmed a gradient and connected.
    Needs ``spec_dict``: a child rebuilds the workload from the spec
    through ``SIM_WORKLOADS``;
  * ``host``   — the multi-host mode (:mod:`repro_torch.cluster.
    hostlink`): the server binds ``listen`` (``HOST:PORT``) and *waits*
    for workers to join with ``python -m repro_torch join HOST:PORT``.
    The spec travels to them in the handshake, worker ids are leased
    with a generation fence, and the barrier is "every seed worker has
    joined".  With ``max_workers`` above ``num_workers`` the fleet grows
    while the run goes on: the staging buffer and the K(t) schedule
    follow it.  Kills cut the worker's connection; respawns are refused
    (replacement capacity rejoins from its own host).  Needs
    ``spec_dict``.  The same hub admits read-only serve clients
    (``python -m repro_torch infer``; ``serve_every`` down-samples
    their push stream) and stats clients (``python -m repro_torch
    top``), which read :meth:`ClusterRuntime._stats_payload`.

The telemetry bus records timeline spans only when ``trace`` names an
output file (the trainer writes it after the run), and ``prom_port``
serves a Prometheus ``/metrics`` endpoint over the same payload the
stats clients get, plus the bus's counters, while the run lasts.

Pieces that run concurrently with training:

  * **metric sampler** — holds the *published* params slab on a fixed
    wall-clock grid (a tensor no later flush writes, so holding it costs
    nothing); loss and accuracy are evaluated after the run, so
    measurement never perturbs the contention being measured;
  * **fault injector** — kills workers at their planned times (and
    deregisters them so a sync barrier cannot deadlock on the dead),
    respawning them after ``respawn_after_s`` with a fresh data-stream
    generation;
  * **checkpointer** — saves the server state via
    :mod:`repro_torch.checkpoint` on a cadence, and optionally restores
    the latest checkpoint mid-run (``restore_at_s``, simulated server
    recovery).

Everything blocking takes a timeout and every thread watches a stop
event, so a wedged run degrades to "budget elapses, run ends" rather
than a hang.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import (latest_step, load_opt_state,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.cluster.faults import FaultPlan
from repro_torch.cluster.hostlink import HostTransport, parse_hostport
from repro_torch.cluster.mptransport import (ProcTransport, ProcWorkerConfig,
                                             SocketTransport, torch_flags)
from repro_torch.cluster.server import ParameterServer
from repro_torch.cluster.transport import TRANSPORTS, InProcTransport
from repro_torch.cluster.worker import Worker, wait_for
from repro_torch.convert import Device, resolve_device, to_device, tree_to
from repro_torch.core.schedule import ThresholdSchedule, constant_schedule
from repro_torch.core.simulator import data_to
from repro_torch.core.slab import slab_codec
from repro_torch.data.pipeline import shard_indices
from repro_torch.obs.telemetry import Telemetry
from repro_torch.optim.slab_form import SlabOptimizer

_log = logging.getLogger("repro_torch.cluster.runtime")

# how long the fleet barrier waits for every worker to connect, unless
# the caller says otherwise: 25 worker processes start in about 100 s on
# 8 host cores (PERF.md), so the reference's 180 s is too close
PROC_READY_TIMEOUT_S = 300.0


@dataclasses.dataclass
class ClusterResult:
    """What one cluster run produced (adapted into ``RunResult`` by
    :class:`repro_torch.cluster.trainer.ClusterTrainer`)."""
    times: np.ndarray            # wall-clock metric grid (seconds)
    train_loss: np.ndarray
    test_loss: np.ndarray
    test_acc: np.ndarray
    num_updates: int             # parameter updates applied this run
    num_gradients: int           # == the server's applied counter, exactly
    mode: str
    start_version: int           # >0 when resumed from a checkpoint
    accounting: Dict[str, Any]   # applied/dropped/buffered/... + computed
    events: List[Dict[str, Any]]   # kills, respawns, checkpoints, restores
    final_params: Any            # host (CPU) tensors
    wall_s: float
    # the serving-plane report, shape-stable across transports: a hub
    # reports its serve and stats clients, inproc the same keys, empty
    serving: Optional[Dict[str, Any]] = None
    # the telemetry summary plus a ledger_check block cross-checking its
    # counters against the conservation ledger
    telemetry: Optional[Dict[str, Any]] = None
    # proc and host: seconds from the barrier's start (the first spawn,
    # or listening) to its release: the workers' start-up, data and
    # warm-up gradient
    fleet_ready_s: Optional[float] = None


class ClusterRuntime:
    """One wall-clock parameter-server training run."""

    def __init__(self, loss_fn: Callable, init_params, data, *,
                 mode: str, lr: float = 0.01, batch: int = 32,
                 num_workers: int = 4, wall_budget_s: float = 5.0,
                 sample_every_s: float = 0.25,
                 schedule: Optional[ThresholdSchedule] = None,
                 flush_mode: str = "sum", staleness_decay: float = 1.0,
                 max_gradients: Optional[int] = None, seed: int = 0,
                 faults: FaultPlan = FaultPlan(),
                 accuracy_fn: Optional[Callable] = None,
                 transport: Optional[Any] = None,
                 transport_kind: str = "inproc",
                 spec_dict: Optional[Dict[str, Any]] = None,
                 listen: Optional[str] = None,
                 heartbeat_s: float = 2.0, serve_every: int = 1,
                 max_workers: Optional[int] = None,
                 join_secret: Optional[str] = None,
                 lease_grace_s: float = 2.0,
                 slab_dtype: str = "f32",
                 optimizer: Optional[SlabOptimizer] = None,
                 proc_ready_timeout_s: float = PROC_READY_TIMEOUT_S,
                 verbose: bool = False,
                 ckpt_dir: Optional[str] = None,
                 resume_from: Optional[str] = None,
                 trace: Optional[str] = None,
                 prom_port: Optional[int] = None,
                 device: Device = None):
        if mode not in ("sync", "async", "hybrid"):
            raise ValueError(f"mode must be sync, async or hybrid, got "
                             f"{mode!r}")
        if transport_kind not in TRANSPORTS:
            raise ValueError(f"transport_kind must be one of {TRANSPORTS},"
                             f" got {transport_kind!r}")
        if transport_kind == "proc" and spec_dict is None:
            raise ValueError(
                'transport_kind="proc" needs spec_dict (an ExperimentSpec'
                " dict): worker processes rebuild the workload from it "
                "through the SIM_WORKLOADS registry — run through "
                "ClusterTrainer / repro_torch.api.run(spec) with "
                'spec.transport="proc"')
        if transport_kind == "host" and spec_dict is None \
                and transport is None:
            raise ValueError(
                'transport_kind="host" needs spec_dict (an ExperimentSpec'
                " dict): it is what joining hosts receive in the leader "
                "handshake and rebuild their workload from — run through "
                "ClusterTrainer / repro_torch.api.run(spec) with "
                'spec.transport="host"')
        if transport_kind == "host" and faults.respawn_after_s > 0:
            raise ValueError(
                "the host transport cannot respawn remote workers (the "
                "leader does not own the remote machine) — drop "
                "respawn_after_s and rejoin replacement capacity with "
                "`python -m repro_torch join` instead")
        if mode == "async":
            schedule = constant_schedule(num_workers, 1)
        if mode == "hybrid" and schedule is None:
            raise ValueError("hybrid mode needs a schedule")
        # elastic admission is the host transport's: the others own
        # their whole fleet from the start
        if max_workers is not None and transport_kind != "host":
            raise ValueError(
                "max_workers (elastic admission) requires "
                'transport_kind="host" — the other transports spawn '
                "their entire fleet up front")
        self.max_workers = max(num_workers, int(max_workers
                                                or num_workers))
        # faults may name any admissible worker id, an elastic one that
        # has not joined yet included (a kill then finds nobody)
        faults.validate_worker_ids(self.max_workers)
        if (faults.checkpoint_every_s > 0 or faults.restore_at_s > 0) \
                and not ckpt_dir:
            raise ValueError(
                "FaultPlan requests checkpointing "
                f"(checkpoint_every_s={faults.checkpoint_every_s}, "
                f"restore_at_s={faults.restore_at_s}) but no ckpt_dir "
                "was given — pass --ckpt-dir / ClusterTrainer(ckpt_dir=)")
        # every metric snapshot holds a params slab until the post-run
        # evaluation; bound the count
        if wall_budget_s / sample_every_s > 4096:
            raise ValueError(
                f"wall_budget_s/sample_every_s = "
                f"{wall_budget_s / sample_every_s:.0f} metric snapshots "
                "(> 4096), each retaining a full parameter copy — "
                "increase sample_every_s")
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.init_params = tree_to(init_params, self.device)
        self.x_tr, self.y_tr, self.x_te, self.y_te = data_to(data,
                                                              self.device)
        self.mode = mode
        self.lr = lr
        self.batch = batch
        self.num_workers = num_workers
        # the *current* fleet size: seeded at num_workers, grown by
        # admission up to max_workers (host only); the K(t) schedule and
        # the staging buffer follow it
        self.fleet_size = num_workers
        self._fleet_lock = threading.Lock()
        self.wall_budget_s = wall_budget_s
        self.sample_every_s = sample_every_s
        self.schedule = schedule
        self.flush_mode = flush_mode
        self.staleness_decay = staleness_decay
        self.max_gradients = max_gradients
        self.seed = seed
        self.faults = faults
        self.transport_kind = transport_kind
        self.spec_dict = spec_dict
        self.proc_ready_timeout_s = float(proc_ready_timeout_s)
        self.ckpt_dir = ckpt_dir
        self.resume_from = resume_from
        self.verbose = verbose
        # the telemetry bus: counters and histograms always, timeline
        # spans only when a trace file was asked for (``trace`` is its
        # path, written by the trainer after the run)
        self.trace_path = trace
        self.obs = Telemetry(trace=bool(trace))
        # a Prometheus endpoint over the live stats payload, bound once
        # the server exists
        self.prom_port = prom_port
        self.prom_server = None
        # workers fetch a params slab, decode, differentiate and
        # re-encode: each gradient ships as one (P,) tensor
        self.slab_dtype = str(slab_dtype)
        self.optimizer = optimizer or SlabOptimizer("sgd")
        self.codec = slab_codec(self.init_params, self.slab_dtype)
        grad_fn = torch.func.grad(loss_fn)

        def _grad_slab(p_slab, x, y):
            return self.codec.encode(grad_fn(self.codec.decode(p_slab), x, y))

        self._grad = _grad_slab
        self._acc = accuracy_fn
        # bounded gradient channel = backpressure: a worker whose
        # gradient the server can't take yet blocks — on a queue for
        # thread workers, on socket flow control otherwise
        cap = max(4, 2 * num_workers)
        self._own_transport = transport is None
        if transport is not None:
            self.transport = transport
        elif transport_kind == "socket":
            self.transport = SocketTransport(cap, family="tcp",
                                             slab_dtype=self.slab_dtype,
                                             device=self.device)
        elif transport_kind == "proc":
            self.transport = ProcTransport(cap, family="unix",
                                           slab_dtype=self.slab_dtype,
                                           device=self.device)
        elif transport_kind == "host":
            bind_host, bind_port = parse_hostport(listen or "127.0.0.1:0")
            self.transport = HostTransport(
                cap, host=bind_host, port=bind_port,
                num_workers=num_workers,
                welcome_config={"spec": spec_dict},
                heartbeat_s=heartbeat_s, serve_every=serve_every,
                max_workers=self.max_workers,
                join_secret=join_secret, lease_grace_s=lease_grace_s,
                slab_dtype=self.slab_dtype, device=self.device)
        else:
            self.transport = InProcTransport(grad_capacity=cap)
        # the socket hubs count wire bytes on the live bus
        self.transport.obs = self.obs
        # the resolved bind address (host): port 0 in `listen` is the
        # real ephemeral port by now
        self.listen_address: Optional[Any] = \
            tuple(self.transport.address) \
            if transport_kind == "host" else None
        self._stop = threading.Event()
        self._workers: Dict[int, Worker] = {}
        self._all_workers: List[Worker] = []
        self._generation: Dict[int, int] = {}
        self.events: List[Dict[str, Any]] = []
        self._control_errors: List[str] = []
        self._t0 = 0.0

    def _guarded(self, fn: Callable, name: str) -> threading.Thread:
        """Control thread whose failure is captured and re-raised by
        ``run()``: a dead checkpointer/injector means the fault plan was
        not executed, which must not look like a clean run."""
        def body():
            try:
                fn()
            except Exception:
                self._control_errors.append(
                    f"{name}:\n{traceback.format_exc()}")
        return threading.Thread(target=body, name=name, daemon=True)

    # ------------------------------------------------------------ hooks
    def _elapsed(self) -> float:
        return time.monotonic() - self._t0

    def _log_event(self, kind: str, **kw) -> None:
        ev = {"t": round(self._elapsed(), 3), "event": kind, **kw}
        self.events.append(ev)
        self.obs.instant("server", kind, **kw)
        self.obs.count(f"events.{kind}")
        _log.info("+%.2fs %s %s", ev["t"], kind, kw)
        if self.verbose:
            print(f"[cluster +{ev['t']:6.2f}s] {kind} {kw}", flush=True)

    def _batches(self, wid: int, generation: int):
        """The worker's minibatches, gathered on the device: the indices
        go up through pinned memory, so drawing one never waits for the
        card."""
        for take in shard_indices(self.x_tr.shape[0], wid,
                                  self.num_workers, self.batch,
                                  seed=self.seed, generation=generation):
            idx = to_device(take, self.device)
            yield self.x_tr[idx], self.y_tr[idx]

    def _spawn(self, wid: int) -> None:
        gen = self._generation.get(wid, -1) + 1
        self._generation[wid] = gen
        if self.transport_kind == "proc":
            # membership follows the connection, not the spawn: the
            # hub's on_worker_ready hook registers this worker when its
            # HELLO arrives, so a sync barrier never waits seconds of
            # child start-up for a worker that cannot contribute yet
            self.transport.spawn_worker(ProcWorkerConfig(
                spec=self.spec_dict, worker_id=wid, generation=gen,
                num_workers=self.num_workers, mode=self.mode,
                straggle_s=self.faults.straggle_s(wid), seed=self.seed,
                batch=self.batch, device=self.device.type,
                # on the CPU a child splits its work as the parent does
                # (the same reductions, bit for bit); on the card it
                # needs no more than one host thread
                threads=torch.get_num_threads()
                if self.device.type == "cpu" else 1,
                flags=torch_flags()))
            return
        wtrans: Any = self.transport
        if self.transport_kind == "socket":
            wtrans = self.transport.connect(wid, gen)
        w = Worker(wid, grad_fn=self._grad, batches=self._batches(wid, gen),
                   transport=wtrans, mode=self.mode,
                   straggle_s=self.faults.straggle_s(wid),
                   generation=gen, obs=self.obs)
        if wtrans is not self.transport:
            w.endpoint = wtrans         # flushed + closed at shutdown
            # a dead connection stops the worker; a kill or the shutdown
            # setting the stop event wakes the endpoint's waits
            w.stop_event = wtrans.closed
        self._workers[wid] = w
        self._all_workers.append(w)
        self.server.register(wid)
        w.start()

    def _grow_fleet_to(self, n: int) -> None:
        """Online admission: a joiner beyond the current fleet grows the
        server's staging buffer and re-derives the K(t) schedule for the
        new fleet *before* it registers, so a sync round that fills at
        once already has a row for every live member.  The ledger is
        untouched: staged rows survive the resize."""
        with self._fleet_lock:
            if n <= self.fleet_size:
                return
            old = self.fleet_size
            schedule = None
            if self.mode == "async":
                schedule = constant_schedule(n, 1)
            elif self.mode == "hybrid" and self.spec_dict \
                    and self.spec_dict.get("schedule"):
                from repro_torch.api.schedules import parse_schedule
                schedule = parse_schedule(self.spec_dict["schedule"], n)
            self.server.grow_fleet(n, schedule)
            self.fleet_size = n
        self.obs.gauge("fleet_size", n)
        self.obs.count("members.admitted_beyond_seed", n - old)
        self._log_event("fleet_grow", from_workers=old, to_workers=n)

    def _on_remote_ready(self, wid: int, gen: int) -> None:
        # hub reader thread: a worker said HELLO.  A spawned (proc)
        # worker registers only at its exact generation, so an orphan
        # HELLO from a process the injector superseded cannot revive a
        # killed id.  A joined (host) worker's generation is leased by
        # the hub, which fences older ones: any newer one is the
        # legitimate holder of the shard
        if self.transport_kind == "host":
            if gen >= self._generation.get(wid, -1):
                self._grow_fleet_to(wid + 1)
                self._generation[wid] = gen
                self.server.register(wid)
                self.obs.count("members.joined")
                self.obs.gauge("live_workers", len(self.server.live))
                self._log_event("member_join", worker=wid,
                                generation=gen)
            return
        if self._generation.get(wid) == gen:
            self.server.register(wid)

    def _on_remote_gone(self, wid: int, gen: int) -> None:
        # hub reader thread: a worker's connection died (kill, crash,
        # shutdown).  Deregistering here (idempotent) closes the race
        # where a HELLO lands between the injector's kill and the
        # process dying: a registered-but-dead worker would stall every
        # later sync round
        if self._generation.get(wid) == gen:
            self.server.deregister(wid)
            if self.transport_kind == "host":
                self.obs.count("members.departed")
                self.obs.gauge("live_workers", len(self.server.live))
                self._log_event("member_gone", worker=wid,
                                generation=gen)

    def _kill(self, wid: int) -> None:
        if self.transport_kind == "proc":
            sigkilled = self.transport.kill_worker(wid)
            self.server.deregister(wid)
            self._log_event("kill", worker=wid, sigkill=sigkilled)
            return
        if self.transport_kind == "host":
            # the one fault a leader can inflict on a remote host: cut
            # the connection (the worker exits cleanly on EOF)
            cut = self.transport.kill_worker(wid)
            self.server.deregister(wid)
            self._log_event("kill", worker=wid, connection_cut=cut)
            return
        w = self._workers.get(wid)
        if w is not None:
            w.stop_event.set()
        self.server.deregister(wid)
        self._log_event("kill", worker=wid)

    def _stats_payload(self) -> Dict[str, Any]:
        """One ``top`` tick: the live ledger columns, staleness
        percentiles and fleet state, with the reference's keys in its
        order.  Runs on the hub's stats thread or a Prometheus scrape,
        so it reads host-side counters only (never a tensor on the card,
        whose read would wait for the device)."""
        a = self.server.accounting()
        st = self.obs.hist_stats("staleness") or {}
        serve_clients = self.transport.serve_stats()["clients"]
        counters = self.obs.counters()
        return {
            "t": round(self._elapsed(), 3),
            "version": self.server.version,
            "mode": self.mode,
            "optimizer": self.optimizer.name,
            "optimizer_steps": counters.get("optimizer_steps", 0),
            "applied": a["applied"],
            "dropped": a["dropped"],
            "buffered": a["buffered"],
            "pending_round": a["pending_round"],
            "updates": a["updates"],
            "staleness": {"p50": st.get("p50"), "p99": st.get("p99")},
            "queue_depth": self.transport.pending_gradients(),
            "live_workers": len(self.server.live),
            "num_workers": self.num_workers,
            "fleet_size": self.fleet_size,
            "max_workers": self.max_workers,
            "serve_clients": serve_clients,
        }

    # ------------------------------------------------- background loops
    def _injector(self) -> None:
        # one merged timeline: a pending respawn must not delay later
        # kills ("kill" sorts before "spawn" on ties)
        events = [(t, "kill", wid) for t, wid in self.faults.kill_events()]
        if self.faults.respawn_after_s > 0:
            events += [(t + self.faults.respawn_after_s, "spawn", wid)
                       for t, wid in self.faults.kill_events()]
        for t, kind, wid in sorted(events):
            if self._stop.wait(max(0.0, t - self._elapsed())):
                return
            if kind == "kill":
                self._kill(wid)
            else:
                self._spawn(wid)
                self._log_event("respawn", worker=wid,
                                generation=self._generation[wid])

    def _checkpointer(self) -> None:
        while not self._stop.wait(self.faults.checkpoint_every_s):
            # params and moments captured under one lock acquisition
            version, params, applied, opt_state = \
                self.server.snapshot_for_checkpoint()
            path = os.path.join(self.ckpt_dir, f"step_{version}")
            save_checkpoint(path, params, version,
                            extra={"mode": self.mode, "applied": applied,
                                   "backend": "cluster",
                                   "optimizer": self.optimizer.name},
                            opt_state=opt_state)
            self._log_event("checkpoint", step=version)

    def _restorer(self) -> None:
        if self._stop.wait(self.faults.restore_at_s):
            return
        step = latest_step(self.ckpt_dir)
        if step is None:
            self._log_event("restore_skipped", reason="no checkpoint yet")
            return
        path = os.path.join(self.ckpt_dir, f"step_{step}")
        params, step = restore_checkpoint(path, like=self.init_params)
        # the moments and update count ride the same checkpoint; an
        # sgd-written one has none and they restart from zero
        self.server.restore(params, step, opt_state=load_opt_state(path))
        self._log_event("restore", step=step)

    def _sampler(self, snaps: List) -> None:
        # a reference to the published slab: zero work on the hot path,
        # decoded after the run
        i = 0
        while True:
            target = i * self.sample_every_s
            wait = target - self._elapsed()
            if wait > 0 and self._stop.wait(wait):
                return
            if self._stop.is_set():
                return
            version, slab, _ = self.server.snapshot_slab()
            snaps.append((target, version, slab))
            i += 1

    def _wind_down(self) -> "tuple[int, List[str]]":
        """Fleet teardown with the gradient channel kept flowing.

        Joins the worker threads and processes, flushes the socket
        endpoints and quiesces the transport, all while draining the
        gradient channel into the ``in_flight`` count: a backpressured
        sender can finish its last frame only if the server side keeps
        making room.  Afterwards every complete frame has been received
        and counted and the channel is empty, so the ledger is exact.
        Returns ``(in_flight, proc_errors)``."""
        in_flight = 0
        deadline = time.monotonic() + 15.0

        def drain() -> None:
            nonlocal in_flight
            while self.transport.recv_gradient(timeout=0) is not None:
                in_flight += 1

        for w in self._all_workers:     # prompt: all waits see stop
            w.join(timeout=10.0)
        proc_errors: List[str] = []
        if self.transport_kind == "proc":
            while self.transport.procs_alive():
                drain()
                # a child still starting up (a respawn racing the end of
                # the budget) has no connection to get the shutdown EOF
                # on: SIGKILL it; it has sent nothing
                self.transport.kill_unconnected()
                if time.monotonic() > deadline:
                    break
                time.sleep(0.02)
            proc_errors = self.transport.join_workers(timeout=5.0)
        # socket endpoints: push out accepted-but-unshipped gradients
        # (already counted as computed), then hang up so the hub reader
        # sees EOF and can quiesce
        endpoints = [w.endpoint for w in self._all_workers
                     if w.endpoint is not None]
        unflushed = list(endpoints)
        while unflushed and time.monotonic() < deadline:
            drain()
            # an endpoint whose sender died can never flush its rest
            unflushed = [ep for ep in unflushed
                         if not ep.flush(0.05) and ep.can_flush()]
        for ep in endpoints:
            ep.close()
        while True:
            drain()
            if self.transport.quiesce(timeout=0.1):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    "transport failed to quiesce within 15s — the "
                    "conservation ledger would be approximate")
        drain()
        return in_flight, proc_errors

    # -------------------------------------------------------------- run
    def run(self) -> ClusterResult:
        try:
            return self._run()
        finally:
            if self.prom_server is not None:
                self.prom_server.close()
            if self._own_transport:
                self.transport.close()

    def _await_fleet(self) -> None:
        """Hold the clock until the seed fleet has connected (HELLO ==
        warm), at most ``proc_ready_timeout_s``; on ``proc`` fail fast
        on a child that died during start-up, e.g. one that could not
        open its device."""
        deadline = time.monotonic() + self.proc_ready_timeout_s
        while not self.transport.wait_for_workers(
                self.num_workers,
                timeout=min(1.0, max(0.0, deadline - time.monotonic()))):
            if self.transport_kind == "proc":
                dead = self.transport.dead_workers()
                if dead:
                    raise RuntimeError(
                        "worker process(es) died before the fleet was "
                        "ready:\n" + "\n".join(dead))
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"only {sorted(self.transport.live_workers())} of "
                    f"{self.num_workers} workers connected within "
                    f"{self.proc_ready_timeout_s}s")

    def _announce(self) -> None:
        """Tell whoever starts the joiners where to send them."""
        bind_host, bind_port = self.listen_address
        self._log_event("listening", host=bind_host, port=int(bind_port),
                        expected_workers=self.num_workers)
        # a wildcard bind is not a dialable address: the hint names a
        # host the workers can reach
        adv_host = bind_host if bind_host not in ("0.0.0.0", "::", "") \
            else "<LEADER_HOST>"
        print(f"[cluster] leader listening on {bind_host}:{bind_port} — "
              f"waiting for {self.num_workers} worker(s) to join "
              f"(python -m repro_torch join {adv_host}:{bind_port})",
              file=sys.stderr, flush=True)

    def _run(self) -> ClusterResult:
        self._t0 = time.monotonic()     # provisional, reset at the start
        start_version = 0
        start_params = self.init_params
        resume_opt_state = None
        if self.resume_from:
            start_params, start_version = restore_checkpoint(
                self.resume_from, like=self.init_params)
            # moments + update count resume with the params; None (an
            # sgd-written checkpoint) keeps them at zero
            resume_opt_state = load_opt_state(self.resume_from)

        # one gradient before the clock starts, so the budget measures
        # contention, not set-up (cuDNN's first convolution, the first
        # launches); the server's construction builds, loads and runs
        # the flush kernel once.  Worker processes and joined hosts warm
        # their own
        remote = self.transport_kind in ("proc", "host")
        if remote:
            # hold BEFORE the server's construction-time publish: a
            # worker connecting early idles in fetch_params instead of
            # banking gradients before the clock starts
            self.transport.hold_params()
        else:
            x, y = next(self._batches(0, 0))
            wait_for(self._grad(self.codec.encode(start_params), x, y))
        self.server = ParameterServer(
            start_params, lr=self.lr, mode=self.mode,
            transport=self.transport, num_workers=self.num_workers,
            schedule=self.schedule, flush_mode=self.flush_mode,
            staleness_decay=self.staleness_decay,
            max_gradients=self.max_gradients,
            start_version=start_version,
            slab_dtype=self.slab_dtype, optimizer=self.optimizer,
            obs=self.obs)
        if resume_opt_state is not None:
            # after construction (warmup rewound the count to 0) and
            # before any worker can flush
            self.server.agg.reset_opt_state(resume_opt_state)
        wait_for(self.server.agg.params_slab)
        if hasattr(self.transport, "stats_provider"):
            # the STATS push plane: the hub answers stats clients with
            # live numbers from now on
            self.transport.stats_provider = self._stats_payload
        if self.prom_port is not None:
            from repro_torch.obs.prom import PromServer
            self.prom_server = PromServer(
                lambda: (self._stats_payload(), self.obs.counters()),
                self.prom_port)
            self._log_event("prom_listening",
                            port=int(self.prom_server.port))
            if self.verbose:
                print(f"[cluster] prometheus metrics at "
                      f"{self.prom_server.url}", file=sys.stderr,
                      flush=True)

        snaps: List = []
        threads: List[threading.Thread] = []
        fleet_ready_s = None
        try:
            if remote:
                # assemble the fleet (spawn it, or advertise and wait
                # for joins) and hold the clock until every seed worker
                # is warm and connected
                self.transport.on_worker_ready = self._on_remote_ready
                self.transport.on_worker_gone = self._on_remote_gone
                if self.transport_kind == "host":
                    self.transport.on_serve_ready = \
                        lambda sid: self._log_event("serve_client",
                                                    serve_id=sid)
                t_spawn = time.monotonic()
                if self.transport_kind == "proc":
                    for wid in range(self.num_workers):
                        self._spawn(wid)
                else:
                    # joiners may have said HELLO before the hooks
                    # existed: register them now
                    for wid, gen in \
                            self.transport.connected_workers().items():
                        self._on_remote_ready(wid, gen)
                    self._announce()
                self._await_fleet()
                fleet_ready_s = time.monotonic() - t_spawn
            self._t0 = time.monotonic()
            if remote:
                self.transport.release_params()     # the starting gun
            if start_version:
                self._log_event("resume", step=start_version,
                                path=self.resume_from)
            threads.append(self._guarded(lambda: self._sampler(snaps),
                                         "sampler"))
            if self.faults.kill:
                threads.append(self._guarded(self._injector, "injector"))
            if self.ckpt_dir and self.faults.checkpoint_every_s > 0:
                threads.append(self._guarded(self._checkpointer, "ckpt"))
            if self.ckpt_dir and self.faults.restore_at_s > 0:
                threads.append(self._guarded(self._restorer, "restore"))
            for t in threads:
                t.start()
            if not remote:
                for wid in range(self.num_workers):
                    self._spawn(wid)

            deadline = self._t0 + self.wall_budget_s
            next_q = 0.0            # queue-depth sampling grid (~5 Hz)
            while time.monotonic() < deadline \
                    and not self.server.done.is_set():
                msg = self.transport.recv_gradient(timeout=min(
                    0.02, max(1e-3, deadline - time.monotonic())))
                if msg is not None:
                    self.server.ingest(msg)
                now = time.monotonic() - self._t0
                if now >= next_q:
                    self.obs.observe("queue_depth",
                                     self.transport.pending_gradients())
                    next_q = now + 0.2
            wall_s = self._elapsed()
        finally:
            # ALWAYS stop the workers, also when the server loop died: a
            # worker blocked on a bounded send retries until its stop
            # event is set.  Control threads stop first, so the injector
            # cannot respawn a worker nobody stops
            self._stop.set()
            for t in threads:
                t.join(timeout=10.0)
            if remote:
                # EOF on the params direction tells each worker process
                # (spawned or joined) to stop; its in-flight gradient
                # frames still drain
                self.transport.half_close_workers()
            for w in self._all_workers:
                w.stop_event.set()

        in_flight, proc_errors = self._wind_down()
        errors = [f"worker {w.worker_id}.{w.generation}:\n{w.error}"
                  for w in self._all_workers if w.error]
        errors += proc_errors
        errors += self._control_errors
        # a thread that outlived its join would keep changing the state
        # the ledger is about to report
        errors += [f"{t.name} did not stop within the join timeout"
                   for t in (*self._all_workers, *threads)
                   if t.is_alive()]
        if errors:
            raise RuntimeError("cluster thread(s)/process(es) crashed "
                               "or hung:\n" + "\n".join(errors))
        leftover = self.transport.pending_gradients()
        if leftover:
            raise RuntimeError(f"{leftover} gradients appeared after the "
                               "final drain — a producer outlived shutdown")

        accounting: Dict[str, Any] = self.server.accounting()
        accounting["in_flight"] = in_flight
        if self.transport_kind in ("socket", "proc", "host"):
            # "computed" = complete frames that reached the hub: exact
            # under every failure, since whatever a killed worker had
            # not finished sending died with it, like a thread worker
            # killed before its send
            received = self.transport.received_counts()
            accounting["computed"] = sum(received.values())
            # an elastic fleet may have grown past the seed: a column
            # for every member that ever existed
            accounting["computed_per_worker"] = {
                str(wid): received.get(wid, 0)
                for wid in sorted(set(range(self.fleet_size))
                                  | set(received))}
            accounting["torn_frames"] = self.transport.torn_frames
        else:
            accounting["computed"] = sum(w.sent for w in self._all_workers)
            per_worker: Dict[str, int] = {}
            for w in self._all_workers:     # all generations of each id
                key = str(w.worker_id)
                per_worker[key] = per_worker.get(key, 0) + w.sent
            accounting["computed_per_worker"] = per_worker

        # ---------------------------------- evaluate the metric snapshots
        times, tr, te, acc = [], [], [], []
        with torch.no_grad():
            for target, _, slab in snaps:
                params = self.codec.decode(slab)
                times.append(target)
                tr.append(float(self.loss_fn(params, self.x_tr[:2048],
                                             self.y_tr[:2048])))
                te.append(float(self.loss_fn(params, self.x_te,
                                             self.y_te)))
                acc.append(float(self._acc(params, self.x_te, self.y_te))
                           if self._acc is not None else 0.0)

        _, final_params, applied = self.server.snapshot()
        # the serving report is shape-stable across transports: the
        # in-process one reports the same keys, empty
        serving = self.transport.serve_stats()
        # every gradient the server ingested is exactly accounted
        # (applied + dropped + buffered + pending), and everything
        # computed that was never ingested is the in_flight drain
        telemetry = self.obs.summary()
        c = telemetry["counters"]
        ingested = c.get("grads_ingested", 0)
        ledger_sum = (accounting["applied"] + accounting["dropped"]
                      + accounting["buffered"]
                      + accounting["pending_round"])
        telemetry["ledger_check"] = {
            "grads_ingested": ingested,
            "ledger_sum": ledger_sum,
            "computed": accounting["computed"],
            "in_flight": accounting["in_flight"],
            "consistent": (ingested == ledger_sum
                           and accounting["computed"]
                           == ingested + accounting["in_flight"]),
        }
        return ClusterResult(
            times=np.asarray(times), train_loss=np.asarray(tr),
            test_loss=np.asarray(te), test_acc=np.asarray(acc),
            num_updates=accounting["updates"], num_gradients=applied,
            mode=self.mode, start_version=start_version,
            accounting=accounting, events=list(self.events),
            final_params=final_params, wall_s=wall_s,
            serving=serving,
            telemetry=telemetry, fleet_ready_s=fleet_ready_s)
