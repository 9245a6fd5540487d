"""The wall-clock cluster runtime: server + workers + faults + metrics.

A port of ``src/repro/cluster/runtime.py`` for the in-process transport.
:class:`ClusterRuntime` wires one :class:`~repro_torch.cluster.server.
ParameterServer`, a fleet of worker threads, an
:class:`~repro_torch.cluster.transport.InProcTransport` and the
:class:`~repro_torch.cluster.faults.FaultPlan` injector, then runs until
a wall-clock budget elapses or an applied-gradient budget is hit.  The
params, the data and every gradient live on ``device`` (``cuda`` unless
the caller asks for the CPU); the flushes run the port's flush kernels.
The ``socket``, ``proc`` and ``host`` transports come with ROADMAP A10,
the trace and Prometheus exports with A11.

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
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import (latest_step, load_opt_state,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.cluster.faults import FaultPlan
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


def check_ported(transport_kind: str, trace: Optional[str] = None,
                 prom_port: Optional[int] = None) -> None:
    """Refuse what the port does not run yet, naming where it comes."""
    if transport_kind not in TRANSPORTS:
        raise ValueError(f"transport_kind must be one of {TRANSPORTS},"
                         f" got {transport_kind!r}")
    if transport_kind != "inproc":
        raise NotImplementedError(
            f"the cluster backend's {transport_kind!r} transport is not "
            "ported to repro_torch yet: it comes with ROADMAP A10 (wire "
            "transports); use transport='inproc'")
    if trace or prom_port is not None:
        raise NotImplementedError(
            "the cluster runtime's trace and Prometheus exports are not "
            "ported to repro_torch yet: they come with ROADMAP A11 "
            "(telemetry and serving)")


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
    # the telemetry summary plus a ledger_check block cross-checking its
    # counters against the conservation ledger
    telemetry: Optional[Dict[str, Any]] = None


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
                 transport_kind: str = "inproc",
                 slab_dtype: str = "f32",
                 optimizer: Optional[SlabOptimizer] = None,
                 verbose: bool = False,
                 ckpt_dir: Optional[str] = None,
                 resume_from: Optional[str] = None,
                 trace: Optional[str] = None,
                 prom_port: Optional[int] = None,
                 device: Device = None):
        if mode not in ("sync", "async", "hybrid"):
            raise ValueError(f"mode must be sync, async or hybrid, got "
                             f"{mode!r}")
        check_ported(transport_kind, trace, prom_port)
        if mode == "async":
            schedule = constant_schedule(num_workers, 1)
        if mode == "hybrid" and schedule is None:
            raise ValueError("hybrid mode needs a schedule")
        faults.validate_worker_ids(num_workers)
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
        self.wall_budget_s = wall_budget_s
        self.sample_every_s = sample_every_s
        self.schedule = schedule
        self.flush_mode = flush_mode
        self.staleness_decay = staleness_decay
        self.max_gradients = max_gradients
        self.seed = seed
        self.faults = faults
        self.ckpt_dir = ckpt_dir
        self.resume_from = resume_from
        self.verbose = verbose
        # the telemetry bus: counters and histograms, no timeline spans
        # (their export is A11)
        self.obs = Telemetry(trace=False)
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
        # gradient the server can't take yet blocks
        self.transport = InProcTransport(grad_capacity=max(4,
                                                           2 * num_workers))
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
        w = Worker(wid, grad_fn=self._grad, batches=self._batches(wid, gen),
                   transport=self.transport, mode=self.mode,
                   straggle_s=self.faults.straggle_s(wid),
                   generation=gen, obs=self.obs)
        self._workers[wid] = w
        self._all_workers.append(w)
        self.server.register(wid)
        w.start()

    def _kill(self, wid: int) -> None:
        w = self._workers.get(wid)
        if w is not None:
            w.stop_event.set()
        self.server.deregister(wid)
        self._log_event("kill", worker=wid)

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

    def _wind_down(self) -> int:
        """Join the stopped workers (a send blocked on the bounded queue
        gives up within 0.05 s of the stop), then drain what they sent
        but the server never ingested into the ``in_flight`` count.
        Afterwards the channel is empty, so the ledger is exact."""
        for w in self._all_workers:
            w.join(timeout=10.0)
        in_flight = 0
        while self.transport.recv_gradient(timeout=0) is not None:
            in_flight += 1
        return in_flight

    # -------------------------------------------------------------- run
    def run(self) -> ClusterResult:
        try:
            return self._run()
        finally:
            self.transport.close()

    def _run(self) -> ClusterResult:
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
        # the flush kernel once
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

        snaps: List = []
        threads: List[threading.Thread] = []
        try:
            self._t0 = time.monotonic()
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
            for w in self._all_workers:
                w.stop_event.set()

        in_flight = self._wind_down()
        errors = [f"worker {w.worker_id}.{w.generation}:\n{w.error}"
                  for w in self._all_workers if w.error]
        errors += self._control_errors
        # a thread that outlived its join would keep changing the state
        # the ledger is about to report
        errors += [f"{t.name} did not stop within the join timeout"
                   for t in (*self._all_workers, *threads)
                   if t.is_alive()]
        if errors:
            raise RuntimeError("cluster thread(s) crashed or hung:\n"
                               + "\n".join(errors))
        leftover = self.transport.pending_gradients()
        if leftover:
            raise RuntimeError(f"{leftover} gradients appeared after the "
                               "final drain — a producer outlived shutdown")

        accounting: Dict[str, Any] = self.server.accounting()
        accounting["in_flight"] = in_flight
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
            final_params=final_params, wall_s=wall_s, telemetry=telemetry)
