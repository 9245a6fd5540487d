"""The parameter server: live params + aggregation policy under a lock.

A port of ``src/repro/cluster/server.py``.  The server owns the one
mutable copy of the parameters, as a flat slab
(:mod:`repro_torch.core.slab`), and applies the repo's aggregation
policies (a K(t) :class:`repro_torch.core.schedule.ThresholdSchedule`)
against real concurrent workers:

  * ``async``  — K(t) ≡ 1: every ingested gradient is applied at once;
  * ``hybrid`` — gradients buffer until |buffer| >= K(version), then
    flush as one update (Smooth Switch);
  * ``sync``   — a barrier round: one gradient from every *live* worker
    at the current version, aggregated in worker-id order (which makes
    the policy bitwise-reproducible), applied as their mean.  Gradients
    from an older version (e.g. a worker that died mid-round and came
    back) are dropped and accounted.

Workers ship ``(P,)`` gradient slabs, the server stages them into the
aggregator's ``(K_max, P)`` buffer, and every update is one
:meth:`~repro_torch.core.slab.SlabAggregator.flush_apply`: one launch
of the ``flush``, ``flush_momentum`` or ``flush_adamw`` kernel on the
card.  No update reads a device value on the host: the ledger counters
are host integers, so ``flush_s`` times the dispatch, as in the
reference.

The master params slab is updated in place, so nothing that escapes the
server aliases it: workers receive the published copy each flush makes,
and :meth:`snapshot` copies to the host.

Every mutation happens under ``self.lock``; membership changes
(kill/respawn) re-check the sync barrier so a shrinking fleet cannot
deadlock a round.  ``applied`` / ``dropped`` gradients and ``version``
(= updates) are exact, and ``RunResult.num_gradients`` reports them to
the gradient.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Set

import numpy as np

from repro_torch.cluster.transport import GradientMsg, ParamsMsg, Transport
from repro_torch.core.schedule import ThresholdSchedule
from repro_torch.core.slab import SlabAggregator, SlabBuffer, slab_codec
from repro_torch.obs.telemetry import NULL
from repro_torch.optim.slab_form import SlabOptimizer


class ParameterServer:
    def __init__(self, params, *, lr: float, mode: str,
                 transport: Transport, num_workers: int,
                 schedule: Optional[ThresholdSchedule] = None,
                 flush_mode: str = "sum", staleness_decay: float = 1.0,
                 max_gradients: Optional[int] = None,
                 start_version: int = 0,
                 slab_dtype: str = "f32",
                 optimizer: Optional[SlabOptimizer] = None,
                 obs=None):
        if mode not in ("sync", "async", "hybrid"):
            raise ValueError(f"mode must be sync, async or hybrid, got "
                             f"{mode!r}")
        if flush_mode not in ("sum", "mean"):
            raise ValueError(f"flush_mode must be sum or mean, got "
                             f"{flush_mode!r}")
        if mode in ("async", "hybrid") and schedule is None:
            raise ValueError(f"{mode} mode needs a K(t) schedule")
        self.lock = threading.RLock()
        self.obs = obs if obs is not None else NULL
        self._last_k: Optional[int] = None  # K(t) switch detection
        self.version = int(start_version)   # parameter updates applied
        self.start_version = int(start_version)
        self.mode = mode
        self.lr = lr
        self.schedule = schedule
        self.flush_mode = flush_mode
        self.staleness_decay = staleness_decay
        self.max_gradients = max_gradients
        self.transport = transport
        # a flush aggregates at most one gradient per worker — except
        # async, where K ≡ 1 by definition pins staging to one row.  A
        # hybrid schedule built for a larger fleet can demand more
        # rows, so staging covers the schedule's own ceiling too
        if mode == "async":
            k_max = 1
        else:
            k_max = max(1, num_workers,
                        schedule.num_workers if schedule else 0)
        # slab_dtype is the staging/wire dtype; the master params slab,
        # the moments and the flush reduction stay f32
        self.codec = slab_codec(params, slab_dtype)
        self.optimizer = optimizer or SlabOptimizer("sgd")
        self.agg = SlabAggregator(self.codec, params, k_max,
                                  optimizer=self.optimizer)
        # build and load the flush kernel before the clock starts (a
        # build mid-run would stall the whole fleet under the lock)
        self.agg.warmup()
        self.buffer = SlabBuffer(self.agg, staleness_decay)
        self.applied = 0                    # gradients folded into updates
        self.dropped = 0                    # stale / discarded gradients
        self.updates_applied = 0            # _apply calls (never rolled
        #                                     back, unlike version)
        self.restore_epoch = 0              # bumped per restore(); rides
        #                                     on ParamsMsg so workers can
        #                                     tell a restore from a slow
        #                                     round (see ParamsMsg.epoch)
        # membership starts empty: workers register as they spawn
        self.live: Set[int] = set()
        self._round: Dict[int, Any] = {}    # sync: worker_id -> grad slab
        self.done = threading.Event()       # max_gradients budget reached
        transport.publish_params(ParamsMsg(self.version,
                                           self.agg.params_slab))

    # ------------------------------------------------------- membership
    def grow_fleet(self, num_workers: int,
                   schedule: Optional[ThresholdSchedule] = None) -> None:
        """Admit a fleet larger than construction time planned for: grow
        the staging buffer to ``num_workers`` rows and, when a schedule
        re-derived for the new fleet is given, swap it in with the
        resize.  Must run before :meth:`register` for any worker id
        beyond the old ceiling.  Staged rows are preserved
        (:meth:`SlabAggregator.grow`), so the ledger is untouched."""
        with self.lock:
            if schedule is not None:
                self.schedule = schedule
            if self.mode == "async":
                k_max = 1       # K ≡ 1 by definition: one row, any fleet
            else:
                k_max = max(1, int(num_workers),
                            self.schedule.num_workers
                            if self.schedule else 0)
            self.agg.grow(k_max)

    def register(self, worker_id: int) -> None:
        with self.lock:
            self.live.add(worker_id)

    def deregister(self, worker_id: int) -> None:
        with self.lock:
            self.live.discard(worker_id)
            if self.mode == "sync":
                # a shrinking fleet may complete the round it was blocking
                self._maybe_complete_round()

    # ---------------------------------------------------------- ingest
    def ingest(self, msg: GradientMsg) -> None:
        with self.lock:
            # every gradient that reached the server, and how stale it
            # was on arrival (negative after a restore rolled the clock
            # back).  The ledger cross-check is grads_ingested ==
            # applied + dropped + buffered + pending
            self.obs.count("grads_ingested")
            self.obs.count(f"grads_ingested.w{msg.worker_id}")
            stale = self.version - msg.version
            self.obs.observe("staleness", stale)
            self.obs.observe(f"staleness.w{msg.worker_id}", stale)
            if self.done.is_set():
                self.dropped += 1
                self.obs.count("drops.budget")
                return
            if self.mode == "sync":
                self._ingest_sync(msg)
            else:
                self._ingest_buffered(msg)

    def _ingest_sync(self, msg: GradientMsg) -> None:
        if msg.version != self.version:
            self.dropped += 1       # late arrival from a previous round
            self.obs.count("drops.stale")
            return
        if msg.worker_id in self._round:
            # a worker re-contributing to an in-progress round (after a
            # restore rolled the version back while it waited): latest
            # wins, the overwritten gradient is accounted as dropped
            self.dropped += 1
            self.obs.count("drops.duplicate")
        self._round[msg.worker_id] = msg.grad
        self._maybe_complete_round()

    def _maybe_complete_round(self) -> None:
        if not self.live or not set(self._round) >= self.live:
            return
        wids = sorted(self._round)          # deterministic fold order
        for slot, w in enumerate(wids):
            self.agg.stage(self._round[w], slot)
        k = len(wids)
        self._round = {}
        self._apply(np.ones((k,)), self.lr)     # the round's plain mean

    def _ingest_buffered(self, msg: GradientMsg) -> None:
        self.buffer.add(msg.grad, msg.version)
        # async is K ≡ 1 by definition; hybrid asks the K(t) schedule
        k_needed = 1 if self.mode == "async" else \
            self.schedule(self.version)
        if k_needed != self._last_k:
            if self._last_k is not None:
                self.obs.count("k_switches")
                self.obs.instant("server", "k_switch", k=k_needed,
                                 version=self.version)
            self._last_k = k_needed
        if len(self.buffer) >= k_needed:
            weights = self.buffer.weights(self.version)
            k = len(self.buffer)
            self.buffer.clear()
            # "sum" applies every buffered gradient at full lr (the
            # paper's Algorithm 1; K=1 ≡ async exactly); "mean" is the
            # sync-style update
            scale = self.lr * k if self.flush_mode == "sum" else self.lr
            self._apply(weights, scale)

    def _apply(self, weights: np.ndarray, scale: float) -> None:
        t0 = time.monotonic()
        pub = self.agg.flush_apply(weights, scale)
        dt = time.monotonic() - t0
        self.version += 1
        self.updates_applied += 1
        self.applied += len(weights)
        self.obs.observe("flush_s", dt)
        self.obs.observe("opt_update_s", dt)
        self.obs.count("optimizer_steps")
        self.obs.span_at("server", "flush", t0, dt, k=len(weights),
                         version=self.version)
        self.obs.count("grads_applied", len(weights))
        self.obs.count("updates")
        t1 = time.monotonic()
        self.transport.publish_params(
            ParamsMsg(self.version, pub, epoch=self.restore_epoch))
        dt1 = time.monotonic() - t1
        self.obs.observe("publish_s", dt1)
        self.obs.span_at("server", "publish", t1, dt1,
                         version=self.version)
        self.obs.count("params_published")
        if self.max_gradients and self.applied >= self.max_gradients:
            self.done.set()

    # ----------------------------------------------- snapshot / restore
    def snapshot(self):
        """(version, params, applied), params as a host copy of the
        decoded tree.  Only the grab of the published slab (a fresh
        tensor no flush writes again) needs the lock; the copy to the
        host runs outside it."""
        with self.lock:
            version, pub, applied = (self.version, self.agg.params_slab,
                                     self.applied)
        return version, self.codec.decode_host(pub), applied

    def snapshot_slab(self):
        """(version, params_slab, applied): the published params slab,
        which no later flush writes — the zero-work snapshot for in-run
        samplers, decoded after the run."""
        with self.lock:
            return self.version, self.agg.params_slab, self.applied

    def snapshot_for_checkpoint(self):
        """(version, params, applied, opt_state), params and moments
        captured under **one** lock acquisition: a flush between two
        separate snapshots would save moments one step ahead of their
        params.  The moments are updated in place, so their host copy
        runs under the lock; the params' copy runs outside it."""
        with self.lock:
            version, pub, applied = (self.version, self.agg.params_slab,
                                     self.applied)
            opt_state = self.agg.opt_state_host()
        return version, self.codec.decode_host(pub), applied, opt_state

    def snapshot_opt_state(self):
        """Host copies of the moment slabs and the update count (``None``
        for sgd), taken under the lock: the moments are updated in place,
        so a concurrent flush would change them mid-copy."""
        with self.lock:
            return self.agg.opt_state_host()

    def restore(self, params, step: int, opt_state=None) -> None:
        """Restore into the running server: replace the live params and
        version (so K(t) continues from ``step``) and discard the staged
        and mid-round gradients (computed against a history that no
        longer exists; wiped, since a diverged non-finite gradient would
        poison later flushes through ``0 · inf = nan``)."""
        with self.lock:
            lost = len(self.buffer) + len(self._round)
            self.dropped += lost
            self.obs.count("drops.restore", lost)
            self.obs.count("restores")
            self.obs.instant("server", "restore", step=int(step),
                             lost=lost)
            self.buffer.discard()
            self._round = {}
            self.agg.reset_params(params)
            # the moments resync with the params: the checkpointed slabs
            # and count, or zeros
            self.agg.reset_opt_state(opt_state)
            self.version = int(step)
            # the epoch bump tells a sync worker "this is a restore,
            # recontribute": the version alone can look like an
            # ordinary not-yet-finished round
            self.restore_epoch += 1
            self.transport.publish_params(
                ParamsMsg(self.version, self.agg.params_slab,
                          epoch=self.restore_epoch))

    def accounting(self) -> Dict[str, int]:
        with self.lock:
            # "updates" counts _apply calls: a mid-run restore rolls
            # version backwards but not the work done
            return {"applied": self.applied, "dropped": self.dropped,
                    "buffered": len(self.buffer),
                    "pending_round": len(self._round),
                    "updates": self.updates_applied}
