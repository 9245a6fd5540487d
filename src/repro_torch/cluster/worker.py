"""A cluster worker: one thread computing real gradients.

A port of ``src/repro/cluster/worker.py``.  Each worker owns a
deterministic minibatch stream over its shard of the training data
(:func:`repro_torch.data.pipeline.shard_indices`), fetches the latest
published parameter slab from the transport, computes a gradient, and
sends it back as a slab tagged with the parameter version it read:
staleness in this runtime is physical, not simulated.  ``grad_fn`` is
slab in, slab out (decode, ``torch.func.grad``, encode), so each
gradient is flattened once and the transport carries one tensor each
way.

On the card every thread launches on the device's default stream, so
the server's staging copy and flush run after the gradient they
consume.  Before sending, a worker waits for its own gradient on an
event recorded after it (the reference's ``block_until_ready``): not
for the whole device, which would wait for the other workers' work and
the server's flushes too.

Policy differences live entirely in *when* a worker blocks:

  * ``async`` / ``hybrid`` — fetch whatever version is current, never
    wait;
  * ``sync`` — after contributing to round v, block until the server
    publishes v+1 (the barrier's worker side).

``straggle_s`` adds a sleep per gradient; ``stop_event`` is the
cooperative kill switch the fault injector and the runtime's shutdown
both set, so neither a crashed server nor a kill can leave a worker in
the bounded-send retry loop.  A killed worker's gradient in hand is
lost *before* send, so the ledger (sent == applied + dropped + buffered
+ pending + in-flight) holds.  Every transport wait is a short positive
timeout, and each iteration re-checks ``stop_event``.
"""
from __future__ import annotations

import threading
import time
import traceback
from typing import Callable, Iterator, Optional

import torch

from repro_torch.cluster.transport import GradientMsg, Transport
from repro_torch.obs.telemetry import NULL


def wait_for(t: torch.Tensor) -> None:
    """Block this thread until the work queued so far on ``t``'s stream,
    which produces ``t``, is done.  The thread sleeps rather than spins
    (``blocking=True``): a fleet of spinning threads would take the
    cores the launching threads need."""
    if t.is_cuda:
        done = torch.cuda.Event(blocking=True)
        done.record(torch.cuda.current_stream(t.device))
        done.synchronize()


class Worker(threading.Thread):
    def __init__(self, worker_id: int, *, grad_fn: Callable,
                 batches: Iterator, transport: Transport, mode: str,
                 straggle_s: float = 0.0, generation: int = 0,
                 name: Optional[str] = None, obs=None):
        super().__init__(name=name or f"worker-{worker_id}.{generation}",
                         daemon=True)
        self.worker_id = worker_id
        self.generation = generation
        self.grad_fn = grad_fn
        self.batches = batches
        self.transport = transport
        self.mode = mode
        self.straggle_s = straggle_s
        self.stop_event = threading.Event()
        self.sent = 0            # gradients actually handed to the server
        self.error: Optional[str] = None
        self.obs = obs if obs is not None else NULL

    def run(self) -> None:
        try:
            self._loop()
        except Exception:                       # surfaced by the runtime
            self.error = traceback.format_exc()

    def _loop(self) -> None:
        next_version = 0        # sync: the round we haven't contributed to
        epoch = 0               # restore epoch of the params last used
        while not self.stop_event.is_set():
            min_v = next_version if self.mode == "sync" else 0
            msg = self.transport.fetch_params(min_version=min_v,
                                              timeout=0.05)
            if msg is None:
                if self.mode == "sync" and min_v > 0:
                    # a checkpoint restore moves the server's version
                    # *backwards* and wipes the round in progress:
                    # resync.  The restore EPOCH is the signal — a
                    # merely-lower version is indistinguishable from
                    # "my round has not finished yet" on a slow fleet,
                    # and re-contributing on that false positive would
                    # double-draw from the batch stream and break sync
                    # determinism
                    cur = self.transport.fetch_params(timeout=0)
                    if cur is not None and cur.epoch != epoch:
                        msg = cur
                if msg is None:
                    continue
            epoch = msg.epoch
            x, y = next(self.batches)
            t0 = time.monotonic()
            grad = self.grad_fn(msg.params, x, y)
            wait_for(grad)
            dt = time.monotonic() - t0
            self.obs.observe("grad_s", dt)
            self.obs.observe(f"grad_s.w{self.worker_id}", dt)
            self.obs.span_at(f"worker/{self.worker_id}", "grad_compute",
                             t0, dt, version=msg.version)
            if self.straggle_s and self.stop_event.wait(self.straggle_s):
                break           # killed mid-straggle: gradient is lost
            out = GradientMsg(self.worker_id, grad, msg.version,
                              self.sent + 1)
            t0 = time.monotonic()
            ok = False          # bounded queue: block until the server
            while not ok and not self.stop_event.is_set():  # drains, or
                ok = self.transport.send_gradient(out, timeout=0.05)
            if not ok:
                break           # ...killed while blocked: gradient lost
            wait = time.monotonic() - t0
            self.obs.observe("send_wait_s", wait)
            self.obs.span_at(f"worker/{self.worker_id}", "send_wait",
                             t0, wait, version=msg.version)
            self.sent += 1
            if self.mode == "sync":
                next_version = msg.version + 1
