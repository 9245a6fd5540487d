"""Message transport between cluster workers and the parameter server.

Two channels:

  * gradients, worker -> server (:class:`GradientMsg`): a multi-producer
    queue the server drains;
  * parameters, server -> workers (:class:`ParamsMsg`): a versioned
    broadcast cell — workers always read the latest published version,
    optionally blocking until a minimum version appears (the sync
    barrier's worker side).

**Wire format:** both payloads are gradient *slabs*
(:mod:`repro_torch.core.slab`) — one contiguous, tile-aligned ``(P,)``
tensor per message, not a tree of leaves.  Workers flatten a gradient
exactly once and the server stages the slab straight into its
aggregation buffer.

A port of ``src/repro/cluster/transport.py``.  :class:`Transport` is the
interface; :class:`InProcTransport` is the in-process (threads + queue)
implementation, the only one ported so far: the socket, process and
multi-host transports come with ROADMAP A10.  All blocking calls take
timeouts, and nothing assumes the payloads share an address space
beyond the payload field itself.

**Timeout contract** (uniform across every method and implementation):

  * ``timeout=None`` — block until the call can complete;
  * ``timeout <= 0`` — never block (poll once and return);
  * ``timeout > 0``  — block at most that many seconds.

A call that gives up (timeout elapsed, nothing available) returns the
sentinel (``False`` for sends, ``None`` for receives) — it never raises.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Optional, Protocol

# the spec-facing transport names (ExperimentSpec.transport / --transport);
# the port runs inproc and refuses the other three until ROADMAP A10:
#   inproc — worker threads + queue: one address space, GIL-shared compute
#   socket — worker threads, but every message crosses a real TCP socket
#            (length-prefixed slab frames): the wire format is physical
#   proc   — one OS process per worker over Unix-domain sockets: stale
#            reads, stragglers, and SIGKILL worker death are physical
#   host   — the leader binds a routable --listen HOST:PORT and remote
#            workers join it themselves (`python -m repro join`): the
#            address, the discovery, and the machine boundary are real
TRANSPORTS = ("inproc", "socket", "proc", "host")


@dataclasses.dataclass
class GradientMsg:
    worker_id: int
    grad: Any          # gradient slab: (P,) tensor (repro_torch.core.slab)
    version: int       # params version the gradient was computed against
    seq: int           # worker-local gradient counter (accounting)


@dataclasses.dataclass
class ParamsMsg:
    version: int
    params: Any        # params slab: (P,) tensor — the server's published
    #                    copy (never an alias of its master slab)
    epoch: int = 0     # restore epoch: bumped on every checkpoint
    #                    restore.  Version alone cannot signal a
    #                    restore — "version went backwards" is
    #                    indistinguishable from "my round has not
    #                    completed yet" on a slow fleet, and sync
    #                    workers must resync on the former but keep
    #                    waiting on the latter


class Transport(Protocol):
    """Wire between N workers and one parameter server.

    The timeout contract (module docstring) is part of the protocol:
    ``None`` blocks, ``<= 0`` polls, positive waits at most that long.
    """

    def send_gradient(self, msg: GradientMsg,
                      timeout: Optional[float] = None
                      ) -> bool:                             # worker side
        """Hand one gradient to the server.  ``True`` once the message
        is durably in the channel; ``False`` if the channel stayed full
        for the whole timeout (backpressure) — the caller retries with
        the *same* message."""
        ...

    def recv_gradient(self, timeout: Optional[float] = None
                      ) -> Optional[GradientMsg]:            # server side
        """Next gradient, or ``None`` if none arrived within the
        timeout (``timeout=None`` blocks until one does)."""
        ...

    def publish_params(self, msg: ParamsMsg) -> None:        # server side
        """Replace the broadcast cell — *unconditionally*, even when
        ``msg.version`` is lower than the current one: a checkpoint
        restore legitimately moves the published version backwards, and
        workers resync to whatever is current."""
        ...

    def fetch_params(self, min_version: int = 0,
                     timeout: Optional[float] = None
                     ) -> Optional[ParamsMsg]:               # worker side
        """Latest published params with ``version >= min_version``, or
        ``None`` on timeout (the sync barrier's worker side)."""
        ...

    def pending_gradients(self) -> int:
        """Gradients sent but not yet received.  **Approximate while
        producers are live** (it reads a concurrently-mutated queue
        size); exact only once every producer has stopped and, for
        multi-process transports, :meth:`quiesce` returned ``True`` —
        which is the only state in which the conservation ledger may
        read it."""
        ...

    def quiesce(self, timeout: Optional[float] = None) -> bool:
        """Block until no in-flight bytes remain between producers and
        :meth:`recv_gradient` (socket transports: every connection
        drained to EOF).  ``True`` when fully quiesced.  Callers must
        have stopped the producers first, and may need to interleave
        ``recv_gradient(timeout=0)`` drains with ``quiesce`` calls — a
        bounded channel can otherwise never empty."""
        ...

    def close(self) -> None:
        """Release transport resources (sockets, threads, processes).
        Idempotent."""
        ...


class InProcTransport:
    """Threads-in-one-process transport: queue + versioned broadcast cell.

    ``grad_capacity`` bounds the gradient queue (0 = unbounded): a full
    queue blocks the sending worker, which is the backpressure a real
    wire applies when the server is the bottleneck — without it an
    outpaced server accumulates an unbounded stale-gradient backlog."""

    def __init__(self, grad_capacity: int = 0):
        self._grads: "queue.Queue[GradientMsg]" = \
            queue.Queue(maxsize=grad_capacity)
        self._cell: Optional[ParamsMsg] = None
        self._cond = threading.Condition()

    # ------------------------------------------------- gradient channel
    def send_gradient(self, msg: GradientMsg,
                      timeout: Optional[float] = None) -> bool:
        try:
            if timeout is not None and timeout <= 0:
                self._grads.put_nowait(msg)
            else:                       # None blocks (the contract)
                self._grads.put(msg, timeout=timeout)
            return True
        except queue.Full:
            return False

    def recv_gradient(self, timeout: Optional[float] = None
                      ) -> Optional[GradientMsg]:
        # timeout=None must BLOCK, matching send_gradient — it used to
        # mean get_nowait(), the opposite of the send side's contract
        try:
            if timeout is not None and timeout <= 0:
                return self._grads.get_nowait()
            return self._grads.get(timeout=timeout)
        except queue.Empty:
            return None

    def pending_gradients(self) -> int:
        return self._grads.qsize()      # exact once producers stopped

    def quiesce(self, timeout: Optional[float] = None) -> bool:
        return True     # same address space: nothing is ever in flight

    def close(self) -> None:
        pass

    # ------------------------------------------------ parameter channel
    def publish_params(self, msg: ParamsMsg) -> None:
        with self._cond:
            self._cell = msg
            self._cond.notify_all()

    def fetch_params(self, min_version: int = 0,
                     timeout: Optional[float] = None
                     ) -> Optional[ParamsMsg]:
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._cell is not None
                and self._cell.version >= min_version, timeout)
            return self._cell if ok else None
