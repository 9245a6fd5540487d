"""Multi-host slab transport: host:port addressing and leader discovery.

A port of ``src/repro/cluster/hostlink.py``.  :class:`HostTransport` is
the multi-host mode of the slab hub
(:class:`~repro_torch.cluster.mptransport.SocketTransport`): the server
binds a user-chosen ``HOST:PORT`` (``--listen``), and remote workers
*launch themselves* — ``python -m repro_torch join HOST:PORT`` from any
machine that has the package — instead of being spawned by the leader.
Code never crosses the machine boundary: the experiment spec travels
over the wire in the leader handshake, and the joiner rebuilds the
workload from that JSON through ``SIM_WORKLOADS``, as a ``proc`` worker
process does.  The protocol is the reference's byte for byte, so a
joiner of either package trains under a leader of either.

**Leader handshake** (one round trip before the HELLO/GRAD/PARAMS
protocol; frames in :mod:`repro_torch.cluster.mptransport`)::

    joiner                          leader (hub)
      | -- JOIN(magic, v, want_id) -->|   lease a worker id
      | <-- WELCOME{spec, worker_id,  |   (or REJECT + readable reason)
      |      generation, num_workers}-|
      |   ... rebuild the workload, warm one gradient ...
      | -- HELLO(magic, v, id, gen) ->|   ready: joins the fleet barrier
      | <==== PARAMS / GRAD ... =====>|   the training protocol

**Worker-id leases with generation fencing** — the worker id is the
data-shard assignment, so the leader hands ids out centrally:
``JOIN(-1)`` leases the lowest free id, ``JOIN(w)`` asks for one, and a
rejoining host is re-leased its old id with the generation bumped (a
fresh batch stream, never a duplicate).  Every grant advances the id's
generation, and a HELLO carrying an older generation than the current
lease is fenced out.

**Elastic membership** — the fleet is *seeded* at ``cluster_workers``;
with ``max_workers`` above it the leader keeps admitting joiners mid-run
up to that ceiling (the runtime grows the staging buffer and re-derives
the K(t) schedule).  Every joiner shards over ``max_workers``, so a late
admission re-partitions nobody's data.  A departed worker's id enters a
**re-lease grace window**: its own host may resume it at once
(``JOIN(w)``), while an auto join only receives it once the window has
passed.  Auto joins retry such rejections within their deadline
(:data:`BUSY_MARKER`).

**Authenticated JOIN** — a leader with a shared join secret answers
JOIN with CHALLENGE (a random nonce); the joiner proves the secret with
AUTH = HMAC-SHA256(secret, nonce) and only then receives WELCOME.  A
wrong digest, and a direct HELLO that skips the challenge, are rejected
readably and never enter the barrier.

The leader cannot respawn a remote worker: a kill on this transport
cuts the worker's connection (the remote process exits cleanly on EOF),
and replacement capacity rejoins from its own host — ``join
--reconnect`` does exactly that, resuming the old lease at the next
generation.

The host hub also admits read-only peers: a **serve client** (SERVE,
``python -m repro_torch infer``) gets a WELCOME with the spec, a
``serve_id`` and the push cadence, then the coalesced params broadcast
(every ``serve_every``-th version); a **stats client** (STATS, ``python
-m repro_torch top``) gets a ``stats_id`` and the telemetry push.
Neither holds a lease, sits in the fleet barrier or enters the ledger,
and neither is challenged: they can observe, never contribute.
:func:`negotiate_serve` and :func:`negotiate_stats` are their
handshakes.
"""
from __future__ import annotations

import hmac
import json
import logging
import os
import random
import socket
import subprocess
import sys
import threading
import time
import traceback
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.cluster.mptransport import (
    _AUTH_NONCE_LEN, _CTRL, _F_CHALLENGE, _F_PARAMS, _F_PING, _F_PONG,
    _F_REJECT, _F_WELCOME, _HDR, _MAX_FRAME, CUDA_DETERMINISTIC,
    SocketTransport,
    SocketWorkerClient, WireProtocolError, _auth_digest, _auth_frame,
    _challenge_frame, _join_frame, _peer_error, _recv_exact,
    _serve_frame, _stats_frame, _welcome_frame, set_torch_flags)
from repro_torch.cluster.worker import wait_for
from repro_torch.convert import Device, resolve_device, to_device
from repro_torch.core.slab import slab_codec
from repro_torch.data.pipeline import shard_indices, worker_shards

_log = logging.getLogger("repro_torch.cluster.hostlink")

# Machine-readable marker on lease rejections that resolve themselves as
# the fleet churns (a dead predecessor's connection not reaped yet, a
# slot about to free up).  It travels inside the REJECT reason, and
# negotiate_join retries exactly the marked rejections within its
# deadline; protocol errors are never marked and fail fast.  The same
# string as the reference's, so either package's joiner retries the
# other's leader.
BUSY_MARKER = "[busy]"


def parse_hostport(s: str, default_host: str = "127.0.0.1"
                   ) -> Tuple[str, int]:
    """``"HOST:PORT"`` / ``":PORT"`` / ``"PORT"`` -> ``(host, port)``.
    Port 0 means "pick an ephemeral port" (the resolved one is on
    ``transport.address``)."""
    s = str(s).strip()
    host, sep, port_s = s.rpartition(":")
    if not sep:
        host, port_s = "", s
    host = host or default_host
    try:
        port = int(port_s)
    except ValueError:
        raise ValueError(f"invalid listen address {s!r}: expected "
                         "HOST:PORT (e.g. 0.0.0.0:5555, :0)") from None
    if not 0 <= port < 65536:
        raise ValueError(f"invalid port {port} in listen address {s!r}")
    return host, port


def _addr_str(address: Any) -> str:
    if isinstance(address, str):
        return address
    host, port = tuple(address)[:2]
    return f"{host}:{port}"


# ========================================================== leader side


class HostTransport(SocketTransport):
    """The multi-host hub: a TCP slab hub at a real ``host:port`` that
    *admits* remote workers instead of launching them.

    ``welcome_config`` (JSON-able; the runtime passes ``{"spec":
    spec.to_dict()}``) is what every joiner receives in WELCOME,
    extended per join with its ``worker_id`` lease, ``generation``,
    ``num_workers`` (the admission ceiling: the shard space) and
    ``heartbeat_s`` (the PING cadence, from which joiners size their
    hung-leader watchdog).  ``kill_worker`` cuts a connection: the
    leader does not own the remote process.  ``serve_every``
    down-samples the serve clients' push stream.
    """

    def __init__(self, grad_capacity: int = 0, *,
                 host: str = "127.0.0.1", port: int = 0,
                 num_workers: int, welcome_config:
                 Optional[Dict[str, Any]] = None,
                 heartbeat_s: float = 2.0, serve_every: int = 1,
                 max_workers: Optional[int] = None,
                 join_secret: Optional[str] = None,
                 lease_grace_s: float = 2.0,
                 slab_dtype: str = "f32", device: Device = None):
        super().__init__(grad_capacity, family="tcp", host=host,
                         port=port, heartbeat_s=heartbeat_s,
                         serve_every=serve_every, slab_dtype=slab_dtype,
                         device=device)
        self.num_workers = int(num_workers)
        # the admission ceiling AND the data-shard space: every joiner
        # shards over max_workers for the whole run.  With no elastic
        # cap it equals num_workers
        self.max_workers = max(self.num_workers,
                               int(max_workers or self.num_workers))
        self.join_secret = join_secret or None
        self.lease_grace_s = float(lease_grace_s)
        self.welcome_config = dict(welcome_config or {})
        self._leases: Dict[int, int] = {}       # worker_id -> generation
        self._departed: Dict[int, float] = {}   # worker_id -> close time
        self._lease_lock = threading.Lock()

    # ------------------------------------------------------------ leases
    def _taken_ids(self) -> set:
        """Worker ids held by a live connection: HELLO'd, or leased and
        still building (a JOIN whose HELLO is pending)."""
        with self._conns_cond:
            taken = set()
            for c in self._conns:
                if c.closed.is_set():
                    continue
                if c.worker_id is not None:
                    taken.add(c.worker_id)
                elif c.leased_wid is not None:
                    taken.add(c.leased_wid)
        return taken

    def _on_join(self, conn, requested_id: int) -> Optional[str]:
        if self._draining:
            # permanent (no BUSY_MARKER): a reconnect racing the
            # shutdown gets a fast, clean no
            return ("the run is shutting down — no new workers are "
                    "being admitted")
        if self.join_secret and not conn.auth_ok:
            # park the JOIN behind a challenge; _on_auth grants the
            # lease once the digest verifies.  The nonce is random per
            # attempt, so a captured AUTH cannot be replayed
            conn.pending_join = int(requested_id)
            conn.auth_nonce = os.urandom(_AUTH_NONCE_LEN)
            conn.awaiting_auth = True
            conn.send_frame(_challenge_frame(conn.auth_nonce))
            return None
        return self._grant_lease(conn, requested_id)

    def _on_auth(self, conn, digest: bytes) -> Optional[str]:
        secret, nonce = self.join_secret, conn.auth_nonce
        if not secret or nonce is None:
            return "unexpected AUTH frame — this hub issued no challenge"
        if not hmac.compare_digest(_auth_digest(secret, nonce),
                                   bytes(digest)):
            return ("join authentication failed: the AUTH digest does "
                    "not match this leader's join secret (check "
                    "--join-secret on both sides)")
        conn.awaiting_auth = False
        conn.auth_ok = True
        req, conn.pending_join = conn.pending_join, None
        return self._grant_lease(conn, -1 if req is None else req)

    def _grant_lease(self, conn, requested_id: int) -> Optional[str]:
        with self._lease_lock:
            taken = self._taken_ids()
            now = time.monotonic()
            if requested_id < 0:
                free = [w for w in range(self.max_workers)
                        if w not in taken]
                if not free:
                    return (f"{BUSY_MARKER} fleet is full: all "
                            f"{self.max_workers} worker ids are joined")
                # an auto join never receives a recently departed id
                # inside its grace window: the departed host may be
                # reconnecting and would find its shard taken
                open_now = [w for w in free
                            if now - self._departed.get(w, -1e18)
                            >= self.lease_grace_s]
                if not open_now:
                    return (f"{BUSY_MARKER} every free worker id is "
                            "inside the "
                            f"{self.lease_grace_s:.1f}s re-lease grace "
                            "window (its previous holder may rejoin)")
                wid = open_now[0]
            else:
                if requested_id >= self.max_workers:
                    return (f"worker id {requested_id} out of range "
                            f"(fleet size {self.max_workers})")
                if requested_id in taken:
                    return (f"{BUSY_MARKER} worker id {requested_id} "
                            "is already joined")
                # an explicit request skips the grace window: it is the
                # departed holder resuming its shard, fenced by the
                # generation bump either way
                wid = requested_id
            generation = self._leases.get(wid, -1) + 1
            self._leases[wid] = generation
            conn.leased_wid = wid
            self._departed.pop(wid, None)
        cfg = dict(self.welcome_config)
        cfg.update(worker_id=wid, generation=generation,
                   num_workers=self.max_workers,
                   heartbeat_s=self.heartbeat_s)
        conn.send_frame(_welcome_frame(cfg))
        _log.info("leased worker id %d (generation %d)", wid, generation)
        return None

    def _on_serve(self, conn) -> Optional[str]:
        """Admit a read-only serve client: no lease, no shard, no
        barrier seat; a ``serve_id`` and a WELCOME carrying the spec, so
        the client can rebuild the model.  It decodes the broadcast in
        the run's slab dtype (the spec names it)."""
        with self._lease_lock:
            sid = self._serve_seq
            self._serve_seq += 1
        conn.is_serve = True
        conn.serve_id = sid
        conn.slab_dtype = self.slab_dtype
        cfg = dict(self.welcome_config)
        cfg.update(role="serve", serve_id=sid,
                   heartbeat_s=self.heartbeat_s,
                   serve_every=self.serve_every)
        conn.send_frame(_welcome_frame(cfg))
        _log.info("admitted serve client %d (read-only)", sid)
        return None

    def _on_stats(self, conn) -> Optional[str]:
        """Admit a read-only stats client: no lease and no spec, a
        ``stats_id`` and the push cadence.  WELCOME goes out here,
        before :meth:`_on_stats_ready` adds the connection to the push
        list, so the client sees WELCOME before any STATS frame."""
        with self._lease_lock:
            sid = self._stats_seq
            self._stats_seq += 1
        conn.is_stats = True
        conn.stats_id = sid
        cfg = {"role": "stats", "stats_id": sid,
               "heartbeat_s": self.heartbeat_s,
               "stats_every_s": self.stats_every_s}
        conn.send_frame(_welcome_frame(cfg))
        _log.info("admitted stats client %d (read-only)", sid)
        return None

    def _admit_hello(self, conn, worker_id: int,
                     generation: int) -> Optional[str]:
        if not 0 <= worker_id < self.max_workers:
            # an out-of-range id would count toward the fleet barrier
            # while its data shard does not exist
            return (f"worker id {worker_id} out of range (fleet size "
                    f"{self.max_workers})")
        if self.join_secret and not conn.auth_ok:
            # the challenge lives on the JOIN leg; a bare HELLO would
            # bypass it
            return ("this leader requires an authenticated JOIN "
                    "(shared --join-secret) — a direct HELLO is not "
                    "accepted")
        with self._lease_lock, self._conns_cond:
            for c in self._conns:
                # a leased-but-still-building joiner holds its id too
                # (worker_id is None until its HELLO)
                if c is not conn and not c.closed.is_set() \
                        and worker_id in (c.worker_id, c.leased_wid):
                    return (f"worker id {worker_id} already has a "
                            "live connection")
            cur = self._leases.get(worker_id)
            if cur is not None and generation < cur:
                return (f"generation fence: worker {worker_id} HELLO "
                        f"carries generation {generation} but the "
                        f"current lease is {cur} (superseded peer)")
            if cur is None or generation > cur:
                # a direct HELLO without a JOIN: record it so later
                # joins and rejoins fence correctly
                self._leases[worker_id] = generation
            # claim the id inside the admission critical section: a
            # racing admission or join for the same id sees it taken
            conn.worker_id, conn.generation = worker_id, generation
            self._departed.pop(worker_id, None)
            return None

    def _conn_closed(self, conn) -> None:
        # the grace window for auto joins runs from the departure
        wid = conn.worker_id if conn.worker_id is not None \
            else conn.leased_wid
        if wid is not None:
            with self._lease_lock:
                self._departed[wid] = time.monotonic()
        super()._conn_closed(conn)

    # ------------------------------------------------------------ faults
    def kill_worker(self, worker_id: int) -> bool:
        """Cut the worker's connection, the network fault a leader can
        inflict on a remote host; the remote process sees EOF and exits
        cleanly (or rejoins).  True if a live connection was cut."""
        with self._conns_cond:
            conns = [c for c in self._conns
                     if c.worker_id == worker_id
                     and not c.closed.is_set()]
        for c in conns:
            c.close()
        return bool(conns)


# =========================================================== join side


def _backoff_delays(base: float = 0.1, cap: float = 1.0
                    ) -> Iterator[float]:
    """Jittered exponential backoff: base, 2·base, ... capped, each ±50%
    jittered, so a fleet dialing a restarting leader never retries in
    lockstep."""
    delay = base
    while True:
        yield delay * random.uniform(0.5, 1.5)
        delay = min(cap, delay * 2.0)


def _connect_retry(host: str, port: int,
                   timeout: float) -> socket.socket:
    """Dial the leader, retrying with jittered backoff until it is up
    (a leader and its joiners may start in either order)."""
    deadline = time.monotonic() + max(0.0, timeout)
    delays = _backoff_delays()
    while True:
        try:
            return socket.create_connection((host, port), timeout=5.0)
        except OSError as e:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise WireProtocolError(
                    f"could not reach the leader at {host}:{port} "
                    f"within {timeout:.0f}s: {e}") from None
            time.sleep(min(next(delays), remaining))


def negotiate_join(address: Any, *, worker_id: Optional[int] = None,
                   connect_timeout: float = 30.0,
                   secret: Optional[str] = None
                   ) -> Tuple[socket.socket, Dict[str, Any]]:
    """The JOIN handshake: connect, ask for a worker-id lease, return
    ``(connected socket, welcome config)``.  ``connect_timeout`` covers
    the whole negotiation: an unreachable leader and transient lease
    contention (a rejoin racing the teardown of its predecessor's
    connection) are retried with jittered backoff until the deadline.
    ``secret`` answers a secured leader's CHALLENGE.  Raises
    :class:`WireProtocolError` with the leader's readable reason when
    the rejection is permanent or the deadline passed."""
    host, port = parse_hostport(address) if isinstance(address, str) \
        else tuple(address)[:2]
    deadline = time.monotonic() + max(0.0, connect_timeout)
    last_busy: Optional[WireProtocolError] = None
    delays = _backoff_delays()
    while True:
        sock = None
        try:
            sock = _connect_retry(host, int(port),
                                  max(0.0, deadline - time.monotonic()))
            frame = _join_frame(-1 if worker_id is None
                                else int(worker_id))
            return sock, _leader_handshake(sock, frame, deadline,
                                           what="join", secret=secret)
        except WireProtocolError as e:
            if sock is not None:
                sock.close()    # idempotent (the handshake closes too)
            if BUSY_MARKER in str(e):
                last_busy = e
                if time.monotonic() > deadline:
                    raise
                time.sleep(min(next(delays),
                               max(0.0, deadline - time.monotonic())))
                continue
            if last_busy is not None \
                    and time.monotonic() > deadline:
                # the deadline ran out while retrying a busy lease: the
                # lease rejection is the actionable error, not the
                # generic timeout
                raise last_busy
            raise


def negotiate_serve(address: Any, *, connect_timeout: float = 30.0
                    ) -> Tuple[socket.socket, Dict[str, Any]]:
    """The SERVE handshake: connect read-only, return ``(connected
    socket, welcome config)``.  No lease, so no busy retry: a rejection
    is permanent and raises :class:`WireProtocolError` with the
    leader's reason."""
    return _read_only_handshake(address, _serve_frame(), "serve",
                                connect_timeout)


def negotiate_stats(address: Any, *, connect_timeout: float = 30.0
                    ) -> Tuple[socket.socket, Dict[str, Any]]:
    """The STATS handshake (``top``): connect as a read-only telemetry
    subscriber, return ``(connected socket, welcome config)``; as
    :func:`negotiate_serve`."""
    return _read_only_handshake(address, _stats_frame(), "stats",
                                connect_timeout)


def _read_only_handshake(address: Any, request: bytes, what: str,
                         connect_timeout: float
                         ) -> Tuple[socket.socket, Dict[str, Any]]:
    host, port = parse_hostport(address) if isinstance(address, str) \
        else tuple(address)[:2]
    deadline = time.monotonic() + max(0.0, connect_timeout)
    sock = _connect_retry(host, int(port), max(0.0, connect_timeout))
    return sock, _leader_handshake(sock, request, deadline, what=what)


def _leader_handshake(sock: socket.socket, request: bytes,
                      deadline: float, what: str = "join",
                      secret: Optional[str] = None) -> Dict[str, Any]:
    """Send one request frame and read frames until the leader answers
    WELCOME (returned as the parsed config) or REJECT (raised with the
    leader's reason).  A CHALLENGE in between is answered with AUTH =
    HMAC-SHA256(``secret``, nonce); without a secret it fails
    readably."""
    ok = False
    try:
        # re-armed per frame: the deadline covers the WHOLE negotiation,
        # so a leader that keeps sending other frames without WELCOME
        # cannot hold the joiner past it
        sock.settimeout(max(0.1, deadline - time.monotonic()))
        sock.sendall(request)
        while True:
            if time.monotonic() > deadline:
                raise WireProtocolError(
                    f"leader did not complete the {what} handshake "
                    "within the deadline")
            sock.settimeout(max(0.1, deadline - time.monotonic()))
            hdr, _ = _recv_exact(sock, _HDR.size)
            if hdr is None:
                raise WireProtocolError(
                    f"leader hung up during the {what} handshake")
            ftype, n = _HDR.unpack(hdr)
            if n > _MAX_FRAME:
                raise WireProtocolError(
                    f"malformed handshake frame (type {ftype}, "
                    f"length {n})")
            payload, _ = _recv_exact(sock, n)
            if payload is None:
                raise WireProtocolError(
                    f"leader hung up mid-frame during the {what} "
                    "handshake")
            if ftype in (_F_PARAMS, _F_PING, _F_PONG):
                continue        # broadcasts and liveness racing the
                #                 handshake; HELLO re-arms the push
            if n < _CTRL.size:
                raise WireProtocolError(
                    f"malformed handshake frame (type {ftype}, "
                    f"length {n})")
            magic, proto = _CTRL.unpack(payload[:_CTRL.size])
            err = _peer_error(magic, proto)
            if err is not None:
                raise WireProtocolError(f"leader handshake failed: {err}")
            body = bytes(payload[_CTRL.size:])
            if ftype == _F_CHALLENGE:
                if not secret:
                    raise WireProtocolError(
                        f"the leader requires an authenticated {what}: "
                        "pass the shared secret (--join-secret)")
                sock.sendall(_auth_frame(_auth_digest(secret, body)))
                continue
            if ftype == _F_REJECT:
                raise WireProtocolError(
                    f"leader rejected the {what}: "
                    + body.decode("utf-8", "replace"))
            if ftype != _F_WELCOME:
                raise WireProtocolError(
                    f"expected WELCOME, got frame type {ftype}")
            cfg = json.loads(body.decode("utf-8"))
            sock.settimeout(None)
            ok = True
            return cfg
    except OSError as e:
        # a reset or a timeout mid-handshake (a leader closing its
        # listener with this connection still in the backlog) is the
        # leader hanging up, not a crash of the joiner
        raise WireProtocolError(
            f"leader hung up during the {what} handshake: {e}") from None
    finally:
        if not ok:
            sock.close()


def build_slab_worker_fn(spec, worker_id: int, num_workers: int,
                         generation: int, *, batch: int, seed: int,
                         device: torch.device):
    """Rebuild one worker's world from an ``ExperimentSpec``: the
    slab-in/slab-out gradient function, already run once on ``device``,
    and a factory for its deterministic minibatch stream.  Shared by
    ``proc`` worker processes and ``host`` joiners: the spec is the
    whole cross-boundary contract.  The workload is rebuilt through
    ``SIM_WORKLOADS``, and only this worker's shard of the training set
    stays, on the device (the rest is freed here).  ``fresh_batches(gen)``
    draws the batches an in-process worker of the same ``(seed,
    worker_id, gen)`` draws, row for row; ``gen`` defaults to
    ``generation``, and a rejoin at a later generation re-derives only
    the stream."""
    from repro_torch.api.trainers import SIM_WORKLOADS

    loss_fn, init_params, data, _ = SIM_WORKLOADS[spec.arch](spec, device)
    n = data[0].shape[0]
    rows = worker_shards(n, num_workers)[worker_id]
    x, y = to_device(data[0][rows], device), to_device(data[1][rows], device)
    del data
    codec = slab_codec(init_params, spec.slab_dtype)
    grad_fn = torch.func.grad(loss_fn)

    def grad(p_slab, xb, yb):
        return codec.encode(grad_fn(codec.decode(p_slab), xb, yb))

    def fresh_batches(gen: Optional[int] = None):
        # the shard is round robin: global row r is local row r // N
        for take in shard_indices(n, worker_id, num_workers, batch,
                                  seed=seed, generation=generation
                                  if gen is None else int(gen)):
            idx = to_device(take // num_workers, device)
            yield x[idx], y[idx]

    # warm up on a throwaway stream: the training stream must start at
    # batch 0, exactly like an in-process worker's
    wx, wy = next(fresh_batches())
    wait_for(grad(codec.encode(init_params), wx, wy))
    return grad, fresh_batches


def _rejoin(address: Any, wid: int, window_s: float, *,
            secret: Optional[str] = None, verbose: bool = True
            ) -> Optional[Tuple[socket.socket, Dict[str, Any]]]:
    """Reconnect after a mid-run drop: ask for the *same* worker id (the
    explicit request skips the leader's grace window) for up to
    ``window_s``.  The new ``(socket, welcome config)``, or ``None``
    when the leader is gone, draining, or the window passed: all normal
    ends of a run."""
    if verbose:
        print(f"[join] worker {wid} lost the leader; reconnecting for "
              f"up to {window_s:.0f}s", flush=True)
    try:
        return negotiate_join(address, worker_id=wid,
                              connect_timeout=window_s, secret=secret)
    except WireProtocolError as e:
        if verbose:
            print(f"[join] worker {wid} will not rejoin: {e}",
                  flush=True)
        return None


def _open_device(device: Device) -> torch.device:
    """The joiner's device, set up as a worker process's: on the card
    one intra-op thread and the switches ClusterTrainer sets on the
    leader, so a joined worker's gradients carry the bits an in-process
    worker's do; on the CPU the thread count the process started with."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.set_num_threads(1)
        set_torch_flags(CUDA_DETERMINISTIC)
    return dev


def run_joined_worker(address: Any, *,
                      worker_id: Optional[int] = None,
                      connect_timeout: float = 30.0,
                      verbose: bool = True,
                      secret: Optional[str] = None,
                      reconnect_s: float = 0.0,
                      device: Device = None) -> int:
    """One joined worker, end to end: JOIN -> WELCOME -> rebuild the
    workload from the wire spec on ``device`` -> warm a gradient ->
    HELLO (ready) -> train until the leader hangs up or the run ends.
    With ``reconnect_s > 0`` a mid-run drop re-negotiates the same lease
    (next generation, fresh stream, the warm gradient function kept)
    for up to that window.  Returns a process exit code: 2 when the
    workload or the device cannot be set up (it never computes
    elsewhere), 3 on a worker error, 4 when rejected, 5 when the leader
    looks hung.  Raises :class:`WireProtocolError` when the *first*
    join is turned away; a failed rejoin after a session exits 0 (the
    run is over or the shard is covered)."""
    sock, cfg = negotiate_join(address, worker_id=worker_id,
                               connect_timeout=connect_timeout,
                               secret=secret)
    from repro_torch.api.spec import ExperimentSpec
    from repro_torch.cluster.worker import Worker

    built = None            # ((wid, num_workers), (spec, grad, batches))
    total_sent = sessions = 0
    wid = generation = 0
    while True:
        wid, generation = int(cfg["worker_id"]), int(cfg["generation"])
        num_workers = int(cfg["num_workers"])
        if verbose:
            print(f"[join] leased worker {wid}.{generation} of "
                  f"{num_workers} from {_addr_str(address)}; rebuilding "
                  f"workload", flush=True)
        try:
            if built is None or built[0] != (wid, num_workers):
                dev = _open_device(device)
                spec = ExperimentSpec.from_dict(cfg["spec"])
                grad, fresh_batches = build_slab_worker_fn(
                    spec, wid, num_workers, generation,
                    batch=spec.batch, seed=spec.seed, device=dev)
                built = ((wid, num_workers),
                         (spec, dev, grad, fresh_batches))
            spec, dev, grad, fresh_batches = built[1]
            # hung-leader watchdog, sized from the leader's PING cadence
            # (announced in WELCOME): a generous multiple, so a pause or
            # one slow flush never trips it
            hb = float(cfg.get("heartbeat_s") or 0.0)
            stall_timeout = max(10.0, 5.0 * hb) if hb > 0 else 0.0
            # HELLO == ready: into the fleet barrier only now, so the
            # leader's clock never measures this start-up
            client = SocketWorkerClient(None, wid, generation=generation,
                                        heartbeat_timeout_s=stall_timeout,
                                        sock=sock,
                                        slab_dtype=spec.slab_dtype,
                                        device=dev)
        except Exception:
            traceback.print_exc()
            sys.stderr.flush()
            try:
                sock.close()
            except OSError:
                pass
            return 2

        worker = Worker(wid, grad_fn=grad,
                        batches=fresh_batches(generation),
                        transport=client, mode=spec.mode,
                        straggle_s=spec.faults.straggle_s(wid),
                        generation=generation)
        # leader shutdown or death closes the connection -> closed is
        # set -> the loop exits: a dead leader never strands this worker
        worker.stop_event = client.closed
        if verbose:
            print(f"[join] worker {wid}.{generation} ready (warm); "
                  "training", flush=True)
        worker.run()                        # inline, not as a thread
        client.flush(5.0)
        client.close()
        total_sent += worker.sent
        sessions += 1
        if worker.error:
            print(worker.error, file=sys.stderr, flush=True)
            return 3
        if client.reject_reason:
            print(f"[join] worker {wid}.{generation} was rejected: "
                  f"{client.reject_reason}", file=sys.stderr, flush=True)
            return 4
        if client.stall_reason:
            print(f"[join] worker {wid}.{generation} gave up: "
                  f"{client.stall_reason}", file=sys.stderr, flush=True)
            return 5
        if reconnect_s <= 0:
            break
        nxt = _rejoin(address, wid, reconnect_s, secret=secret,
                      verbose=verbose)
        if nxt is None:
            break
        sock, cfg = nxt
    if verbose:
        print(f"[join] worker {wid} done: {total_sent} gradients sent "
              f"over {sessions} session(s)", flush=True)
    return 0


def _join_child(address: str, connect_timeout: float, verbose: bool,
                secret: Optional[str], reconnect_s: float,
                device: Device) -> None:
    """Child entry point for ``join --workers K`` (spawned, one
    interpreter each).  ``os._exit``: everything is flushed, and
    unwinding a CUDA context's threads gains nothing."""
    code = 1
    try:
        code = run_joined_worker(address, connect_timeout=connect_timeout,
                                 verbose=verbose, secret=secret,
                                 reconnect_s=reconnect_s, device=device)
    except WireProtocolError as e:
        print(f"join failed: {e}", file=sys.stderr, flush=True)
        code = 4
    except Exception:
        traceback.print_exc()
        code = 2
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def join_main(address: str, *, worker_id: Optional[int] = None,
              workers: int = 1, connect_timeout: float = 60.0,
              verbose: bool = True, secret: Optional[str] = None,
              reconnect_s: float = 0.0, device: Device = None) -> int:
    """``python -m repro_torch join``.  ``workers > 1`` spawns one OS
    process per worker, as a multi-worker host joining the fleet."""
    if workers < 1:
        print("error: --workers must be >= 1", file=sys.stderr)
        return 2
    if workers > 1 and worker_id is not None:
        print("error: --worker-id and --workers > 1 are mutually "
              "exclusive (the leader assigns ids per worker)",
              file=sys.stderr)
        return 2
    if workers == 1:
        try:
            return run_joined_worker(address, worker_id=worker_id,
                                     connect_timeout=connect_timeout,
                                     verbose=verbose, secret=secret,
                                     reconnect_s=reconnect_s,
                                     device=device)
        except WireProtocolError as e:
            print(f"join failed: {e}", file=sys.stderr, flush=True)
            return 4
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_join_child,
                         args=(address, connect_timeout, verbose,
                               secret, reconnect_s, device),
                         name=f"join-{i}") for i in range(workers)]
    for p in procs:
        p.start()
    code = 0
    for p in procs:
        p.join()
        if p.exitcode:
            code = max(code, abs(int(p.exitcode)))
    return code


def spawn_join_process(address: Any, *, workers: int = 1,
                       worker_id: Optional[int] = None,
                       connect_timeout: float = 120.0,
                       device: Optional[str] = None,
                       secret: Optional[str] = None,
                       reconnect_s: Optional[float] = None
                       ) -> "subprocess.Popen":
    """Launch ``python -m repro_torch join`` as a separate OS process
    group: a stand-in for a second machine (its own interpreter, its
    own rebuild from the spec JSON, TCP the only link).  ``device``
    becomes ``--device`` (the CLI's default is ``cuda``).  On the CPU
    the group splits its work over the caller's intra-op thread count
    (``OMP_NUM_THREADS``), as ``proc`` children do."""
    cmd = [sys.executable, "-m", "repro_torch", "join", _addr_str(address),
           "--workers", str(workers),
           "--connect-timeout", str(connect_timeout), "--quiet"]
    if worker_id is not None:
        cmd += ["--worker-id", str(worker_id)]
    if secret is not None:
        cmd += ["--join-secret", secret]
    if reconnect_s is not None:
        cmd += ["--reconnect", str(reconnect_s)]
    if device is not None:
        cmd += ["--device", str(device)]
    env = dict(os.environ)
    import repro_torch
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(repro_torch.__file__)))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    if device == "cpu":
        env["OMP_NUM_THREADS"] = str(torch.get_num_threads())
    return subprocess.Popen(cmd, env=env)
