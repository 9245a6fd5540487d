"""Multi-process slab transport: sockets + one process per worker.

A port of ``src/repro/cluster/mptransport.py``.  :class:`SocketTransport`
implements the :class:`~repro_torch.cluster.transport.Transport`
protocol over real sockets (TCP or Unix-domain): the server side is a
*hub* — a listener plus one reader/writer thread pair per accepted
worker connection — and the worker side is a
:class:`SocketWorkerClient` endpoint, made by
:meth:`SocketTransport.connect` (worker threads in the hub's process)
or by a child process that connects to ``hub.address`` itself.
:class:`ProcTransport` adds a ``multiprocessing`` *spawn* launcher that
runs each worker in its own OS process, so stale parameter reads,
stragglers and SIGKILL worker death are physical across address spaces
and no interpreter lock is shared.  Children compute on the parent's
device: on the card, several processes share one GPU by time-slicing.
The multi-host hub that leases worker ids to joiners is
:class:`~repro_torch.cluster.hostlink.HostTransport`.

**Wire format** — the reference's protocol v1, byte for byte (the two
packages' hubs and clients talk to each other)::

    frame   := header payload
    header  := !BI            (type: u8, payload length: u32)
    HELLO   := !IHIi          magic, proto, worker_id, generation
    HELLO'  := !IHIiB         ... + slab dtype code (non-f32 peers only)
    JOIN    := !IHi           magic, proto, requested worker id (-1=auto)
    WELCOME := !IH json       magic, proto, lease + spec JSON  (hub ->)
    REJECT  := !IH utf-8      magic, proto, readable reason   (hub ->)
    GRAD    := !IiQ raw-slab  worker_id, version, seq
    PARAMS  := !ii  raw-slab  version, restore-epoch          (hub ->)
    PING    := !IH            magic, proto — leader liveness  (hub ->)
    PONG    := !IH            magic, proto — liveness reply
    SERVE   := !IH            magic, proto — read-only params subscribe
    STATS   := !IH [json]     magic, proto — read-only stats subscribe
                              (client ->, empty body); one stats push
                              (hub ->, JSON body)
    CHALLENGE := !IH nonce    magic, proto, 32-byte nonce    (hub ->)
    AUTH    := !IH digest     magic, proto, HMAC-SHA256(secret, nonce)

``raw-slab`` is the ``(P_pad,)`` slab as little-endian ``<f4``, or for
a bf16 connection (negotiated by the one trailing byte of HELLO') the
raw little-endian bf16 bit patterns (``<u2``: the ``int16`` view of a
``torch.bfloat16`` tensor).

The first frame on every accepted connection must be a HELLO, JOIN,
SERVE or STATS carrying the protocol magic and version: a stray client
is rejected with a logged, readable error and a best-effort REJECT frame
(:attr:`SocketTransport.rejected_peers` counts them), never admitted to
the fleet.  Frame lengths are validated before any payload is read.
The plain hub answers every control frame as the reference's plain hub
does: a JOIN, AUTH, SERVE or STATS with a REJECT (only the multi-host
hub leases ids, issues challenges and admits read-only peers), a first
frame of any other type with a REJECT, and a PONG, or an unknown frame
after HELLO, not at all.

**Serving plane**: a peer whose first frame is SERVE becomes a read-only
subscriber to the params broadcast (``python -m repro_torch infer``).
It never holds a worker id, so the fleet barrier, ``live_workers``,
``received_counts`` and with them the ledger exclude it, and a GRAD it
sends is rejected.  It gets the same lazily encoded PARAMS frames the
workers get; ``serve_every`` down-samples its stream to every Nth
version (version 0 always ships), and a skipped version is never
encoded for it.  :meth:`SocketTransport.serve_stats` reports pushes,
last version and skips per client.

**Stats plane**: a peer whose first frame is STATS becomes a read-only
subscriber to the hub's telemetry push (``python -m repro_torch top``):
a small JSON payload from :attr:`SocketTransport.stats_provider` every
``stats_every_s``.  Stats peers are never sent the params broadcast at
all, so a sync run with a stats reader attached stays bitwise equal.
The cadence thread starts when a provider is installed and records each
payload in a ring of ``_STATS_HISTORY_LEN`` cells, subscribers or not; a
new stats reader is first sent the ring as one ``{"history": [...]}``
frame, then the current payload, then live pushes.

**Liveness**: with ``heartbeat_s > 0`` the hub PINGs every
authenticated connection on that cadence.  A client replies PONG and
takes *any* frame as proof of life: with ``heartbeat_timeout_s > 0`` it
closes the connection, with a readable :attr:`SocketWorkerClient.
stall_reason`, when no frame arrived for that long (a hung leader holds
its sockets open, so EOF alone cannot show it).

**Payloads on the card**: a GRAD payload is received straight into a
pinned host tensor and staged with one asynchronous host-to-device copy
(the hub's reader never blocks on the card); the client lands PARAMS the
same way.  The hub encodes a published version lazily, once per slab
dtype, in whichever connection writer needs it first: the publish
itself (inside a server update) only swaps a reference to the
published slab, which no later flush writes, so no update waits for a
device-to-host copy.

**Channel semantics** match :class:`~repro_torch.cluster.transport.
InProcTransport` (``tests/test_torch_transport.py`` runs one battery
against each): gradients are per-connection FIFO into one bounded hub
queue — a full queue blocks the connection's reader, socket flow
control stalls the worker's sender, and the worker's small outbound
queue fills, so ``send_gradient`` returning ``False`` is end-to-end
backpressure; params are a versioned broadcast, the hub keeping the
latest publication and each connection's writer *coalescing*
intermediate versions (a restore that moves the version backwards
included).

**Accounting**: a SIGKILLed worker can die mid-frame; the hub discards
the torn frame (``torn_frames``) and counts only complete ones in
:meth:`SocketTransport.received_counts`, the exact "computed" column of
the conservation ledger.  ``quiesce()`` joins the connection readers
once the producers are gone.  ``hold_params``/``release_params`` are
the fleet-ready barrier's starting gun: until release, connected
workers idle in ``fetch_params``.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import hmac
import json
import logging
import os
import queue
import socket
import struct
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from repro_torch.cluster.transport import GradientMsg, ParamsMsg
from repro_torch.convert import Device, resolve_device
from repro_torch.obs.telemetry import NULL

_log = logging.getLogger("repro_torch.cluster.transport")

# protocol identity: the first frame of every connection must carry both
_MAGIC = 0x534C4142                  # "SLAB"
_PROTO_VERSION = 1

_HDR = struct.Struct("!BI")          # frame type, payload length
_HELLO = struct.Struct("!IHIi")      # magic, proto, worker_id, generation
_HELLO_DT = struct.Struct("!IHIiB")  # ... + slab dtype code (non-f32 only)
_JOIN = struct.Struct("!IHi")        # magic, proto, requested id (-1=auto)
_CTRL = struct.Struct("!IH")         # magic, proto (control frame prefix)
_GRAD = struct.Struct("!IiQ")        # worker_id, version, seq
_PARAMS = struct.Struct("!ii")       # version, restore epoch

_F_HELLO, _F_GRAD, _F_PARAMS, _F_JOIN, _F_WELCOME, _F_REJECT = \
    1, 2, 3, 4, 5, 6
_F_SERVE, _F_PING, _F_PONG = 7, 8, 9
_F_STATS = 10
_F_CHALLENGE, _F_AUTH = 11, 12

# HMAC-SHA256 over the challenge nonce: both sides fixed-size
_AUTH_NONCE_LEN = 32
_AUTH_DIGEST_LEN = 32

# the leader's ring of recent stats cells: enough for a late `top` to
# backfill rates (two minutes at the default 0.5 s cadence)
_STATS_HISTORY_LEN = 240

# one frame must fit in memory several times over; anything bigger is a
# corrupted header (a reader that lost frame sync), not a real slab
_MAX_FRAME = 1 << 30

_DT_F32, _DT_BF16 = 0, 1             # HELLO' slab dtype codes
_DT_NAMES = {_DT_F32: "f32", _DT_BF16: "bf16"}
_DT_CODES = {name: code for code, name in _DT_NAMES.items()}
_SLAB_ITEMSIZE = {"f32": 4, "bf16": 2}
_TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# the integer type whose bits one wire element carries (numpy has no
# bf16): a little-endian int32 image of an f32 slab is its <f4 image
_BITS = {"f32": torch.int32, "bf16": torch.int16}


class WireProtocolError(RuntimeError):
    """A peer violated the slab wire protocol (bad magic, version
    mismatch, malformed handshake, rejected join)."""


def _recv_into(sock: socket.socket, view: memoryview) -> Tuple[bool, bool]:
    """Fill ``view`` from the socket.  Returns ``(ok, partial)``:
    ``partial`` is True when the peer died after delivering *some* of
    the bytes — a torn read, as opposed to a clean EOF on a frame
    boundary (a SIGKILL can cut a frame mid-header)."""
    got, n = 0, len(view)
    while got < n:
        try:
            k = sock.recv_into(view[got:], n - got)
        except (OSError, ValueError):
            return False, got > 0
        if k == 0:
            return False, got > 0
        got += k
    return True, False


def _recv_exact(sock: socket.socket, n: int
                ) -> Tuple[Optional[bytearray], bool]:
    """Exactly ``n`` bytes, or ``(None, partial)`` (see _recv_into)."""
    buf = bytearray(n)
    ok, partial = _recv_into(sock, memoryview(buf))
    return (buf if ok else None), partial


def _recv_slab(sock: socket.socket, nbytes: int, dtype_name: str,
               device: torch.device) -> Optional[torch.Tensor]:
    """One slab payload, received straight into a host tensor — pinned
    when it is bound for the card, so staging is one asynchronous
    host-to-device copy — and returned on ``device``.  ``None`` when the
    connection died before the last byte."""
    cuda = device.type == "cuda"
    host = torch.empty(nbytes // _SLAB_ITEMSIZE[dtype_name],
                       dtype=_TORCH_DTYPES[dtype_name], pin_memory=cuda)
    bits = host.view(_BITS[dtype_name]).numpy()
    ok, _ = _recv_into(sock, memoryview(bits).cast("B"))
    if not ok:
        return None
    if sys.byteorder != "little":       # the wire is little-endian
        bits.byteswap(inplace=True)
    return host.to(device, non_blocking=True) if cuda else host


def _slab_to_bytes(slab, dtype_name: str = "f32") -> bytes:
    """The slab's wire image: little-endian ``<f4``, or for bf16 the raw
    little-endian bf16 bit patterns (``<u2``).  A slab on the card is
    copied to the host here."""
    t = torch.as_tensor(slab).detach().to(_TORCH_DTYPES[dtype_name])
    bits = t.cpu().contiguous().view(_BITS[dtype_name]).numpy()
    return bits.astype(bits.dtype.newbyteorder("<"), copy=False).tobytes()


def _grad_frame(msg: GradientMsg, dtype_name: str = "f32") -> bytes:
    slab = _slab_to_bytes(msg.grad, dtype_name)
    return (_HDR.pack(_F_GRAD, _GRAD.size + len(slab))
            + _GRAD.pack(msg.worker_id, msg.version, msg.seq) + slab)


def _params_frame(msg: ParamsMsg, dtype_name: str = "f32") -> bytes:
    slab = _slab_to_bytes(msg.params, dtype_name)
    return (_HDR.pack(_F_PARAMS, _PARAMS.size + len(slab))
            + _PARAMS.pack(msg.version, msg.epoch) + slab)


def _hello_frame(worker_id: int, generation: int,
                 slab_dtype: str = "f32") -> bytes:
    """An f32 peer sends the 14-byte v1 HELLO; only a non-f32 peer
    appends the dtype byte."""
    if slab_dtype == "f32":
        return (_HDR.pack(_F_HELLO, _HELLO.size)
                + _HELLO.pack(_MAGIC, _PROTO_VERSION, worker_id,
                              generation))
    return (_HDR.pack(_F_HELLO, _HELLO_DT.size)
            + _HELLO_DT.pack(_MAGIC, _PROTO_VERSION, worker_id,
                             generation, _DT_CODES[slab_dtype]))


def _join_frame(requested_id: int) -> bytes:
    return (_HDR.pack(_F_JOIN, _JOIN.size)
            + _JOIN.pack(_MAGIC, _PROTO_VERSION, requested_id))


def _ctrl_frame(ftype: int, body: bytes) -> bytes:
    return (_HDR.pack(ftype, _CTRL.size + len(body))
            + _CTRL.pack(_MAGIC, _PROTO_VERSION) + body)


def _welcome_frame(cfg: Dict[str, Any]) -> bytes:
    return _ctrl_frame(_F_WELCOME, json.dumps(cfg).encode("utf-8"))


def _reject_frame(reason: str) -> bytes:
    return _ctrl_frame(_F_REJECT, reason.encode("utf-8"))


def _serve_frame() -> bytes:
    """Read-only params subscribe request (client ->, first frame)."""
    return _ctrl_frame(_F_SERVE, b"")


def _stats_frame(payload: bytes = b"") -> bytes:
    """Empty body: a read-only stats subscribe request (client ->,
    first frame).  JSON body: one stats push (hub ->)."""
    return _ctrl_frame(_F_STATS, payload)


def _challenge_frame(nonce: bytes) -> bytes:
    """Authenticated-JOIN challenge (hub ->): prove you hold the shared
    join secret before the lease is granted."""
    return _ctrl_frame(_F_CHALLENGE, nonce)


def _auth_frame(digest: bytes) -> bytes:
    """Challenge response (client ->): HMAC-SHA256(secret, nonce)."""
    return _ctrl_frame(_F_AUTH, digest)


def _auth_digest(secret: str, nonce: bytes) -> bytes:
    return hmac.new(secret.encode("utf-8"), nonce,
                    hashlib.sha256).digest()


def _ping_frame() -> bytes:
    return _ctrl_frame(_F_PING, b"")


def _pong_frame() -> bytes:
    return _ctrl_frame(_F_PONG, b"")


def _peer_error(magic: int, proto: int) -> Optional[str]:
    """Reject reason for a bad protocol identity, or None when valid."""
    if magic != _MAGIC:
        return (f"bad magic 0x{magic:08X} (expected 0x{_MAGIC:08X}) — "
                "peer is not a repro slab endpoint")
    if proto != _PROTO_VERSION:
        return (f"protocol version mismatch: peer speaks v{proto}, this "
                f"hub speaks v{_PROTO_VERSION}")
    return None


def _configure(sock: socket.socket) -> None:
    if sock.family == socket.AF_INET:
        # grad/params frames are latency-critical; never Nagle-delay them
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


# ======================================================== server side


class _Conn:
    """One accepted connection: a reader thread (gradients and control
    frames in) and a writer thread (coalesced params broadcast out)."""

    def __init__(self, hub: "SocketTransport", sock: socket.socket):
        self.hub = hub
        self.sock = sock
        self.worker_id: Optional[int] = None    # set by an admitted HELLO
        self.generation = 0
        # the slab dtype this connection negotiated: f32 unless its
        # HELLO carried a dtype byte.  It decodes GRAD, validates GRAD
        # lengths and picks the encoded PARAMS frame the writer pushes
        self.slab_dtype = "f32"
        self.authenticated = False          # valid HELLO/JOIN/SERVE/STATS
        self.leased_wid: Optional[int] = None   # set by a JOIN lease
        # authenticated-JOIN state (hubs with a join secret): a JOIN is
        # parked as pending_join while the CHALLENGE round-trips; the
        # lease is granted only once the AUTH digest verifies
        self.awaiting_auth = False          # CHALLENGE sent, AUTH due
        self.auth_ok = False                # digest verified
        self.auth_nonce: Optional[bytes] = None
        self.pending_join: Optional[int] = None
        # read-only peers keep worker_id None, which keeps every
        # membership surface (barrier, ledger, live_workers) worker-only.
        # Serve peers get the params broadcast; stats peers get none
        self.is_serve = False
        self.serve_id: Optional[int] = None
        self.is_stats = False
        self.stats_id: Optional[int] = None
        self.pushes = 0                     # params frames shipped (serve)
        self.last_pushed_version: Optional[int] = None
        self.skipped_pushes = 0             # down-sampled by serve_every
        self.closed = threading.Event()
        self._params_ev = threading.Event()
        # the publication last pushed or skipped: a new publication is a
        # new ParamsMsg, so identity tells a version already handled
        self._last_msg: Optional[ParamsMsg] = None
        self._lock = threading.Lock()       # close() idempotence
        self._wlock = threading.Lock()      # whole frames only: the
        #                                     writer thread and control
        #                                     replies share one socket
        _configure(sock)
        self.reader = threading.Thread(target=self._read_loop,
                                       name="hub-reader", daemon=True)
        self.writer = threading.Thread(target=self._write_loop,
                                       name="hub-writer", daemon=True)
        self.reader.start()
        self.writer.start()

    # ------------------------------------------------------- frames in
    def _frame_error(self, ftype: int, n: int) -> Optional[str]:
        """Header-level validation, BEFORE the payload is read: a
        garbage header must never commit the reader to a garbage-sized
        read.  The reasons are the reference hub's, word for word."""
        if ftype == _F_HELLO:
            if self.worker_id is not None:
                return ("repeated HELLO on one connection — a peer "
                        "identifies itself exactly once (a re-HELLO "
                        "under another id would ghost-register the "
                        "first one in the sync barrier)")
            return None if n in (_HELLO.size, _HELLO_DT.size) else \
                (f"HELLO frame has length {n}, expected {_HELLO.size} "
                 f"or {_HELLO_DT.size}")
        if ftype == _F_JOIN:
            if self.authenticated:
                return ("JOIN on an already-authenticated connection — "
                        "one connection holds at most one lease")
            return None if n == _JOIN.size else \
                f"JOIN frame has length {n}, expected {_JOIN.size}"
        if ftype == _F_SERVE:
            if self.authenticated:
                return ("SERVE on an already-authenticated connection "
                        "— a trainer cannot demote itself to a reader "
                        "mid-stream")
            return None if n == _CTRL.size else \
                f"SERVE frame has length {n}, expected {_CTRL.size}"
        if ftype == _F_STATS:
            if self.authenticated:
                return ("STATS on an already-authenticated connection "
                        "— a trainer cannot demote itself to a stats "
                        "reader mid-stream")
            return None if n == _CTRL.size else \
                (f"STATS subscribe frame has length {n}, expected "
                 f"{_CTRL.size}")
        if ftype == _F_AUTH:
            if self.authenticated:
                return ("AUTH on an already-authenticated connection — "
                        "the challenge round-trips exactly once")
            if not self.awaiting_auth:
                return ("unexpected AUTH frame — this connection has "
                        "no challenge outstanding")
            return None if n == _CTRL.size + _AUTH_DIGEST_LEN else \
                (f"AUTH frame has length {n}, expected "
                 f"{_CTRL.size + _AUTH_DIGEST_LEN}")
        if not self.authenticated:
            return (f"first frame has type {ftype}, not "
                    "HELLO/JOIN/SERVE/STATS — peer is not speaking the "
                    "repro slab protocol")
        if n > _MAX_FRAME:
            return (f"frame length {n} exceeds the {_MAX_FRAME}-byte "
                    "maximum — peer lost frame sync")
        if ftype == _F_GRAD and (n < _GRAD.size or (n - _GRAD.size)
                                 % _SLAB_ITEMSIZE[self.slab_dtype]):
            return (f"malformed GRAD frame: payload length {n} is not "
                    f"header + whole {self.slab_dtype} slab elements — "
                    "peer lost frame sync")
        return None

    def _read_loop(self) -> None:
        hub = self.hub
        try:
            while not self.closed.is_set():
                hdr, partial = _recv_exact(self.sock, _HDR.size)
                if hdr is None:
                    if partial:
                        hub._note_torn()        # died mid-header
                    break                       # else: clean EOF
                ftype, n = _HDR.unpack(hdr)
                err = self._frame_error(ftype, n)
                if err is None and ftype == _F_GRAD \
                        and self.worker_id is None:
                    err = ("GRAD frame from a read-only serve client"
                           if self.is_serve else
                           "GRAD frame from a read-only stats client"
                           if self.is_stats else
                           "GRAD frame before HELLO — the peer never "
                           "identified itself")
                if err is not None:
                    hub._reject(self, err)
                    break
                if ftype == _F_GRAD:
                    if not self._read_grad(n):
                        break
                    continue
                payload, _ = _recv_exact(self.sock, n)
                if payload is None:
                    hub._note_torn()            # died mid-frame: discard
                    break
                hub.obs.count("wire.rx_bytes", _HDR.size + n)
                err = self._control(ftype, payload)
                if err is not None:
                    hub._reject(self, err)
                    break
        finally:
            self.close()
            hub._conn_closed(self)

    def _control(self, ftype: int, payload: bytes) -> Optional[str]:
        """Act on one validated non-GRAD frame; a reject reason, or
        None.  PONG (liveness: receipt alone is the signal) and frame
        types this hub does not act on are ignored (forward compat)."""
        hub = self.hub
        if ftype == _F_HELLO:
            if len(payload) == _HELLO_DT.size:
                magic, proto, wid, gen, dtc = _HELLO_DT.unpack(payload)
            else:
                magic, proto, wid, gen = _HELLO.unpack(payload)
                dtc = _DT_F32               # bare v1 HELLO: f32
            err = _peer_error(magic, proto)
            if err is None and dtc not in _DT_NAMES:
                err = (f"unknown slab dtype code {dtc} in HELLO — peer is "
                       "from a newer build negotiating a dtype this hub "
                       "does not speak")
            if err is None:
                # before admission: the first params push must already
                # use the negotiated encoding
                self.slab_dtype = _DT_NAMES[dtc]
                # the hook claims worker_id inside the hub's admission
                # lock: concurrent admissions for one id see each other
                err = hub._admit_hello(self, wid, gen)
            if err is None:
                self.authenticated = True
                hub._on_hello(self)
            return err
        if ftype == _F_JOIN:
            magic, proto, req = _JOIN.unpack(payload)
            err = _peer_error(magic, proto) or hub._on_join(self, req)
            # a secret-bearing hub parks the JOIN behind a CHALLENGE:
            # the connection stays unauthenticated (no broadcast, no
            # lease) until AUTH lands
            if err is None:
                self.authenticated = not self.awaiting_auth
            return err
        if ftype == _F_AUTH:
            magic, proto = _CTRL.unpack(payload[:_CTRL.size])
            err = _peer_error(magic, proto) \
                or hub._on_auth(self, payload[_CTRL.size:])
            if err is None:
                self.authenticated = True
            return err
        if ftype in (_F_SERVE, _F_STATS):
            magic, proto = _CTRL.unpack(payload)
            serve = ftype == _F_SERVE
            err = _peer_error(magic, proto) or (
                hub._on_serve(self) if serve else hub._on_stats(self))
            if err is None:
                self.authenticated = True
                if serve:
                    hub._on_serve_ready(self)
                else:
                    hub._on_stats_ready(self)
            return err
        return None

    def _read_grad(self, n: int) -> bool:
        """One GRAD payload into the hub queue; False when the sender
        died mid-frame (the torn frame is discarded and counted)."""
        hub = self.hub
        head, _ = _recv_exact(self.sock, _GRAD.size)
        grad = None if head is None else _recv_slab(
            self.sock, n - _GRAD.size, self.slab_dtype, hub.device)
        if grad is None:
            hub._note_torn()
            return False
        hub.obs.count("wire.rx_bytes", _HDR.size + n)
        wid, version, seq = _GRAD.unpack(head)
        # the span brackets the bounded put: its duration IS the
        # backpressure wait when the hub queue is full
        with hub.obs.span(f"worker/{wid}/wire", "grad_rx", version=version,
                          seq=seq, bytes=_HDR.size + n):
            ok = hub._enqueue(GradientMsg(wid, grad, version, seq))
        if ok:
            hub._count_received(wid)
        return True

    # ----------------------------------------------------- params out
    def notify_params(self) -> None:
        self._params_ev.set()

    def send_frame(self, frame: bytes,
                   lock_timeout: Optional[float] = None) -> bool:
        """Write one whole frame (serialized against the params writer).
        False when the connection is gone or, with ``lock_timeout``,
        when the write lock stayed held that long (a writer wedged in
        ``sendall`` against a stalled peer must not wedge the reader)."""
        if lock_timeout is None:
            acquired = self._wlock.acquire()
        else:
            acquired = self._wlock.acquire(timeout=lock_timeout)
        if not acquired:
            return False
        try:
            self.sock.sendall(frame)
            self.hub.obs.count("wire.tx_bytes", len(frame))
            return True
        except OSError:
            return False
        finally:
            self._wlock.release()

    def _write_loop(self) -> None:
        hub = self.hub
        while not self.closed.is_set():
            if not self._params_ev.wait(0.2):
                continue
            self._params_ev.clear()
            # never broadcast the model to a peer that has not
            # authenticated (HELLO, a granted JOIN or SERVE; admission
            # re-arms the push), and never to a stats reader: a few
            # hundred bytes of JSON per tick, never a slab, which is
            # what keeps a sync run bitwise equal with one attached
            if not self.authenticated or self.is_stats:
                continue
            pub = hub._pub_current()
            if pub is None or pub[0] is self._last_msg:
                continue
            version = pub[0].version
            every = hub.serve_every
            if self.is_serve and every > 1 and version % every \
                    and version != 0:
                # serve clients get every Nth version (the initial model
                # always ships), up to N-1 versions stale for 1/N of the
                # broadcast; a skipped version is never encoded here
                self._last_msg = pub[0]
                self.skipped_pushes += 1
                continue
            if not self.send_frame(hub._encode(pub, self.slab_dtype)):
                break
            self._last_msg = pub[0]
            if self.is_serve:
                self.pushes += 1
                self.last_pushed_version = version

    # ------------------------------------------------------------- misc
    def half_close(self) -> None:
        """Stop the params direction (the worker sees EOF and shuts
        down) while still reading its in-flight gradient frames."""
        try:
            self.sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    def close(self) -> None:
        with self._lock:
            if self.closed.is_set():
                return
            self.closed.set()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class SocketTransport:
    """The server-side hub: a full :class:`Transport` over real sockets.

    ``recv_gradient`` / ``publish_params`` / ``pending_gradients`` /
    ``quiesce`` are the parameter server's half.  Workers use
    :class:`SocketWorkerClient` endpoints (:meth:`connect` in this
    process, or a child process connecting to :attr:`address`).  The
    hub's own ``send_gradient`` / ``fetch_params`` are local loopbacks,
    kept so the hub satisfies the whole protocol.

    ``grad_capacity`` bounds the hub gradient queue (0 = unbounded); the
    bound reaches the workers through socket flow control.  TCP binds
    ``(host, port)`` (port 0 picks one; the resolved address is
    :attr:`address`), Unix mode a socket in a fresh temporary directory.
    Received gradient slabs land on ``device`` (``cuda`` unless the
    caller asks for the CPU).  ``heartbeat_s > 0`` PINGs every
    authenticated connection on that cadence (0: no PINGs).
    ``serve_every`` down-samples the serve clients' push stream.
    """

    # the telemetry bus; the runtime swaps in its live bus before the
    # run starts, directly-constructed hubs keep the no-op one
    obs = NULL

    def __init__(self, grad_capacity: int = 0, *, family: str = "unix",
                 host: str = "127.0.0.1", port: int = 0,
                 heartbeat_s: float = 0.0, serve_every: int = 1,
                 slab_dtype: str = "f32", device: Device = None):
        if family not in ("unix", "tcp"):
            raise ValueError(f"family must be unix or tcp, got {family!r}")
        if slab_dtype not in _DT_CODES:
            raise ValueError(f"slab_dtype must be one of "
                             f"{sorted(_DT_CODES)}, got {slab_dtype!r}")
        self.device = resolve_device(device)
        self.family = family
        # the RUN's slab dtype: what connect() hands in-process workers;
        # each connection may still negotiate its own through HELLO'
        self.slab_dtype = slab_dtype
        self.heartbeat_s = float(heartbeat_s)
        self.serve_every = max(1, int(serve_every))
        self._sockdir: Optional[str] = None
        if family == "unix":
            self._sockdir = tempfile.mkdtemp(prefix="repro-torch-hub-")
            self.address: Any = os.path.join(self._sockdir, "hub.sock")
            lsock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            lsock.bind(self.address)
        else:
            lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            lsock.bind((host, port))
            self.address = lsock.getsockname()
        lsock.listen(128)
        lsock.settimeout(0.2)               # close() unblocks accept
        self._lsock = lsock
        self._grads: "queue.Queue[GradientMsg]" = \
            queue.Queue(maxsize=grad_capacity)
        self._closed = threading.Event()
        self._conns: List[_Conn] = []
        self._conns_cond = threading.Condition()
        self._received: Dict[int, int] = {}
        self._recv_lock = threading.Lock()
        self._torn = 0
        self._rejected = 0
        # the current publication as published (its slab is a tensor no
        # later flush writes) and its wire frames by dtype, encoded on
        # first use; a new publication starts a new dict
        self._pub_msg: Optional[ParamsMsg] = None
        self._pub_frames: Dict[str, bytes] = {}
        self._pub_cond = threading.Condition()
        self._encode_lock = threading.Lock()
        self._hold = False          # hold_params(): see the fleet barrier
        self._draining = False      # half_close_workers() was called
        # membership hooks, called from hub reader threads with
        # (worker_id, generation) when a worker's HELLO is admitted and
        # when its connection dies: the proc runtime registers a child
        # with the server on HELLO, so one still starting up never holds
        # a sync barrier it cannot contribute to
        self.on_worker_ready: Optional[Any] = None
        self.on_worker_gone: Optional[Any] = None
        # serving plane: a hook called with the serve id on admission,
        # and every serve connection ever admitted
        self.on_serve_ready: Optional[Any] = None
        self._serve_seq = 0
        self._serve_conns: List[_Conn] = []
        # stats plane: a zero-argument callable returning a JSON-able
        # dict, installed by the runtime once its server exists; the
        # cadence thread starts when it is installed
        self.stats_every_s = 0.5
        self._stats_seq = 0
        self._stats_conns: List[_Conn] = []
        self._stats_thread: Optional[threading.Thread] = None
        self._stats_history: Any = \
            collections.deque(maxlen=_STATS_HISTORY_LEN)
        self._stats_provider: Optional[Any] = None
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="hub-accept", daemon=True)
        self._accept_thread.start()
        self._hb_thread: Optional[threading.Thread] = None
        if self.heartbeat_s > 0:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, name="hub-heartbeat",
                daemon=True)
            self._hb_thread.start()

    # ------------------------------------------------------- accept side
    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                sock, _ = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._conns_cond:
                conn = _Conn(self, sock)
                self._conns.append(conn)
            if self._draining:
                # shutdown already began: a late joiner (a respawn still
                # starting up) gets its EOF at once and stops
                conn.half_close()

    def _admit_hello(self, conn: _Conn, worker_id: int,
                     generation: int) -> Optional[str]:
        """Membership policy hook: a reject reason, or None to admit.
        On admit the hook claims ``conn.worker_id``/``generation``
        inside its own critical section, so concurrent admissions for
        one id see each other.  The plain hub admits every well-formed
        HELLO; :class:`~repro_torch.cluster.hostlink.HostTransport`
        fences stale generations and duplicate ids here."""
        with self._conns_cond:
            conn.worker_id, conn.generation = worker_id, generation
        return None

    def _on_join(self, conn: _Conn, requested_id: int) -> Optional[str]:
        """JOIN (lease negotiation) hook: only the multi-host hub
        leases ids; the plain hub tells the peer to HELLO directly."""
        return ("this hub does not negotiate worker-id leases (not a "
                "host transport) — connect with HELLO")

    def _on_auth(self, conn: _Conn, digest: bytes) -> Optional[str]:
        """AUTH (challenge response) hook: only a hub that issued a
        CHALLENGE can verify one."""
        return "unexpected AUTH frame — this hub issued no challenge"

    def _on_serve(self, conn: _Conn) -> Optional[str]:
        """SERVE (read-only subscribe) hook: only the multi-host hub
        admits serve clients; the plain hub has no spec to hand them."""
        return ("this hub does not admit serve clients (not a host "
                "transport) — point `repro infer` at a training leader")

    def _on_stats(self, conn: _Conn) -> Optional[str]:
        """STATS (read-only telemetry subscribe) hook: only the
        multi-host hub admits stats clients."""
        return ("this hub does not admit stats clients (not a host "
                "transport) — point `repro top` at a training leader")

    def _on_hello(self, conn: _Conn) -> None:
        with self._conns_cond:
            self._conns_cond.notify_all()
        # re-arm the params push: a JOIN handshake may have consumed a
        # pre-HELLO push on the client side (the negotiator reads frames
        # until WELCOME), and a coalescing writer would never resend it
        conn._last_msg = None
        conn.notify_params()
        if self.on_worker_ready is not None:
            self.on_worker_ready(conn.worker_id, conn.generation)

    def _on_serve_ready(self, conn: _Conn) -> None:
        """An admitted serve connection: arm its params push (as HELLO
        does) and report it."""
        with self._conns_cond:
            self._serve_conns.append(conn)
        conn._last_msg = None
        conn.notify_params()
        if self.on_serve_ready is not None:
            self.on_serve_ready(conn.serve_id)

    @property
    def stats_provider(self) -> Optional[Any]:
        return self._stats_provider

    @stats_provider.setter
    def stats_provider(self, provider: Optional[Any]) -> None:
        """Installing a provider starts the cadence thread at once, so
        the history ring holds cells when a late ``top`` attaches."""
        self._stats_provider = provider
        if provider is not None and not self._closed.is_set():
            self._ensure_stats_thread()

    def stats_history(self) -> List[Dict[str, Any]]:
        """Recent stats cells, oldest first (the backfill payload)."""
        return list(self._stats_history)

    def _on_stats_ready(self, conn: _Conn) -> None:
        """An admitted stats connection: send the history backfill, then
        one current payload, and only then add it to the push list, so a
        cadence tick never overtakes its own backfill on the wire."""
        history = self.stats_history()
        if history:
            conn.send_frame(
                _stats_frame(json.dumps({"history": history})
                             .encode("utf-8")), lock_timeout=1.0)
        conn.send_frame(self._stats_frame_now(), lock_timeout=1.0)
        with self._conns_cond:
            self._stats_conns.append(conn)
        self._ensure_stats_thread()

    def _stats_frame_now(self, record: bool = False) -> bytes:
        """One STATS push from the provider's current payload; a
        ``waiting`` state while no provider is installed or it raises
        (mid-teardown).  ``record=True`` (the cadence thread) appends a
        real payload to the history ring."""
        provider = self._stats_provider
        payload = None
        if provider is not None:
            try:
                payload = provider()
            except Exception:
                payload = None
        if payload is None:
            payload = {"state": "waiting"}
        elif record:
            self._stats_history.append(payload)
        return _stats_frame(json.dumps(payload).encode("utf-8"))

    def _ensure_stats_thread(self) -> None:
        with self._conns_cond:
            if self._stats_thread is not None:
                return
            self._stats_thread = threading.Thread(
                target=self._stats_loop, name="hub-stats", daemon=True)
            self._stats_thread.start()

    def _stats_loop(self) -> None:
        """Every ``stats_every_s``: record the current payload in the
        history ring, then push it to every live stats reader (a short
        lock timeout: one stalled reader must not delay the others)."""
        while not self._closed.wait(self.stats_every_s):
            frame = self._stats_frame_now(record=True)
            with self._conns_cond:
                conns = [c for c in self._stats_conns
                         if not c.closed.is_set()]
            for conn in conns:
                conn.send_frame(frame, lock_timeout=0.2)

    def serve_stats(self) -> Dict[str, Any]:
        """The serving plane's report: per serve client, the versions it
        was sent, the last one and the pushes ``serve_every`` skipped;
        and how many stats clients were admitted."""
        with self._conns_cond:
            conns = list(self._serve_conns)
            stats_clients = len(self._stats_conns)
        return {
            "clients": len(conns),
            "rejected_peers": self.rejected_peers,
            "serve_every": self.serve_every,
            "stats_clients": stats_clients,
            "per_client": [
                {"serve_id": c.serve_id,
                 "pushes": c.pushes,
                 "last_version": c.last_pushed_version,
                 "skipped_pushes": c.skipped_pushes,
                 "connected": not c.closed.is_set()}
                for c in conns],
        }

    def _heartbeat_loop(self) -> None:
        """PING every authenticated connection on the heartbeat cadence
        (``wire.pings`` counts those sent).  A short lock timeout keeps a
        writer wedged against one stalled peer from delaying the others'
        liveness."""
        frame = _ping_frame()
        while not self._closed.wait(self.heartbeat_s):
            with self._conns_cond:
                conns = [c for c in self._conns
                         if c.authenticated and not c.closed.is_set()]
            for conn in conns:
                if conn.send_frame(frame, lock_timeout=0.2):
                    self.obs.count("wire.pings")

    def _reject(self, conn: _Conn, reason: str) -> None:
        """Turn away a peer with a readable error: logged, counted, and a
        best-effort REJECT frame.  The caller breaks its read loop, so
        the connection closes without ever entering the barrier."""
        try:
            peer = conn.sock.getpeername()
        except OSError:
            peer = "?"
        _log.warning("rejecting peer %s: %s", peer, reason)
        with self._recv_lock:
            self._rejected += 1
        conn.send_frame(_reject_frame(reason), lock_timeout=1.0)

    def _conn_closed(self, conn: _Conn) -> None:
        with self._conns_cond:
            self._conns_cond.notify_all()
        if self.on_worker_gone is not None and conn.worker_id is not None:
            self.on_worker_gone(conn.worker_id, conn.generation)

    def _enqueue(self, msg: GradientMsg) -> bool:
        # bounded put that close() can interrupt: the reader blocking
        # here is what turns a full hub queue into socket backpressure
        while not self._closed.is_set():
            try:
                self._grads.put(msg, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _count_received(self, worker_id: int) -> None:
        with self._recv_lock:
            self._received[worker_id] = \
                self._received.get(worker_id, 0) + 1

    def _note_torn(self) -> None:
        with self._recv_lock:
            self._torn += 1

    # ----------------------------------------------- Transport (server)
    def recv_gradient(self, timeout: Optional[float] = None
                      ) -> Optional[GradientMsg]:
        try:
            if timeout is not None and timeout <= 0:
                return self._grads.get_nowait()
            return self._grads.get(timeout=timeout)
        except queue.Empty:
            return None

    def publish_params(self, msg: ParamsMsg) -> None:
        """Swap in the new publication (unconditionally: a restore
        publishes an older version) and wake the writers.  Nothing is
        encoded here: an update never waits for the slab's copy to the
        host."""
        with self._pub_cond:
            self._pub_msg = msg
            self._pub_frames = {}
            self._pub_cond.notify_all()
            if self._hold:
                return                  # workers see it on release
        self._notify_all_conns()

    def _pub_current(self) -> Optional[Tuple[ParamsMsg, Dict[str, bytes]]]:
        """The current publication and its frames by dtype, or None
        while hold_params() withholds the broadcast."""
        with self._pub_cond:
            if self._hold or self._pub_msg is None:
                return None
            return self._pub_msg, self._pub_frames

    def _encode(self, pub: Tuple[ParamsMsg, Dict[str, bytes]],
                dtype_name: str) -> bytes:
        """A publication as a PARAMS frame in one dtype, encoded by the
        first writer that asks and shared by the rest.  Encoding runs
        outside the publish lock, so a flush can publish meanwhile."""
        msg, frames = pub
        frame = frames.get(dtype_name)
        if frame is None:
            with self._encode_lock:
                frame = frames.get(dtype_name)
                if frame is None:
                    frame = frames[dtype_name] = _params_frame(msg,
                                                               dtype_name)
        return frame

    def _notify_all_conns(self) -> None:
        with self._conns_cond:
            conns = list(self._conns)
        for conn in conns:
            conn.notify_params()

    def hold_params(self) -> None:
        """Withhold the params broadcast from workers (the hub-local cell
        still updates): workers that connect meanwhile idle in
        ``fetch_params`` instead of banking gradients before the clock
        starts."""
        with self._pub_cond:
            self._hold = True

    def release_params(self) -> None:
        """End a :meth:`hold_params` hold: push the latest params to
        every connected worker (the starting gun)."""
        with self._pub_cond:
            self._hold = False
        self._notify_all_conns()

    def pending_gradients(self) -> int:
        return self._grads.qsize()

    # --------------------------------------------- Transport (loopback)
    def send_gradient(self, msg: GradientMsg,
                      timeout: Optional[float] = None) -> bool:
        try:
            if timeout is not None and timeout <= 0:
                self._grads.put_nowait(msg)
            else:
                self._grads.put(msg, timeout=timeout)
        except queue.Full:
            return False
        self._count_received(msg.worker_id)
        return True

    def fetch_params(self, min_version: int = 0,
                     timeout: Optional[float] = None
                     ) -> Optional[ParamsMsg]:
        with self._pub_cond:
            ok = self._pub_cond.wait_for(
                lambda: self._pub_msg is not None
                and self._pub_msg.version >= min_version,
                0 if (timeout is not None and timeout <= 0) else timeout)
            return self._pub_msg if ok else None

    # ------------------------------------------------------- lifecycle
    def connect(self, worker_id: int,
                generation: int = 0) -> "SocketWorkerClient":
        """A worker-side endpoint in this process (thread workers),
        speaking the run's slab dtype, with slabs on the hub's device."""
        return SocketWorkerClient(self.address, worker_id,
                                  generation=generation, family=self.family,
                                  slab_dtype=self.slab_dtype,
                                  device=self.device)

    def wait_for_workers(self, n: int,
                         timeout: Optional[float] = None) -> bool:
        """Block until ``n`` distinct workers have said HELLO and are
        still connected (process workers connect only once warm, so this
        is the fleet-ready barrier)."""
        def ready() -> bool:
            return len(self._live()) >= n
        with self._conns_cond:
            return self._conns_cond.wait_for(ready, timeout)

    def _live(self) -> Set[int]:
        return {c.worker_id for c in self._conns
                if c.worker_id is not None and not c.closed.is_set()}

    def live_workers(self) -> Set[int]:
        with self._conns_cond:
            return self._live()

    def connected_workers(self) -> Dict[int, int]:
        """{worker_id: generation} of every live, admitted connection."""
        with self._conns_cond:
            return {c.worker_id: c.generation for c in self._conns
                    if c.worker_id is not None and not c.closed.is_set()}

    def received_counts(self) -> Dict[int, int]:
        """Complete gradient frames received, per worker id: the exact
        "computed" ledger column for socket workers.  Read only after
        :meth:`quiesce` returned ``True``."""
        with self._recv_lock:
            return dict(self._received)

    @property
    def torn_frames(self) -> int:
        """Frames discarded because the sender died mid-write."""
        with self._recv_lock:
            return self._torn

    @property
    def rejected_peers(self) -> int:
        """Connections turned away for violating the wire protocol."""
        with self._recv_lock:
            return self._rejected

    def half_close_workers(self) -> None:
        """EOF to every worker (params direction) while their in-flight
        gradient frames still drain: the clean-shutdown signal for
        process workers.  Workers that connect after this call are
        half-closed on arrival, so a late respawn cannot outlive the
        run."""
        self._draining = True
        with self._conns_cond:
            conns = list(self._conns)
        for conn in conns:
            conn.half_close()

    def quiesce(self, timeout: Optional[float] = None) -> bool:
        """True once every connection reader has drained to EOF (the
        producers must be stopped).  Interleave with
        ``recv_gradient(timeout=0)``: a reader blocked on the bounded
        queue needs the caller to make room.  Serve and stats
        connections are skipped: they send no gradients, and a lingering
        reader must never hold up the end of training."""
        deadline = None if timeout is None else \
            time.monotonic() + max(0.0, timeout)
        with self._conns_cond:
            conns = [c for c in self._conns
                     if not c.is_serve and not c.is_stats]
        for conn in conns:
            remain = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            conn.reader.join(timeout=remain)
            if conn.reader.is_alive():
                return False
        return True

    def close(self) -> None:
        self._closed.set()
        try:
            self._lsock.close()
        except OSError:
            pass
        with self._conns_cond:
            conns = list(self._conns)
        for conn in conns:
            conn.close()
        self._accept_thread.join(timeout=2.0)
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
        if self._stats_thread is not None:
            self._stats_thread.join(timeout=2.0)
        if self.family == "unix":
            try:
                os.unlink(self.address)
            except OSError:
                pass
            try:
                os.rmdir(self._sockdir)
            except OSError:
                pass


# ======================================================== worker side

# a worker's outbound queue: small, so a full hub stalls the worker
# within a couple of gradients (the reference's default)
_SEND_CAPACITY = 2


class SocketWorkerClient:
    """The worker half of the protocol over one socket connection.

    ``send_gradient`` enqueues into a small bounded outbound queue
    (``_SEND_CAPACITY`` gradients) drained by a sender thread (a
    timed-out send never leaves a torn frame on the wire: the frame goes
    whole or not at all), and
    ``fetch_params`` waits on a local versioned cell kept current by a
    reader thread, whose slabs land on ``device``.

    :attr:`closed` is set when the connection dies (hub shutdown, kill,
    network error); runtimes make it the worker's stop event, so a dead
    hub never leaves a live worker spinning.

    ``heartbeat_timeout_s > 0`` arms a liveness watchdog: when *no*
    frame (params, PING, anything) arrived for that long, the leader is
    declared hung, :attr:`stall_reason` says so and the connection
    closes, which stops the worker as a dead hub does.  ``sock`` adopts
    an already-connected socket (the one a JOIN handshake leased the
    worker id on) instead of dialing ``address``.
    """

    def __init__(self, address: Any, worker_id: int, *,
                 generation: int = 0, family: str = "unix",
                 connect_timeout: float = 10.0,
                 heartbeat_timeout_s: float = 0.0,
                 sock: Optional[socket.socket] = None,
                 slab_dtype: str = "f32", device: Device = None):
        if slab_dtype not in _DT_CODES:
            raise ValueError(f"slab_dtype must be one of "
                             f"{sorted(_DT_CODES)}, got {slab_dtype!r}")
        self.device = resolve_device(device)
        self.worker_id = worker_id
        self.generation = generation
        self.slab_dtype = slab_dtype
        self.reject_reason: Optional[str] = None
        self.stall_reason: Optional[str] = None
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self._last_rx = time.monotonic()
        if sock is None:
            if family == "unix":
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                sock.settimeout(connect_timeout)
                sock.connect(address)
            else:
                sock = socket.create_connection(tuple(address),
                                                timeout=connect_timeout)
        sock.settimeout(None)
        _configure(sock)
        self.sock = sock
        self.closed = threading.Event()
        self._cell: Optional[ParamsMsg] = None
        self._cond = threading.Condition()
        self._sendq: "queue.Queue[GradientMsg]" = \
            queue.Queue(maxsize=_SEND_CAPACITY)
        self._close_lock = threading.Lock()
        self._closed_once = False
        self._wlock = threading.Lock()      # whole frames only: the
        #                                     sender thread and PONG
        #                                     replies share one socket
        self.sock.sendall(_hello_frame(worker_id, generation, slab_dtype))
        self._reader = threading.Thread(
            target=self._read_loop, name=f"client-reader-{worker_id}",
            daemon=True)
        self._sender = threading.Thread(
            target=self._send_loop, name=f"client-sender-{worker_id}",
            daemon=True)
        self._reader.start()
        self._sender.start()
        if self.heartbeat_timeout_s > 0:
            threading.Thread(target=self._watchdog_loop,
                             name=f"client-watchdog-{worker_id}",
                             daemon=True).start()

    # ------------------------------------------------------ wire threads
    def _read_loop(self) -> None:
        itemsize = _SLAB_ITEMSIZE[self.slab_dtype]
        try:
            while not self.closed.is_set():
                hdr, _ = _recv_exact(self.sock, _HDR.size)
                if hdr is None:
                    break
                ftype, n = _HDR.unpack(hdr)
                if n > _MAX_FRAME:
                    break
                if ftype == _F_PARAMS and n >= _PARAMS.size \
                        and (n - _PARAMS.size) % itemsize == 0:
                    head, _ = _recv_exact(self.sock, _PARAMS.size)
                    slab = None if head is None else _recv_slab(
                        self.sock, n - _PARAMS.size, self.slab_dtype,
                        self.device)
                    if slab is None:
                        break
                    self._last_rx = time.monotonic()
                    version, epoch = _PARAMS.unpack(head)
                    with self._cond:
                        self._cell = ParamsMsg(version, slab, epoch=epoch)
                        self._cond.notify_all()
                    continue
                payload, _ = _recv_exact(self.sock, n)
                if payload is None:
                    break
                self._last_rx = time.monotonic()
                if ftype == _F_PING:
                    # best effort: the hub only needs bytes to flow back,
                    # and a send error shows on the next gradient anyway
                    with self._wlock:
                        try:
                            self.sock.sendall(_pong_frame())
                        except OSError:
                            break
                elif ftype == _F_REJECT:
                    reason = payload[_CTRL.size:].decode(
                        "utf-8", "replace") if n >= _CTRL.size else ""
                    self.reject_reason = reason or "rejected by hub"
                    _log.warning("hub rejected worker %d.%d: %s",
                                 self.worker_id, self.generation,
                                 self.reject_reason)
                    break
                # other frame types are ignored (forward compat)
        finally:
            self._mark_closed()

    def _send_loop(self) -> None:
        while True:
            try:
                msg = self._sendq.get(timeout=0.1)
            except queue.Empty:
                if self.closed.is_set():
                    return
                continue
            try:
                frame = _grad_frame(msg, self.slab_dtype)
                with self._wlock:
                    self.sock.sendall(frame)
            except OSError:
                # accepted but never shipped: no task_done(), so flush()
                # cannot claim it landed
                self._mark_closed()
                return
            self._sendq.task_done()

    def _watchdog_loop(self) -> None:
        """Declare the leader hung when no frame of any kind arrived
        within ``heartbeat_timeout_s``, then close, so every blocked
        path (fetch_params, the worker loop) unwinds promptly."""
        timeout = self.heartbeat_timeout_s
        while not self.closed.wait(min(timeout / 4.0, 1.0)):
            idle = time.monotonic() - self._last_rx
            if idle > timeout:
                self.stall_reason = (
                    f"no frames from the hub for {idle:.1f}s (liveness "
                    f"timeout {timeout:.1f}s) — the leader looks hung; "
                    "giving up on this connection")
                _log.warning("worker %d.%d: %s", self.worker_id,
                             self.generation, self.stall_reason)
                self.close()
                return

    def _mark_closed(self) -> None:
        self.closed.set()
        with self._cond:
            self._cond.notify_all()         # wake blocked fetch_params

    # ------------------------------------------- Transport (worker half)
    def send_gradient(self, msg: GradientMsg,
                      timeout: Optional[float] = None) -> bool:
        if timeout is not None and timeout <= 0:
            if self.closed.is_set():
                return False
            try:
                self._sendq.put_nowait(msg)
                return True
            except queue.Full:
                return False
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        while not self.closed.is_set():
            remain = None if deadline is None else \
                deadline - time.monotonic()
            if remain is not None and remain <= 0:
                return False
            try:
                self._sendq.put(msg, timeout=0.05 if remain is None
                                else min(0.05, remain))
                return True
            except queue.Full:
                continue
        return False

    def fetch_params(self, min_version: int = 0,
                     timeout: Optional[float] = None
                     ) -> Optional[ParamsMsg]:
        def ok() -> bool:
            return (self._cell is not None
                    and self._cell.version >= min_version)
        with self._cond:
            if timeout is not None and timeout <= 0:
                return self._cell if ok() else None
            deadline = None if timeout is None else \
                time.monotonic() + timeout
            while not ok():
                if self.closed.is_set():
                    return None
                remain = None if deadline is None else \
                    deadline - time.monotonic()
                if remain is not None and remain <= 0:
                    return None
                self._cond.wait(0.1 if remain is None
                                else min(0.1, remain))
            return self._cell

    def pending_gradients(self) -> int:
        return self._sendq.qsize()

    # the worker half never receives gradients or publishes params
    def recv_gradient(self, timeout: Optional[float] = None):
        raise NotImplementedError("worker-side endpoint")

    def publish_params(self, msg: ParamsMsg) -> None:
        raise NotImplementedError("worker-side endpoint")

    # ------------------------------------------------------- lifecycle
    def flush(self, timeout: float = 5.0) -> bool:
        """Block until every accepted gradient is on the wire (the ledger
        already counts them as computed).  Waits on the sender *thread*,
        not on :attr:`closed`: a hub half-close sets ``closed`` while the
        gradient direction is still writable."""
        deadline = time.monotonic() + timeout
        while self._sendq.unfinished_tasks:
            if not self._sender.is_alive() \
                    or time.monotonic() > deadline:
                return self._sendq.unfinished_tasks == 0
            time.sleep(0.01)
        return True

    def can_flush(self) -> bool:
        """Whether unshipped frames can still make progress (the sender
        thread is alive)."""
        return self._sender.is_alive()

    def quiesce(self, timeout: Optional[float] = None) -> bool:
        return self.flush(timeout if timeout is not None else 5.0)

    def close(self) -> None:
        with self._close_lock:
            if self._closed_once:
                return
            self._closed_once = True
        self._mark_closed()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


# ================================================== process launcher

# the parent's numerics switches a child copies before its first
# gradient: without them a child's convolutions may take other
# algorithms (TF32, cuDNN's non-deterministic ones), and its gradients
# other bits.  name -> (object, attribute)
_TORCH_FLAGS = {
    "cudnn.allow_tf32": (torch.backends.cudnn, "allow_tf32"),
    "cuda.matmul.allow_tf32": (torch.backends.cuda.matmul, "allow_tf32"),
    "cudnn.deterministic": (torch.backends.cudnn, "deterministic"),
    "cudnn.benchmark": (torch.backends.cudnn, "benchmark"),
}


# the values of those switches ClusterTrainer sets on the card, and a
# joiner on the card sets for itself: float32 products in full float32,
# deterministic convolution algorithms (a sync run repeats bit for bit)
CUDA_DETERMINISTIC = {"cudnn.allow_tf32": False,
                      "cuda.matmul.allow_tf32": False,
                      "cudnn.deterministic": True, "cudnn.benchmark": False}


def torch_flags() -> Dict[str, bool]:
    """This process's values of the switches in ``_TORCH_FLAGS``."""
    return {name: bool(getattr(obj, attr))
            for name, (obj, attr) in _TORCH_FLAGS.items()}


def set_torch_flags(flags: Dict[str, bool]) -> None:
    for name, value in flags.items():
        obj, attr = _TORCH_FLAGS[name]
        setattr(obj, attr, value)


@dataclasses.dataclass
class ProcWorkerConfig:
    """Everything a worker process needs to rebuild its world: the
    experiment spec (the workload is rebuilt through ``SIM_WORKLOADS``;
    only this picklable description crosses the process boundary), its
    identity and shard, the hub address, and where it computes:
    ``device`` is the parent's (``"cuda"`` or ``"cpu"``, never chosen by
    the child), ``threads`` its intra-op thread count and ``flags`` the
    parent's :func:`torch_flags`."""
    spec: Dict[str, Any]
    worker_id: int
    generation: int
    num_workers: int
    mode: str
    straggle_s: float
    seed: int
    batch: int
    device: str = "cuda"
    threads: int = 1
    flags: Dict[str, bool] = dataclasses.field(default_factory=dict)
    address: Any = None
    family: str = "unix"


def _proc_worker_main(cfg: ProcWorkerConfig) -> None:
    """Child entry point: set up the device, rebuild the workload, warm
    one gradient, and only then connect (HELLO == ready), so the
    parent's budget measures contention, not start-up.  A child that
    cannot reach its device exits non-zero: it never computes
    elsewhere."""
    try:
        torch.set_num_threads(cfg.threads)
        set_torch_flags(cfg.flags)
        device = resolve_device(cfg.device)
        from repro_torch.api.spec import ExperimentSpec
        from repro_torch.cluster.hostlink import build_slab_worker_fn
        from repro_torch.cluster.worker import Worker

        spec = ExperimentSpec.from_dict(cfg.spec)
        grad, fresh_batches = build_slab_worker_fn(
            spec, cfg.worker_id, cfg.num_workers, cfg.generation,
            batch=cfg.batch, seed=cfg.seed, device=device)
        client = SocketWorkerClient(cfg.address, cfg.worker_id,
                                    generation=cfg.generation,
                                    family=cfg.family,
                                    slab_dtype=spec.slab_dtype,
                                    device=device)
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(2)

    worker = Worker(cfg.worker_id, grad_fn=grad, batches=fresh_batches(),
                    transport=client, mode=cfg.mode,
                    straggle_s=cfg.straggle_s, generation=cfg.generation)
    # hub shutdown or death closes the connection -> closed is set ->
    # the loop exits: a dead hub never leaves this process alive
    worker.stop_event = client.closed
    worker.run()                            # inline, not as a thread
    client.flush(5.0)
    client.close()
    code = 0
    if worker.error:
        print(worker.error, file=sys.stderr, flush=True)
        code = 3
    sys.stdout.flush()
    sys.stderr.flush()
    # no interpreter teardown: everything is flushed, and unwinding a
    # CUDA context's threads from a fast-exiting child gains nothing
    os._exit(code)


class ProcTransport(SocketTransport):
    """The multi-process transport: a Unix-domain (or TCP) socket hub
    plus a ``multiprocessing`` *spawn* launcher — each worker is a fresh
    OS process that connects back to the hub once warm.  Kills are
    **SIGKILL**: the hub's torn-frame handling and received-side
    accounting keep the ledger exact through them.  Spawn, not fork: a
    process with CUDA initialised and threads running cannot fork
    safely."""

    def __init__(self, grad_capacity: int = 0, *, family: str = "unix",
                 slab_dtype: str = "f32", device: Device = None):
        super().__init__(grad_capacity, family=family,
                         slab_dtype=slab_dtype, device=device)
        import multiprocessing
        self._ctx = multiprocessing.get_context("spawn")
        self._procs: Dict[int, Any] = {}            # live, by worker id
        self._all_procs: List[Tuple[int, int, Any]] = []
        self._killed: Set[int] = set()              # pids we SIGKILLed

    # -------------------------------------------------------- processes
    def spawn_worker(self, cfg: ProcWorkerConfig):
        cfg = dataclasses.replace(cfg, address=self.address,
                                  family=self.family)
        p = self._ctx.Process(
            target=_proc_worker_main, args=(cfg,),
            name=f"worker-{cfg.worker_id}.{cfg.generation}", daemon=True)
        p.start()
        self._procs[cfg.worker_id] = p
        self._all_procs.append((cfg.worker_id, cfg.generation, p))
        return p

    def _sigkill(self, p) -> None:
        self._killed.add(p.pid)
        p.kill()

    def kill_worker(self, worker_id: int) -> bool:
        """SIGKILL the worker's current process (no cooperation, no
        clean-up).  True if a live process was signalled."""
        p = self._procs.get(worker_id)
        if p is None or not p.is_alive():
            return False
        self._sigkill(p)
        return True

    def procs_alive(self) -> bool:
        """Any spawned worker process still running?"""
        return any(p.is_alive() for _, _, p in self._all_procs)

    def kill_unconnected(self) -> None:
        """SIGKILL worker processes that never finished connecting (a
        respawn still starting up when the run ends): they have sent
        nothing, the EOF shutdown cannot reach them, and waiting out
        their start-up would stall teardown.  Planned kills, not
        errors."""
        with self._conns_cond:
            connected = {(c.worker_id, c.generation) for c in self._conns
                         if c.worker_id is not None}
        for wid, gen, p in self._all_procs:
            if p.is_alive() and (wid, gen) not in connected:
                self._sigkill(p)

    def _failure(self, wid: int, gen: int, p) -> Optional[str]:
        code = p.exitcode
        if code in (0, None) or (code < 0 and p.pid in self._killed):
            return None
        return (f"worker process {wid}.{gen} exited with code {code} "
                "(see its stderr above)")

    def dead_workers(self) -> List[str]:
        """Processes that already exited abnormally (no planned SIGKILL):
        the fleet-ready barrier fails fast on a child that crashed
        during start-up."""
        return [err for err in (self._failure(*w) for w in self._all_procs)
                if err]

    def join_workers(self, timeout: float = 10.0) -> List[str]:
        """Join every spawned process, escalating to SIGKILL past the
        deadline.  Returns readable errors for processes that failed
        rather than exited cleanly or by a planned SIGKILL."""
        errors: List[str] = []
        deadline = time.monotonic() + timeout
        for wid, gen, p in self._all_procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                self._sigkill(p)
                p.join(timeout=2.0)
                errors.append(f"worker process {wid}.{gen} did not stop "
                              "within the join timeout (SIGKILLed)")
                continue
            err = self._failure(wid, gen, p)
            if err:
                errors.append(err)
        return errors

    def close(self) -> None:
        for _, _, p in self._all_procs:
            if p.is_alive():
                self._sigkill(p)
        for _, _, p in self._all_procs:
            p.join(timeout=2.0)
        super().close()
