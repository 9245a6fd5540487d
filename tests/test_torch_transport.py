"""The port's slab transports (``repro_torch.cluster.transport`` and
``mptransport``) on the CPU: the conformance battery of
``tests/test_transport.py`` run against ``inproc``, ``socket-tcp``,
``socket-unix`` and ``proc`` (FIFO and bitwise payloads, backpressure
with conservation, the min-version barrier, the version going backwards
on a restore, the timeout contract), the broadcast reaching every
worker, the wire frames byte-equal to the JAX package's, and the two
packages' hubs and clients talking to each other over a Unix socket.

The socket transports run hub and worker endpoint in one process here
(the frames still cross a real socket); the worker processes of
``proc`` run in ``tests/test_torch_mpcluster.py``.
"""
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from repro.cluster import mptransport as jmp
from repro.cluster.transport import GradientMsg as JGradientMsg
from repro.cluster.transport import ParamsMsg as JParamsMsg
from repro_torch.cluster import mptransport as tmp
from repro_torch.cluster.mptransport import ProcTransport, SocketTransport
from repro_torch.cluster.transport import (GradientMsg, InProcTransport,
                                           ParamsMsg)

torch.set_num_threads(2)
CPU = "cpu"
KINDS = ["inproc", "socket-tcp", "socket-unix", "proc"]


def make_pair(kind: str, cap: int):
    """(server_side, worker_endpoint, close_fn) for one transport kind:
    one object for ``inproc``, else a hub and a client connected to its
    address."""
    if kind == "inproc":
        t = InProcTransport(grad_capacity=cap)
        return t, t, t.close
    if kind == "proc":
        hub = ProcTransport(cap, family="unix", device=CPU)
    else:
        hub = SocketTransport(
            cap, family="tcp" if kind == "socket-tcp" else "unix",
            device=CPU)
    client = hub.connect(0)

    def close():
        client.close()
        hub.close()
    return hub, client, close


def drain_all(server, client, got=0, deadline_s: float = 10.0):
    """Drain the gradient channel to empty after flushing and closing
    the worker endpoint, the only state in which counts are exact.
    Flush and drain interleave: a backpressured sender finishes its
    accepted frames only while the server makes room."""
    deadline = time.monotonic() + deadline_s
    if client is not server:
        while not client.flush(0.05):
            while server.recv_gradient(timeout=0) is not None:
                got += 1
            assert time.monotonic() < deadline, "endpoint failed to flush"
        client.close()
    while True:
        while server.recv_gradient(timeout=0) is not None:
            got += 1
        if server.quiesce(timeout=0.1):
            break
        assert time.monotonic() < deadline, "transport failed to quiesce"
    while server.recv_gradient(timeout=0) is not None:
        got += 1
    assert server.pending_gradients() == 0
    return got


def _slab(values, dtype=np.float32):
    return torch.from_numpy(np.asarray(values, dtype))


def _bytes(t) -> bytes:
    return t.numpy().tobytes()


# --------------------------------------------------- conformance battery

@pytest.mark.parametrize("kind", KINDS)
def test_fifo_order_and_bitwise_payload(kind):
    server, client, close = make_pair(kind, cap=16)
    try:
        rng = np.random.default_rng(0)
        sent = [_slab(rng.normal(size=64)) for _ in range(5)]
        for i, g in enumerate(sent):
            assert client.send_gradient(GradientMsg(0, g, 7, i + 1),
                                        timeout=5.0)
        for i, g in enumerate(sent):
            msg = server.recv_gradient(timeout=5.0)
            assert msg is not None
            assert (msg.worker_id, msg.version, msg.seq) == (0, 7, i + 1)
            # f32 slabs round-trip bitwise: the cross-process parity
            # guarantee starts here
            assert _bytes(msg.grad) == _bytes(g)
        assert server.recv_gradient(timeout=0) is None
    finally:
        close()


@pytest.mark.parametrize("kind", KINDS)
def test_backpressure_blocks_sender_and_conserves(kind):
    """A full bounded channel eventually refuses a timed send (for
    sockets: hub queue, kernel buffers and outbound queue all full), and
    every gradient accepted before that is delivered exactly once."""
    server, client, close = make_pair(kind, cap=2)
    try:
        big = torch.zeros(1 << 18)                  # 1 MiB frames
        sent_ok, refused = 0, False
        for _ in range(64):
            if client.send_gradient(GradientMsg(0, big, 0, sent_ok + 1),
                                    timeout=0.05):
                sent_ok += 1
            else:
                refused = True
                break
        assert refused, f"64 x 1MiB sends never hit backpressure ({kind})"
        assert drain_all(server, client) == sent_ok
    finally:
        close()


@pytest.mark.parametrize("kind", KINDS)
def test_fetch_params_min_version_barrier(kind):
    server, client, close = make_pair(kind, cap=4)
    try:
        assert client.fetch_params(timeout=0.05) is None  # nothing yet
        server.publish_params(ParamsMsg(1, torch.full((8,), 1.0)))
        msg = client.fetch_params(min_version=1, timeout=5.0)
        assert msg is not None and msg.version == 1
        assert _bytes(msg.params) == _bytes(torch.full((8,), 1.0))
        # the barrier: v2 is not there yet
        assert client.fetch_params(min_version=2, timeout=0.1) is None
        t = threading.Timer(0.25, server.publish_params,
                            (ParamsMsg(2, torch.full((8,), 2.0)),))
        t.start()
        try:
            msg = client.fetch_params(min_version=2, timeout=5.0)
            assert msg is not None and msg.version == 2
        finally:
            t.join()
    finally:
        close()


@pytest.mark.parametrize("kind", KINDS)
def test_version_goes_backwards_on_restore(kind):
    """A restore publishes an OLDER version; the broadcast overwrites
    unconditionally so workers can resync to the restored round."""
    server, client, close = make_pair(kind, cap=4)
    try:
        server.publish_params(ParamsMsg(5, torch.full((4,), 5.0)))
        assert client.fetch_params(min_version=5, timeout=5.0).version == 5
        server.publish_params(ParamsMsg(2, torch.full((4,), 2.0)))
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            cur = client.fetch_params(timeout=0.05)
            if cur is not None and cur.version == 2:
                break
        assert cur.version == 2, cur
        assert _bytes(cur.params) == _bytes(torch.full((4,), 2.0))
    finally:
        close()


@pytest.mark.parametrize("kind", KINDS)
def test_timeout_contract(kind):
    """``timeout <= 0`` polls (never blocks); ``None`` blocks until the
    call can complete."""
    server, client, close = make_pair(kind, cap=2)
    try:
        t0 = time.monotonic()
        assert server.recv_gradient(timeout=0) is None
        assert client.fetch_params(timeout=0) is None
        assert time.monotonic() - t0 < 0.5      # polls, no waiting

        out = []
        th = threading.Thread(
            target=lambda: out.append(server.recv_gradient()),  # None
            daemon=True)
        th.start()
        th.join(0.3)
        assert th.is_alive(), "recv_gradient(timeout=None) must block"
        assert client.send_gradient(GradientMsg(0, torch.ones(4), 0, 1),
                                    timeout=5.0)
        th.join(5.0)
        assert not th.is_alive() and out[0].seq == 1
    finally:
        close()


def test_socket_broadcast_reaches_every_worker():
    """publish_params is a broadcast: N connected workers each see the
    latest version, late joiners get the current params on connect."""
    hub = SocketTransport(4, family="tcp", device=CPU)
    clients = []
    try:
        hub.publish_params(ParamsMsg(3, torch.arange(6.0)))
        clients = [hub.connect(w) for w in range(3)]
        for c in clients:
            msg = c.fetch_params(min_version=3, timeout=5.0)
            assert msg is not None and msg.version == 3
            assert _bytes(msg.params) == _bytes(torch.arange(6.0))
        assert hub.wait_for_workers(3, timeout=5.0)
        assert hub.live_workers() == {0, 1, 2}
        assert hub.connected_workers() == {0: 0, 1: 0, 2: 0}
    finally:
        for c in clients:
            c.close()
        hub.close()


def test_hold_params_withholds_the_broadcast_until_release():
    """The fleet barrier's starting gun: a connected worker sees no
    params while the hub holds them, then the latest on release."""
    hub = SocketTransport(4, family="unix", device=CPU)
    client = hub.connect(0)
    try:
        hub.hold_params()
        hub.publish_params(ParamsMsg(1, torch.ones(4)))
        hub.publish_params(ParamsMsg(2, torch.full((4,), 2.0)))
        assert hub.wait_for_workers(1, timeout=5.0)
        assert client.fetch_params(timeout=0.3) is None
        assert hub.fetch_params(timeout=0).version == 2   # hub-local cell
        hub.release_params()
        msg = client.fetch_params(min_version=2, timeout=5.0)
        assert msg is not None and _bytes(msg.params) == \
            _bytes(torch.full((4,), 2.0))
    finally:
        client.close()
        hub.close()


# --------------------------------------------- frames, byte for byte

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_frames_byte_equal_to_reference(dtype):
    """GRAD, PARAMS and HELLO/HELLO' built by the port from a seeded
    slab are the reference's frames byte for byte; a bf16 slab travels
    as its raw little-endian bit patterns."""
    rng = np.random.default_rng(3)
    slab = rng.normal(size=8192 * 2).astype(np.float32)
    t = torch.from_numpy(slab.copy())
    assert tmp._grad_frame(GradientMsg(3, t, 11, 42), dtype) == \
        jmp._grad_frame(JGradientMsg(3, slab, 11, 42), dtype)
    assert tmp._params_frame(ParamsMsg(7, t, epoch=2), dtype) == \
        jmp._params_frame(JParamsMsg(7, slab, epoch=2), dtype)
    assert tmp._hello_frame(5, 1, dtype) == jmp._hello_frame(5, 1, dtype)
    if dtype == "bf16":
        # a slab already in bf16 encodes to the same bits
        assert tmp._slab_to_bytes(t.to(torch.bfloat16), "bf16") == \
            jmp._slab_to_bytes(slab, "bf16")
    assert len(tmp._hello_frame(5, 1, dtype)) == \
        (19 if dtype == "f32" else 20)


def test_reject_frame_byte_equal_to_reference():
    reason = "bad magic 0x00000000 — peer is not a repro slab endpoint"
    assert tmp._reject_frame(reason) == jmp._reject_frame(reason)
    assert tmp._peer_error(0, 1) == jmp._peer_error(0, 1)
    assert tmp._peer_error(tmp._MAGIC, 2) == jmp._peer_error(jmp._MAGIC, 2)


def _raw_peer(hub, frame: bytes) -> bytes:
    """Connect a raw socket to the hub, send ``frame`` and return what
    comes back before the hub hangs up (a hub closing over bytes it did
    not read resets the connection, which may cut the reply)."""
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(5.0)
    s.connect(hub.address)
    try:
        s.sendall(frame)
        out = b""
        while True:
            try:
                chunk = s.recv(65536)
            except ConnectionResetError:
                return out
            if not chunk:
                return out
            out += chunk
    finally:
        s.close()


def _reject_reason(reply: bytes) -> str:
    ftype, n = tmp._HDR.unpack_from(reply)
    assert ftype == tmp._F_REJECT
    return reply[tmp._HDR.size + tmp._CTRL.size:
                 tmp._HDR.size + n].decode("utf-8")


def _first_frame(ftype: int) -> bytes:
    """A well-formed frame of each control type, as a peer's first."""
    if ftype == tmp._F_JOIN:
        return jmp._join_frame(-1)
    if ftype == tmp._F_AUTH:
        return jmp._auth_frame(jmp._auth_digest("s", b"\x00" * 32))
    if ftype == tmp._F_WELCOME:
        return jmp._welcome_frame({"worker_id": 0})
    if ftype == tmp._F_CHALLENGE:
        return jmp._challenge_frame(b"\x01" * 32)
    return jmp._ctrl_frame(ftype, b"")


# every control frame of protocol v1 and the ROADMAP item that brought
# it to the port: the host transport's (A10b), the serving and stats
# planes' (A11)
_CONTROL_FRAMES = sorted(
    [(t, "A10b") for t in (tmp._F_JOIN, tmp._F_WELCOME, tmp._F_PING,
                          tmp._F_PONG, tmp._F_CHALLENGE, tmp._F_AUTH)]
    + [(tmp._F_SERVE, "A11"), (tmp._F_STATS, "A11")])


@pytest.mark.parametrize("ftype,item", _CONTROL_FRAMES)
def test_frames_not_served_yet_are_rejected_naming_their_item(ftype, item):
    """A control frame as a peer's first, sent to the plain hub, is
    answered exactly as the reference's plain hub answers it: the same
    REJECT, byte for byte.  SERVE and STATS (A11) are turned away
    because only the host hub admits read-only peers, and no REJECT
    names a ROADMAP item any more."""
    frame = _first_frame(ftype)
    hub = SocketTransport(4, family="unix", device=CPU)
    try:
        reply = _raw_peer(hub, frame)
        assert hub.rejected_peers == 1 and hub.live_workers() == set()
    finally:
        hub.close()
    assert "ROADMAP" not in _reject_reason(reply)
    if item == "A11":
        assert "not a host transport" in _reject_reason(reply)
    ref = jmp.SocketTransport(4, family="unix")
    try:
        want = _raw_peer(ref, frame)
        assert ref.rejected_peers == 1
    finally:
        ref.close()
    assert _reject_reason(reply) == _reject_reason(want)
    assert reply == want


# ------------------------------------------- interop with the reference

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reference_client_against_port_hub(dtype):
    """A JAX-package worker client and the port's hub, over a Unix
    socket: gradients arrive bitwise, the broadcast reaches the client
    bitwise, and a stray peer is turned away without touching the
    fleet."""
    hub = SocketTransport(8, family="unix", slab_dtype=dtype, device=CPU)
    client = jmp.SocketWorkerClient(hub.address, 4, generation=2,
                                    family="unix", slab_dtype=dtype)
    try:
        assert hub.wait_for_workers(1, timeout=5.0)
        assert hub.connected_workers() == {4: 2}
        rng = np.random.default_rng(1)
        sent = [rng.normal(size=8192).astype(np.float32) for _ in range(3)]
        for i, g in enumerate(sent):
            assert client.send_gradient(JGradientMsg(4, g, 9, i + 1),
                                        timeout=5.0)
        for i, g in enumerate(sent):
            msg = hub.recv_gradient(timeout=5.0)
            assert (msg.worker_id, msg.version, msg.seq) == (4, 9, i + 1)
            assert tmp._slab_to_bytes(msg.grad, dtype) == \
                jmp._slab_to_bytes(g, dtype)
        params = rng.normal(size=8192).astype(np.float32)
        hub.publish_params(ParamsMsg(6, torch.from_numpy(params.copy()),
                                     epoch=1))
        got = client.fetch_params(min_version=6, timeout=5.0)
        assert (got.version, got.epoch) == (6, 1)
        assert jmp._slab_to_bytes(got.params, dtype) == \
            jmp._slab_to_bytes(params, dtype)
        _raw_peer(hub, b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
        deadline = time.monotonic() + 5.0
        while hub.rejected_peers == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert hub.rejected_peers == 1 and hub.live_workers() == {4}
        # the fleet's connection is untouched
        assert client.send_gradient(JGradientMsg(4, sent[0], 9, 4),
                                    timeout=5.0)
        assert hub.recv_gradient(timeout=5.0).seq == 4
    finally:
        client.close()
        hub.close()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_port_client_against_reference_hub(dtype):
    """The port's worker client and a JAX-package hub, over a Unix
    socket: the hub admits the port's HELLO, gradients arrive bitwise
    and the broadcast comes back bitwise."""
    hub = jmp.SocketTransport(8, family="unix", slab_dtype=dtype)
    client = tmp.SocketWorkerClient(hub.address, 1, family="unix",
                                    slab_dtype=dtype, device=CPU)
    try:
        assert hub.wait_for_workers(1, timeout=5.0)
        rng = np.random.default_rng(2)
        sent = [_slab(rng.normal(size=8192)) for _ in range(3)]
        for i, g in enumerate(sent):
            assert client.send_gradient(GradientMsg(1, g, 4, i + 1),
                                        timeout=5.0)
        for i, g in enumerate(sent):
            msg = hub.recv_gradient(timeout=5.0)
            assert (msg.worker_id, msg.version, msg.seq) == (1, 4, i + 1)
            assert jmp._slab_to_bytes(msg.grad, dtype) == \
                tmp._slab_to_bytes(g, dtype)
        params = rng.normal(size=8192).astype(np.float32)
        hub.publish_params(JParamsMsg(3, params, epoch=2))
        got = client.fetch_params(min_version=3, timeout=5.0)
        assert (got.version, got.epoch) == (3, 2)
        assert got.params.dtype == tmp._TORCH_DTYPES[dtype]
        assert tmp._slab_to_bytes(got.params, dtype) == \
            jmp._slab_to_bytes(params, dtype)
        assert hub.rejected_peers == 0
    finally:
        client.close()
        hub.close()
