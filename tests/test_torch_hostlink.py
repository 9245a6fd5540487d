"""The port's multi-host transport (``spec.transport = "host"``) on the
CPU: the battery of ``tests/test_hostlink.py``, the control frames and
the HMAC digest against the reference's, the liveness watchdog, interop
with the JAX package's leader and joiner in both directions, and the
fleet-ready timeout.

  * **pinned wire format** — slab payloads are little-endian ``<f4`` on
    the wire, HELLO carries magic and version, and malformed, mismatched
    or oversized peers are rejected readably, never admitted;
  * **addressing and leader discovery** — explicit ``--listen`` ports,
    JOIN/WELCOME leases with generation fencing, elastic admission, the
    re-lease grace window, authenticated JOIN;
  * **end to end** — a leader plus ``python -m repro_torch join``
    process groups (their own interpreters and spec-JSON rebuilds, TCP
    the only link) bitwise equal to ``inproc`` under a sync budget, an
    elastic run that admits, loses and re-leases, and joined workers
    that exit cleanly when the leader dies.

Joiners compute on the CPU (``device="cpu"``) and split their work over
this process's two intra-op threads.  Every wait polls for what it
asserts.
"""
import logging
import socket
import threading
import time

import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as JaxSpec
from repro.cluster import hostlink as jhl
from repro.cluster import mptransport as jmp
from repro.cluster.trainer import ClusterTrainer as JaxClusterTrainer
from repro.cluster.transport import GradientMsg as JGradientMsg
from repro_torch.api import ExperimentSpec
from repro_torch.api.trainers import SIM_WORKLOADS
from repro_torch.cluster import mptransport as mpt
from repro_torch.cluster.hostlink import (BUSY_MARKER, HostTransport,
                                          negotiate_join, parse_hostport,
                                          spawn_join_process)
from repro_torch.cluster.mptransport import (SocketTransport,
                                             SocketWorkerClient,
                                             WireProtocolError)
from repro_torch.cluster.runtime import PROC_READY_TIMEOUT_S, ClusterRuntime
from repro_torch.cluster.trainer import ClusterTrainer
from repro_torch.cluster.transport import GradientMsg, ParamsMsg
from repro_torch.core.slab import slab_codec
from repro_torch.obs.telemetry import Telemetry

torch.set_num_threads(2)
CPU = "cpu"


def _poll(predicate, timeout_s: float = 5.0, what: str = "condition"):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.02)


def _wait_all(procs, timeout_s: float = 60.0):
    """Exit codes of joiner processes; a stranded one is killed."""
    codes = {}
    for name, p in procs.items():
        if p is None:
            continue
        try:
            codes[name] = p.wait(timeout=timeout_s)
        except Exception:
            p.kill()
            codes[name] = "stranded"
    return codes


# ------------------------------------------------------------ addressing

def test_parse_hostport():
    assert parse_hostport("10.0.0.7:5555") == ("10.0.0.7", 5555)
    assert parse_hostport(":0") == ("127.0.0.1", 0)
    assert parse_hostport("7781") == ("127.0.0.1", 7781)
    with pytest.raises(ValueError, match="HOST:PORT"):
        parse_hostport("nonsense:port")
    with pytest.raises(ValueError, match="port"):
        parse_hostport("h:70000")


def test_tcp_explicit_port_resolved_and_fast_restart():
    """An explicit port binds that port (0 still means "pick"), the
    resolved address is exposed, and SO_REUSEADDR lets a fast restart
    rebind the same port while old connections sit in TIME_WAIT."""
    t1 = SocketTransport(2, family="tcp", port=0, device=CPU)
    host, port = tuple(t1.address)
    assert port != 0
    c1 = t1.connect(0)
    assert t1.wait_for_workers(1, timeout=5.0)
    c1.close()
    t1.close()
    t2 = SocketTransport(2, family="tcp", port=port, device=CPU)
    try:
        assert tuple(t2.address) == (host, port)
        c2 = t2.connect(1)
        assert t2.wait_for_workers(1, timeout=5.0)
        c2.close()
    finally:
        t2.close()


def test_spec_host_transport_round_trip_and_listen_validation():
    spec = ExperimentSpec(transport="host", listen="0.0.0.0:5555",
                          backend="cluster", max_workers=6)
    assert ExperimentSpec.from_json(spec.to_json()) == spec
    assert JaxSpec.from_json(spec.to_json()).max_workers == 6
    with pytest.raises(ValueError, match="listen"):
        ExperimentSpec(transport="host", listen="not-an-address:x")


# ------------------------------------------------- pinned slab byte order

def test_slab_payload_is_little_endian_on_the_wire():
    """The port's GRAD and PARAMS payloads are ``<f4``, byte for byte
    the reference's frame of the same values, also when the reference
    is handed a byteswapped (big-endian) array."""
    vals = np.linspace(-3.0, 7.0, 16, dtype=np.float32)
    t = torch.from_numpy(vals.copy())
    goff = mpt._HDR.size + mpt._GRAD.size
    frame = mpt._grad_frame(GradientMsg(3, t, 7, 1))
    assert frame[goff:] == vals.astype("<f4").tobytes()
    assert frame == jmp._grad_frame(JGradientMsg(3, vals.astype(">f4"),
                                                 7, 1))
    poff = mpt._HDR.size + mpt._PARAMS.size
    frame = mpt._params_frame(ParamsMsg(5, t, epoch=2))
    assert frame[poff:] == vals.astype("<f4").tobytes()


def test_byteswapped_payload_roundtrips_over_socket():
    """A reference worker hands the port's TCP hub a byteswapped
    gradient: it arrives value-identical as a native float32 tensor, and
    the broadcast comes back to it bitwise."""
    hub = SocketTransport(4, family="tcp", device=CPU)
    client = jmp.SocketWorkerClient(hub.address, 0, family="tcp")
    try:
        vals = np.linspace(-1.0, 1.0, 32, dtype=np.float32)
        assert client.send_gradient(
            JGradientMsg(0, vals.astype(">f4"), 1, 1), timeout=5.0)
        msg = hub.recv_gradient(timeout=5.0)
        assert msg is not None and msg.grad.dtype == torch.float32
        assert msg.grad.numpy().tobytes() == vals.tobytes()
        hub.publish_params(ParamsMsg(1, torch.from_numpy(vals.copy())))
        pmsg = client.fetch_params(min_version=1, timeout=5.0)
        assert pmsg is not None
        pgot = np.asarray(pmsg.params)
        assert pgot.dtype == np.float32 and pgot.dtype.isnative
        assert pgot.tobytes() == vals.tobytes()
    finally:
        client.close()
        hub.close()


# ------------------------------------------- the control frames, pinned

_NONCE = bytes(range(32))


@pytest.mark.parametrize("name,build", [
    ("JOIN", lambda m: m._join_frame(-1) + m._join_frame(7)),
    ("WELCOME", lambda m: m._welcome_frame(
        {"spec": {"arch": "mlp", "seed": 3}, "worker_id": 2,
         "generation": 1, "num_workers": 4, "heartbeat_s": 2.0})),
    ("CHALLENGE", lambda m: m._challenge_frame(_NONCE)),
    ("AUTH", lambda m: m._auth_frame(m._auth_digest("s3cret", _NONCE))),
    ("PING", lambda m: m._ping_frame()),
    ("PONG", lambda m: m._pong_frame()),
    ("digest", lambda m: m._auth_digest("open-sesame", _NONCE)
     + m._auth_digest("", b"")),
])
def test_control_frames_byte_equal_to_reference(name, build):
    assert build(mpt) == build(jmp), name


def test_welcome_of_a_lease_byte_equal_to_reference():
    """The WELCOME a JOIN draws from the port's leader and from the
    reference's, for the same welcome config, is one byte string."""
    cfg = {"spec": {"arch": "mlp", "mode": "sync"}}
    hubs = [HostTransport(4, num_workers=2, max_workers=3,
                          welcome_config=cfg, device=CPU),
            jhl.HostTransport(4, num_workers=2, max_workers=3,
                              welcome_config=cfg)]
    replies = []
    try:
        for hub in hubs:
            s = socket.create_connection(tuple(hub.address), timeout=5.0)
            s.sendall(mpt._join_frame(1))
            hdr = s.recv(mpt._HDR.size, socket.MSG_WAITALL)
            _, n = mpt._HDR.unpack(hdr)
            replies.append(hdr + s.recv(n, socket.MSG_WAITALL))
            s.close()
    finally:
        for hub in hubs:
            hub.close()
    assert replies[0] == replies[1]
    assert replies[0][0] == mpt._F_WELCOME


# ------------------------------------------------ handshake gatekeeping

def test_garbage_connection_rejected_without_joining_barrier():
    """A stray TCP client (here: speaking HTTP) is turned away, logged
    and counted, without crashing the hub, entering the fleet barrier or
    wedging a reader on a garbage frame length."""
    hub = SocketTransport(4, family="tcp", device=CPU)
    try:
        stray = socket.create_connection(tuple(hub.address), timeout=5.0)
        stray.sendall(b"GET / HTTP/1.1\r\nHost: example\r\n\r\n")
        _poll(lambda: hub.rejected_peers == 1, what="stray rejected")
        assert hub.live_workers() == set()
        assert not hub.wait_for_workers(1, timeout=0.2)
        stray.settimeout(5.0)
        try:
            while stray.recv(65536):
                pass
        except OSError:
            pass        # RST: the hub closed with unread bytes pending
        stray.close()
        client = hub.connect(0)
        assert hub.wait_for_workers(1, timeout=5.0)
        client.close()
    finally:
        hub.close()


def test_hello_version_mismatch_rejected_with_readable_error(caplog):
    """Right magic, wrong protocol version: a REJECT with a readable
    reason, logged, and the connection never becomes a worker."""
    hub = SocketTransport(4, family="tcp", device=CPU)
    try:
        peer = socket.create_connection(tuple(hub.address), timeout=5.0)
        bad = (mpt._HDR.pack(mpt._F_HELLO, mpt._HELLO.size)
               + mpt._HELLO.pack(mpt._MAGIC, 99, 0, 0))
        with caplog.at_level(logging.WARNING):
            peer.sendall(bad)
            _poll(lambda: hub.rejected_peers == 1, what="peer rejected")
        assert "version mismatch" in caplog.text and "v99" in caplog.text
        peer.settimeout(5.0)
        hdr = peer.recv(mpt._HDR.size, socket.MSG_WAITALL)
        ftype, n = mpt._HDR.unpack(hdr)
        assert ftype == mpt._F_REJECT
        payload = peer.recv(n, socket.MSG_WAITALL)
        reason = payload[mpt._CTRL.size:].decode()
        assert "version mismatch" in reason and "v99" in reason
        peer.close()
        assert hub.live_workers() == set()
    finally:
        hub.close()


def test_bad_magic_and_oversized_frame_rejected():
    hub = SocketTransport(4, family="tcp", device=CPU)
    try:
        p1 = socket.create_connection(tuple(hub.address), timeout=5.0)
        p1.sendall(mpt._HDR.pack(mpt._F_HELLO, mpt._HELLO.size)
                   + mpt._HELLO.pack(0xDEADBEEF, mpt._PROTO_VERSION,
                                     0, 0))
        _poll(lambda: hub.rejected_peers == 1, what="bad magic rejected")
        p1.close()
        # an admitted peer that loses frame sync (absurd length) is cut
        # off before the reader commits to the garbage read
        p2 = socket.create_connection(tuple(hub.address), timeout=5.0)
        p2.sendall(mpt._hello_frame(1, 0))
        _poll(lambda: 1 in hub.live_workers(), what="worker 1 admitted")
        p2.sendall(mpt._HDR.pack(mpt._F_GRAD, mpt._MAX_FRAME + 1))
        _poll(lambda: hub.rejected_peers == 2, what="oversize rejected")
        _poll(lambda: hub.live_workers() == set(),
              what="worker 1 deregistered")
        p2.close()
        # a GRAD whose slab is not whole f4 elements: a readable reject
        p3 = socket.create_connection(tuple(hub.address), timeout=5.0)
        p3.sendall(mpt._hello_frame(2, 0))
        _poll(lambda: 2 in hub.live_workers(), what="worker 2 admitted")
        p3.sendall(mpt._HDR.pack(mpt._F_GRAD, mpt._GRAD.size + 3)
                   + b"\x00" * (mpt._GRAD.size + 3))
        _poll(lambda: hub.rejected_peers == 3,
              what="ragged GRAD rejected")
        p3.close()
    finally:
        hub.close()


def test_silent_peer_receives_no_params_broadcast():
    """A connection that never authenticates is not sent the model: its
    writer wakes for the publication and skips it, while a real worker
    gets it."""
    hub = SocketTransport(4, family="tcp", device=CPU)
    silent = None
    try:
        silent = socket.create_connection(tuple(hub.address),
                                          timeout=5.0)
        _poll(lambda: len(hub._conns) == 1, what="silent peer accepted")
        quiet_conn = hub._conns[0]
        hub.publish_params(ParamsMsg(1, torch.ones(64)))
        client = hub.connect(0)
        msg = client.fetch_params(min_version=1, timeout=5.0)
        assert msg is not None and msg.version == 1     # workers: yes
        # the silent peer's writer has taken the publication's wake-up
        _poll(lambda: not quiet_conn._params_ev.is_set(),
              what="silent peer's writer woke and skipped")
        silent.setblocking(False)
        with pytest.raises(BlockingIOError):
            silent.recv(4096)
        client.close()
    finally:
        if silent is not None:
            silent.close()
        hub.close()


def test_out_of_range_hello_rejected():
    """A direct HELLO naming a worker id outside the fleet is not
    admitted: it would fill the barrier while its shard does not
    exist."""
    hub = HostTransport(4, host="127.0.0.1", port=0, num_workers=2,
                        welcome_config={}, device=CPU)
    try:
        stray = SocketWorkerClient(tuple(hub.address), 7, generation=0,
                                   family="tcp", device=CPU)
        assert stray.closed.wait(5.0)
        assert "out of range" in (stray.reject_reason or "")
        stray.close()
        assert hub.live_workers() == set()
    finally:
        hub.close()


def test_rehello_rejected_and_no_ghost_registration():
    """One connection identifies itself exactly once: a second HELLO is
    a protocol violation, and the connection is dropped whole, so no
    ghost worker id stays in the barrier."""
    hub = SocketTransport(4, family="tcp", device=CPU)
    gone = []
    hub.on_worker_gone = lambda wid, gen: gone.append(wid)
    try:
        peer = socket.create_connection(tuple(hub.address), timeout=5.0)
        peer.sendall(mpt._hello_frame(0, 0))
        _poll(lambda: 0 in hub.live_workers(), what="worker 0 admitted")
        peer.sendall(mpt._hello_frame(1, 0))       # re-HELLO, new id
        _poll(lambda: hub.rejected_peers == 1, what="re-HELLO rejected")
        _poll(lambda: hub.live_workers() == set(),
              what="no ghost worker left behind")
        _poll(lambda: gone == [0], what="worker 0 deregistered")
        peer.close()
    finally:
        hub.close()


def test_client_surfaces_reject_reason():
    """A rejected worker endpoint closes with the hub's readable reason
    on ``reject_reason`` instead of spinning."""
    hub = HostTransport(4, host="127.0.0.1", port=0, num_workers=2,
                        welcome_config={}, device=CPU)
    live = hub.connect(1)
    try:
        assert hub.wait_for_workers(1, timeout=5.0)
        dup = hub.connect(1)        # same worker id, same generation
        assert dup.closed.wait(5.0)
        assert "live connection" in (dup.reject_reason or "")
        dup.close()
    finally:
        live.close()
        hub.close()


# --------------------------------------------------- leases and fencing

def test_join_lease_negotiation_and_generation_fencing():
    hub = HostTransport(4, host="127.0.0.1", port=0, num_workers=2,
                        welcome_config={"spec": {"arch": "mlp"}},
                        device=CPU)
    addr = tuple(hub.address)
    socks = []
    try:
        s0, cfg0 = negotiate_join(addr)
        socks.append(s0)
        assert (cfg0["worker_id"], cfg0["generation"]) == (0, 0)
        assert cfg0["num_workers"] == 2
        assert cfg0["spec"] == {"arch": "mlp"}      # the wire contract
        # worker 0 is leased but still building (no HELLO yet): a direct
        # HELLO for its id must not take the shard from under it
        impostor = SocketWorkerClient(addr, 0, generation=0,
                                      family="tcp", device=CPU)
        assert impostor.closed.wait(5.0)
        assert "live connection" in (impostor.reject_reason or "")
        impostor.close()
        s1, cfg1 = negotiate_join(addr)
        socks.append(s1)
        assert (cfg1["worker_id"], cfg1["generation"]) == (1, 0)
        # lease contention is retried within connect_timeout, so the
        # expected failure needs a short deadline; an out-of-range id
        # fails at once
        with pytest.raises(WireProtocolError, match="full"):
            negotiate_join(addr, connect_timeout=0.5)
        with pytest.raises(WireProtocolError, match="already joined"):
            negotiate_join(addr, worker_id=1, connect_timeout=0.5)
        t0 = time.monotonic()
        with pytest.raises(WireProtocolError, match="out of range"):
            negotiate_join(addr, worker_id=5, connect_timeout=30.0)
        assert time.monotonic() - t0 < 5.0      # permanent: no retry
        # an attempt abandoned at its deadline may still have a JOIN in
        # flight, which a lagging hub would grant once s1 is gone: wait
        # until only s0's and s1's connections are open
        _poll(lambda: sum(not c.closed.is_set() for c in hub._conns) == 2,
              what="the turned-away attempts' connections closed")
        # a rejoining host resumes its shard at a bumped generation; the
        # rejoin may race the reaping of its predecessor's connection,
        # which negotiate_join retries itself
        s1.close()
        s1b, cfg1b = negotiate_join(addr, worker_id=1,
                                    connect_timeout=10.0)
        socks.append(s1b)
        assert (cfg1b["worker_id"], cfg1b["generation"]) == (1, 1)
        # generation fencing: with no live connection holding the id
        # (the lease outlives the connection), a HELLO from the
        # superseded generation-0 peer is turned away
        s1b.close()
        deadline = time.monotonic() + 5.0
        while True:
            stale = SocketWorkerClient(addr, 1, generation=0,
                                       family="tcp", device=CPU)
            assert stale.closed.wait(5.0)
            reason = stale.reject_reason or ""
            stale.close()
            if "generation fence" in reason:
                break
            # the hub may not have reaped s1b's connection yet: the
            # (also correct) duplicate rejection fires
            assert "live connection" in reason, reason
            assert time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        for s in socks:
            s.close()
        hub.close()


def test_join_handshake_skips_ping_frames():
    """A PING racing the JOIN handshake (a leader with a short cadence)
    is skipped by the negotiator, not misread as the WELCOME."""
    ls = socket.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(1)
    done = threading.Event()

    def leader():
        conn, _ = ls.accept()
        conn.recv(mpt._HDR.size + mpt._JOIN.size, socket.MSG_WAITALL)
        conn.sendall(mpt._ping_frame()
                     + mpt._welcome_frame({"worker_id": 3,
                                           "generation": 0,
                                           "num_workers": 4,
                                           "heartbeat_s": 0.0}))
        done.wait(5.0)
        conn.close()

    t = threading.Thread(target=leader, daemon=True)
    t.start()
    try:
        sock, cfg = negotiate_join(ls.getsockname(), connect_timeout=5.0)
        assert cfg["worker_id"] == 3
        sock.close()
    finally:
        done.set()
        t.join(5.0)
        ls.close()


# --------------------------------------------------------- liveness

def test_worker_watchdog_detects_hung_leader():
    """A leader that accepts and then goes silent (alive, wedged: no EOF
    to see): the worker's no-frames watchdog closes the connection with
    a readable reason."""
    ls = socket.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(1)
    held = []
    threading.Thread(target=lambda: held.append(ls.accept()),
                     daemon=True).start()
    client = SocketWorkerClient(ls.getsockname(), 0, family="tcp",
                                heartbeat_timeout_s=1.0, device=CPU)
    try:
        assert client.closed.wait(6.0), "watchdog never fired"
        assert "hung" in (client.stall_reason or "")
    finally:
        client.close()
        ls.close()


def test_heartbeat_keeps_idle_worker_alive():
    """The same watchdog under a leader that PINGs every 0.2 s and
    publishes nothing: the client answers each PING with a PONG and
    stays connected well past its 1 s timeout."""
    hub = SocketTransport(4, family="tcp", heartbeat_s=0.2, device=CPU)
    hub.obs = Telemetry(trace=False)
    pong = len(mpt._pong_frame())
    hello = mpt._HDR.size + mpt._HELLO.size
    try:
        client = SocketWorkerClient(hub.address, 0, family="tcp",
                                    heartbeat_timeout_s=1.0, device=CPU)
        # 10 PONGs: 2 s of PINGs, twice the watchdog's timeout
        _poll(lambda: hub.obs.counters().get("wire.rx_bytes", 0)
              >= hello + 10 * pong or client.closed.is_set(),
              timeout_s=20.0, what="ten PONGs")
        assert not client.closed.is_set(), client.stall_reason
        assert client.stall_reason is None
        client.close()
    finally:
        hub.close()


# ------------------------------------------- elastic admission + auth

def test_elastic_admission_beyond_seed_fleet():
    """With ``max_workers`` above the seed, auto JOINs keep receiving
    fresh ids past ``num_workers``, and every WELCOME names the ceiling
    as the shard space."""
    hub = HostTransport(4, host="127.0.0.1", port=0, num_workers=2,
                        max_workers=4, welcome_config={}, device=CPU)
    addr = tuple(hub.address)
    socks = []
    try:
        for expect in range(4):
            s, cfg = negotiate_join(addr)
            socks.append(s)
            assert (cfg["worker_id"], cfg["generation"]) == (expect, 0)
            assert cfg["num_workers"] == 4
        with pytest.raises(WireProtocolError, match="full"):
            negotiate_join(addr, connect_timeout=0.5)
    finally:
        for s in socks:
            s.close()
        hub.close()


def test_auto_join_blocked_by_grace_window_then_relessed():
    """An auto JOIN is not handed a recently departed worker id (its
    holder may be reconnecting) until the grace window passes; then the
    id is re-leased at a bumped generation."""
    hub = HostTransport(4, host="127.0.0.1", port=0, num_workers=1,
                        welcome_config={}, lease_grace_s=2.0, device=CPU)
    addr = tuple(hub.address)
    try:
        s0, cfg0 = negotiate_join(addr)
        assert (cfg0["worker_id"], cfg0["generation"]) == (0, 0)
        s0.close()
        _poll(lambda: 0 in hub._departed, what="departure recorded")
        with pytest.raises(WireProtocolError, match="grace") as e:
            negotiate_join(addr, connect_timeout=0.3)
        assert BUSY_MARKER in str(e.value)
        # no JOIN of the abandoned attempts is still in flight
        _poll(lambda: all(c.closed.is_set() for c in hub._conns),
              what="the turned-away attempts' connections closed")
        # the busy rejection is retried past expiry: same id, next
        # generation, never a new shard
        s1, cfg1 = negotiate_join(addr, connect_timeout=20.0)
        assert (cfg1["worker_id"], cfg1["generation"]) == (0, 1)
        s1.close()
    finally:
        hub.close()


def test_join_secret_challenge_and_rejections():
    """Authenticated JOIN: a secretless joiner fails readably on its own
    side, a wrong secret draws the leader's readable REJECT without a
    lease or a barrier seat, the right one is admitted at generation 0,
    and a direct HELLO cannot sidestep the challenge."""
    hub = HostTransport(4, host="127.0.0.1", port=0, num_workers=2,
                        welcome_config={"spec": {"arch": "mlp"}},
                        join_secret="open-sesame", device=CPU)
    addr = tuple(hub.address)
    try:
        with pytest.raises(WireProtocolError, match="authenticated"):
            negotiate_join(addr, connect_timeout=5.0)
        with pytest.raises(WireProtocolError,
                           match="authentication failed"):
            negotiate_join(addr, secret="wrong", connect_timeout=5.0)
        assert hub.live_workers() == set()
        s, cfg = negotiate_join(addr, secret="open-sesame")
        try:
            assert (cfg["worker_id"], cfg["generation"]) == (0, 0)
            assert cfg["spec"] == {"arch": "mlp"}
        finally:
            s.close()
        stray = SocketWorkerClient(addr, 1, generation=0, family="tcp",
                                   device=CPU)
        assert stray.closed.wait(5.0)
        assert "authenticated JOIN" in (stray.reject_reason or "")
        stray.close()
        assert 1 not in hub.live_workers()
        # the reference's joiner answers the port leader's challenge
        js, jcfg = jhl.negotiate_join(addr, secret="open-sesame",
                                      connect_timeout=5.0)
        assert jcfg["worker_id"] in (0, 1)
        js.close()
    finally:
        hub.close()


# ---------------------------------------------------------- end to end

def _host_spec(**kw):
    base = dict(arch="mlp", backend="cluster", mode="sync",
                schedule=None, cluster_workers=2, wall_budget_s=30.0,
                wall_sample_every_s=10.0, batch=16, smoke=True,
                max_gradients=12)
    base.update(kw)
    return ExperimentSpec(**base)


def _check_conservation(res):
    a = res.extra["accounting"]
    assert a["computed"] == (a["applied"] + a["dropped"] + a["buffered"]
                             + a["pending_round"] + a["in_flight"]), a
    assert res.num_gradients == a["applied"]
    assert a["computed"] == sum(a["computed_per_worker"].values())
    return a


def test_two_host_groups_bitwise_identical_to_inproc():
    """The same sync spec under a gradient budget, once with worker
    threads and once as a leader plus two separately launched
    ``repro_torch join`` process groups (each rebuilds the workload from
    the spec JSON it was sent): bitwise equal final params.  The pinned
    ``<f4`` frames, leased shards and worker-id-ordered rounds leave no
    other outcome.

    Two read-only serve clients subscribe to the host run while it
    trains: they receive pushes, never claim a barrier seat, and leave
    the training outcome bitwise untouched."""
    from repro_torch.serve.client import ServeClient
    finals = {}
    trainer = ClusterTrainer(device=CPU)
    res = trainer.run(_host_spec(transport="inproc"))
    a = _check_conservation(res)
    assert a["applied"] == 12 and res.num_updates == 6
    finals["inproc"] = trainer.last_params

    spec = _host_spec(transport="host", listen="127.0.0.1:0")
    trainer2 = ClusterTrainer(device=CPU)
    runtime = trainer2.build_runtime(spec)
    assert runtime.listen_address[1] != 0       # resolved, advertisable
    procs = {i: spawn_join_process(runtime.listen_address, device=CPU,
                                     reconnect_s=0)
             for i in range(2)}
    serve_clients = [ServeClient(runtime.listen_address, device=CPU)
                     for _ in range(2)]
    try:
        res_h = trainer2.finish(runtime, spec)
    finally:
        codes = _wait_all(procs)
        for c in serve_clients:
            c.close()
    assert codes == {0: 0, 1: 0}, codes
    a = _check_conservation(res_h)
    assert a["applied"] == 12 and res_h.num_updates == 6
    assert res_h.extra["telemetry"]["ledger_check"]["consistent"]
    finals["host"] = trainer2.last_params

    # the serving plane saw the run but never entered it
    serving = res_h.extra["serving"]
    assert serving["clients"] == 2, serving
    for c in serve_clients:
        seen = list(c.versions_seen)
        assert seen and seen == sorted(seen), seen
    assert res_h.extra["listen"].startswith("127.0.0.1:")
    listening = [e for e in res_h.extra["events"]
                 if e["event"] == "listening"]
    assert listening and listening[0]["expected_workers"] == 2
    assert res_h.extra["fleet_ready_s"] > 0
    for key in finals["inproc"]:
        assert torch.equal(finals["inproc"][key], finals["host"][key]), key


def test_elastic_e2e_admit_kill_release_and_exact_ledger():
    """Elasticity end to end over TCP: a 2-worker run admits a third
    joiner mid-run (the fleet grows beyond the seed), survives a
    SIGKILLed worker whose shard is re-leased to a fresh process at a
    bumped generation, and finishes with an exact ledger."""
    spec = _host_spec(transport="host", listen="127.0.0.1:0",
                      mode="async", cluster_workers=2, max_workers=3,
                      max_gradients=None, wall_budget_s=120.0)
    trainer = ClusterTrainer(device=CPU)
    runtime = trainer.build_runtime(spec)
    addr = runtime.listen_address

    def _applied():
        server = getattr(runtime, "server", None)
        return server.applied if server is not None else 0

    box = {}
    th = threading.Thread(
        target=lambda: box.update(res=trainer.finish(runtime, spec)),
        daemon=True)
    procs = {"j0": spawn_join_process(addr, worker_id=0, device=CPU,
                                      reconnect_s=0),
             "j1": spawn_join_process(addr, worker_id=1, device=CPU,
                                      reconnect_s=0)}
    th.start()
    try:
        _poll(lambda: runtime.transport.live_workers() >= {0, 1},
              timeout_s=180.0, what="seed fleet assembled")
        _poll(lambda: _applied() > 0, timeout_s=60.0,
              what="seed fleet training")
        procs["j2"] = spawn_join_process(addr, device=CPU, reconnect_s=0)
        _poll(lambda: 2 in runtime.transport.live_workers(),
              timeout_s=180.0, what="worker 2 admitted mid-run")
        # the hub admits the HELLO a beat before the runtime's hook
        # grows the fleet: poll, don't assert
        _poll(lambda: runtime.fleet_size == 3, timeout_s=30.0,
              what="fleet grew to 3")
        mark = _applied()
        _poll(lambda: _applied() > mark, timeout_s=60.0,
              what="grown fleet training")
        procs["j1"].kill()                  # SIGKILL a seed worker...
        _poll(lambda: 1 not in runtime.transport.live_workers(),
              timeout_s=60.0, what="killed worker reaped")
        # ...and re-lease its shard to a fresh process (the explicit id
        # skips the grace window; the generation bump fences the ghost)
        procs["j3"] = spawn_join_process(addr, worker_id=1, device=CPU,
                                         reconnect_s=0)
        _poll(lambda: 1 in runtime.transport.live_workers(),
              timeout_s=180.0, what="shard re-leased")
        mark = _applied()
        _poll(lambda: _applied() > mark, timeout_s=60.0,
              what="re-leased fleet training")
    finally:
        if getattr(runtime, "server", None) is not None:
            runtime.server.done.set()           # end the run
        th.join(120.0)
        codes = _wait_all(procs)
    assert not th.is_alive(), "runtime never finished"
    assert codes == {"j0": 0, "j1": -9, "j2": 0, "j3": 0}, codes

    res = box["res"]
    a = _check_conservation(res)
    assert a["applied"] > 0
    assert set(a["computed_per_worker"]) == {"0", "1", "2"}
    events = res.extra["events"]
    grow = [e for e in events if e["event"] == "fleet_grow"]
    assert grow and grow[0]["to_workers"] == 3, grow
    joins = [e for e in events if e["event"] == "member_join"]
    assert any(e["worker"] == 2 for e in joins), joins
    assert any(e["worker"] == 1 and e["generation"] >= 1
               for e in joins), joins
    assert any(e["event"] == "member_gone" and e["worker"] == 1
               for e in events)
    counters = res.extra["telemetry"]["counters"]
    assert counters["members.admitted_beyond_seed"] == 1


def test_kill_the_leader_joined_worker_exits_cleanly():
    """When the leader dies, a joined worker sees EOF and exits 0: no
    hang in ``recv``, no strand in the send retry loop, and a reset in
    its rejoin attempt is the leader hanging up, not a crash."""
    spec = _host_spec(mode="async", cluster_workers=1,
                      max_gradients=None)
    hub = HostTransport(8, host="127.0.0.1", port=0, num_workers=1,
                        welcome_config={"spec": spec.to_dict()},
                        device=CPU)
    proc = spawn_join_process(hub.address, device=CPU, reconnect_s=0)
    try:
        assert hub.wait_for_workers(1, timeout=180.0), \
            "joined worker never connected"
        # put the worker mid-loop: real params, so it is fetching,
        # computing and sending when the leader vanishes
        _, init_params, _, _ = SIM_WORKLOADS[spec.arch](spec, CPU)
        slab = slab_codec(init_params).encode(init_params)
        hub.publish_params(ParamsMsg(0, slab))
        _poll(lambda: hub.pending_gradients() > 0
              or sum(hub.received_counts().values()) > 0,
              timeout_s=60.0, what="worker training")
        hub.close()                             # the leader dies
        assert proc.wait(timeout=60) == 0       # EOF -> clean exit
    finally:
        if proc.poll() is None:
            proc.kill()
        hub.close()


# ------------------------------------- interop with the JAX package

def _params_allclose(got, want):
    for key, w in want.items():
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(w),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_port_joiner_trains_under_a_reference_leader():
    """A JAX-package leader (``HostTransport`` through its
    ``ClusterTrainer``) and a ``repro_torch join`` worker: the port
    rebuilds the workload from the reference's spec JSON, trains on the
    reference's params, and the run ends with an exact ledger and final
    params allclose to the reference's own in-process run."""
    fields = dict(arch="mlp", backend="cluster", mode="sync",
                  schedule=None, cluster_workers=1, wall_budget_s=60.0,
                  wall_sample_every_s=30.0, batch=16, smoke=True,
                  max_gradients=10)
    jtrainer = JaxClusterTrainer()
    jtrainer.run(JaxSpec(**fields))
    inproc = jtrainer.last_params
    jspec = JaxSpec(**{**fields, "transport": "host",
                       "listen": "127.0.0.1:0"})
    runtime = jtrainer.build_runtime(jspec)
    proc = spawn_join_process(runtime.listen_address, device=CPU,
                                     reconnect_s=0)
    try:
        res = jtrainer.finish(runtime, jspec)
    finally:
        codes = _wait_all({"port": proc})
    assert codes == {"port": 0}, codes
    a = _check_conservation(res)
    assert a["applied"] == 10 and res.num_updates == 10
    assert res.extra["telemetry"]["ledger_check"]["consistent"]
    _params_allclose(jtrainer.last_params, inproc)


def test_reference_joiner_trains_under_a_port_leader():
    """The port's leader and a ``repro join`` worker of the JAX package
    (its own ``spawn_join_process(platform="cpu")``): the reference
    rebuilds the workload from the port's spec JSON, and the run ends
    with an exact ledger and final params allclose to the port's own
    in-process run."""
    spec = _host_spec(cluster_workers=1, max_gradients=10)
    trainer = ClusterTrainer(device=CPU)
    trainer.run(spec)
    inproc = trainer.last_params
    hspec = spec.with_(transport="host", listen="127.0.0.1:0")
    runtime = trainer.build_runtime(hspec)
    proc = jhl.spawn_join_process(runtime.listen_address, platform="cpu",
                                  reconnect_s=0)
    try:
        res = trainer.finish(runtime, hspec)
    finally:
        codes = _wait_all({"reference": proc})
    assert codes == {"reference": 0}, codes
    a = _check_conservation(res)
    assert a["applied"] == 10 and res.num_updates == 10
    assert res.extra["telemetry"]["ledger_check"]["consistent"]
    _params_allclose(trainer.last_params, inproc)


# ------------------------------------------------ the fleet-ready wait

def test_ready_timeout_reaches_the_barrier():
    """``proc_ready_timeout_s`` is the barrier's wait: the port's default
    is 300 s, the trainer gives ``host`` 600 s as the reference's does,
    and a tiny value with an absent joiner fails readably, well under a
    second after it runs out."""
    spec = _host_spec(transport="host", listen="127.0.0.1:0")
    trainer = ClusterTrainer(device=CPU)
    runtime = trainer.build_runtime(spec)
    try:
        assert runtime.proc_ready_timeout_s == 600.0
    finally:
        runtime.transport.close()
    assert trainer.build_runtime(spec.with_(transport="inproc")) \
        .proc_ready_timeout_s == PROC_READY_TIMEOUT_S == 300.0
    loss, params, data, _ = SIM_WORKLOADS["mlp"](spec, CPU)
    runtime = ClusterRuntime(loss, params, data, mode="sync",
                             num_workers=2, transport_kind="host",
                             spec_dict=spec.to_dict(),
                             proc_ready_timeout_s=0.4, device=CPU)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match=r"only \[\] of 2 workers connected within "
                             r"0\.4s"):
        runtime.run()
    assert time.monotonic() - t0 < 0.4 + 0.9
