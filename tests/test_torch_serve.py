"""The port's serving plane (``repro_torch.serve``, the SERVE and PING
frames) on the CPU: the cases of ``tests/test_serve.py`` and parity with
the JAX package.

  * **admission**: only the host hub admits SERVE peers, read-only; a
    version-mismatched peer is rejected and counted, a GRAD from a serve
    client is rejected before it reaches the ledger, and serve peers
    never appear in the fleet barrier;
  * **publication**: pushes are version-monotonic per client,
    ``serve_every`` down-samples them, and a stalled serve client blocks
    neither ``publish_params`` nor a worker;
  * **liveness**: the hung-leader watchdogs of workers and serve
    clients, heartbeats keeping an idle client alive, PINGs racing the
    handshake, and no client stranded by a dead leader;
  * **inference**: greedy generation and the adapters on pushed slabs;
  * **end to end**: a training leader serving two ``python -m
    repro_torch infer`` processes while a joined worker trains;
  * **across the packages**: the serve WELCOME and PARAMS frames are
    the reference's byte for byte (f32 and bf16 slabs), and each
    package's client reads the other's leader, PARAMS bitwise.

Every wait polls for what it asserts; nothing sleeps a fixed time to let
a count settle.
"""
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as JaxSpec
from repro.cluster import hostlink as jhl
from repro.cluster import mptransport as jmp
from repro.cluster.transport import ParamsMsg as JParamsMsg
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.serve import client as jclient
from repro.serve import workload as jworkload
from repro_torch.api import ExperimentSpec
from repro_torch.api.trainers import SIM_WORKLOADS
from repro_torch.cluster import mptransport as mpt
from repro_torch.cluster.hostlink import (HostTransport, negotiate_serve,
                                          spawn_join_process)
from repro_torch.cluster.mptransport import (SocketTransport,
                                             SocketWorkerClient,
                                             WireProtocolError)
from repro_torch.cluster.trainer import ClusterTrainer
from repro_torch.cluster.transport import GradientMsg, ParamsMsg
from repro_torch.convert import params_from_numpy
from repro_torch.core.slab import slab_codec
from repro_torch.launch import serve as tserve
from repro_torch.serve.client import (ServeClient, infer_main,
                                      spawn_infer_process)
from repro_torch.serve.workload import build_infer_adapter, lm_tiny_config

torch.set_num_threads(2)
CPU = "cpu"


def _poll(predicate, timeout_s: float = 5.0, what: str = "condition"):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.02)


def _host_hub(**kw):
    kw.setdefault("num_workers", 1)
    kw.setdefault("welcome_config", {"spec": {"arch": "mlp"}})
    return HostTransport(8, host="127.0.0.1", port=0, device=CPU, **kw)


def _client(hub, **kw):
    return ServeClient(hub.address, device=CPU, **kw)


def _full(n, v):
    return torch.full((n,), float(v))


# ------------------------------------------------------------- admission


def test_serve_rejected_on_non_host_hub():
    hub = SocketTransport(family="tcp", device=CPU)
    try:
        with pytest.raises(WireProtocolError,
                           match="not a host transport"):
            negotiate_serve(hub.address, connect_timeout=5.0)
        _poll(lambda: hub.rejected_peers == 1, what="rejected count")
        assert hub.live_workers() == set()
        # infer's exit code for a leader that turns it away
        assert infer_main(tuple(hub.address), requests=1,
                          connect_timeout=5.0, verbose=False,
                          device=CPU) == 4
    finally:
        hub.close()


def _recv_exact(s: socket.socket, n: int) -> bytes:
    """``n`` bytes from ``s``: a socket with a timeout is non-blocking
    underneath, so one ``recv`` (even with MSG_WAITALL) may return
    short."""
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        assert chunk, f"the peer closed after {len(buf)} of {n} bytes"
        buf += chunk
    return buf


def test_version_mismatched_serve_peer_rejected():
    hub = _host_hub()
    try:
        s = socket.create_connection(tuple(hub.address), timeout=5.0)
        s.sendall(mpt._HDR.pack(mpt._F_SERVE, mpt._CTRL.size)
                  + mpt._CTRL.pack(mpt._MAGIC, 99))
        # the hub answers with a readable REJECT, then closes
        ftype, n = mpt._HDR.unpack(_recv_exact(s, mpt._HDR.size))
        assert ftype == mpt._F_REJECT
        reason = _recv_exact(s, n)[mpt._CTRL.size:].decode()
        assert "version mismatch" in reason
        _poll(lambda: hub.rejected_peers == 1, what="rejected count")
        assert hub.serve_stats()["clients"] == 0
        s.close()
    finally:
        hub.close()


def test_serve_client_never_enters_membership():
    hub = _host_hub()
    try:
        client = _client(hub)
        assert client.welcome["role"] == "serve"
        assert client.welcome["spec"] == {"arch": "mlp"}
        # no barrier seat, no ledger row
        assert hub.live_workers() == set()
        assert hub.connected_workers() == {}
        assert not hub.wait_for_workers(1, timeout=0.3)
        assert hub.received_counts() == {}
        _poll(lambda: hub.serve_stats()["clients"] == 1,
              what="serve admission")
        client.close()
    finally:
        hub.close()


def test_serve_client_sending_grad_is_rejected():
    hub = _host_hub()
    try:
        client = _client(hub)
        client.sock.sendall(mpt._grad_frame(
            GradientMsg(0, torch.zeros(4), 0, 0)))
        _poll(lambda: hub.rejected_peers == 1, what="rejected count")
        assert client.closed.wait(5.0)
        assert "read-only" in (client.reject_reason or "")
        assert hub.recv_gradient(timeout=0) is None
        assert hub.received_counts() == {}
        client.close()
    finally:
        hub.close()


# ----------------------------------------------------------- publication


def test_params_pushes_version_monotonic_per_client():
    """Six publications: the client ends at the last, every version it
    saw once and in order, and the hub's count of pushes to it agrees
    (polled: the count moves just after the frame is written)."""
    hub = _host_hub()
    try:
        client = _client(hub)
        # the hub lists the client just after its WELCOME went out
        _poll(lambda: hub.serve_stats()["clients"] == 1,
              what="serve admission")
        for v in range(6):
            hub.publish_params(ParamsMsg(v, _full(16, v)))
            _poll(lambda: hub.serve_stats()["per_client"][0]
                  ["last_version"] == v, what=f"version {v} pushed")
        msg = client.wait_params(min_version=5, timeout=5.0)
        assert msg is not None and msg.version == 5
        assert float(msg.params[0]) == 5.0
        _poll(lambda: len(client.versions_seen) ==
              hub.serve_stats()["per_client"][0]["pushes"],
              what="the client to read every push")
        seen = list(client.versions_seen)
        assert seen == sorted(seen) == list(range(6)), seen
        client.close()
    finally:
        hub.close()


def test_serve_every_downsamples_the_push_stream():
    hub = _host_hub(serve_every=3)
    try:
        client = _client(hub)
        assert client.welcome["serve_every"] == 3
        _poll(lambda: hub.serve_stats()["clients"] == 1,
              what="serve admission")
        for v in range(8):
            hub.publish_params(ParamsMsg(v, _full(8, v)))
            _poll(lambda: (lambda c: c["pushes"] + c["skipped_pushes"])(
                hub.serve_stats()["per_client"][0]) == v + 1,
                what=f"version {v} pushed or skipped")
        msg = client.wait_params(min_version=6, timeout=5.0)
        assert msg is not None and msg.version == 6
        _poll(lambda: client.versions_seen[-1:] == [6], what="v6 read")
        assert client.versions_seen == [0, 3, 6], client.versions_seen
        stats = hub.serve_stats()["per_client"][0]
        assert stats["skipped_pushes"] == 5 and stats["pushes"] == 3
        client.close()
    finally:
        hub.close()


def test_stalled_serve_client_never_blocks_publish_or_workers():
    """A serve client that connects and never reads again: its writer
    wedges against the full socket, but ``publish_params`` stays O(1)
    and a worker keeps receiving fresh versions."""
    hub = _host_hub()
    try:
        s = socket.create_connection(tuple(hub.address), timeout=5.0)
        s.sendall(mpt._serve_frame())
        _, n = mpt._HDR.unpack(_recv_exact(s, mpt._HDR.size))
        _recv_exact(s, n)                       # WELCOME: the last read
        _poll(lambda: hub.serve_stats()["clients"] == 1,
              what="serve admission")

        worker = hub.connect(0)
        _poll(lambda: hub.live_workers() == {0}, what="worker hello")

        slab = torch.arange(256 * 1024, dtype=torch.float32)   # 1 MiB
        t0 = time.monotonic()
        for v in range(30):
            hub.publish_params(ParamsMsg(v, slab + v))
        publish_s = time.monotonic() - t0
        assert publish_s < 2.0, f"publish_params stalled: {publish_s:.2f}s"

        msg = worker.fetch_params(min_version=29, timeout=10.0)
        assert msg is not None and msg.version == 29
        assert float(msg.params[1]) == 30.0
        worker.close()
        s.close()
    finally:
        hub.close()                             # must not hang either


# -------------------------------------------------------------- liveness


def test_worker_watchdog_detects_hung_leader():
    """A leader that accepts and goes silent (no EOF to see): the
    worker's no-frames watchdog closes with a readable reason."""
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


def test_serve_watchdog_detects_hung_leader():
    hub = _host_hub(heartbeat_s=0.0)            # a silent leader
    try:
        client = _client(hub, heartbeat_timeout_s=1.0)
        assert client.closed.wait(6.0), "watchdog never fired"
        assert "hung" in (client.stall_reason or "")
    finally:
        hub.close()


def test_heartbeat_keeps_idle_client_alive():
    """A healthy leader PINGing on a short cadence and publishing
    nothing: PINGs are proof of life, the client stays connected."""
    hub = _host_hub(heartbeat_s=0.2)
    try:
        client = _client(hub, heartbeat_timeout_s=1.0)
        assert not client.closed.wait(2.5), \
            f"client died despite heartbeats: {client.stall_reason}"
        assert client.stall_reason is None
        client.close()
    finally:
        hub.close()


def test_serve_handshake_skips_ping_frames():
    """A PING racing the SERVE handshake is skipped, not misread as the
    WELCOME."""
    ls = socket.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(1)
    done = threading.Event()

    def leader():
        conn, _ = ls.accept()
        conn.recv(mpt._HDR.size + mpt._CTRL.size, socket.MSG_WAITALL)
        conn.sendall(mpt._ping_frame()
                     + mpt._welcome_frame({"serve_id": 7, "spec": None,
                                           "heartbeat_s": 0.0}))
        done.wait(5.0)
        conn.close()

    t = threading.Thread(target=leader, daemon=True)
    t.start()
    sock, cfg = negotiate_serve(ls.getsockname(), connect_timeout=5.0)
    assert cfg["serve_id"] == 7
    done.set()
    sock.close()
    t.join(timeout=5.0)
    ls.close()


def test_dead_leader_strands_no_serve_client():
    hub = _host_hub()
    client = _client(hub)
    _poll(lambda: hub.serve_stats()["clients"] == 1,
          what="serve admission")
    hub.close()
    assert client.closed.wait(5.0), "client stranded after leader death"
    assert client.stall_reason is None          # EOF, not a hang
    client.close()


# ------------------------------------------------------------ inference


def test_greedy_generate_decode_step_is_cached():
    """The reference caches one jitted decode step per config, with the
    params an argument; the port has no jit, and the same holds of its
    plain function: two params trees generate through one call path,
    deterministically, each giving the reference's tokens on the same
    weights."""
    cfg = lm_tiny_config()
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 4)).astype(np.int32)
    outs = []
    for seed in (0, 1):
        jp = JM.init_params(jax.random.PRNGKey(seed), cfg)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp))
        with torch.inference_mode():
            o = tserve.greedy_generate(cfg, tp, prompts, 4)
            again = tserve.greedy_generate(cfg, tp, prompts, 4)
        assert o.shape == (2, 8) and np.array_equal(o[:, :4], prompts)
        assert np.array_equal(o, again)
        assert np.array_equal(o, jserve.greedy_generate(cfg, jp, prompts,
                                                        4))
        outs.append(o)
    assert jserve._decode_step_fn(cfg) is jserve._decode_step_fn(cfg)


def test_probe_adapter_decodes_pushed_slab():
    spec = ExperimentSpec(arch="mlp", smoke=True)
    _, params, _, _ = SIM_WORKLOADS["mlp"](spec, torch.device(CPU))
    adapter = build_infer_adapter(spec, device=CPU)
    assert adapter.kind == "probe"
    out = adapter.run(adapter.decode(slab_codec(params).encode(params)), 0)
    assert np.isfinite(out["probe_loss"]) and out["n"] == 64


@pytest.mark.parametrize("slab_dtype", ["f32", "bf16"])
def test_lm_adapter_generates_from_a_pushed_slab(slab_dtype):
    """lm-tiny's adapter decodes a pushed slab of the run's layout and
    greedy-decodes the reference adapter's prompts; on the same slab the
    two packages' adapters generate the same tokens."""
    spec = ExperimentSpec(arch="lm-tiny", smoke=True, slab_dtype=slab_dtype)
    _, params, _, _ = SIM_WORKLOADS["lm-tiny"](spec, torch.device(CPU))
    adapter = build_infer_adapter(spec, batch=2, prompt_len=6, gen_len=5,
                                  device=CPU)
    assert adapter.kind == "lm" and adapter.codec.padded_size == 98_304
    slab = adapter.codec.encode(params)
    out = adapter.run(adapter.decode(slab), 0)
    assert len(out["tokens"]) == 5 and out["n"] == 10

    jspec = JaxSpec(arch="lm-tiny", smoke=True, slab_dtype=slab_dtype)
    jad = jworkload.build_infer_adapter(jspec, batch=2, prompt_len=6,
                                        gen_len=5)
    assert np.array_equal(jad.prompts, adapter.prompts)
    assert jad.codec.padded_size == adapter.codec.padded_size
    wire = mpt._slab_to_bytes(slab, slab_dtype)
    jslab = jmp._slab_from_payload(wire, 0, slab_dtype)
    assert jad.run(jad.decode(jslab), 0)["tokens"] == out["tokens"]


# ----------------------------------------------------------- end to end


def _host_spec(**kw):
    base = dict(arch="mlp", backend="cluster", mode="async",
                schedule=None, cluster_workers=1, wall_budget_s=25.0,
                wall_sample_every_s=10.0, batch=16, smoke=True,
                transport="host", listen="127.0.0.1:0")
    base.update(kw)
    return ExperimentSpec(**base)


def test_leader_serves_two_infer_clients_while_training():
    """A training leader serves two separately launched ``python -m
    repro_torch infer`` processes (each rebuilds its inference workload
    from the wire spec) while a joined worker trains; all three exit 0,
    and the report accounts for both clients."""
    spec = _host_spec()
    trainer = ClusterTrainer(device=CPU)
    runtime = trainer.build_runtime(spec)
    runtime.proc_ready_timeout_s = 120.0
    addr = runtime.listen_address
    clients = [spawn_infer_process(addr, requests=2, device=CPU)
               for _ in range(2)]
    join = spawn_join_process(addr, device=CPU, reconnect_s=0)

    def wind_up():
        # end the run once both clients got their requests served
        for p in clients:
            p.wait(timeout=120)
        runtime.server.done.set()

    box = {}
    leader = threading.Thread(
        target=lambda: box.update(res=trainer.finish(runtime, spec)),
        daemon=True)
    leader.start()
    codes = []
    try:
        _poll(lambda: getattr(runtime, "server", None) is not None,
              120.0, "the server")
        wind_up()
        leader.join(timeout=60.0)
    finally:
        for p in (join, *clients):
            try:
                codes.append(p.wait(timeout=60))
            except Exception:
                p.kill()
                codes.append("killed")
    assert codes == [0, 0, 0], codes
    res = box["res"]
    serving = res.extra["serving"]
    assert serving["clients"] == 2
    for c in serving["per_client"]:
        assert c["pushes"] >= 1, serving
    assert [e for e in res.extra["events"]
            if e["event"] == "serve_client"]
    assert res.num_gradients > 0


# ------------------------------------------ across the two packages

def _raw_serve(address, n_frames: int):
    """Subscribe with a raw SERVE frame and return the first
    ``n_frames`` frames, as bytes.  The wait is long: under a loaded
    test run a hub's threads can be slow to answer."""
    s = socket.create_connection(tuple(address), timeout=30.0)
    try:
        s.sendall(mpt._serve_frame())
        frames = []
        for _ in range(n_frames):
            hdr = _recv_exact(s, mpt._HDR.size)
            _, n = mpt._HDR.unpack(hdr)
            frames.append(hdr + _recv_exact(s, n))
        return frames
    finally:
        s.close()


@pytest.mark.parametrize("slab_dtype", ["f32", "bf16"])
def test_serve_frames_byte_equal_to_reference(slab_dtype):
    """One publication behind both packages' host leaders: the serve
    WELCOME (the spec, its key order, ``serve_every``) and the PARAMS
    frame in the run's slab dtype arrive byte for byte the same."""
    spec = JaxSpec(arch="mlp", backend="cluster", transport="host",
                   listen="127.0.0.1:0", slab_dtype=slab_dtype).to_dict()
    assert ExperimentSpec.from_dict(spec).to_dict() == spec
    slab = np.random.default_rng(4).normal(size=8192).astype(np.float32)
    kw = dict(host="127.0.0.1", port=0, num_workers=2,
              welcome_config={"spec": spec}, heartbeat_s=0.0,
              serve_every=2, slab_dtype=slab_dtype)
    ours = HostTransport(8, device=CPU, **kw)
    ref = jhl.HostTransport(8, **kw)
    try:
        ours.publish_params(ParamsMsg(4, torch.from_numpy(slab.copy()),
                                      epoch=1))
        ref.publish_params(JParamsMsg(4, slab, epoch=1))
        got = {name: _raw_serve(hub.address, 2)
               for name, hub in (("ours", ours), ("ref", ref))}
        assert got["ours"] == got["ref"]
        assert got["ours"][1] == jmp._params_frame(
            JParamsMsg(4, slab, epoch=1), slab_dtype)
    finally:
        ours.close()
        ref.close()


@pytest.mark.parametrize("slab_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("client", ["reference-on-port",
                                    "port-on-reference"])
def test_serve_clients_across_packages(client, slab_dtype):
    """The reference's ``ServeClient`` reads the port's leader and the
    port's reads the reference's: WELCOME, and every pushed version's
    PARAMS bitwise in the run's slab dtype."""
    spec = {"arch": "mlp", "slab_dtype": slab_dtype}
    kw = dict(host="127.0.0.1", port=0, num_workers=1,
              welcome_config={"spec": spec}, slab_dtype=slab_dtype)
    rng = np.random.default_rng(5)
    slabs = [rng.normal(size=8192).astype(np.float32) for _ in range(3)]
    if client == "reference-on-port":
        hub = HostTransport(8, device=CPU, **kw)
        reader = jclient.ServeClient(hub.address)
        publish = lambda v: hub.publish_params(          # noqa: E731
            ParamsMsg(v, torch.from_numpy(slabs[v].copy())))
        got_bytes = lambda p: jmp._slab_to_bytes(p, slab_dtype)  # noqa
    else:
        hub = jhl.HostTransport(8, **kw)
        reader = ServeClient(hub.address, device=CPU)
        publish = lambda v: hub.publish_params(          # noqa: E731
            JParamsMsg(v, slabs[v]))
        got_bytes = lambda p: mpt._slab_to_bytes(p, slab_dtype)  # noqa
    try:
        assert reader.welcome["role"] == "serve"
        assert reader.welcome["spec"] == spec
        assert reader.slab_dtype == slab_dtype
        for v in range(3):
            publish(v)
            msg = reader.wait_params(min_version=v, timeout=5.0)
            assert msg is not None and msg.version == v
            assert got_bytes(msg.params) == \
                jmp._slab_to_bytes(slabs[v], slab_dtype)
        _poll(lambda: hub.serve_stats()["clients"] == 1,
              what="serve admission")
    finally:
        reader.close()
        hub.close()


def test_cli_serve_every_reaches_the_hub():
    """``--serve-every`` is a spec flag: the host leader's hub takes it
    and announces it in the serve WELCOME."""
    import argparse

    from repro_torch.api.cli import _add_spec_flags, _build_spec
    ap = argparse.ArgumentParser()
    _add_spec_flags(ap, backend_flag=True)
    spec = _build_spec(ap.parse_args(
        ["--backend", "cluster", "--transport", "host", "--listen",
         "127.0.0.1:0", "--serve-every", "4", "--arch", "mlp",
         "--smoke"]), None)
    assert spec.serve_every == 4
    runtime = ClusterTrainer(device=CPU).build_runtime(spec)
    try:
        assert runtime.transport.serve_every == 4
        client = ServeClient(runtime.listen_address, device=CPU)
        assert client.welcome["serve_every"] == 4
        assert client.welcome["spec"]["serve_every"] == 4
        client.close()
    finally:
        runtime.transport.close()
