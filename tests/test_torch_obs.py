"""The port's telemetry plane (``repro_torch.obs``) on the CPU: the cases
of ``tests/test_obs.py`` (the bus, the Chrome trace, counters that
reconcile with the conservation ledger on every transport, tracing that
leaves a sync run bitwise unchanged, a STATS reader that leaves a host
run bitwise unchanged, ``top``'s rows and its history backfill), and
parity with the JAX package: the same span list gives the same trace
JSON, the same payload the same Prometheus text, the same stats doc the
same ``top`` row, and STATS frames and clients interoperate across the
two packages' leaders byte for byte.

Joined workers run as threads (``run_joined_worker``) unless a test
needs a process.  Every wait polls for what it asserts.
"""
import io
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from repro.cluster import hostlink as jhl
from repro.cluster import mptransport as jmp
from repro.obs import chrome_trace as jchrome_trace
from repro.obs import prom as jprom
from repro.obs import top as jtop
from repro_torch.api import ExperimentSpec
from repro_torch.api.cli import main as cli_main
from repro_torch.cluster import mptransport as mpt
from repro_torch.cluster.hostlink import HostTransport, run_joined_worker
from repro_torch.cluster.mptransport import SocketTransport, \
    WireProtocolError
from repro_torch.cluster.trainer import ClusterTrainer
from repro_torch.obs import NULL, Telemetry, chrome_trace, \
    write_chrome_trace
from repro_torch.obs import prom
from repro_torch.obs.top import StatsClient, _fmt_line, top_main

torch.set_num_threads(2)
CPU = "cpu"


def _poll(predicate, timeout_s: float = 10.0, what: str = "condition"):
    deadline = time.monotonic() + timeout_s
    while not predicate():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.02)


def _spec(**kw):
    base = dict(arch="mlp", backend="cluster", mode="hybrid",
                schedule="step:40", cluster_workers=2, wall_budget_s=1.5,
                wall_sample_every_s=0.5, batch=16, smoke=True)
    base.update(kw)
    return ExperimentSpec(**base)


def _sync_spec(**kw):
    base = dict(arch="mlp", backend="cluster", mode="sync",
                schedule=None, cluster_workers=2, wall_budget_s=30.0,
                wall_sample_every_s=10.0, batch=16, smoke=True,
                max_gradients=12)
    base.update(kw)
    return ExperimentSpec(**base)


def _check_reconcile(res):
    """Telemetry counters against the conservation ledger, exactly."""
    a = res.extra["accounting"]
    tel = res.extra["telemetry"]
    c = tel["counters"]
    ingested = c.get("grads_ingested", 0)
    assert ingested == (a["applied"] + a["dropped"] + a["buffered"]
                        + a["pending_round"]), (c, a)
    assert a["computed"] == ingested + a["in_flight"], (c, a)
    assert c.get("grads_applied", 0) == a["applied"]
    assert c.get("updates", 0) == a["updates"]
    per_worker = sum(v for k, v in c.items()
                     if k.startswith("grads_ingested.w"))
    assert per_worker == ingested
    assert tel["ledger_check"]["consistent"], tel["ledger_check"]
    return tel


def _join_threads(addr, n: int):
    """``n`` joined workers on the CPU as threads; their exit codes land
    in the returned dict."""
    codes = {}

    def body(i):
        codes[i] = run_joined_worker(addr, connect_timeout=60.0,
                                     verbose=False, device=CPU)
    threads = [threading.Thread(target=body, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    return threads, codes


def _finish_joined(threads, codes, n: int):
    for t in threads:
        t.join(timeout=60.0)
    assert not any(t.is_alive() for t in threads), "a joiner hung"
    assert codes == {i: 0 for i in range(n)}, codes


# --------------------------------------------------------------- the bus

def test_telemetry_counters_gauges_histograms():
    tel = Telemetry()
    tel.count("grads")
    tel.count("grads", 4)
    tel.count("bytes", 100)
    tel.gauge("depth", 3.0)
    tel.gauge("depth", 7.0)               # last write wins
    for v in range(100):
        tel.observe("staleness", float(v))
    assert tel.counters() == {"grads": 5, "bytes": 100}
    st = tel.hist_stats("staleness")
    assert st["count"] == 100 and st["min"] == 0.0 and st["max"] == 99.0
    assert st["p50"] == 50.0 and st["p99"] == 98.0
    assert tel.hist_stats("nope") is None
    s = tel.summary()
    assert s["trace"] is False and s["spans_recorded"] == 0
    assert s["gauges"] == {"depth": 7.0}
    assert s["counters"]["grads"] == 5
    assert s["histograms"]["staleness"]["mean"] == pytest.approx(49.5)


def test_spans_recorded_only_when_tracing():
    off = Telemetry(trace=False)
    with off.span("server", "flush", k=3):
        pass
    off.span_at("server", "flush", time.monotonic(), 0.001)
    off.instant("server", "k_switch", k=1)
    assert off.spans() == []

    on = Telemetry(trace=True)
    with on.span("worker/0", "grad_compute", version=7):
        pass
    on.span_at("server", "flush", time.monotonic(), 0.002, k=2)
    on.instant("server", "k_switch", k=1)
    spans = on.spans()
    assert len(spans) == 3
    assert sorted(s[0] for s in spans) == ["I", "X", "X"]
    x = next(s for s in spans if s[2] == "grad_compute")
    assert x[1] == "worker/0" and x[5] == {"version": 7}
    assert on.summary()["spans_recorded"] == 3


def test_null_telemetry_is_inert():
    assert NULL.enabled is False
    NULL.count("x")
    NULL.gauge("x", 1.0)
    NULL.observe("x", 1.0)
    with NULL.span("t", "n"):
        pass
    NULL.span_at("t", "n", 0.0, 0.0)
    NULL.instant("t", "n")
    assert NULL.counters() == {} and NULL.spans() == []
    assert NULL.hist_stats("x") is None
    assert NULL.summary() == {"trace": False, "counters": {},
                              "gauges": {}, "histograms": {},
                              "spans_recorded": 0}


def test_chrome_trace_export(tmp_path):
    tel = Telemetry(trace=True)
    t = time.monotonic()
    tel.span_at("worker/1", "grad_compute", t, 0.003, version=5)
    tel.span_at("server", "flush", t + 0.003, 0.001, k=2)
    tel.instant("server", "k_switch", k=1)
    doc = chrome_trace(tel)
    events = doc["traceEvents"]
    # the server track sorts first whatever the names' order
    meta = {e["args"]["name"]: e["tid"] for e in events
            if e["ph"] == "M" and e["name"] == "thread_name"}
    assert meta["server"] == 0 and meta["worker/1"] == 1
    flush = next(e for e in events if e["name"] == "flush")
    assert flush["ph"] == "X" and flush["dur"] == pytest.approx(1000.0)
    assert flush["args"] == {"k": 2} and flush["cat"] == "server"
    grad = next(e for e in events if e["name"] == "grad_compute")
    assert grad["tid"] == 1 and grad["cat"] == "worker"
    inst = next(e for e in events if e["name"] == "k_switch")
    assert inst["ph"] == "i" and inst["s"] == "t"
    assert flush["ts"] - grad["ts"] == pytest.approx(3000.0)

    out = tmp_path / "trace.json"
    assert write_chrome_trace(tel, str(out)) == 3   # metadata not counted
    loaded = json.loads(out.read_text())
    assert loaded["displayTimeUnit"] == "ms"
    assert len(loaded["traceEvents"]) == len(events)


class _Spans:
    """A span buffer with fixed contents, fed to both packages."""

    def __init__(self, spans):
        self._spans = spans

    def spans(self):
        return list(self._spans)


def test_chrome_trace_json_equal_to_reference():
    """One span list, both exporters: the same document (track order,
    ``ph``, ``ts``, ``dur``, ``cat``, ``args``), byte for byte as JSON."""
    spans = [
        ("X", "worker/1/wire", "grad_rx", 0.0012345678, 0.0000421,
         {"version": 3, "seq": 1, "bytes": 32789}),
        ("X", "worker/0", "grad_compute", 0.000501, 0.0031, {"version": 2}),
        ("X", "server", "flush", 0.0042, 0.0000123456, {"k": 2}),
        ("X", "server", "publish", 0.00425, 0.0000071, {"version": 3}),
        ("I", "server", "k_switch", 0.005, 0.0, {"k": 3}),
        ("I", "worker/10", "kill", 1.5, 0.0, {}),
    ]
    ours, ref = chrome_trace(_Spans(spans)), jchrome_trace(_Spans(spans))
    assert ours == ref
    assert json.dumps(ours) == json.dumps(ref)


# --------------------------------------------- ledger reconciliation

@pytest.mark.parametrize("transport", ["inproc", "socket"])
def test_counters_reconcile_with_ledger(transport):
    res = ClusterTrainer(device=CPU).run(_spec(transport=transport))
    tel = _check_reconcile(res)
    h = tel["histograms"]
    # the instrumented seams produced samples: staleness per ingest,
    # flush and publish per update, grad and send-wait per gradient
    for name in ("staleness", "flush_s", "publish_s", "grad_s",
                 "send_wait_s", "queue_depth"):
        assert h.get(name, {}).get("count", 0) > 0, name
    assert tel["counters"].get("params_published", 0) > 0


def test_counters_reconcile_with_ledger_proc():
    """The same across the process boundary: the children keep their
    compute telemetry, the parent has every counter the check needs."""
    res = ClusterTrainer(device=CPU).run(_spec(
        transport="proc", wall_budget_s=3.0, wall_sample_every_s=1.0,
        max_gradients=200))
    c = _check_reconcile(res)["counters"]
    assert c.get("wire.rx_bytes", 0) > 0
    assert c.get("wire.tx_bytes", 0) > 0


# ----------------------------------------------------- tracing is inert

def test_trace_on_off_bitwise_identical(tmp_path):
    """A sync run under a gradient budget, traced and untraced: the same
    final params bit for bit, and the traced run's file is a loadable
    Chrome trace with grad_compute spans on every worker track and
    flush and publish spans on the server's."""
    spec = _sync_spec()
    plain = ClusterTrainer(device=CPU)
    res = plain.run(spec)
    assert res.extra["accounting"]["applied"] == 12
    assert "trace_path" not in res.extra
    assert res.extra["telemetry"]["trace"] is False
    assert res.extra["telemetry"]["spans_recorded"] == 0

    out = tmp_path / "trace.json"
    traced = ClusterTrainer(device=CPU, trace=str(out))
    res_t = traced.run(spec)
    assert res_t.extra["accounting"]["applied"] == 12
    assert res_t.extra["trace_path"] == str(out)
    assert res_t.extra["telemetry"]["spans_recorded"] > 0
    for key in plain.last_params:
        assert torch.equal(plain.last_params[key],
                           traced.last_params[key]), key

    events = json.loads(out.read_text())["traceEvents"]
    tid_of = {e["tid"]: e["args"]["name"] for e in events
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"server", "worker/0", "worker/1"} <= set(tid_of.values())
    grads = {}
    for e in events:
        if e.get("ph") == "X" and e["name"] == "grad_compute":
            track = tid_of[e["tid"]]
            grads[track] = grads.get(track, 0) + 1
    assert grads.get("worker/0", 0) >= 1 and grads.get("worker/1", 0) >= 1
    names = [e["name"] for e in events if e.get("ph") == "X"]
    assert names.count("flush") >= 1 and names.count("publish") >= 1


# -------------------------------------------- live stats plane (STATS)

def test_stats_reader_does_not_perturb_sync_run():
    """A read-only STATS subscriber on a live host leader streams
    progress but never enters the run: the sync outcome is bitwise the
    in-process one, the ledger exact, and the reader counted as a stats
    client, never a serve client."""
    spec = _sync_spec()
    base = ClusterTrainer(device=CPU)
    res = base.run(spec)
    assert res.extra["accounting"]["applied"] == 12
    # the serving report is always there, empty-shaped off host
    assert res.extra["serving"] == {
        "clients": 0, "rejected_peers": 0, "serve_every": 1,
        "stats_clients": 0, "per_client": []}

    hspec = _sync_spec(transport="host", listen="127.0.0.1:0")
    trainer = ClusterTrainer(device=CPU)
    runtime = trainer.build_runtime(hspec)
    threads, codes = _join_threads(runtime.listen_address, 2)
    reader = StatsClient(runtime.listen_address)
    docs = []
    try:
        res_h = trainer.finish(runtime, hspec)
        while True:
            doc = reader.wait_stats(timeout=0.5)
            if doc is None:
                break
            docs.append(doc)
    finally:
        reader.close()
        _finish_joined(threads, codes, 2)

    assert res_h.extra["accounting"]["applied"] == 12
    _check_reconcile(res_h)
    serving = res_h.extra["serving"]
    assert serving["clients"] == 0 and serving["stats_clients"] == 1
    assert docs, "the stats reader saw no push"
    live = [d for d in docs if "version" in d]
    if live:                                # saw the run mid-flight
        assert live[-1]["mode"] == "sync"
        assert 0 <= live[-1]["applied"] <= 12
    for key in base.last_params:
        assert torch.equal(base.last_params[key],
                           trainer.last_params[key]), key


_DOCS = [
    {"state": "waiting"},
    {"t": 1.5, "version": 42, "mode": "hybrid", "applied": 120,
     "dropped": 1, "buffered": 2, "pending_round": 0, "updates": 40,
     "staleness": {"p50": 0.0, "p99": 2.0}, "queue_depth": 3,
     "live_workers": 2, "num_workers": 2, "serve_clients": 0},
    {"t": 0.25, "version": 7, "mode": "async", "optimizer": "adamw",
     "optimizer_steps": 7, "applied": 7, "dropped": 0, "buffered": 0,
     "pending_round": 0, "updates": 7,
     "staleness": {"p50": None, "p99": None}, "queue_depth": 0,
     "live_workers": 3, "num_workers": 2, "fleet_size": 3,
     "max_workers": 4, "serve_clients": 2},
]


def test_top_formats_waiting_and_live_rows():
    assert "waiting" in _fmt_line(_DOCS[0], None)
    line = _fmt_line(_DOCS[1], 99.5)
    assert "42" in line and "99.5" in line and "hybrid" in line


@pytest.mark.parametrize("i,rate", [(0, None), (1, 99.5), (1, None),
                                    (2, 1234.56)])
def test_top_rows_equal_to_reference(i, rate):
    assert _fmt_line(_DOCS[i], rate) == jtop._fmt_line(_DOCS[i], rate)


_COUNTERS = {"wire.tx_bytes": 123456, "wire.rx_bytes": 654321,
             "optimizer_steps": 7, "grads_ingested.w0": 3,
             "events.kill": 1}


@pytest.mark.parametrize("i,counters", [(0, None), (1, None),
                                        (1, _COUNTERS), (2, _COUNTERS),
                                        (None, _COUNTERS)])
def test_render_prometheus_equal_to_reference(i, counters):
    doc = None if i is None else _DOCS[i]
    text = prom.render_prometheus(doc, counters)
    assert text == jprom.render_prometheus(doc, counters)
    if i == 2:
        assert "repro_grads_applied_total 7" in text
        assert 'repro_run_info{mode="async",optimizer="adamw"} 1' in text
        # optimizer_steps is rendered once, from the payload
        assert [ln for ln in text.splitlines() if ln.startswith(
            "repro_optimizer_steps_total")] == \
            ["repro_optimizer_steps_total 7"]


def _history_provider():
    state = {"n": 0}

    def provider():
        state["n"] += 1
        return {"t": state["n"] * 0.05, "version": state["n"],
                "applied": state["n"] * 10, "dropped": 0, "buffered": 0,
                "pending_round": 0, "queue_depth": 0, "live_workers": 1,
                "fleet_size": 1, "serve_clients": 0, "mode": "async",
                "staleness": {"p50": 0.0, "p99": 0.0}}
    return provider


def test_stats_history_ring_backfills_late_attaching_top():
    """The cadence thread feeds the history ring with nobody watching; a
    late subscriber gets the ring as a one-shot backfill before its
    first live push (seeding the grads/s delta), and live pushes are
    coalesced: a slow reader skips ticks."""
    hub = HostTransport(4, host="127.0.0.1", port=0, num_workers=1,
                        welcome_config={}, device=CPU)
    hub.stats_every_s = 0.05
    reader = None
    try:
        hub.stats_provider = _history_provider()
        _poll(lambda: len(hub.stats_history()) >= 3, 5.0,
              "the history ring")
        reader = StatsClient(hub.address)
        first = reader.wait_stats(timeout=5.0)
        assert first is not None and "version" in first
        assert reader.backfill, "no history backfill received"
        versions = [c["version"] for c in reader.backfill]
        assert versions == sorted(versions)
        assert versions[-1] <= first["version"]

        _poll(lambda: hub.stats_history()[-1]["version"]
              > first["version"] + 2, 5.0, "more ticks")
        latest = reader.wait_stats(timeout=5.0)
        assert latest is not None
        assert latest["version"] > first["version"] + 1

        # applied moves 10 per 0.05 s of leader clock: 200.0 grads/s on
        # the first printed row, from the backfill
        out = io.StringIO()
        assert top_main(tuple(hub.address), count=1, out=out) == 0
        text = out.getvalue()
        assert "backfilled" in text and "200.0" in text, text
    finally:
        if reader is not None:
            reader.close()
        hub.close()


def test_plain_hub_refuses_stats_clients():
    hub = SocketTransport(family="tcp", device=CPU)
    try:
        with pytest.raises(WireProtocolError, match="not a host transport"):
            StatsClient(hub.address, connect_timeout=5.0)
        _poll(lambda: hub.rejected_peers == 1, what="the rejected count")
        assert top_main(tuple(hub.address), count=1,
                        connect_timeout=5.0, out=io.StringIO()) == 4
    finally:
        hub.close()


# ------------------------------------------ across the two packages

_FIXED = {"t": 1.25, "version": 3, "mode": "sync", "optimizer": "sgd",
          "optimizer_steps": 0, "applied": 6, "dropped": 0, "buffered": 0,
          "pending_round": 2, "updates": 3,
          "staleness": {"p50": 0.0, "p99": 1.0}, "queue_depth": 1,
          "live_workers": 2, "num_workers": 2, "fleet_size": 2,
          "max_workers": 2, "serve_clients": 0}


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


def _raw_stats(address, n_frames: int):
    """Subscribe with a raw STATS frame and return the first
    ``n_frames`` frames the leader sends, as bytes."""
    s = socket.create_connection(tuple(address), timeout=5.0)
    try:
        s.sendall(mpt._stats_frame())
        frames = []
        for _ in range(n_frames):
            hdr = _recv_exact(s, mpt._HDR.size)
            _, n = mpt._HDR.unpack(hdr)
            frames.append(hdr + _recv_exact(s, n))
        return frames
    finally:
        s.close()


def test_stats_frames_byte_equal_to_reference():
    """The same payload behind both packages' host leaders: WELCOME
    (key order, the ``stats_every_s`` float), the history backfill and
    the first push arrive byte for byte the same."""
    ours = HostTransport(4, host="127.0.0.1", port=0, num_workers=2,
                         welcome_config={}, device=CPU)
    ref = jhl.HostTransport(4, host="127.0.0.1", port=0, num_workers=2,
                            welcome_config={})
    try:
        got = {}
        for name, hub in (("ours", ours), ("ref", ref)):
            hub.stats_every_s = 60.0        # no tick during the reads
            hub.stats_provider = lambda: dict(_FIXED)
            hub._stats_history.append(dict(_FIXED))     # one past tick
            got[name] = _raw_stats(hub.address, 3)
        assert got["ours"] == got["ref"]
        welcome, backfill, push = got["ours"]
        assert mpt._HDR.unpack_from(welcome)[0] == mpt._F_WELCOME
        body = welcome[mpt._HDR.size + mpt._CTRL.size:]
        assert list(json.loads(body)) == ["role", "stats_id",
                                          "heartbeat_s", "stats_every_s"]
        assert json.loads(backfill[mpt._HDR.size + mpt._CTRL.size:]) == \
            {"history": [_FIXED]}
        assert push == mpt._stats_frame(json.dumps(_FIXED).encode())
    finally:
        ours.close()
        ref.close()


@pytest.mark.parametrize("client", ["reference-on-port", "port-on-reference"])
def test_stats_clients_across_packages(client):
    """The reference's ``StatsClient`` reads the port's leader and the
    port's reads the reference's: WELCOME, backfill and live pushes."""
    if client == "reference-on-port":
        hub = HostTransport(4, host="127.0.0.1", port=0, num_workers=1,
                            welcome_config={}, device=CPU)
        make = jtop.StatsClient
    else:
        hub = jhl.HostTransport(4, host="127.0.0.1", port=0,
                                num_workers=1, welcome_config={})
        make = StatsClient
    hub.stats_every_s = 0.05
    reader = None
    try:
        hub.stats_provider = _history_provider()
        _poll(lambda: len(hub.stats_history()) >= 2, 5.0, "the ring")
        reader = make(tuple(hub.address))
        assert reader.welcome["role"] == "stats"
        assert reader.welcome["stats_every_s"] == 0.05
        first = reader.wait_stats(timeout=5.0)
        assert first is not None and first["mode"] == "async"
        assert reader.backfill and all("version" in c
                                       for c in reader.backfill)
        nxt = reader.wait_stats(timeout=5.0)
        assert nxt is not None and nxt["version"] > first["version"]
        assert hub.serve_stats()["stats_clients"] == 1
        assert hub.serve_stats()["clients"] == 0
    finally:
        if reader is not None:
            reader.close()
        hub.close()


# ------------------------------------------------------ Prometheus

def _scrape(url: str):
    try:
        with urllib.request.urlopen(url, timeout=5.0) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, ""


def test_prom_server_serves_the_newest_payload():
    box = {"doc": None}
    server = prom.PromServer(lambda: (box["doc"], None), 0,
                             host="127.0.0.1")
    try:
        assert _scrape(server.url)[0] == 503     # nothing yet
        box["doc"] = dict(_FIXED)
        status, text = _scrape(server.url)
        assert status == 200
        assert text == jprom.render_prometheus(_FIXED, None)
        assert _scrape(server.url.replace("/metrics", "/nope"))[0] == 404
    finally:
        server.close()
        server.close()                       # idempotent


def test_cli_trace_with_prom_port(tmp_path, capsys):
    """``python -m repro_torch trace FILE ... --prom-port 0`` on the
    CPU: the trace file is written and named in the result, and the
    Prometheus endpoint was bound (a ``prom_listening`` event)."""
    trace = tmp_path / "t.json"
    out = tmp_path / "r.json"
    code = cli_main(["trace", str(trace), "--arch", "mlp", "--smoke",
                     "--device", "cpu", "--cluster-workers", "2",
                     "--mode", "sync", "--max-gradients", "6",
                     "--wall-budget", "20", "--prom-port", "0",
                     "--log-level", "warning", "--quiet",
                     "--out", str(out)])
    assert code == 0
    res = json.loads(out.read_text())
    assert res["extra"]["trace_path"] == str(trace)
    assert [e for e in res["extra"]["events"]
            if e["event"] == "prom_listening"]
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"flush", "publish", "grad_compute"} <= names
    # off the cluster backend both flags are ignored with a warning
    code = cli_main(["simulate", "--smoke", "--device", "cpu", "--quiet",
                     "--horizon", "0.5", "--trace", str(trace),
                     "--prom-port", "0"])
    assert code == 0
    err = capsys.readouterr().err
    assert "--trace records the cluster runtime" in err
    assert "--prom-port exposes the cluster runtime" in err


def test_cli_top_against_a_leader(capsys):
    """``python -m repro_torch top HOST:PORT --count 2`` prints the
    header and two rows and exits 0; against a plain hub it exits 4."""
    hub = HostTransport(4, host="127.0.0.1", port=0, num_workers=1,
                        welcome_config={}, device=CPU)
    hub.stats_every_s = 0.05
    try:
        hub.stats_provider = _history_provider()
        host, port = hub.address[:2]
        assert cli_main(["top", f"{host}:{port}", "--count", "2",
                         "--log-level", "error"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith("[top] stats client 0 connected")
        rows = [ln for ln in out if ln.startswith("[top] v")]
        assert len(rows) == 2 and "[async]" in rows[-1]
    finally:
        hub.close()
