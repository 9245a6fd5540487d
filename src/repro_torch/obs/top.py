"""``python -m repro_torch top HOST:PORT``: live remote run introspection.

A port of ``src/repro/obs/top.py``; either package's client reads either
package's leader.  :class:`StatsClient` rides the STATS handshake
(:func:`repro_torch.cluster.hostlink.negotiate_stats`): it receives the
leader's WELCOME (``stats_id`` and push cadence), then a reader thread
keeps a local cell current from the hub's JSON pushes (ledger counters,
staleness percentiles, queue depth), a few hundred bytes per tick and
never a params slab.  Stats clients hold no worker id and never enter
the fleet barrier or the ledger, and the hub sends them no params, so a
sync run with one attached stays bitwise equal.

:func:`top_main` is the CLI body: one line per push with grads/s from
consecutive applied counts, staleness p50/p99 and the live ledger
columns.  A late attach is not blind: the hub's first push is a
``{"history": [...]}`` backfill from its ring, which seeds the rate, so
the first live row already has grads/s.
"""
from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, Dict, List, Optional, TextIO

from repro_torch.cluster.mptransport import (_CTRL, _F_PING, _F_REJECT,
                                             _F_STATS, _HDR, _MAX_FRAME,
                                             WireProtocolError, _pong_frame,
                                             _recv_exact)


class StatsClient:
    """One read-only telemetry subscription to a training leader.

    ``wait_stats(timeout)`` blocks for the next *unconsumed* push (None
    on timeout / close) — pushes are coalesced into a single latest
    cell, so a slow caller skips ticks instead of queueing them.
    """

    def __init__(self, address: Any, *, connect_timeout: float = 30.0):
        from repro_torch.cluster.hostlink import negotiate_stats
        sock, cfg = negotiate_stats(address,
                                    connect_timeout=connect_timeout)
        self.welcome: Dict[str, Any] = cfg
        self.stats_id = int(cfg.get("stats_id", -1))
        sock.settimeout(None)
        self.sock = sock
        self.closed = threading.Event()
        self.reject_reason: Optional[str] = None
        self.pushes_seen = 0
        # the hub's history-ring backfill (sent once, before the first
        # live push): past ticks, oldest first — never coalesced into
        # the live cell, so wait_stats() still only ever returns fresh
        # pushes
        self.backfill: List[Dict[str, Any]] = []
        self._cell: Optional[Dict[str, Any]] = None
        self._cell_seq = 0                  # bumps on every push
        self._taken_seq = 0                 # last seq wait_stats returned
        self._cond = threading.Condition()
        self._wlock = threading.Lock()
        self._close_lock = threading.Lock()
        self._closed_once = False
        self._reader = threading.Thread(
            target=self._read_loop, name=f"stats-reader-{self.stats_id}",
            daemon=True)
        self._reader.start()

    # ---------------------------------------------------------- threads
    def _read_loop(self) -> None:
        try:
            while not self.closed.is_set():
                hdr, _ = _recv_exact(self.sock, _HDR.size)
                if hdr is None:
                    break
                ftype, n = _HDR.unpack(hdr)
                if n > _MAX_FRAME:
                    break
                payload, _ = _recv_exact(self.sock, n)
                if payload is None:
                    break
                if ftype == _F_PING:
                    with self._wlock:
                        try:
                            self.sock.sendall(_pong_frame())
                        except OSError:
                            break
                elif ftype == _F_STATS and n > _CTRL.size:
                    try:
                        doc = json.loads(
                            payload[_CTRL.size:].decode("utf-8"))
                    except (ValueError, UnicodeDecodeError):
                        continue            # malformed tick: skip it
                    if isinstance(doc.get("history"), list):
                        # the one-shot ring backfill: keep it aside,
                        # don't wake wait_stats (it is not a live tick)
                        self.backfill = [c for c in doc["history"]
                                         if isinstance(c, dict)]
                        continue
                    with self._cond:
                        self._cell = doc
                        self._cell_seq += 1
                        self.pushes_seen += 1
                        self._cond.notify_all()
                elif ftype == _F_REJECT:
                    reason = payload[_CTRL.size:].decode(
                        "utf-8", "replace") if n >= _CTRL.size else ""
                    self.reject_reason = reason or "rejected by hub"
                    break
                # other frame types: ignored (forward compat)
        finally:
            self.close()

    def _mark_closed(self) -> None:
        self.closed.set()
        with self._cond:
            self._cond.notify_all()

    # -------------------------------------------------------------- api
    def wait_stats(self, timeout: Optional[float] = None
                   ) -> Optional[Dict[str, Any]]:
        """The next push not yet returned by this method (coalesced:
        only the latest is kept)."""
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        with self._cond:
            while self._taken_seq == self._cell_seq:
                if self.closed.is_set():
                    return None
                remain = None if deadline is None else \
                    deadline - time.monotonic()
                if remain is not None and remain <= 0:
                    return None
                self._cond.wait(0.1 if remain is None
                                else min(0.1, remain))
            self._taken_seq = self._cell_seq
            return self._cell

    def close(self) -> None:
        with self._close_lock:
            if self._closed_once:
                return
            self._closed_once = True
        self._mark_closed()
        try:
            self.sock.shutdown(2)           # SHUT_RDWR
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


# ================================================================ CLI


def _fmt_line(doc: Dict[str, Any], rate: Optional[float]) -> str:
    """One ``top`` row from one stats payload."""
    if doc.get("state") == "waiting":
        return "[top] waiting: leader is up but the run has not started"
    st = doc.get("staleness") or {}
    p50 = st.get("p50")
    p99 = st.get("p99")
    stale = "stale p50/p99 -/-" if p50 is None else \
        f"stale p50/p99 {p50:.0f}/{p99:.0f}"
    rate_s = "grads/s     -" if rate is None else \
        f"grads/s {rate:7.1f}"
    return (f"[top] v{doc.get('version', 0):<6} {rate_s}  {stale}  "
            f"applied {doc.get('applied', 0):<7} "
            f"dropped {doc.get('dropped', 0):<5} "
            f"buffered {doc.get('buffered', 0):<4} "
            f"pending {doc.get('pending_round', 0):<4} "
            f"queue {doc.get('queue_depth', 0):<4} "
            f"workers {doc.get('live_workers', 0)}/"
            f"{doc.get('fleet_size', doc.get('num_workers', 0))} "
            f"serve {doc.get('serve_clients', 0)} "
            f"opt {doc.get('optimizer', 'sgd')}:"
            f"{doc.get('optimizer_steps', 0)} "
            f"[{doc.get('mode', '?')}]")


def top_main(address: str, *, count: Optional[int] = None,
             duration_s: Optional[float] = None,
             connect_timeout: float = 30.0,
             prom_port: Optional[int] = None,
             out: Optional[TextIO] = None) -> int:
    """``python -m repro_torch top`` body: print the leader's pushes,
    one line each, until EOF, ``count`` rows or ``duration_s``.  With
    ``prom_port`` the newest push is also served as a Prometheus
    ``/metrics`` endpoint (:mod:`repro_torch.obs.prom`), so a scraper
    never touches the training wire.  Exit codes: 0 ok (a leader that
    goes away mid-watch included), 4 rejected by the leader or
    unreachable."""
    out = out if out is not None else sys.stdout
    try:
        client = StatsClient(address, connect_timeout=connect_timeout)
    except WireProtocolError as e:
        print(f"top failed: {e}", file=sys.stderr, flush=True)
        return 4
    prom = None
    if prom_port is not None:
        from repro_torch.obs.prom import PromServer
        latest: Dict[str, Any] = {}
        orig_wait = client.wait_stats

        def _wait(timeout=None):
            doc = orig_wait(timeout)
            if doc is not None:
                latest["doc"] = doc
            return doc

        client.wait_stats = _wait       # type: ignore[method-assign]
        prom = PromServer(lambda: (latest.get("doc"), None), prom_port)
        print(f"[top] prometheus metrics at {prom.url}", file=out,
              flush=True)
    try:
        print(f"[top] stats client {client.stats_id} connected to "
              f"{address} (push every "
              f"{client.welcome.get('stats_every_s', '?')}s)",
              file=out, flush=True)
        rows = 0
        prev: Optional[Dict[str, Any]] = None   # (for the rate delta)
        prev_t: Optional[float] = None
        t_start = time.monotonic()
        backfilled = False
        while count is None or rows < count:
            if duration_s is not None \
                    and time.monotonic() - t_start > duration_s:
                break
            doc = client.wait_stats(timeout=1.0)
            now = time.monotonic()
            if doc is None:
                if client.closed.is_set():
                    break
                continue
            if not backfilled:
                backfilled = True
                if client.backfill:
                    # seed the rate delta from the hub's history ring:
                    # the first live row is not blind on a late attach
                    prev = client.backfill[-1]
                    print(f"[top] backfilled {len(client.backfill)} "
                          "past tick(s) from the leader's history "
                          "ring", file=out, flush=True)
            rate = None
            if prev is not None and "applied" in doc \
                    and "applied" in prev:
                # prefer the leader's own clock ("t", carried in every
                # cell): backfilled ticks have no local receipt time
                if isinstance(doc.get("t"), (int, float)) \
                        and isinstance(prev.get("t"), (int, float)) \
                        and doc["t"] > prev["t"]:
                    rate = (doc["applied"] - prev["applied"]) \
                        / (doc["t"] - prev["t"])
                elif prev_t is not None and now > prev_t:
                    rate = (doc["applied"] - prev["applied"]) \
                        / (now - prev_t)
            print(_fmt_line(doc, rate), file=out, flush=True)
            rows += 1
            if "applied" in doc:
                prev, prev_t = doc, now
        if client.reject_reason:
            print(f"top: rejected by leader: {client.reject_reason}",
                  file=sys.stderr, flush=True)
            return 4
        if client.closed.is_set() and rows > 0:
            print("[top] leader closed the connection (run over)",
                  file=out, flush=True)
        return 0
    finally:
        if prom is not None:
            prom.close()
        client.close()
