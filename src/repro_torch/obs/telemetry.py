"""The in-process telemetry bus: counters, histograms, trace spans.

A copy of ``src/repro/obs/telemetry.py`` (which imports no JAX; the
port imports nothing of the JAX package).  Its export surfaces are the
Chrome trace (:mod:`repro_torch.obs.trace`, spans recorded only when
the cluster runtime is given ``trace=``), the STATS frame read by
``python -m repro_torch top`` (:mod:`repro_torch.obs.top`), Prometheus
(:mod:`repro_torch.obs.prom`) and :meth:`Telemetry.summary` in
``RunResult.extra["telemetry"]``.

One :class:`Telemetry` instance rides a cluster run (created by the
runtime, shared with the server and the thread workers).  The design
constraint is the hot path: ``ingest`` and the workers call into this
on *every gradient*, so every operation
is a dict update under one lock — no allocation beyond the first use
of a name, no formatting, no I/O.  Spans (for the Chrome trace export)
are only recorded when ``trace=True``; with tracing off, ``span()``
returns a shared no-op context manager and ``span_at``/``instant``
return immediately, so a tracing-disabled run does the same arithmetic
in the same order as one with the bus absent entirely — which is what
keeps sync runs bitwise-identical with tracing on or off
(regression-tested in the JAX package's ``tests/test_obs.py``).

Vocabulary:

  * ``count(name, n)`` — monotonic counters (``grads_ingested``,
    ``wire.rx_bytes``, ...);
  * ``gauge(name, v)`` — last-write-wins instantaneous values;
  * ``observe(name, v)`` — histogram samples (``staleness``,
    ``flush_s``, ``queue_depth``): running count/min/max/sum plus a
    capped sample buffer for percentiles;
  * ``span(track, name, **args)`` / ``span_at(...)`` /
    ``instant(...)`` — timeline events on a named track
    (``server``, ``worker/3``, ``worker/3/wire``), monotonic-clock
    relative to the bus's creation, exported by
    :func:`repro_torch.obs.trace.write_chrome_trace`.

:data:`NULL` is the no-op singleton: components take ``obs=None`` and
fall back to it, so instrumentation is zero-cost for callers that
construct subsystems directly (tests, benchmarks, library use).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

# spans are ring-buffered: a long run keeps the most recent window
# rather than growing without bound (200k spans ~ tens of MB of JSON,
# about what a trace viewer stays responsive on)
SPAN_CAPACITY = 200_000
# histogram sample retention per name: percentiles are computed over a
# capped buffer; count/min/max/sum stay exact past the cap
HIST_CAPACITY = 65_536


class _Hist:
    __slots__ = ("count", "total", "vmin", "vmax", "samples")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        self.samples: List[float] = []

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        if self.vmin is None or v < self.vmin:
            self.vmin = v
        if self.vmax is None or v > self.vmax:
            self.vmax = v
        if len(self.samples) < HIST_CAPACITY:
            self.samples.append(v)

    def stats(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0}
        s = sorted(self.samples)

        def pct(q: float) -> float:
            if not s:
                return 0.0
            idx = min(len(s) - 1, max(0, round(q * (len(s) - 1))))
            return float(s[int(idx)])

        return {"count": self.count,
                "min": float(self.vmin), "max": float(self.vmax),
                "mean": self.total / self.count,
                "p50": pct(0.50), "p99": pct(0.99)}


class _SpanCtx:
    """Context manager recording one completed span on exit."""
    __slots__ = ("_tel", "_track", "_name", "_args", "_t0")

    def __init__(self, tel: "Telemetry", track: str, name: str,
                 args: Optional[Dict[str, Any]]):
        self._tel = tel
        self._track = track
        self._name = name
        self._args = args

    def __enter__(self) -> "_SpanCtx":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.monotonic()
        self._tel._spans.append(
            ("X", self._track, self._name,
             self._t0 - self._tel.t0, t1 - self._t0, self._args))


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Telemetry:
    """The live bus.  Thread-safe; every mutation is O(1) under one
    lock (spans append to a lock-free deque)."""

    def __init__(self, trace: bool = False):
        self.trace = bool(trace)
        self.t0 = time.monotonic()      # span/instant time base
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Hist] = {}
        # (kind "X"|"I", track, name, t_rel_s, dur_s, args|None)
        self._spans: "collections.deque[Tuple]" = \
            collections.deque(maxlen=SPAN_CAPACITY)

    @property
    def enabled(self) -> bool:
        return True

    # ------------------------------------------------------------ metrics
    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Hist()
            h.add(float(value))

    # ----------------------------------------------------------- timeline
    def span(self, track: str, name: str, **args) -> Any:
        """``with obs.span("worker/0", "grad_compute", version=v): ...``
        — records a complete span when tracing, a shared no-op
        otherwise."""
        if not self.trace:
            return _NULL_SPAN
        return _SpanCtx(self, track, name, args or None)

    def span_at(self, track: str, name: str, t_start: float,
                dur_s: float, **args) -> None:
        """Record an already-measured span (``t_start`` from
        ``time.monotonic()``) — for call sites that time the work
        anyway and feed the duration to a histogram too."""
        if self.trace:
            self._spans.append(("X", track, name, t_start - self.t0,
                                dur_s, args or None))

    def instant(self, track: str, name: str, **args) -> None:
        """A zero-duration timeline marker (K(t) switch, kill,
        restore, ...)."""
        if self.trace:
            self._spans.append(("I", track, name,
                                time.monotonic() - self.t0, 0.0,
                                args or None))

    # ------------------------------------------------------------ exports
    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def hist_stats(self, name: str) -> Optional[Dict[str, float]]:
        """Live percentile snapshot of one histogram (the STATS frame
        provider reads ``staleness`` here mid-run)."""
        with self._lock:
            h = self._hists.get(name)
            return h.stats() if h is not None else None

    def spans(self) -> List[Tuple]:
        return list(self._spans)

    def summary(self) -> Dict[str, Any]:
        """The structured metrics report that lands in
        ``RunResult.extra["telemetry"]``."""
        with self._lock:
            return {
                "trace": self.trace,
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.stats()
                               for k, h in sorted(self._hists.items())},
                "spans_recorded": len(self._spans),
            }


class NullTelemetry:
    """The disabled bus: every call is a no-op.  Components default to
    this when no ``obs`` is passed, so instrumentation costs nothing
    outside an observed run."""

    trace = False

    @property
    def enabled(self) -> bool:
        return False

    def count(self, name: str, n: int = 1) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def observe(self, name: str, value: float) -> None:
        pass

    def span(self, track: str, name: str, **args) -> Any:
        return _NULL_SPAN

    def span_at(self, track: str, name: str, t_start: float,
                dur_s: float, **args) -> None:
        pass

    def instant(self, track: str, name: str, **args) -> None:
        pass

    def counters(self) -> Dict[str, int]:
        return {}

    def hist_stats(self, name: str) -> Optional[Dict[str, float]]:
        return None

    def spans(self) -> List[Tuple]:
        return []

    def summary(self) -> Dict[str, Any]:
        return {"trace": False, "counters": {}, "gauges": {},
                "histograms": {}, "spans_recorded": 0}


NULL = NullTelemetry()
