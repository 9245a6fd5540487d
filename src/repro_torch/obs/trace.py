"""Chrome trace-event export: a cluster run as a Perfetto waterfall.

A port of ``src/repro/obs/trace.py``: the same span list gives the same
JSON.  A :class:`~repro_torch.obs.telemetry.Telemetry` span buffer
becomes the Chrome trace-event document (``traceEvents``: ``ph: "X"``
complete events and ``ph: "i"`` instants, microsecond timestamps) that
``chrome://tracing`` and https://ui.perfetto.dev load.  Every telemetry
*track* is one named thread row, ``server`` first and the others sorted
(``worker/0``, ``worker/0/wire``, ...): per-worker ``grad_compute``
spans beside the server's ``flush`` and ``publish``, wire ``grad_rx``
spans showing backpressure waits, and instants for K(t) switches, kills
and restores.

On the card the server's ``flush`` span times the flush's dispatch from
the host, not the kernel: the flush enqueues its kernel and returns
without waiting for the device.

Written by ``python -m repro_torch run --backend cluster --trace
out.json`` (or ``python -m repro_torch trace out.json ...``).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List


def chrome_trace(tel) -> Dict[str, Any]:
    """The trace-event document for a telemetry bus's span buffer."""
    spans = tel.spans()
    tracks = sorted({s[1] for s in spans},
                    key=lambda t: (t != "server", t))
    tid = {track: i for i, track in enumerate(tracks)}
    events: List[Dict[str, Any]] = [
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid[t],
         "args": {"name": t}} for t in tracks]
    events += [
        {"name": "thread_sort_index", "ph": "M", "pid": 1,
         "tid": tid[t], "args": {"sort_index": tid[t]}} for t in tracks]
    for kind, track, name, t_rel, dur, args in spans:
        ev: Dict[str, Any] = {
            "name": name, "pid": 1, "tid": tid[track],
            "ts": round(t_rel * 1e6, 3),
            "cat": track.split("/", 1)[0],
        }
        if kind == "X":
            ev["ph"] = "X"
            ev["dur"] = round(dur * 1e6, 3)
        else:
            ev["ph"] = "i"
            ev["s"] = "t"           # instant scoped to its thread row
        if args:
            ev["args"] = dict(args)
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(tel, path: str) -> int:
    """Write the trace JSON; returns the number of timeline events
    (track metadata rows not counted)."""
    doc = chrome_trace(tel)
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return sum(1 for e in doc["traceEvents"] if e["ph"] != "M")
