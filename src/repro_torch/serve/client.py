"""The read-only serve client: subscribe to a training leader's params.

A port of ``src/repro/serve/client.py``; either package's client reads
either package's leader.  :class:`ServeClient` rides the SERVE handshake
(:func:`repro_torch.cluster.hostlink.negotiate_serve`): it receives the
leader's WELCOME (spec, ``serve_id``, heartbeat cadence), then a reader
thread keeps a local versioned cell current from the coalesced PARAMS
broadcast, landing each slab on the client's device as a worker's
client does.  It holds no worker id, sends no gradients and has no seat
in the fleet barrier.  PINGs are answered with PONGs, and a hung leader
(no frame at all for several heartbeat periods) trips the watchdog:
:attr:`ServeClient.stall_reason` says so and the client closes.

:func:`infer_main` is the body of ``python -m repro_torch infer
HOST:PORT``: connect, rebuild the inference workload from the wire spec
(:func:`repro_torch.serve.workload.build_infer_adapter`) and run
requests against the newest pushed version, reporting each request's
params version and latency.
"""
from __future__ import annotations

import logging
import os
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.cluster.mptransport import (_CTRL, _F_PARAMS, _F_PING,
                                             _F_REJECT, _HDR, _MAX_FRAME,
                                             _PARAMS, _SLAB_ITEMSIZE,
                                             WireProtocolError, _pong_frame,
                                             _recv_exact, _recv_slab)
from repro_torch.cluster.transport import ParamsMsg
from repro_torch.convert import Device, resolve_device

_log = logging.getLogger("repro_torch.serve")


class ServeClient:
    """One read-only subscription to a training leader's params.

    ``wait_params(min_version, timeout)`` blocks for the newest pushed
    snapshot at or above ``min_version`` (None on timeout or close),
    coalesced: a slow caller skips versions instead of queueing them.
    :attr:`versions_seen` records every version pushed here, in arrival
    order.  ``heartbeat_timeout_s=None`` sizes the hung-leader watchdog
    from the leader's announced cadence; 0 disables it.  Slabs land on
    ``device`` (``cuda`` unless the caller asks for the CPU).
    """

    def __init__(self, address: Any, *, connect_timeout: float = 30.0,
                 heartbeat_timeout_s: Optional[float] = None,
                 device: Device = None):
        from repro_torch.cluster.hostlink import negotiate_serve
        self.device = resolve_device(device)
        sock, cfg = negotiate_serve(address,
                                    connect_timeout=connect_timeout)
        self.welcome: Dict[str, Any] = cfg
        self.serve_id = int(cfg.get("serve_id", -1))
        # the run's slab dtype rides the WELCOME spec: the leader pushes
        # the broadcast to serve clients in it
        self.slab_dtype = str((cfg.get("spec") or {})
                              .get("slab_dtype") or "f32")
        hb = float(cfg.get("heartbeat_s") or 0.0)
        if heartbeat_timeout_s is None:
            heartbeat_timeout_s = max(10.0, 5.0 * hb) if hb > 0 else 0.0
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        sock.settimeout(None)
        self.sock = sock
        self.closed = threading.Event()
        self.reject_reason: Optional[str] = None
        self.stall_reason: Optional[str] = None
        self.versions_seen: List[int] = []
        self._cell: Optional[ParamsMsg] = None
        self._cond = threading.Condition()
        self._wlock = threading.Lock()
        self._close_lock = threading.Lock()
        self._closed_once = False
        self._last_rx = time.monotonic()
        self._reader = threading.Thread(
            target=self._read_loop, name=f"serve-reader-{self.serve_id}",
            daemon=True)
        self._reader.start()
        if self.heartbeat_timeout_s > 0:
            threading.Thread(
                target=self._watchdog_loop,
                name=f"serve-watchdog-{self.serve_id}",
                daemon=True).start()

    # ---------------------------------------------------------- threads
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
                        self.versions_seen.append(version)
                        self._cond.notify_all()
                    continue
                payload, _ = _recv_exact(self.sock, n)
                if payload is None:
                    break
                self._last_rx = time.monotonic()
                if ftype == _F_PING:
                    with self._wlock:
                        try:
                            self.sock.sendall(_pong_frame())
                        except OSError:
                            break
                elif ftype == _F_REJECT:
                    reason = payload[_CTRL.size:].decode(
                        "utf-8", "replace") if n >= _CTRL.size else ""
                    self.reject_reason = reason or "rejected by hub"
                    _log.warning("hub rejected serve client %d: %s",
                                 self.serve_id, self.reject_reason)
                    break
                # other frame types are ignored (forward compat)
        finally:
            # a full close: no half-open socket for the leader's reader
            self.close()

    def _watchdog_loop(self) -> None:
        timeout = self.heartbeat_timeout_s
        while not self.closed.wait(min(timeout / 4.0, 1.0)):
            idle = time.monotonic() - self._last_rx
            if idle > timeout:
                self.stall_reason = (
                    f"no frames from the leader for {idle:.1f}s "
                    f"(liveness timeout {timeout:.1f}s) — the leader "
                    "looks hung; giving up on this connection")
                _log.warning("serve client %d: %s", self.serve_id,
                             self.stall_reason)
                self.close()
                return

    def _mark_closed(self) -> None:
        self.closed.set()
        with self._cond:
            self._cond.notify_all()

    # -------------------------------------------------------------- api
    @property
    def spec_dict(self) -> Optional[Dict[str, Any]]:
        return self.welcome.get("spec")

    def wait_params(self, min_version: int = 0,
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


# ============================================================= infer CLI


def infer_main(address: str, *, requests: int = 8,
               duration_s: Optional[float] = None, batch: int = 2,
               prompt_len: int = 8, gen_len: int = 8,
               connect_timeout: float = 60.0, verbose: bool = True,
               device: Device = None) -> int:
    """``python -m repro_torch infer`` body, inference on ``device``.
    Exit codes: 0 ok, 3 no params ever arrived, 4 rejected by the
    leader, 5 the leader hung.  A missing device raises before the
    connection is made."""
    dev = resolve_device(device)
    try:
        client = ServeClient(address, connect_timeout=connect_timeout,
                             device=dev)
    except WireProtocolError as e:
        print(f"infer failed: {e}", file=sys.stderr, flush=True)
        return 4
    try:
        from repro_torch.api.spec import ExperimentSpec
        from repro_torch.serve.workload import build_infer_adapter
        if client.spec_dict is None:
            print("infer failed: leader's WELCOME carried no spec",
                  file=sys.stderr, flush=True)
            return 4
        spec = ExperimentSpec.from_dict(client.spec_dict)
        if verbose:
            print(f"[infer] serve client {client.serve_id} connected to "
                  f"{address} (arch={spec.arch}); building the "
                  "inference workload", flush=True)
        adapter = build_infer_adapter(spec, batch=batch,
                                      prompt_len=prompt_len,
                                      gen_len=gen_len, device=dev)
        done = 0
        last_version: Optional[int] = None
        params = None
        t_start = time.monotonic()
        while done < requests:
            if duration_s is not None \
                    and time.monotonic() - t_start > duration_s:
                break
            msg = client.wait_params(min_version=0, timeout=1.0)
            if msg is None:
                if client.closed.is_set():
                    break
                continue
            if msg.version != last_version:
                params = adapter.decode(msg.params)
                last_version = msg.version
            t0 = time.monotonic()
            out = adapter.run(params, done)
            dt = time.monotonic() - t0
            done += 1
            if verbose:
                print(f"[infer] req {done}: params v{msg.version} "
                      f"{dt * 1e3:.1f}ms — {adapter.summary(out)}",
                      flush=True)
        wall = time.monotonic() - t_start
        if client.stall_reason:
            print(f"infer: {client.stall_reason}", file=sys.stderr,
                  flush=True)
            return 5
        if client.reject_reason:
            print(f"infer: rejected by leader: {client.reject_reason}",
                  file=sys.stderr, flush=True)
            return 4
        if done == 0:
            print("infer: no params ever arrived (leader gone before "
                  "the first push?)", file=sys.stderr, flush=True)
            return 3
        if verbose:
            print(f"[infer] {done} requests in {wall:.2f}s "
                  f"({done / max(wall, 1e-9):.2f} req/s), last params "
                  f"version {last_version}", flush=True)
        return 0
    finally:
        client.close()


def spawn_infer_process(address: Any, *, requests: int = 2,
                        connect_timeout: float = 120.0,
                        device: Optional[str] = None,
                        quiet: bool = True,
                        stdout: Any = None) -> "subprocess.Popen":
    """Launch ``python -m repro_torch infer`` as a separate OS process:
    a stand-in for an inference client on another machine (its own
    interpreter and spec rebuild, TCP the only link), as
    :func:`repro_torch.cluster.hostlink.spawn_join_process` launches a
    joiner.  ``device`` becomes ``--device`` (the CLI's default is
    ``cuda``); ``stdout`` (a file) takes the client's per-request report
    when ``quiet`` is False."""
    from repro_torch.cluster.hostlink import _addr_str
    cmd = [sys.executable, "-m", "repro_torch", "infer", _addr_str(address),
           "--requests", str(requests),
           "--connect-timeout", str(connect_timeout)]
    if quiet:
        cmd.append("--quiet")
    if device is not None:
        cmd += ["--device", str(device)]
    env = dict(os.environ)
    import repro_torch
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(repro_torch.__file__)))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    if device == "cpu":
        env["OMP_NUM_THREADS"] = str(torch.get_num_threads())
    return subprocess.Popen(cmd, env=env, stdout=stdout)
