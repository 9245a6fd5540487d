"""The port's multi-host surface from the command line, on the CPU: a
``run --transport host`` leader and a ``serve --listen`` leader, each
with ``python -m repro_torch join`` workers started as separate
processes, ``serve`` without ``--listen`` still on the LM path, and the
elastic example (``python -m repro_torch.examples.smoke_elastic``).

Every leader binds port 0; the joiners learn the port from the line the
leader prints, as a user reading the terminal would.
"""
import json
import os
import re
import subprocess
import sys
import threading

import pytest
import torch

from repro_torch.api import RunResult

torch.set_num_threads(2)
SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
ENV = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")


def _module(*args, **kw):
    return subprocess.Popen([sys.executable, "-m", "repro_torch", *args],
                            env=ENV, **kw)


def _leader_address(leader, timeout_s: float = 120.0) -> str:
    """The HOST:PORT the leader prints once it listens; the rest of its
    stderr is drained in the background so it never blocks on a full
    pipe."""
    found, lines = threading.Event(), []

    def read():
        for line in leader.stderr:
            lines.append(line)
            if "leader listening on" in line:
                found.set()
        found.set()

    threading.Thread(target=read, daemon=True).start()
    assert found.wait(timeout_s), "leader printed no address"
    m = next((re.search(r"listening on (\S+:\d+)", line) for line in lines
              if "leader listening on" in line), None)
    assert m is not None, "".join(lines)
    return m.group(1)


def _check_host_result(path, workers: int, applied: int):
    res = RunResult.from_json(open(path).read())
    a = res.extra["accounting"]
    assert a["computed"] == (a["applied"] + a["dropped"] + a["buffered"]
                             + a["pending_round"] + a["in_flight"]), a
    assert res.num_gradients == a["applied"] == applied
    assert res.extra["telemetry"]["ledger_check"]["consistent"]
    assert set(a["computed_per_worker"]) == {str(w) for w in range(workers)}
    events = [e["event"] for e in res.extra["events"]]
    assert events.count("member_join") == workers and "listening" in events
    return res


@pytest.mark.parametrize("entry", ["run", "serve"])
def test_cli_host_leader_with_join_workers(entry, tmp_path):
    """``run --backend cluster --transport host --listen 127.0.0.1:0``
    (or its sugar ``serve --listen``) with two joined workers on the
    CPU: two ``join`` processes for ``run``, one ``join --workers 2``
    group for ``serve``.  The run finishes with an exact ledger and a
    consistent telemetry cross-check, and every process exits 0."""
    out = str(tmp_path / "r.json")
    head = ["run", "--backend", "cluster", "--transport", "host"] \
        if entry == "run" else ["serve"]
    leader = _module(*head, "--listen", "127.0.0.1:0", "--arch", "mlp",
                     "--cluster-workers", "2", "--mode", "sync",
                     "--max-gradients", "12", "--wall-budget", "60",
                     "--batch", "16", "--device", "cpu", "--quiet",
                     "--out", out, stdout=subprocess.PIPE,
                     stderr=subprocess.PIPE, text=True)
    joins = []
    try:
        addr = _leader_address(leader)
        groups = [["--workers", "1"]] * 2 if entry == "run" \
            else [["--workers", "2"]]
        joins = [_module("join", addr, *g, "--device", "cpu", "--quiet",
                         "--reconnect", "0") for g in groups]
        leader_out, _ = leader.communicate(timeout=180)
        codes = [p.wait(timeout=60) for p in joins]
    finally:
        for p in [leader, *joins]:
            if p.poll() is None:
                p.kill()
    assert leader.returncode == 0 and codes == [0] * len(joins), codes
    res = _check_host_result(out, workers=2, applied=12)
    assert res.extra["listen"] == addr
    assert json.loads(leader_out)["num_gradients"] == 12


def test_cli_serve_without_listen_stays_on_the_lm_path(monkeypatch):
    """Only ``--listen`` turns ``serve`` into the cluster leader: without
    it, ``serve`` is greedy decode on a registry model."""
    from repro_torch.api import cli
    from repro_torch.launch import serve
    seen = []
    monkeypatch.setattr(serve, "run", lambda args: seen.append(args) or 7)
    assert cli.main(["serve", "--smoke", "--device", "cpu"]) == 7
    assert len(seen) == 1 and seen[0].device == "cpu"


def test_elastic_example_on_the_cpu():
    """``python -m repro_torch.examples.smoke_elastic --device cpu``:
    seed 2, ceiling 3, a third joiner admitted mid-run, a SIGKILLed
    joiner's shard re-leased at a bumped generation, an exact ledger;
    it exits 0 only if every gate holds."""
    p = subprocess.run([sys.executable, "-m",
                        "repro_torch.examples.smoke_elastic", "--device",
                        "cpu"], env=ENV, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert "[elastic] OK:" in p.stdout
    assert "fleet grew to 3" in p.stdout
