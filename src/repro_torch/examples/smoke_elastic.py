"""Elastic-fleet smoke: online admission and a SIGKILLed shard re-leased.

A port of ``examples/smoke_elastic.py``: the three-terminal elasticity
quickstart, scripted as one process.

  1. a leader starts with a seed fleet of 2 and an admission ceiling of
     3 (``max_workers``), and two ``repro_torch join`` process groups
     come up;
  2. a third joiner is admitted *mid-run*: the fleet grows beyond the
     seed, the staging buffer and the K(t) schedule resized online;
  3. one seed worker is SIGKILLed (no goodbye, no flush); its shard is
     re-leased to a fresh process at a bumped generation;
  4. the run is wound up and gated on exit codes (every surviving
     joiner exits 0, the killed one shows SIGKILL) and on the exact
     conservation ledger: computed == applied + dropped + buffered +
     pending + in-flight, across every grow, kill and re-lease.

    PYTHONPATH=src python -m repro_torch.examples.smoke_elastic --device cpu
    PYTHONPATH=src python -m repro_torch.examples.smoke_elastic --device cuda

On ``cuda`` the leader and its joiners share the card.  Exits 0 only if
every gate holds; every wait is bounded.
"""
from __future__ import annotations

import argparse
import sys
import threading
import time


def _poll(predicate, timeout_s: float, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    while not predicate():
        if time.monotonic() >= deadline:
            raise TimeoutError(f"timed out waiting: {what}")
        time.sleep(0.05)


def run(device: str = "cuda", verbose: bool = True) -> int:
    """The smoke, end to end; 0 when every gate holds, else 1."""
    from repro_torch.api import ExperimentSpec
    from repro_torch.cluster.hostlink import spawn_join_process
    from repro_torch.cluster.trainer import ClusterTrainer

    def say(msg: str) -> None:
        if verbose:
            print(f"[elastic] {msg}", flush=True)

    spec = ExperimentSpec(
        arch="mlp", backend="cluster", mode="async", smoke=True,
        cluster_workers=2, max_workers=3, wall_budget_s=120.0,
        wall_sample_every_s=30.0, batch=16, transport="host",
        listen="127.0.0.1:0")
    trainer = ClusterTrainer(device=device)
    runtime = trainer.build_runtime(spec)
    addr = runtime.listen_address
    say(f"leader on {addr[0]}:{addr[1]} ({device}) — seed fleet 2, "
        "admission ceiling 3")

    def applied() -> int:
        server = getattr(runtime, "server", None)
        return server.applied if server is not None else 0

    box = {}

    def lead() -> None:
        try:
            box["res"] = trainer.finish(runtime, spec)
        except Exception as e:      # surfaced below, after the joiners
            box["error"] = e

    def join(worker_id=None):
        # a replacement is a fresh process: no joiner redials its leader
        return spawn_join_process(addr, worker_id=worker_id, device=device,
                                  reconnect_s=0)

    leader = threading.Thread(target=lead, daemon=True)
    joiners = {"j0": join(0), "j1": join(1)}
    leader.start()
    try:
        _poll(lambda: runtime.transport.live_workers() >= {0, 1},
              180.0, "seed fleet assembled")
        _poll(lambda: applied() > 0, 60.0, "seed fleet training")
        say(f"seed fleet training ({applied()} gradients applied)")

        # online admission: a third host dials the live run
        joiners["j2"] = join()
        _poll(lambda: 2 in runtime.transport.live_workers(), 180.0,
              "third worker admitted mid-run")
        # the hub admits the HELLO a beat before the runtime's hook
        # grows the fleet: poll the growth too
        _poll(lambda: runtime.fleet_size == 3, 30.0, "fleet grew to 3")
        say(f"worker 2 admitted mid-run — fleet grew to "
            f"{runtime.fleet_size}")
        mark = applied()
        _poll(lambda: applied() > mark, 60.0, "grown fleet training")

        # departure: SIGKILL a seed worker, then re-lease its shard
        joiners["j1"].kill()
        _poll(lambda: 1 not in runtime.transport.live_workers(), 60.0,
              "killed worker reaped")
        say("worker 1 SIGKILLed and reaped — re-leasing its shard")
        joiners["j3"] = join(1)
        _poll(lambda: 1 in runtime.transport.live_workers(), 180.0,
              "shard re-leased")
        mark = applied()
        _poll(lambda: applied() > mark, 60.0, "re-leased fleet training")
        say(f"shard re-leased, fleet training again ({applied()} "
            "gradients applied)")
    finally:
        if getattr(runtime, "server", None) is not None:
            runtime.server.done.set()       # wind the run up
        leader.join(timeout=120.0)
        codes = {}
        for name, proc in joiners.items():
            try:
                codes[name] = proc.wait(timeout=60)
            except Exception:
                proc.kill()
                codes[name] = "stranded"
    if leader.is_alive():
        say("FAIL: leader never finished")
        return 1
    if "error" in box:
        raise box["error"]

    ok = True
    survivors = {k: v for k, v in codes.items() if k != "j1"}
    if survivors != {"j0": 0, "j2": 0, "j3": 0}:
        say(f"FAIL: surviving joiner exit codes {survivors}")
        ok = False
    if codes.get("j1") != -9:           # SIGKILL: a negative code
        say(f"FAIL: killed worker exited {codes.get('j1')}, expected a "
            "SIGKILL death")
        ok = False
    res = box["res"]
    a = res.extra["accounting"]
    rhs = (a["applied"] + a["dropped"] + a["buffered"] + a["pending_round"]
           + a["in_flight"])
    if a["computed"] != rhs \
            or not res.extra["telemetry"]["ledger_check"]["consistent"]:
        say(f"FAIL: ledger leak — computed {a['computed']} != "
            f"applied+dropped+buffered+pending+in_flight {rhs}: {a}")
        ok = False
    if set(a["computed_per_worker"]) != {"0", "1", "2"}:
        say("FAIL: per-worker ledger missing members: "
            f"{a['computed_per_worker']}")
        ok = False
    events = res.extra["events"]
    grew = [e for e in events if e["event"] == "fleet_grow"]
    if not grew or grew[0]["to_workers"] != 3:
        say(f"FAIL: no fleet_grow to 3 in events: {grew}")
        ok = False
    if not any(e["event"] == "member_join" and e["worker"] == 1
               and e["generation"] >= 1 for e in events):
        say("FAIL: worker 1 never rejoined at a bumped generation")
        ok = False
    if not ok:
        return 1
    say(f"OK: {a['applied']} gradients applied, ledger exact across "
        f"admit/kill/re-lease (per-worker {a['computed_per_worker']})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.smoke_elastic",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the leader and its joiners compute "
                         "(default cuda)")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    sys.exit(main())
