"""Model-zoo smoke: a registry transformer on the cluster path, bf16 wire.

A port of ``examples/smoke_zoo.py``: a ``zoo:transformer`` workload
(x0.125; real forward and backward through the model stack) trains on
the cluster backend over the ``proc`` transport, each of 2 workers its
own OS process, with the slab wire negotiated down to bf16 and the
slab-resident AdamW (f32 moments beside a bf16 params slab).  The run
is gated on:

  1. the run itself (applied gradients, a finite loss);
  2. the exact conservation ledger: computed == applied + dropped +
     buffered + pending + in-flight;
  3. telemetry with wire traffic both ways and a consistent ledger
     cross-check;
  4. bf16 on the wire: received bytes per computed gradient under 0.75
     of the f32 slab (4 bytes a parameter);
  5. the fused flush + AdamW path (``optimizer_steps`` > 0).

    PYTHONPATH=src python -m repro_torch.examples.smoke_zoo --device cpu
    PYTHONPATH=src python -m repro_torch.examples.smoke_zoo --device cuda

On ``cuda`` the leader and its worker processes share the card and
every flush is one ``flush_adamw`` launch.  Exits 0 only if every gate
holds.
"""
from __future__ import annotations

import argparse
import math
import sys

SCALE = 0.125


def spec():
    from repro_torch.api import ExperimentSpec
    return ExperimentSpec(
        arch="zoo:transformer", backend="cluster", mode="async",
        smoke=True, zoo_scale=SCALE, slab_dtype="bf16", optimizer="adamw",
        transport="proc", cluster_workers=2, wall_budget_s=60.0,
        wall_sample_every_s=15.0, batch=8, max_gradients=24)


def gates(res, n_params: int):
    """The failed gates' messages (empty when every gate holds)."""
    fails = []
    if res.num_gradients <= 0:
        fails.append(f"no gradients applied ({res.num_gradients})")
    losses = res.metrics.get("train_loss", ())
    if not losses or not all(math.isfinite(x) for x in losses):
        fails.append(f"train loss not finite: {losses}")
    a = res.extra["accounting"]
    rhs = (a["applied"] + a["dropped"] + a["buffered"] + a["pending_round"]
           + a["in_flight"])
    if a["computed"] != rhs:
        fails.append(f"ledger leak: computed {a['computed']} != "
                     f"applied+dropped+buffered+pending+in_flight {rhs}")
    tel = res.extra.get("telemetry") or {}
    counters = tel.get("counters") or {}
    tx, rx = counters.get("wire.tx_bytes", 0), counters.get(
        "wire.rx_bytes", 0)
    if tx <= 0 or rx <= 0:
        fails.append(f"no wire traffic recorded (tx={tx} rx={rx})")
    if not tel.get("ledger_check", {}).get("consistent", False):
        fails.append(f"telemetry ledger cross-check: "
                     f"{tel.get('ledger_check')}")
    if counters.get("optimizer_steps", 0) <= 0:
        fails.append("no fused optimizer steps recorded for an adamw run")
    if a["computed"] > 0 and rx / a["computed"] > 0.75 * 4 * n_params:
        fails.append(f"rx {rx / a['computed']:.0f} B/grad is not bf16 "
                     f"({4 * n_params} B f32 slab, {n_params} params)")
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "smoke_zoo")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the leader and its workers run (default "
                         "cuda; a host without CUDA needs --device cpu)")
    args = ap.parse_args(argv)
    from repro_torch.cluster.trainer import ClusterTrainer
    from repro_torch.models.zoo import init_zoo_params, num_params, \
        zoo_config

    res = ClusterTrainer(device=args.device).run(spec())
    p = num_params(init_zoo_params(zoo_config("transformer", SCALE), 0))
    fails = gates(res, p)
    for msg in fails:
        print(f"[zoo] FAIL: {msg}")
    if fails:
        return 1
    a = res.extra["accounting"]
    counters = res.extra["telemetry"]["counters"]
    print(f"[zoo] OK: zoo:transformer x{SCALE:g} ({p} params) trained over "
          f"proc/bf16 on {args.device} — {a['applied']} applied, ledger "
          f"exact, tx {counters['wire.tx_bytes']} B rx "
          f"{counters['wire.rx_bytes']} B", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
