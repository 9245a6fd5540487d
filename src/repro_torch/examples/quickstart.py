"""Quickstart: the paper's Smooth Switch algorithm through the unified
``repro_torch.api`` layer -- one ExperimentSpec, three aggregation modes.
A port of ``examples/quickstart.py``.

Runs the event-driven parameter-server simulator on the paper's random
20-dim classification dataset and compares async / sync / hybrid on the
same initialization -- the paper's core experiment.  Every flush is one
``flush`` kernel launch on the card (``--device cuda``, the default);
``--device cpu`` runs the kernels' plain versions.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu \\
      --horizon 1

(equivalently: python -m repro_torch simulate --arch mlp --mode hybrid \\
    --schedule step:300 --workers 25 --base-compute 0.02 --delay-std 0.25 \\
    --horizon 8 --no-smoke)
"""
from __future__ import annotations

import argparse

from repro_torch.api import ExperimentSpec, SimulatorTrainer
from repro_torch.core.simulator import WorkerPool


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "quickstart")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--horizon", type=float, default=8.0,
                    help="virtual seconds per run (default 8, the "
                         "reference's)")
    args = ap.parse_args(argv)
    # the paper's setting: 25 workers, half of them randomly delayed,
    # lr=0.01, batch 32, threshold step size 3/lr = 300
    base = ExperimentSpec(
        arch="mlp", backend="sim", mode="hybrid", schedule="step:300",
        lr=0.01, batch=32, horizon=args.horizon, seed=0, smoke=False,
        pool=WorkerPool(num_workers=25, base_compute=0.02, delay_std=0.25))
    # one trainer across modes: same dataset, same initialization (the
    # paper's shared-initialization protocol)
    trainer = SimulatorTrainer(device=args.device)

    print(f"{'mode':8s} {'grads':>6s} {'updates':>7s} "
          f"{'avg test acc':>12s} {'final acc':>9s} {'avg loss':>9s}")
    for mode in ("async", "sync", "hybrid"):
        res = trainer.run(base.with_(mode=mode))
        avg, fin = res.averaged(), res.final()
        print(f"{mode:8s} {res.num_gradients:6d} {res.num_updates:7d} "
              f"{100 * avg['test_acc']:11.1f}% {100 * fin['test_acc']:8.1f}% "
              f"{avg['test_loss']:9.3f}")

    print("\nExpected: hybrid sustains async-level gradient throughput with"
          "\nfewer, more confident parameter updates -> best averaged"
          " metrics\n(the paper's headline result).")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
