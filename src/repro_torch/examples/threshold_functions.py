"""Paper §9 (future work): plug different monotone threshold functions
into the Smooth Switch and compare -- step (the paper's), linear, cosine,
exponential -- plus the staleness-decay extension on the buffer.  A port
of ``examples/threshold_functions.py``.

Every schedule is named by a ``repro_torch.api`` spec string, so the
exact experiment is reproducible from the printed spec alone.  Every
flush is one ``flush`` kernel launch on the card (``--device cuda``, the
default); ``--device cpu`` runs the kernels' plain versions.

  PYTHONPATH=src python -m repro_torch.examples.threshold_functions
  PYTHONPATH=src python -m repro_torch.examples.threshold_functions \\
      --device cpu --horizon 1
"""
from __future__ import annotations

import argparse

from repro_torch.api import ExperimentSpec, SimulatorTrainer
from repro_torch.core.simulator import WorkerPool

W = 25


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "threshold_functions")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--horizon", type=float, default=8.0,
                    help="virtual seconds per run (default 8, the "
                         "reference's)")
    args = ap.parse_args(argv)
    base = ExperimentSpec(
        arch="mlp", backend="sim", mode="hybrid", schedule="step:300",
        lr=0.01, batch=32, horizon=args.horizon, seed=0, smoke=False,
        pool=WorkerPool(num_workers=W, base_compute=0.02, delay_std=0.25))
    # one trainer instance: the dataset and the model are built once
    trainer = SimulatorTrainer(device=args.device)

    # rough horizon in updates for the smooth families
    schedules = {
        "step 300 (paper)": "step:300",
        "step 500 (paper)": "step:500",
        "linear": "linear:2500",
        "cosine": "cosine:horizon=2500",
        "exponential": "exp:horizon=2500,rate=5",
    }
    print(f"{'schedule':20s} {'avg acc':>8s} {'final acc':>9s} "
          f"{'avg loss':>9s} {'updates':>8s}")
    for name, sched in schedules.items():
        r = trainer.run(base.with_(schedule=sched))
        a, f = r.averaged(), r.final()
        print(f"{name:20s} {100 * a['test_acc']:7.1f}% "
              f"{100 * f['test_acc']:8.1f}% {a['test_loss']:9.3f} "
              f"{r.num_updates:8d}")

    print("\nbeyond-paper: staleness-weighted flush (decay^staleness)")
    for decay in (1.0, 0.8, 0.5):
        r = trainer.run(base.with_(staleness_decay=decay))
        a = r.averaged()
        print(f"  decay={decay:3.1f}: avg acc {100 * a['test_acc']:5.1f}%  "
              f"avg loss {a['test_loss']:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
