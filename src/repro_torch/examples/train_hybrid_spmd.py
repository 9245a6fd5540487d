"""End-to-end SPMD driver: an xLSTM trained with the group-annealed
hybrid schedule, against the sync and async baselines, through
:mod:`repro_torch.api`.  A port of ``examples/train_hybrid_spmd.py``.

Launch one rank per process; with 4 ranks the reduction-group annealing
g: 1 -> 4 is real (4 replicas -> 2 -> 1, merged between phases):

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.examples.train_hybrid_spmd --device cpu --steps 40

The defaults are sized for the CPU (xlstm-350m's smoke variant);
``--full-100m`` trains the published xlstm-350m config, for the card
(``--device cuda``, the default: the ranks share it over gloo).  Rank 0
prints the table and, with ``--out``, writes the three RunResults.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.train_hybrid_spmd")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="rank 0 writes the three RunResults here")
    args = ap.parse_args(argv)

    from repro_torch.api import ExperimentSpec, SpmdTrainer
    from repro_torch.launch.mesh import distributed, rank_device, world

    dev = rank_device(args.device)
    # one process group for the three runs
    with distributed(dev):
        rank, n_ranks = world()
        if rank == 0:
            print(f"ranks: {n_ranks}")
            if n_ranks == 1:
                print("hint: launch with torchrun --nproc-per-node 4 to "
                      "exercise real group annealing")
        base = ExperimentSpec(
            arch="xlstm-350m", backend="spmd", mode="hybrid",
            schedule=f"step:{max(1, args.steps // n_ranks)}",
            steps=args.steps, batch=args.batch, seq=args.seq, lr=1e-3,
            smoke=not args.full_100m, log_every=20, seed=0)
        results = {}
        for mode in ("hybrid", "async", "sync"):
            if rank == 0:
                print(f"\n=== mode={mode} ===", flush=True)
            results[mode] = SpmdTrainer(device=dev, verbose=rank == 0).run(
                base.with_(mode=mode))
    if rank == 0:
        print("\n=== final losses ===")
        for mode, res in results.items():
            fin = res.final()
            print(f"{mode:8s} loss={fin['loss']:.4f} "
                  f"(divergence at end: {fin['divergence']:.2e})")
        if args.out:
            with open(args.out, "w") as f:
                json.dump({m: r.to_dict() for m, r in results.items()}, f,
                          indent=2)
            print(f"RunResults saved to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
