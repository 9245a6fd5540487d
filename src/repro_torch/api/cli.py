"""``python -m repro_torch`` — the port's CLI.

Subcommands:
  run       execute an ExperimentSpec (flags and/or --spec JSON file) and
            emit a RunResult JSON: ``--backend sim`` (the simulator) or
            ``--backend cluster`` (the wall-clock parameter server with
            worker threads, ``--transport inproc``)
  simulate  alias for ``run --backend sim`` (paper-faithful simulator);
            ``--smoke`` picks a seconds-scale configuration
  serve     greedy decode on a registry model (the model stack's serving
            path: rmsnorm and flash_attention kernels); ``--smoke`` picks
            the reduced same-family config
  schedules list the registered threshold-schedule families

Every run and serve takes ``--device {cuda,cpu}`` (default ``cuda``); without
``--device cpu`` a host with no CUDA is an error, never a CPU run.
The spec and pool flags are those of ``python -m repro``.

Examples:
  python -m repro_torch simulate --smoke
  python -m repro_torch simulate --smoke --device cpu --quiet
  python -m repro_torch serve --arch h2o-danube-1.8b --smoke --device cpu
  python -m repro_torch run --backend sim --arch cnn-cifar --no-smoke \\
      --mode hybrid --schedule step:300 --horizon 2 --out /tmp/r.json
  python -m repro_torch run --backend cluster --arch mlp --device cpu \\
      --cluster-workers 4 --wall-budget 5 --straggler 0:0.1 --kill 1:2 \\
      --respawn-after 0.5 --ckpt-every 1 --ckpt-dir /tmp/ck --quiet
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional

from repro_torch.api.schedules import schedule_help
from repro_torch.api.spec import BACKENDS, FLUSH_MODES, MODES, ExperimentSpec
from repro_torch.cluster.faults import parse_fault_pairs

# CLI flag -> (spec field, type, help).  Every flag defaults to None so
# that only explicitly-passed flags override the --spec file / dataclass
# defaults.
_SPEC_FLAGS = [
    ("--arch", "arch", str, "workload: mlp | cnn-mnist | cnn-cifar"),
    ("--mode", "mode", str, f"one of {MODES}"),
    ("--schedule", "schedule", str,
     'threshold schedule spec, e.g. "step:300"'),
    ("--seed", "seed", int, "RNG seed"),
    ("--lr", "lr", float, "learning rate"),
    ("--batch", "batch", int, "per-gradient batch size"),
    ("--optimizer", "optimizer", str,
     "server-side slab optimizer: sgd (default) | momentum | adamw"),
    ("--beta1", "beta1", float, "momentum decay / AdamW b1 (default 0.9)"),
    ("--beta2", "beta2", float,
     "AdamW second-moment decay b2 (default 0.95)"),
    ("--weight-decay", "weight_decay", float,
     "AdamW decoupled weight decay (default 0)"),
    ("--horizon", "horizon", float, "virtual seconds"),
    ("--sample-every", "sample_every", float, "metric grid spacing"),
    ("--flush-mode", "flush_mode", str, f"one of {FLUSH_MODES}"),
    ("--staleness-decay", "staleness_decay", float,
     "staleness weight decay"),
    ("--cluster-workers", "cluster_workers", int,
     "cluster: worker count (threads)"),
    ("--transport", "transport", str,
     "cluster: worker wire — inproc (threads+queue, the one ported; "
     "socket, proc and host come with ROADMAP A10)"),
    ("--wall-budget", "wall_budget_s", float,
     "cluster: wall-clock training budget (real seconds)"),
    ("--wall-sample-every", "wall_sample_every_s", float,
     "cluster: metric grid spacing (real seconds)"),
    ("--max-gradients", "max_gradients", int,
     "cluster: stop after N applied gradients"),
    ("--slab-dtype", "slab_dtype", str,
     "cluster: gradient/params slab precision on the staging buffer "
     "and the wire — f32 (default) | bf16 (master params and the flush "
     "reduction stay f32)"),
]
# fault-plan flags (cluster backend): merged into spec.faults
_FAULT_FLAGS = [
    ("--straggler", "stragglers", "WID:SECONDS[,WID:SECONDS...]",
     "cluster: extra seconds of delay per gradient for these workers"),
    ("--kill", "kill", "WID:AT_S[,WID:AT_S...]",
     "cluster: kill these workers at the given wall-clock seconds"),
    ("--respawn-after", "respawn_after_s", float,
     "cluster: respawn killed workers after this many seconds"),
    ("--ckpt-every", "checkpoint_every_s", float,
     "cluster: server checkpoint cadence (needs --ckpt-dir)"),
    ("--restore-at", "restore_at_s", float,
     "cluster: restore the latest checkpoint at this wall-clock second"),
]
_POOL_FLAGS = [
    ("--workers", "num_workers", int, "worker count"),
    ("--base-compute", "base_compute", float,
     "seconds per gradient (virtual)"),
    ("--delay-fraction", "delay_fraction", float,
     "fraction of delayed workers"),
    ("--delay-std", "delay_std", float, "delay std (virtual s)"),
]


def _add_spec_flags(ap: argparse.ArgumentParser, backend_flag: bool):
    ap.add_argument("--spec", default=None, metavar="FILE",
                    help="ExperimentSpec JSON file (flags override it)")
    if backend_flag:
        ap.add_argument("--backend", choices=BACKENDS, default=None)
    for flag, dest, typ, hlp in _SPEC_FLAGS + _POOL_FLAGS:
        ap.add_argument(flag, dest=dest, type=typ, default=None, help=hlp)
    for flag, dest, typ, hlp in _FAULT_FLAGS:
        if isinstance(typ, str):     # WID:SECONDS pair lists
            ap.add_argument(flag, dest=f"fault_{dest}", metavar=typ,
                            default=None, help=hlp)
        else:
            ap.add_argument(flag, dest=f"fault_{dest}", type=typ,
                            default=None, help=hlp)
    ap.add_argument("--ckpt-dir", default=None,
                    help="cluster: checkpoint directory")
    ap.add_argument("--resume-from", default=None, metavar="CKPT",
                    help="cluster: restore this checkpoint into the "
                         "server before training (K(t) resumes from the "
                         "restored step)")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=None, help="reduced dataset sizes")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the run executes (default cuda; a host "
                         "without CUDA needs --device cpu)")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="write the full RunResult JSON here")
    ap.add_argument("--save-spec", default=None, metavar="FILE",
                    help="write the resolved ExperimentSpec JSON here")
    ap.add_argument("--quiet", action="store_true",
                    help="print only the result summary")


def _build_spec(args, backend: Optional[str]) -> ExperimentSpec:
    spec = ExperimentSpec.load(args.spec) if args.spec else ExperimentSpec()
    changes = {}
    if backend:
        changes["backend"] = backend
    for _, field, _, _ in _SPEC_FLAGS:
        v = getattr(args, field)
        if v is not None:
            changes[field] = v
    if args.smoke is not None:
        changes["smoke"] = args.smoke
    pool_changes = {f: getattr(args, f) for _, f, _, _ in _POOL_FLAGS
                    if getattr(args, f) is not None}
    if pool_changes:
        changes["pool"] = dataclasses.replace(spec.pool, **pool_changes)
    fault_changes = {}
    for _, field, typ, _ in _FAULT_FLAGS:
        v = getattr(args, f"fault_{field}")
        if v is not None:
            fault_changes[field] = parse_fault_pairs(v) \
                if isinstance(typ, str) else v
    if fault_changes:
        changes["faults"] = dataclasses.replace(spec.faults,
                                                **fault_changes)
    return spec.with_(**changes) if changes else spec


def _summary(result) -> dict:
    d = result.to_dict()
    return {k: d[k] for k in ("backend", "mode", "schedule", "num_updates",
                              "num_gradients", "wall_s", "averaged",
                              "final", "extra")}


def _cmd_run(args, forced_backend: Optional[str] = None) -> int:
    spec = _build_spec(args, forced_backend or getattr(args, "backend",
                                                       None))
    if args.save_spec:
        spec.save(args.save_spec)
    if spec.backend == "cluster":
        from repro_torch.cluster.trainer import ClusterTrainer
        trainer = ClusterTrainer(ckpt_dir=args.ckpt_dir,
                                 resume_from=args.resume_from,
                                 verbose=not args.quiet, device=args.device)
    else:
        from repro_torch.api.trainers import get_trainer
        trainer = get_trainer(spec.backend, device=args.device)
    result = trainer.run(spec)
    if args.out:
        result.save(args.out)
        print(f"full RunResult written to {args.out}", file=sys.stderr)
    if args.out or args.quiet:
        print(json.dumps(_summary(result), indent=2))
    else:
        print(result.to_json())
    return 0


def _cmd_simulate(args) -> int:
    if args.smoke and not args.spec:
        # seconds-scale configuration unless explicitly overridden
        if args.horizon is None:
            args.horizon = 3.0
        if args.num_workers is None:
            args.num_workers = 5
        if args.schedule is None and args.mode in (None, "hybrid"):
            args.schedule = "step:50"
    return _cmd_run(args, forced_backend="sim")


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_run = sub.add_parser("run", help="execute an ExperimentSpec")
    _add_spec_flags(p_run, backend_flag=True)
    p_sim = sub.add_parser("simulate",
                           help="run the paper-faithful simulator backend")
    _add_spec_flags(p_sim, backend_flag=False)
    p_serve = sub.add_parser("serve", help="greedy decode on a registry "
                             "model (prefill replayed through decode)")
    from repro_torch.launch import serve
    serve.add_args(p_serve)
    sub.add_parser("schedules", help="list threshold-schedule families")
    args = ap.parse_args(argv)

    if args.cmd == "serve":
        return serve.run(args)

    if args.cmd in ("run", "simulate"):
        try:
            return _cmd_run(args) if args.cmd == "run" \
                else _cmd_simulate(args)
        except (ValueError, FileNotFoundError) as e:
            # spec/schedule validation and missing --spec files are user
            # errors, not crashes
            print(f"error: {e}", file=sys.stderr)
            return 2
    print("registered threshold-schedule families "
          "(repro_torch.api.parse_schedule):")
    print(schedule_help())
    return 0


if __name__ == "__main__":
    sys.exit(main())
