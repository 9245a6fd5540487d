"""``python -m repro_torch`` — the port's CLI.

Subcommands:
  run       execute an ExperimentSpec (flags and/or --spec JSON file) and
            emit a RunResult JSON: ``--backend sim`` (the simulator),
            ``--backend spmd`` (group-annealed data parallelism, one
            rank per process under ``torchrun``; only rank 0 writes
            ``--out`` and prints the result) or
            ``--backend cluster`` (the wall-clock parameter server:
            ``--transport inproc`` worker threads, ``socket`` threads over
            TCP, ``proc`` worker processes on the same device, ``host``
            a leader that binds ``--listen`` and admits ``join`` workers)
  simulate  alias for ``run --backend sim`` (paper-faithful simulator);
            ``--smoke`` picks a seconds-scale configuration
  serve     greedy decode on a registry model (the model stack's serving
            path: rmsnorm and flash_attention kernels); ``--smoke`` picks
            the reduced same-family config.  With ``--listen HOST:PORT``
            it is the multi-host cluster *leader* instead (= ``run
            --backend cluster --transport host``)
  join      join a cluster leader as one or more workers: the spec
            arrives over the wire, the workload is rebuilt here
            (repro_torch.cluster.hostlink)
  infer     connect to a training leader as a read-only serve client:
            stream fresh params and run inference on every pushed
            version (repro_torch.serve)
  top       connect to a training leader as a read-only stats client:
            stream live telemetry (grads/s, staleness p50/p99, ledger)
            without perturbing the run (repro_torch.obs.top)
  trace     run a cluster experiment with tracing on and write a Chrome
            trace-event / Perfetto JSON timeline: sugar for ``run
            --backend cluster --trace FILE``
  dryrun    trace a registry model's train, prefill or decode step on
            the meta device and record per-card FLOPs, bytes moved,
            collective bytes and peak memory for a layout of H100s, with
            nothing run on a card (repro_torch.launch.dryrun)
  schedules list the registered threshold-schedule families

Every run, serve, join and infer takes ``--device {cuda,cpu}`` (default
``cuda``); without ``--device cpu`` a host with no CUDA is an error,
never a CPU run.  The spec and pool flags are those of ``python -m
repro``.  Every entry point shares one logging setup
(:func:`setup_logging`, ``--log-level``, default warning).

Examples:
  python -m repro_torch simulate --smoke
  python -m repro_torch simulate --smoke --device cpu --quiet
  python -m repro_torch serve --arch h2o-danube-1.8b --smoke --device cpu
  python -m repro_torch run --backend sim --arch cnn-cifar --no-smoke \\
      --mode hybrid --schedule step:300 --horizon 2 --out /tmp/r.json
  torchrun --standalone --nproc-per-node 2 -m repro_torch run \\
      --backend spmd --arch xlstm-350m --smoke --steps 8 --mode hybrid \\
      --schedule step:4 --batch 4 --seq 32 --device cpu --out /tmp/r.json
  python -m repro_torch run --backend cluster --arch mlp --device cpu \\
      --cluster-workers 4 --wall-budget 5 --straggler 0:0.1 --kill 1:2 \\
      --respawn-after 0.5 --ckpt-every 1 --ckpt-dir /tmp/ck --quiet
  python -m repro_torch run --backend cluster --arch mlp --device cpu \\
      --transport proc --cluster-workers 2 --wall-budget 4 --kill 1:1 \\
      --respawn-after 0.5 --quiet
  # terminal 1 (leader), terminal 2+ (workers, possibly other machines):
  python -m repro_torch serve --listen 0.0.0.0:5555 --arch mlp \\
      --cluster-workers 2 --wall-budget 30
  python -m repro_torch join LEADER_HOST:5555 --workers 2
  python -m repro_torch infer LEADER_HOST:5555 --requests 8
  python -m repro_torch top LEADER_HOST:5555 --duration 10
  python -m repro_torch dryrun --all --cards 1
  python -m repro_torch trace /tmp/t.json --arch mlp --device cpu \
      --transport proc --cluster-workers 2 --wall-budget 5
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import List, Optional

from repro_torch.api.schedules import schedule_help
from repro_torch.api.spec import BACKENDS, FLUSH_MODES, MODES, ExperimentSpec
from repro_torch.cluster.faults import parse_fault_pairs

_LOG_LEVELS = ("debug", "info", "warning", "error")


def setup_logging(level: Optional[str] = None) -> None:
    """The logging setup every entry point shares: ``repro_torch.*``
    logger names, one line format, stderr.  Idempotent (``basicConfig``
    does nothing once a handler exists), and the level applies to this
    package's loggers only."""
    import logging
    lvl = getattr(logging, (level or "warning").upper(), logging.WARNING)
    logging.basicConfig(
        level=lvl,
        format="%(asctime)s.%(msecs)03d %(name)s %(levelname)s: "
               "%(message)s",
        datefmt="%H:%M:%S", stream=sys.stderr)
    logging.getLogger("repro_torch").setLevel(lvl)


# CLI flag -> (spec field, type, help).  Every flag defaults to None so
# that only explicitly-passed flags override the --spec file / dataclass
# defaults.
_SPEC_FLAGS = [
    ("--arch", "arch", str,
     "workload (sim, cluster: mlp | cnn-mnist | cnn-cifar | lm-tiny | "
     "zoo:xlstm | zoo:transformer; spmd: registry arch)"),
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
    ("--steps", "steps", int, "spmd: optimizer steps"),
    ("--seq", "seq", int, "spmd: sequence length"),
    ("--merge-alpha", "merge_alpha", float, "spmd: partial-merge factor"),
    ("--mesh-model", "mesh_model", int,
     "spmd: the model (tensor-parallel) axis M; M divides the world "
     "size, and M > 1 covers every family without a frontend "
     "(attention, MLA, MLP, MoE, mamba, mLSTM and sLSTM blocks)"),
    ("--log-every", "log_every", int, "spmd: metric logging interval"),
    ("--cluster-workers", "cluster_workers", int,
     "cluster: worker count (threads)"),
    ("--transport", "transport", str,
     "cluster: worker wire — inproc (threads+queue), socket (threads "
     "over TCP slab frames), proc (one process per worker over Unix "
     "sockets; SIGKILL faults) or host (bind --listen and wait for "
     "`repro_torch join` workers, possibly from other machines)"),
    ("--listen", "listen", str,
     "cluster host transport: leader bind address HOST:PORT (port 0 = "
     "pick one; the resolved address is printed and recorded in the "
     "run's events)"),
    ("--wall-budget", "wall_budget_s", float,
     "cluster: wall-clock training budget (real seconds)"),
    ("--wall-sample-every", "wall_sample_every_s", float,
     "cluster: metric grid spacing (real seconds)"),
    ("--max-gradients", "max_gradients", int,
     "cluster: stop after N applied gradients"),
    ("--heartbeat", "heartbeat_s", float,
     "cluster host transport: leader-liveness PING cadence in seconds "
     "(0 disables; workers and serve clients size their hung-leader "
     "watchdog from it)"),
    ("--serve-every", "serve_every", int,
     "serving plane: push every Nth params version to serve clients "
     "(staleness-vs-bandwidth knob; default 1 = every version)"),
    ("--max-workers", "max_workers", int,
     "cluster host transport: elastic admission ceiling — join workers "
     "beyond --cluster-workers grow the fleet while the run goes on, up "
     "to this many ids (default: --cluster-workers, fixed membership)"),
    ("--slab-dtype", "slab_dtype", str,
     "cluster: gradient/params slab precision on the staging buffer "
     "and the wire — f32 (default) | bf16 (master params and the flush "
     "reduction stay f32)"),
    ("--zoo-scale", "zoo_scale", float,
     "zoo:* workloads: width multiplier applied to the registry config "
     "(default 0.25; 1.0 = the full published tier)"),
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
                    help="spmd/cluster: checkpoint directory")
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
    ap.add_argument("--join-secret", default=None, metavar="SECRET",
                    help="cluster host transport: require joiners to "
                         "prove this shared secret (HMAC challenge/"
                         "response on JOIN); an invocation credential, "
                         "never written into the spec (env: "
                         "REPRO_JOIN_SECRET)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="cluster: write a Chrome trace-event / Perfetto "
                         "JSON timeline of the run here (load it in "
                         "ui.perfetto.dev or chrome://tracing)")
    ap.add_argument("--prom-port", type=int, default=None, metavar="N",
                    help="cluster: serve a Prometheus /metrics endpoint "
                         "on this port while the run lasts (live ledger, "
                         "staleness quantiles, wire byte counters; 0 = "
                         "pick a free port, logged as a prom_listening "
                         "event)")
    ap.add_argument("--log-level", choices=_LOG_LEVELS, default=None,
                    help="repro_torch.* logger level (default warning)")


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
    setup_logging(args.log_level)
    spec = _build_spec(args, forced_backend or getattr(args, "backend",
                                                       None))
    if args.save_spec:
        spec.save(args.save_spec)
    trace, prom_port = args.trace, args.prom_port
    if trace and spec.backend != "cluster":
        print(f"warning: --trace records the cluster runtime's "
              f"timeline and does nothing on backend="
              f"{spec.backend!r}; ignoring it", file=sys.stderr)
        trace = None
    if prom_port is not None and spec.backend != "cluster":
        print(f"warning: --prom-port exposes the cluster runtime's "
              f"live stats and does nothing on backend="
              f"{spec.backend!r}; ignoring it", file=sys.stderr)
        prom_port = None
    if spec.backend == "spmd":
        from repro_torch.api.trainers import SpmdTrainer
        trainer = SpmdTrainer(ckpt_dir=args.ckpt_dir,
                              verbose=not args.quiet, device=args.device)
    elif spec.backend == "cluster":
        from repro_torch.cluster.trainer import ClusterTrainer
        trainer = ClusterTrainer(
            ckpt_dir=args.ckpt_dir, resume_from=args.resume_from,
            verbose=not args.quiet,
            join_secret=args.join_secret
            or os.environ.get("REPRO_JOIN_SECRET") or None,
            trace=trace, prom_port=prom_port, device=args.device)
    else:
        from repro_torch.api.trainers import get_trainer
        trainer = get_trainer(spec.backend, device=args.device)
    result = trainer.run(spec)
    if spec.backend == "spmd" and int(os.environ.get("RANK", "0")):
        return 0        # a rank other than 0: rank 0 reports the run
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


def _cmd_join(rest: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch join",
        description="join a cluster leader as one or more workers — the "
                    "experiment spec arrives over the wire in the leader "
                    "handshake, so this host only needs the repro_torch "
                    "package (repro_torch.cluster.hostlink)")
    ap.add_argument("address", metavar="HOST:PORT",
                    help="the leader's listen address "
                         "(serve --listen HOST:PORT)")
    ap.add_argument("--worker-id", type=int, default=None,
                    help="request a specific worker id / data shard "
                         "(default: the leader leases the lowest free "
                         "one)")
    ap.add_argument("--workers", type=int, default=1,
                    help="join this many workers, one OS process each "
                         "(default 1)")
    ap.add_argument("--connect-timeout", "--join-timeout",
                    dest="connect_timeout", type=float, default=60.0,
                    help="keep retrying the leader (refused/busy, with "
                         "jittered backoff) for this many seconds before "
                         "exiting 4 with the leader's reason")
    ap.add_argument("--join-secret", default=None, metavar="SECRET",
                    help="shared secret for a leader started with "
                         "--join-secret (answers its HMAC challenge; "
                         "env: REPRO_JOIN_SECRET)")
    ap.add_argument("--reconnect", dest="reconnect_s", type=float,
                    default=5.0, metavar="SECONDS",
                    help="after a mid-run connection drop, try to rejoin "
                         "the same worker-id lease for this many seconds "
                         "before giving up cleanly (default 5; 0 "
                         "disables)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress join progress logs")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where this host computes its gradients "
                         "(default cuda; a host without CUDA needs "
                         "--device cpu, and exits 2 without it)")
    ap.add_argument("--log-level", choices=_LOG_LEVELS, default=None,
                    help="repro_torch.* logger level (default warning)")
    args = ap.parse_args(rest)
    setup_logging(args.log_level)
    from repro_torch.cluster.hostlink import join_main
    code = join_main(args.address, worker_id=args.worker_id,
                     workers=args.workers,
                     connect_timeout=args.connect_timeout,
                     verbose=not args.quiet,
                     secret=args.join_secret
                     or os.environ.get("REPRO_JOIN_SECRET") or None,
                     reconnect_s=args.reconnect_s, device=args.device)
    sys.stdout.flush()
    sys.stderr.flush()
    # no interpreter teardown: everything is flushed, and unwinding the
    # worker's threads and a CUDA context gains nothing (as a proc child)
    os._exit(code)


def _cmd_infer(rest: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch infer",
        description="read-only serve client: subscribe to a training "
                    "leader's params broadcast and run inference on "
                    "every pushed version (repro_torch.serve); the "
                    "leader's WELCOME carries the spec, so this host "
                    "only needs the repro_torch package")
    ap.add_argument("address", metavar="HOST:PORT",
                    help="the leader's listen address "
                         "(serve --listen HOST:PORT)")
    ap.add_argument("--requests", type=int, default=8,
                    help="run this many inference requests (default 8)")
    ap.add_argument("--duration", type=float, default=None,
                    help="stop after this many seconds even if "
                         "--requests has not been reached")
    ap.add_argument("--batch", type=int, default=2,
                    help="inference batch size (prompts per request)")
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="prompt length in tokens (lm archs)")
    ap.add_argument("--gen-len", type=int, default=8,
                    help="tokens to generate per request (lm archs)")
    ap.add_argument("--connect-timeout", type=float, default=60.0,
                    help="keep retrying the leader for this many "
                         "seconds (the leader may not be up yet)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-request logs")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where inference runs (default cuda; a host "
                         "without CUDA needs --device cpu)")
    ap.add_argument("--log-level", choices=_LOG_LEVELS, default=None,
                    help="repro_torch.* logger level (default warning)")
    args = ap.parse_args(rest)
    setup_logging(args.log_level)
    from repro_torch.serve.client import infer_main
    code = infer_main(args.address, requests=args.requests,
                      duration_s=args.duration, batch=args.batch,
                      prompt_len=args.prompt_len, gen_len=args.gen_len,
                      connect_timeout=args.connect_timeout,
                      verbose=not args.quiet, device=args.device)
    sys.stdout.flush()
    sys.stderr.flush()
    # no interpreter teardown, as for join: everything is flushed, and
    # unwinding a CUDA context's threads gains nothing
    os._exit(code)


def _cmd_top(rest: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch top",
        description="read-only stats client: stream a training leader's "
                    "live telemetry (grads/s, staleness p50/p99, the "
                    "conservation ledger) one line per push, without "
                    "perturbing the run (repro_torch.obs.top)")
    ap.add_argument("address", metavar="HOST:PORT",
                    help="the leader's listen address "
                         "(serve --listen HOST:PORT)")
    ap.add_argument("--count", type=int, default=None,
                    help="stop after this many stats rows")
    ap.add_argument("--duration", type=float, default=None,
                    help="stop after this many seconds")
    ap.add_argument("--connect-timeout", type=float, default=30.0,
                    help="keep retrying the leader for this many "
                         "seconds (the leader may not be up yet)")
    ap.add_argument("--prom-port", type=int, default=None, metavar="N",
                    help="also serve the newest stats push as a "
                         "Prometheus /metrics endpoint on this port "
                         "(0 = pick a free port; printed at start-up)")
    ap.add_argument("--log-level", choices=_LOG_LEVELS, default=None,
                    help="repro_torch.* logger level (default warning)")
    args = ap.parse_args(rest)
    setup_logging(args.log_level)
    # no device and no tensor here: it renders JSON, so a normal return
    from repro_torch.obs.top import top_main
    return top_main(args.address, count=args.count,
                    duration_s=args.duration,
                    connect_timeout=args.connect_timeout,
                    prom_port=args.prom_port)


def _cmd_serve_leader(rest: List[str]) -> int:
    """``serve --listen HOST:PORT``: the multi-host leader, sugar for
    ``run --backend cluster --transport host --listen ...``."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch serve --listen HOST:PORT",
        description="multi-host cluster leader: bind HOST:PORT, wait for "
                    "`repro_torch join` workers, train, report")
    _add_spec_flags(ap, backend_flag=False)
    args = ap.parse_args(rest)
    if args.transport not in (None, "host"):
        # --listen means something only on the host transport: training
        # locally while joiners dial a port nobody bound is the worst
        # failure
        print(f"error: --listen is the host transport's bind address and "
              f"cannot be combined with --transport {args.transport} "
              "(drop --transport, or use `run --backend cluster`)",
              file=sys.stderr)
        return 2
    args.transport = "host"
    try:
        return _cmd_run(args, forced_backend="cluster")
    except (ValueError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "join":
        # dispatched before the main parse (positional HOST:PORT)
        return _cmd_join(argv[1:])
    if argv and argv[0] == "infer":
        return _cmd_infer(argv[1:])
    if argv and argv[0] == "top":
        return _cmd_top(argv[1:])
    if argv and argv[0] == "dryrun":
        from repro_torch.launch import dryrun
        return dryrun.main(argv[1:])
    if argv and argv[0] == "serve" and any(
            a == "--listen" or a.startswith("--listen=") for a in argv[1:]):
        return _cmd_serve_leader(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_run = sub.add_parser("run", help="execute an ExperimentSpec")
    _add_spec_flags(p_run, backend_flag=True)
    p_sim = sub.add_parser("simulate",
                           help="run the paper-faithful simulator backend")
    _add_spec_flags(p_sim, backend_flag=False)
    p_trace = sub.add_parser(
        "trace", help="run a cluster experiment with tracing on and "
                      "write a Perfetto/Chrome trace-event JSON timeline "
                      "(trace FILE [run flags])")
    p_trace.add_argument("tracefile", metavar="FILE",
                         help="trace JSON output path")
    _add_spec_flags(p_trace, backend_flag=False)
    p_serve = sub.add_parser("serve", help="greedy decode on a registry "
                             "model (prefill replayed through decode); "
                             "with --listen HOST:PORT the multi-host "
                             "cluster leader")
    from repro_torch.launch import serve
    serve.add_args(p_serve)
    sub.add_parser("join", help="join a cluster leader as one or more "
                                "workers (join HOST:PORT --workers N)",
                   add_help=False)
    sub.add_parser("infer", help="read-only serve client: stream fresh "
                                 "params from a training leader and run "
                                 "inference (infer HOST:PORT)",
                   add_help=False)
    sub.add_parser("top", help="read-only stats client: stream live "
                               "telemetry from a training leader "
                               "(top HOST:PORT)", add_help=False)
    sub.add_parser("dryrun", help="meta-device dry-run of a registry "
                                  "model's step on a layout of H100s "
                                  "(dryrun --arch A --shape S --cards N)",
                   add_help=False)
    sub.add_parser("schedules", help="list threshold-schedule families")
    args = ap.parse_args(argv)

    if args.cmd == "serve":
        return serve.run(args)

    if args.cmd == "trace":
        # sugar for `run --backend cluster --trace FILE`
        if args.trace is None:
            args.trace = args.tracefile
        try:
            return _cmd_run(args, forced_backend="cluster")
        except (ValueError, FileNotFoundError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
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
