"""Where the simulator's or the cluster's time goes on the card.

    python -m repro_torch.profile_sim [--backend sim] [--arch cnn-cifar]
        [--mode hybrid] [--optimizer sgd] [--horizon 1.0] [--out FILE]
    python -m repro_torch.profile_sim --backend cluster --mode sync
        [--wall-budget 4] [--max-gradients N]

Runs one experiment (full-width ``cnn-cifar``, the paper's 25 workers —
simulated, or worker threads of the in-process cluster — by default)
once to warm up and once under ``torch.profiler``, then prints one JSON
object: wall seconds, gradients and flushes, device busy time summed by
kernel group (the flush kernels, convolutions, matrix products, other
kernels, memory copies and fills), the device's idle share of the wall
time, the top kernels by device time, and the top host-side PyTorch ops
by their own CPU time.  The profiler slows the host, so wall seconds
here are longer than in an unprofiled run.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.api import ExperimentSpec, SimulatorTrainer
from repro_torch.core.simulator import WorkerPool

# kernel-name substring -> group, first match wins
_GROUPS = (("flush_", "flush kernels"), ("rmsnorm", "rmsnorm kernel"),
           ("flash_fwd", "flash_attention kernel"), ("conv", "convolution"),
           ("cudnn", "convolution"), ("gemm", "matrix product"),
           ("gemv", "matrix product"), ("nvjet", "matrix product"),
           ("Memcpy", "memcpy"), ("Memset", "memset"))


def _group(name: str) -> str:
    for key, group in _GROUPS:
        if key in name:
            return group
    return "other kernels"


def _summarize(prof, wall: float) -> Dict:
    """Device time by kernel group, the device's idle share of ``wall``,
    the top kernels and, when host ops were traced, the top host ops of
    one profiled window.  Device time is read from the profiler's raw
    results: turning the hundred thousand kernels of a cluster run into
    ``FunctionEvent`` objects takes seconds."""
    device: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    host: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != torch.autograd.DeviceType.CPU:
            acc = device[evt.name()]
            acc[0] += (evt.end_ns() - evt.start_ns()) / 1e3
            acc[1] += 1
    if ProfilerActivity.CPU in prof.activities:
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CPU:
                acc = host[evt.name]
                acc[0] += evt.self_cpu_time_total
                acc[1] += 1
    by_group: Dict[str, float] = defaultdict(float)
    for name, (us, _) in device.items():
        by_group[_group(name)] += us
    busy_s = sum(by_group.values()) / 1e6
    kernels = sorted(((us, n, name) for name, (us, n) in device.items()),
                     reverse=True)
    host_ops = sorted(((us, n, name) for name, (us, n) in host.items()),
                      reverse=True)
    return {
        "device": torch.cuda.get_device_name(0),
        "wall_s": wall,
        "device_busy_s": busy_s,
        "device_idle_share": max(0.0, 1.0 - busy_s / wall),
        "device_s_by_group": {k: v / 1e6 for k, v in
                              sorted(by_group.items(),
                                     key=lambda kv: -kv[1])},
        "top_kernels": [{"name": name[:120], "calls": n,
                         "device_s": us / 1e6}
                        for us, n, name in kernels[:12]],
        "host_op_self_s": sum(us for us, _, _ in host_ops) / 1e6,
        "top_host_ops": [{"name": name[:120], "calls": n,
                          "self_cpu_s": us / 1e6}
                         for us, n, name in host_ops[:15]],
    }


def profiled(fn, host_ops: bool = True):
    """``fn()`` once under ``torch.profiler``; returns its result and the
    summary of the window.  ``host_ops=False`` traces the device alone,
    which costs the host less."""
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return res, _summarize(prof, wall)


def profile_run(spec: ExperimentSpec) -> Dict:
    if spec.backend == "cluster":
        from repro_torch.cluster.trainer import ClusterTrainer
        trainer = ClusterTrainer(device="cuda")
        # warm-up: the dataset's upload and each worker thread's cuDNN
        # and cuBLAS handles
        trainer.run(spec.with_(wall_budget_s=min(spec.wall_budget_s, 1.0)))
        about = {"workers": spec.cluster_workers,
                 "wall_budget_s": spec.wall_budget_s,
                 "max_gradients": spec.max_gradients}
    else:
        trainer = SimulatorTrainer(device="cuda")
        trainer.run(spec.with_(horizon=min(spec.horizon, 0.2)))
        about = {"workers": spec.pool.num_workers, "horizon": spec.horizon}
    torch.cuda.synchronize()
    res, report = profiled(lambda: trainer.run(spec))
    out = {"spec": {"backend": spec.backend, "arch": spec.arch,
                    "mode": spec.mode, "schedule": spec.schedule,
                    "optimizer": spec.optimizer, "batch": spec.batch,
                    **about},
           "num_gradients": res.num_gradients,
           "num_updates": res.num_updates}
    if spec.backend == "cluster":
        out["training_wall_s"] = res.extra["serve_wall_s"]
        out["accounting"] = res.extra["accounting"]
    return {**out, **report}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.profile_sim",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", choices=("sim", "cluster"), default="sim")
    ap.add_argument("--arch", default="cnn-cifar")
    ap.add_argument("--mode", default="hybrid")
    ap.add_argument("--schedule", default="step:300")
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--horizon", type=float, default=1.0)
    ap.add_argument("--workers", type=int, default=25)
    ap.add_argument("--wall-budget", type=float, default=4.0,
                    help="cluster: wall-clock training budget (s)")
    ap.add_argument("--max-gradients", type=int, default=None,
                    help="cluster: stop after N applied gradients")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced dataset sizes")
    ap.add_argument("--out", default=None, metavar="FILE")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_sim needs a CUDA device", file=sys.stderr)
        return 1
    spec = ExperimentSpec(
        backend=args.backend, arch=args.arch, mode=args.mode,
        optimizer=args.optimizer,
        schedule=args.schedule if args.mode == "hybrid" else None,
        horizon=args.horizon, smoke=args.smoke,
        pool=WorkerPool(num_workers=args.workers),
        cluster_workers=args.workers, wall_budget_s=args.wall_budget,
        wall_sample_every_s=1.0, max_gradients=args.max_gradients)
    report = profile_run(spec)
    text = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
