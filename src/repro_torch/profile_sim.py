"""Where the simulator's time goes on the card.

    python -m repro_torch.profile_sim [--arch cnn-cifar] [--mode hybrid]
        [--optimizer sgd] [--horizon 1.0] [--out FILE]

Runs one simulator experiment (full-width ``cnn-cifar``, the paper's 25
workers, by default) once to warm up and once under ``torch.profiler``,
then prints one JSON object: wall seconds, gradients and flushes, device
busy time summed by kernel group (the flush kernels, convolutions,
matrix products, other kernels, memory copies and fills), the device's
idle share of the wall time, the top kernels by device time, and the
top host-side PyTorch ops by their own CPU time.  The profiler slows
the host, so wall seconds here are longer than in an unprofiled run.
Needs a CUDA device.
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
_GROUPS = (("flush_", "flush kernels"), ("conv", "convolution"),
           ("cudnn", "convolution"), ("gemm", "matrix product"),
           ("gemv", "matrix product"), ("Memcpy", "memcpy"),
           ("Memset", "memset"))


def _group(name: str) -> str:
    for key, group in _GROUPS:
        if key in name:
            return group
    return "other kernels"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_run(spec: ExperimentSpec) -> Dict:
    trainer = SimulatorTrainer(device="cuda")
    trainer.run(spec.with_(horizon=min(spec.horizon, 0.2)))   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = trainer.run(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_group: Dict[str, float] = defaultdict(float)
    kernels: List = []
    host_ops: List = []
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CPU:
            host_ops.append((evt.self_cpu_time_total, evt.count, evt.key))
            continue
        us = _device_us(evt)
        if us > 0:
            by_group[_group(evt.key)] += us
            kernels.append((us, evt.count, evt.key))
    busy_s = sum(by_group.values()) / 1e6
    kernels.sort(reverse=True)
    host_ops.sort(reverse=True)
    return {
        "device": torch.cuda.get_device_name(0),
        "spec": {"arch": spec.arch, "mode": spec.mode,
                 "optimizer": spec.optimizer, "horizon": spec.horizon,
                 "workers": spec.pool.num_workers, "batch": spec.batch},
        "wall_s": wall, "num_gradients": res.num_gradients,
        "num_updates": res.num_updates,
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


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.profile_sim",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="cnn-cifar")
    ap.add_argument("--mode", default="hybrid")
    ap.add_argument("--schedule", default="step:300")
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--horizon", type=float, default=1.0)
    ap.add_argument("--workers", type=int, default=25)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced dataset sizes")
    ap.add_argument("--out", default=None, metavar="FILE")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_sim needs a CUDA device", file=sys.stderr)
        return 1
    spec = ExperimentSpec(
        arch=args.arch, mode=args.mode, optimizer=args.optimizer,
        schedule=args.schedule if args.mode == "hybrid" else None,
        horizon=args.horizon, smoke=args.smoke,
        pool=WorkerPool(num_workers=args.workers))
    report = profile_run(spec)
    text = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
