"""Where a ``proc`` worker process's start-up goes.

    python -m repro_torch.profile_spawn --workers 1 8 25 [--data-cache DIR]

Spawns each fleet size's children together, as ``ProcTransport`` does,
and has each time the steps a worker process takes before its HELLO
(``cluster/mptransport.py::_proc_worker_main`` and
``cluster/hostlink.py::build_slab_worker_fn``): importing torch, opening
the device, importing the port, rebuilding the workload (drawing the
data set, initialising the params), moving its shard to the device, and
its first gradient.  Prints, per fleet and step, the step's seconds
(min, median, max over the children) and when the last child finished
it.  ``--data-cache DIR`` draws the data set once in this process into
``DIR`` (``REPRO_TORCH_DATA_CACHE``, ``data/synthetic.py``), as
``chip_smoke.py`` does, so that the children map it in place of drawing
it.  This module imports torch only inside functions, so a child's
``import torch`` is timed, not paid while unpickling its target.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import List, Optional


def _child(q, wid: int, n: int, device: str, arch: str) -> None:
    marks = [("interpreter up", time.time())]
    import torch
    marks.append(("import torch", time.time()))
    from repro_torch.convert import resolve_device, to_device
    dev = resolve_device(device)
    torch.set_num_threads(1 if dev.type == "cuda" else 2)
    torch.zeros(1, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    marks.append(("open the device", time.time()))
    from repro_torch.api.spec import ExperimentSpec
    from repro_torch.api.trainers import SIM_WORKLOADS
    from repro_torch.cluster.worker import wait_for
    from repro_torch.core.slab import slab_codec
    from repro_torch.data.pipeline import worker_shards
    marks.append(("import repro_torch", time.time()))
    spec = ExperimentSpec(arch=arch, backend="cluster", smoke=False)
    loss_fn, params, data, _ = SIM_WORKLOADS[arch](spec, dev)
    marks.append(("build the workload", time.time()))
    rows = worker_shards(data[0].shape[0], n)[wid]
    x, y = to_device(data[0][rows], dev), to_device(data[1][rows], dev)
    del data
    wait_for(x)
    marks.append(("shard to the device", time.time()))
    codec = slab_codec(params)
    grad_fn = torch.func.grad(loss_fn)
    wait_for(codec.encode(grad_fn(params, x[:32], y[:32])))
    marks.append(("first gradient", time.time()))
    q.put((wid, marks))


def fleet(n: int, device: str, arch: str) -> dict:
    """Spawn ``n`` children together and collect their step times."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    t0 = time.time()
    procs = [ctx.Process(target=_child, args=(q, w, n, device, arch),
                         daemon=True) for w in range(n)]
    for p in procs:
        p.start()
    got: List = []
    try:
        while len(got) < n:
            try:
                got.append(q.get(timeout=1.0))
            except Exception:       # queue.Empty: check on the children
                failed = [p.exitcode for p in procs
                          if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"children exited with {failed}")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    names = [m for m, _ in got[0][1]]
    steps = {}
    for i, name in enumerate(names):
        durs = [marks[i][1] - (marks[i - 1][1] if i else t0)
                for _, marks in got]
        steps[name] = {"min_s": min(durs),
                       "median_s": statistics.median(durs),
                       "max_s": max(durs),
                       "last_done_s": max(m[i][1] for _, m in got) - t0}
    return {"children": n, "steps": steps}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.profile_spawn",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 25])
    ap.add_argument("--arch", default="cnn-cifar")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--data-cache", default=None)
    args = ap.parse_args(argv)
    import os
    import torch
    if args.data_cache:
        from repro_torch.api.spec import ExperimentSpec
        from repro_torch.api.trainers import SIM_WORKLOADS
        from repro_torch.data.synthetic import CACHE_ENV
        os.environ[CACHE_ENV] = args.data_cache
        t0 = time.time()
        SIM_WORKLOADS[args.arch](ExperimentSpec(
            arch=args.arch, backend="cluster", smoke=False),
            torch.device("cpu"))
        print(f"data set drawn into {args.data_cache} in "
              f"{time.time() - t0:.2f} s", flush=True)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("profile_spawn: no CUDA device; pass --device cpu",
              file=sys.stderr)
        return 1
    about = {"device": torch.cuda.get_device_name(0)
             if args.device == "cuda" else "cpu",
             "host_cpus": os.cpu_count(), "arch": args.arch,
             "data_cache": args.data_cache}
    print(json.dumps(about), flush=True)
    for n in args.workers:
        report = fleet(n, args.device, args.arch)
        print(f"--- {n} children spawned together", flush=True)
        for name, s in report["steps"].items():
            print(f"  {name:20s} step s: min {s['min_s']:7.2f} median "
                  f"{s['median_s']:7.2f} max {s['max_s']:7.2f} | last "
                  f"child done at {s['last_done_s']:7.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
