"""Serving example, a port of ``examples/serve_demo.py``.

Without flags: batched greedy generation through the cache of three
families' reduced same-family configs: h2o-danube-1.8b's ring-buffer
sliding window, deepseek-v2-lite's MLA latent and xlstm-350m's
recurrent state.

  PYTHONPATH=src python -m repro_torch.examples.serve_demo --device cpu

``--live`` runs the whole serving plane in one process instead: an
``lm-tiny`` training leader bound to a loopback port, one joined worker
training against it (a thread), and a read-only
:class:`~repro_torch.serve.ServeClient` that greedy-decodes the same
prompt against three successive pushed params versions.  The tokens
change under the reader's feet as the fleet trains.

  PYTHONPATH=src python -m repro_torch.examples.serve_demo --live --device cpu

On ``cuda`` (the default) the leader, the worker and the client share
the card, and the client's decode runs the rmsnorm kernel.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import threading
import time

import numpy as np
import torch

DEMO_ARCHS = ("h2o-danube-1.8b", "deepseek-v2-lite-16b", "xlstm-350m")


def live_main(device: str = "cuda") -> int:
    from repro_torch.api import ExperimentSpec
    from repro_torch.cluster.hostlink import run_joined_worker
    from repro_torch.cluster.trainer import ClusterTrainer
    from repro_torch.serve.client import ServeClient
    from repro_torch.serve.workload import build_infer_adapter

    spec = ExperimentSpec(
        arch="lm-tiny", backend="cluster", mode="async", smoke=True,
        cluster_workers=1, wall_budget_s=45.0, wall_sample_every_s=45.0,
        batch=16, transport="host", listen="127.0.0.1:0")
    trainer = ClusterTrainer(device=device)
    runtime = trainer.build_runtime(spec)
    addr = runtime.listen_address
    print(f"[demo] leader on {addr[0]}:{addr[1]} ({device}) — one worker "
          "joining, one read-only serve client subscribing", flush=True)

    result = {}
    leader = threading.Thread(
        target=lambda: result.update(res=trainer.finish(runtime, spec)),
        daemon=True)
    leader.start()
    worker = threading.Thread(
        target=run_joined_worker, args=(addr,),
        kwargs={"connect_timeout": 60.0, "verbose": False,
                "device": device}, daemon=True)
    worker.start()

    client = ServeClient(addr, device=device)
    adapter = build_infer_adapter(spec, batch=1, prompt_len=6, gen_len=8,
                                  device=device)
    try:
        last = -1
        for i in range(3):
            msg = client.wait_params(min_version=last + 1, timeout=30.0)
            if msg is None:
                print("[demo] no fresh params within 30s — leader gone?")
                return 1
            last = msg.version
            out = adapter.run(adapter.decode(msg.params), i)
            print(f"[demo] generation {i + 1}: params v{msg.version} — "
                  f"{adapter.summary(out)}", flush=True)
            time.sleep(1.0)      # let training move the params
    finally:
        client.close()
    print("[demo] the same prompt, three params versions: serving reads "
          "a live training run.", flush=True)
    runtime.server.done.set()    # demo over: wrap the run up early
    leader.join(timeout=90.0)
    worker.join(timeout=30.0)
    res = result.get("res")
    if res is None:
        print("[demo] the leader did not finish")
        return 1
    print(f"[demo] training report: {res.num_gradients} gradients "
          f"applied, serving {res.extra['serving']}", flush=True)
    return 0


def main(device: str = "cuda") -> int:
    from repro_torch.configs.registry import get_config, smoke_variant
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import model as M

    dev = torch.device(device)
    for arch in DEMO_ARCHS:
        cfg = dataclasses.replace(smoke_variant(get_config(arch)),
                                  name=arch)
        kinds = sorted({m for m, _ in cfg.block_pattern})
        with torch.inference_mode():
            params = M.init_params(
                torch.Generator(device=dev).manual_seed(0), cfg)
            prompts = np.random.default_rng(0).integers(
                0, cfg.vocab_size, (2, 12)).astype(np.int32)
            t0 = time.time()
            out = greedy_generate(cfg, params, prompts, gen_len=8)
            dt = time.time() - t0
        print(f"{arch:24s} mixers={kinds} out_shape={out.shape} "
              f"{16 / dt:5.1f} tok/s  sample={out[0, -8:].tolist()}")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_demo")
    ap.add_argument("--live", action="store_true",
                    help="serve a live lm-tiny training run instead")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where everything runs (default cuda; a host "
                         "without CUDA needs --device cpu)")
    args = ap.parse_args()
    from repro_torch.convert import resolve_device
    resolve_device(args.device)
    sys.exit(live_main(args.device) if args.live else main(args.device))
