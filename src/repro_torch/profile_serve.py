"""Where the serving path's time goes on the card.

    python -m repro_torch.profile_serve [--arch h2o-danube-1.8b]
        [--batch 4] [--prompt-len 32] [--gen-len 16] [--long 8192]
        [--out FILE]

Builds the model at its published widths and depth with random weights
(seed 0), runs ``greedy_generate`` and ``prefill_step`` (on one
``--long``-token sequence) once to warm up, then once each under
``torch.profiler``, and prints one JSON object per run: wall seconds,
device busy time by kernel group (the rmsnorm and flash_attention
kernels, matrix products, other kernels, copies), the device's idle
share of the wall time, the top kernels and the top host ops.  The
profiler slows the host, so wall seconds here are longer than in an
unprofiled run.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.profile_sim import profiled


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.profile_serve",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="h2o-danube-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--long", type=int, default=8192,
                    help="sequence length of the profiled prefill")
    ap.add_argument("--out", default=None, metavar="FILE")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve needs a CUDA device", file=sys.stderr)
        return 1
    cfg = get_config(args.arch)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)
                           ).astype(np.int32)
    long_batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (1, args.long)).astype(np.int32),
        device=dev)}
    reports = []
    with torch.inference_mode():
        params = M.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
        runs = (
            (f"greedy_generate B={args.batch} prompt={args.prompt_len} "
             f"gen={args.gen_len}",
             lambda: serve.greedy_generate(cfg, params, prompts,
                                           args.gen_len)),
            (f"prefill_step B=1 S={args.long}",
             lambda: serve.prefill_step(params, long_batch, cfg)),
        )
        for label, fn in runs:
            fn()                                   # warm-up
            torch.cuda.synchronize()
            _, report = profiled(fn)
            reports.append({"run": label, "arch": cfg.name, **report})
    text = "\n".join(json.dumps(r) for r in reports)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
