"""What rematerialisation costs the train step on the card, and where.

    python -m repro_torch.profile_remat [--arch h2o-danube-1.8b]
        [--seq 1024] [--repeats 2] [--out FILE]

Builds the model at its published widths and depth with random weights
(seed 0) and AdamW state, and takes its train step
(``launch/steps.py::make_train_step``, B 1) on one ``--seq``-token batch
in three ways: ``none`` (no remat), ``block`` (the config's remat: each
block group checkpointed, and inside it each 512-row query block of the
attention and each mamba/mLSTM chunk) and ``groups`` (the block groups
alone: ``models/remat.py::on`` is patched to False for this run, so the
mixers' own checkpoints are off; a diagnostic, not a mode of the port).
Each way is warmed twice, then timed ``--repeats`` times in turns
(none, block, groups, then the reverse), then run once more under
``torch.profiler``.  One JSON object per way: the fastest wall seconds,
the step's own peak bytes (above what was allocated before it), the
calls of the attention's score function (``kernels/ref.py::
attention_rows``: one per query block, each two score einsums) in one
step, and the profiled window's device busy time by kernel group, idle
share, top kernels and top host ops.  The profiler slows the host, so
its wall seconds are longer than the timed ones.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from contextlib import contextmanager
from typing import List, Optional
from unittest import mock

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_NAMES, get_config
from repro_torch.kernels import ref
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.models import remat
from repro_torch.optim import adamw
from repro_torch.profile_sim import profiled

WAYS = ("none", "block", "groups")


@contextmanager
def _way(name: str, counter: List[int]):
    """The patches of one way: ``groups`` turns the mixers' checkpoints
    off; every way counts ``attention_rows`` calls in ``counter``."""
    rows = ref.attention_rows

    def counted(*args, **kwargs):
        counter[0] += 1
        return rows(*args, **kwargs)
    with mock.patch.object(ref, "attention_rows", counted):
        if name == "groups":
            with mock.patch.object(remat, "on", lambda cfg: False):
                yield
        else:
            yield


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.profile_remat",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="h2o-danube-1.8b")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out", default=None, metavar="FILE")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_remat needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    opt = adamw(3e-4)
    opt_state = opt.init(params)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                             (1, args.seq)).astype(np.int32),
                                device=dev)
             for k in ("tokens", "labels")}
    steps = {w: make_train_step(dataclasses.replace(
        cfg, remat="none" if w == "none" else "block"), opt) for w in WAYS}
    calls = {w: [0] for w in WAYS}

    def run(w):
        with _way(w, calls[w]):
            out = steps[w](params, opt_state, batch)
            torch.cuda.synchronize()
        return out

    reports = {w: {"way": w, "seconds": [], "attention_rows_calls": None}
               for w in WAYS}
    for w in WAYS:
        for _ in range(2):
            run(w)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        calls[w][0] = 0
        out = run(w)
        reports[w]["step_bytes"] = torch.cuda.max_memory_allocated() - base
        reports[w]["attention_rows_calls"] = calls[w][0]
        del out
    order = list(WAYS) + list(reversed(WAYS))
    for _ in range(args.repeats):
        for w in order:
            t0 = time.perf_counter()
            out = run(w)
            reports[w]["seconds"].append(time.perf_counter() - t0)
            del out
    for w in WAYS:
        out, summary = profiled(lambda: run(w))
        del out
        reports[w].update(min_seconds=min(reports[w]["seconds"]),
                          profiled=summary)
    result = {"arch": args.arch, "seq": args.seq, "batch": 1,
              "card": _card(),
              "ratio_block_over_none": reports["block"]["min_seconds"]
              / reports["none"]["min_seconds"],
              "ratio_groups_over_none": reports["groups"]["min_seconds"]
              / reports["none"]["min_seconds"],
              "ways": [reports[w] for w in WAYS]}
    text = json.dumps(result, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
