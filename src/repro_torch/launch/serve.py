"""Serving entry points, after the reference's ``launch/serve.py``: greedy
decode with a ring-buffer-aware KV cache, plus ``prefill_step``, the
counterpart of the reference's serving prefill
(``launch/dryrun.py:150-154``).

Example:
  python -m repro_torch serve --arch h2o-danube-1.8b --smoke \\
      --batch 4 --prompt-len 32 --gen-len 16 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_NAMES, get_config, \
    smoke_variant
from repro_torch.convert import resolve_device
from repro_torch.models import model as M


def greedy_generate(cfg, params, prompts: np.ndarray, gen_len: int,
                    max_seq: int = 0) -> np.ndarray:
    """prompts: (B, P) int32.  Returns (B, P+gen_len) int32 tokens.

    As the reference does it: the prompt is replayed through
    ``decode_step`` one token at a time (cache-exact), then each new
    token is the argmax of the last logits.  Tokens stay on the device
    until the end."""
    B, P = prompts.shape
    max_seq = max_seq or (P + gen_len)
    dev = params["embed"].device
    cache = M.init_cache(cfg, B, max_seq, device=dev)
    toks = torch.as_tensor(np.ascontiguousarray(prompts), device=dev)
    last = None
    for i in range(P):
        last, cache = M.decode_step(params, cache, toks[:, i:i + 1], i, cfg)
    out = [toks]
    cur = torch.argmax(last, dim=-1).to(torch.int32)
    for j in range(gen_len):
        out.append(cur)
        logits, cache = M.decode_step(params, cache, cur, P + j, cfg)
        cur = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.cat(out, dim=1).cpu().numpy()


def prefill_step(params, batch, cfg) -> torch.Tensor:
    """The full-sequence forward's last-position logits (B, vocab)."""
    logits, _ = M.forward(params, batch, cfg)
    return logits[:, -1]


def add_args(ap: argparse.ArgumentParser) -> None:
    """The serve flags: the reference's, plus the port's ``--device``."""
    ap.add_argument("--arch", choices=ARCH_NAMES, default="h2o-danube-1.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the run executes (default cuda; a host "
                         "without CUDA needs --device cpu)")


def run(args: argparse.Namespace) -> int:
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(smoke_variant(cfg), name=cfg.name)
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name} is encoder-only")
    with torch.inference_mode():
        params = M.init_params(
            torch.Generator(device=dev).manual_seed(args.seed), cfg)
        rng = np.random.default_rng(args.seed)
        prompts = rng.integers(0, cfg.vocab_size,
                               (args.batch, args.prompt_len)
                               ).astype(np.int32)
        t0 = time.time()
        out = greedy_generate(cfg, params, prompts, args.gen_len)
        dt = time.time() - t0
    n_new = args.batch * args.gen_len
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen_len} device={dev}")
    print(f"generated {n_new} tokens in {dt:.2f}s "
          f"({n_new / dt:.1f} tok/s on {dev})")
    print("sample:", out[0, -args.gen_len:].tolist())
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch serve")
    add_args(ap)
    return run(ap.parse_args(argv))
