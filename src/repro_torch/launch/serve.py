"""Serving entry points, after the reference's ``launch/serve.py``: greedy
decode with a ring-buffer-aware KV cache, plus ``prefill_step``, the
counterpart of the reference's serving prefill
(``launch/dryrun.py:150-154``).

Both also run sliced over a mesh of data positions x model ranks (ROADMAP
A16c.5; the reference lowers them on its mesh in
``src/repro/launch/dryrun.py:150-185``): with ``tp`` a rank holds its
model slices (``parallel/tensor.py``), with ``gather`` their FSDP
shards over its data column (``parallel/fsdp.py``), and ``column`` (the
column's ``GroupShards``) says which batch rows it serves and groups the
MoE's tokens over the column.  The reference's serving shards the batch
over the data axis when it divides it (``tok_spec``,
``src/repro/launch/dryrun.py:167-169``); a batch it does not divide
(``long_500k``'s B 1) is regime (b) (ROADMAP A16c.5b): every rank
serves every row, the MoE groups them as they are, and the decode
cache is cut along its sequence or channels over the data positions
and the model ranks (``parallel/tensor.py::cache_dims``, ``Spread``).

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


def data_rows(batch: int, column=None) -> slice:
    """The batch rows a data position serves: its B/g contiguous rows of
    the column's ``batch`` (all of them without ``column``), or every
    row where the g positions do not divide the batch (regime (b))."""
    g, d = (1, 0) if column is None else (column.g, column.rank)
    if batch % g:
        return slice(0, batch)
    n = batch // g
    return slice(d * n, (d + 1) * n)


def greedy_generate(cfg, params, prompts: np.ndarray, gen_len: int,
                    max_seq: int = 0, gather=None, tp=None,
                    column=None) -> np.ndarray:
    """prompts: (B, P) int32.  Returns (B, P+gen_len) int32 tokens.

    As the reference does it: the prompt is replayed through
    ``decode_step`` one token at a time (cache-exact), then each new
    token is the argmax of the last logits.  Tokens stay on the device
    until the end.  Sliced (``gather``, ``tp``, ``column``; see above) a
    rank serves its data position's rows (:func:`data_rows`: every row
    in regime (b)) from its slice of the cache, and returns those rows'
    tokens, each the argmax over the vocabulary shards
    (``TensorParallel.argmax``)."""
    B, P = prompts.shape
    rows = data_rows(B, column)
    max_seq = max_seq or (P + gen_len)
    dev = params["embed"].device
    g = 1 if column is None else column.g
    cache = M.init_cache(cfg, B, max_seq, device=dev, tp=tp, data=g)
    toks = torch.as_tensor(np.ascontiguousarray(prompts[rows]), device=dev)
    argmax = (lambda t: torch.argmax(t, dim=-1).to(torch.int32)) \
        if tp is None else tp.argmax

    def step(tokens, i):
        return M.decode_step(params, cache, tokens, i, cfg, gather=gather,
                             tp=tp, column=column, max_seq=max_seq,
                             global_batch=B)[0]
    last = None
    for i in range(P):
        last = step(toks[:, i:i + 1], i)
    out = [toks]
    cur = argmax(last)
    for j in range(gen_len):
        out.append(cur)
        cur = argmax(step(cur, P + j))
    return torch.cat(out, dim=1).cpu().numpy()


def prefill_step(params, batch, cfg, gather=None, tp=None, column=None,
                 global_batch: int = 0) -> torch.Tensor:
    """The full-sequence forward's last-position logits (B, vocab).
    Sliced (see above), ``batch`` is a rank's rows (:func:`data_rows` of
    ``global_batch``, which a column of more than one position needs:
    a ``ValueError`` without it) and the logits are gathered whole over
    the vocabulary shards.  Where the positions do not divide
    ``global_batch`` (regime (b)) the rows are every row, replicated,
    and the MoE groups them without the column."""
    if column is not None and M.served_batch(global_batch, column.g) \
            % column.g:
        column = None
    logits, _ = M.forward(params, batch, cfg, gather=gather, tp=tp,
                          column=column)
    last = logits[:, -1]
    return last if tp is None else tp.gather(last, -1)


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
