"""The sliced serving forward (ROADMAP A16c.5) on the card, held against
the same params served whole: what ``chip_smoke.py``'s ``[spmd-tp]``
(four gloo ranks sharing one card, after each run's training) and
``multicard_smoke``'s ``[serve-tp]`` (four cards over NCCL) check.

:func:`sliced_serve` runs on every rank of an initialised process group
of W ranks as data W/M x model M.  Rank 0 first draws the params whole
from one seed on its card and serves the batch whole: a prefill and a
greedy decode at the config's dtype, whose tokens go to every rank;
below float32, the same params drawn in float32 (the same draws, not
rounded) then give the prefill's last-position logits and every step's
logits of the decode fed those tokens.  Then every rank serves its rows
sliced, twice:

* the counted run, at the config's dtype: a rank draws its model slices
  (``models/model.py::init_params`` with ``take``) and keeps their FSDP
  shards over its data column; the kernels' launch counts are set to 0,
  then the prefill and a free-running greedy decode
  (``launch/serve.py::greedy_generate``) run, and the launches, times
  and collective seconds are read after them.  Its tokens' first
  difference from the whole run's is reported;
* the check, in float32: the same slices and shards drawn in float32,
  the prefill's last-position logits and the decode fed the whole run's
  tokens, every step's logits gathered over the vocabulary.  A serving
  run's shards do not change, so under gloo, whose gathers go through
  the host, each is gathered once here (:func:`_gathered_once`); under
  NCCL where it is used, as the counted run does (a card at data 4 x
  model 1 could not hold deepseek's whole float32 params beside its
  shards).  Rank 0 holds the logits to the float32 whole run's within
  :data:`F32_TOL`.

A batch the data positions do not divide (regime (b), ROADMAP A16c.5b:
``long_500k``'s B 1) is served the same way on every row by every rank;
each position's rows are then the whole batch, and every rank's
free-running tokens must be equal.
"""
from __future__ import annotations

import dataclasses
import gc
import subprocess
import time
import types
from typing import Optional

from repro_torch.parallel.partition import map_with_path

# the float32 sliced logits' largest distance from the float32 whole
# run's: the sum orders of the model axis' reductions, the combine and
# the row-parallel matmuls' shapes move them (PERF.md)
F32_TOL = 1e-3


def _counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    return rms.LAUNCHES, fa.LAUNCHES


def _smi_memory_used() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _allocated(torch, dev, peak: bool = False) -> int:
    if dev.type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(dev) if peak \
        else torch.cuda.memory_allocated(dev)


def _reset_peak(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _release(torch, dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _float32(cfg):
    return cfg if cfg.dtype == "float32" \
        else dataclasses.replace(cfg, dtype="float32")


def _serve_whole(torch, params, cfg, T, n_new: int, max_seq: int, dev,
                 fed=None):
    """The prefill's last-position logits, the greedy tokens and every
    decode step's logits of ``params`` served whole on ``dev``; the
    decode fed ``fed``'s tokens (B, P + n_new) when given."""
    from repro_torch.launch.serve import prefill_step
    from repro_torch.models import model as M
    B, P = T.shape
    with torch.no_grad():
        pre = prefill_step(params, {"tokens": T}, cfg).cpu()
        cache = M.init_cache(cfg, B, max_seq, device=dev)
        cols, dec, cur = [T], [], None
        for i in range(P + n_new):
            if i >= P:
                cols.append(cur)
            tok = T[:, i:i + 1] if i < P else cur
            if fed is not None:
                tok = fed[:, i:i + 1]
            logits, _ = M.decode_step(params, cache, tok, i, cfg)
            dec.append(logits[:, 0].cpu())
            cur = torch.argmax(logits, dim=-1).to(torch.int32)
    return pre, torch.stack(dec, 1), torch.cat(cols, 1).cpu().numpy()


def _whole_run(torch, cfg, seed: int, prompts, n_new: int, max_seq: int,
               dev) -> dict:
    """The batch served whole on ``dev``: the greedy tokens at ``cfg``'s
    dtype and what that run added to the card's allocated bytes at its
    peak; the float32 prefill's last-position logits and every step's
    logits of the float32 decode fed those tokens."""
    from repro_torch.models import model as M
    _sync(torch, dev)
    base = _allocated(torch, dev)
    _reset_peak(torch, dev)
    T = torch.as_tensor(prompts, device=dev)

    def draw(c):
        return M.init_params(torch.Generator(device=dev).manual_seed(seed),
                             c)
    params = draw(cfg)
    pre, dec, toks = _serve_whole(torch, params, cfg, T, n_new, max_seq, dev)
    _sync(torch, dev)
    out = {"toks": toks, "pre": pre, "dec": dec,
           "added_peak_bytes": _allocated(torch, dev, peak=True) - base,
           "smi_memory_used": _smi_memory_used() if dev.type == "cuda"
           else None}
    del params
    _release(torch, dev)
    if cfg.dtype != "float32":
        params = draw(_float32(cfg))
        out["pre"], out["dec"], _ = _serve_whole(
            torch, params, _float32(cfg), T, n_new, max_seq, dev,
            torch.as_tensor(toks, device=dev))
        del params
        _release(torch, dev)
    return out


def _draw_sliced(torch, cfg, seed: int, dev, comm, model: int, g: int):
    """A rank's model slices of the params drawn from ``seed`` on ``dev``
    and their FSDP shards over its data column of ``g`` positions:
    ``(params, gather, tp, column)``."""
    from repro_torch.models import model as M
    from repro_torch.parallel.fsdp import GroupShards
    from repro_torch.parallel.tensor import TensorParallel
    tp = TensorParallel(cfg, M.meta_params(cfg), comm) if model > 1 \
        else None
    mine = M.init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                         take=None if tp is None else tp.take)
    if g == 1:
        return mine, None, tp, None
    column = GroupShards(mine, g, comm.position, comm, model)
    return column.shard(mine), column.gather, tp, column


def _gathered_once(gather):
    """``gather`` with each leaf gathered at its first use and kept (by
    its path and storage): a serving run's shards do not change, so the
    later gathers would give the same tensors."""
    held = {}

    def take(path, tree):
        def one(p, leaf):
            key = (p, leaf.data_ptr())
            if key not in held:
                held[key] = gather(p, leaf)
            return held[key]
        return map_with_path(one, tree, path)
    return take


def sliced_serve(cfg, model: int, batch: int, prompt: int, n_new: int,
                 max_seq: int, seed: int = 0, device=None
                 ) -> Optional[dict]:
    """Serve ``batch`` prompts of ``prompt`` tokens (drawn from ``seed``)
    sliced on this process group as data W/``model`` x model ``model``,
    against rank 0's whole run (see above).  Returns, on rank 0, each
    rank's figures and the float32 logits' largest differences; None
    elsewhere."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import Collectives, rank_device, world
    from repro_torch.launch.serve import (data_rows, greedy_generate,
                                          prefill_step)
    from repro_torch.models import model as M
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device(device or "cuda")
    # what a training run before left in this process' allocator
    _release(torch, dev)
    rank, W = world()
    comm = Collectives(dev, model)
    g = W // model
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    whole = _whole_run(torch, cfg, seed, prompts, n_new, max_seq, dev) \
        if rank == 0 else None
    shared = [None if whole is None else whole["toks"]]
    if W > 1:
        dist.broadcast_object_list(shared, src=0)

    # the counted run, at the config's dtype
    t0 = time.perf_counter()
    mine, gather, tp, column = _draw_sliced(torch, cfg, seed, dev, comm,
                                            model, g)
    _sync(torch, dev)
    draw_s = time.perf_counter() - t0
    rows = data_rows(batch, column)
    for counts in _counters():
        for name in counts:
            counts[name] = 0
    before = comm.seconds_by
    _reset_peak(torch, dev)
    with torch.no_grad():
        _sync(torch, dev)
        t0 = time.perf_counter()
        prefill_step(mine, {"tokens": torch.as_tensor(prompts[rows],
                                                      device=dev)},
                     cfg, gather, tp, column, global_batch=batch)
        _sync(torch, dev)
        t1 = time.perf_counter()
        free = greedy_generate(cfg, mine, prompts, n_new, max_seq, gather,
                               tp, column)
        _sync(torch, dev)
        t2 = time.perf_counter()
    after = comm.seconds_by
    launches = {}
    for counts in _counters():
        launches.update(counts)
    figures = {
        "toks": free, "launches": launches, "draw_s": draw_s,
        "routing": None if tp is None or tp.routing is None
        else int(tp.routing), "prefill_s": t1 - t0,
        "decode_ms": 1e3 * (t2 - t1) / (prompt + n_new),
        "collective_s_by_kind": {k: after.get(k, 0.0) - before.get(k, 0.0)
                                 for k in after},
        "peak_bytes": _allocated(torch, dev, peak=True),
        # the slice of the cache a rank holds, as greedy_generate makes it
        "cache_bytes": sum(
            t.numel() * t.element_size() for c in M.init_cache(
                cfg, batch, max_seq, device="meta", tp=tp, data=g)
            for t in c.values())}
    del mine, gather, tp, column
    _release(torch, dev)

    # the check, in float32, fed the whole run's tokens
    f32 = _float32(cfg)
    mine, gather, tp, column = _draw_sliced(torch, f32, seed, dev, comm,
                                            model, g)
    if gather is not None and comm.backend == "gloo":
        gather = _gathered_once(gather)
    toks = torch.as_tensor(shared[0][rows], device=dev)

    def whole_vocab(logits):
        return logits if tp is None else tp.gather(logits, -1)
    with torch.no_grad():
        figures["pre"] = prefill_step(mine, {"tokens": toks[:, :prompt]},
                                      f32, gather, tp, column,
                                      global_batch=batch).cpu()
        cache = M.init_cache(f32, batch, max_seq, device=dev, tp=tp, data=g)
        steps = []
        for i in range(prompt + n_new):
            out, _ = M.decode_step(mine, cache, toks[:, i:i + 1], i, f32,
                                   gather, tp, column, max_seq,
                                   global_batch=batch)
            steps.append(whole_vocab(out)[:, 0].cpu())
        figures["dec"] = torch.stack(steps, 1)
    del mine, gather, tp, column, cache
    _release(torch, dev)
    got = [None] * W if rank == 0 else None
    if W > 1:
        dist.gather_object(figures, got, dst=0)
    else:
        got = [figures]
    if rank != 0:
        return None
    err_pre = err_dec = 0.0
    diverged = None
    for p in range(g):
        r = got[p * model]
        sl = data_rows(batch, types.SimpleNamespace(g=g, rank=p))
        err_pre = max(err_pre, float((r["pre"] - whole["pre"][sl])
                                     .abs().max()))
        err_dec = max(err_dec, float((r["dec"] - whole["dec"][sl])
                                     .abs().max()))
        for k in range(model):
            cols = np.nonzero((got[p * model + k]["toks"]
                               != whole["toks"][sl]).any(0))[0]
            if len(cols):
                first = int(cols[0]) - prompt
                diverged = first if diverged is None else min(diverged,
                                                              first)
    # the ranks serving the same rows: a model group, or (regime (b))
    # every rank
    lead = [0 if batch % g else r - r % model for r in range(W)]
    toks_equal = all(np.array_equal(got[r]["toks"], got[lead[r]]["toks"])
                     for r in range(W))
    keys = ("cache_bytes", "routing", "launches", "draw_s", "prefill_s",
            "decode_ms", "collective_s_by_kind", "peak_bytes")
    return {"by_rank": {k: [r[k] for r in got] for k in keys},
            "max_abs_prefill": err_pre, "max_abs_decode": err_dec,
            "first_divergence": diverged, "toks_equal": toks_equal,
            "whole_added_peak_bytes": whole["added_peak_bytes"],
            "smi_memory_used": whole["smi_memory_used"],
            "logit_max_abs": float(whole["dec"].abs().max()),
            "dtype": cfg.dtype, "tokens": n_new, "prompt": prompt,
            "batch": batch, "model": model, "data": g, "max_seq": max_seq}


def expected_cache_bytes(cfg, batch: int, max_seq: int, cards: int,
                         model: int) -> int:
    """The dry-run's cache a card holds at this serving shape (bytes of
    its tensors, exact): ``launch/dryrun.py``'s sliced decode step."""
    from repro_torch.configs.registry import InputShape
    from repro_torch.launch import dryrun
    _, _, info = dryrun.build_step(
        cfg, InputShape("serve", max_seq, batch, "decode"), cards,
        fsdp=True, model=model)
    return sum(t.numel() * t.element_size()
               for c in info["cache"] for t in c.values())


def check_served(tag: str, sv: dict, cfg, cards: int, model: int) -> int:
    """Hold :func:`sliced_serve`'s figures ``sv`` (``cards`` ranks at
    ``model``): each rank's cache bytes the dry-run's
    (:func:`expected_cache_bytes`), the float32 prefill's and decode's
    logits within :data:`F32_TOL` of the float32 whole run's, the
    free-running tokens equal across the ranks serving the same rows
    (each model group; in regime (b) every rank), and so an MoE's
    routing digests (taken under a model axis: ``model`` > 1), rmsnorm
    launched on every rank and flash on every rank of a model that
    attends.  Raises ``AssertionError`` naming ``tag``; returns the
    cache bytes."""
    from repro_torch.models.config import ATTN, ATTN_GLOBAL, MLA, MOE
    by = sv["by_rank"]
    spread = sv["batch"] % sv["data"] != 0
    want = expected_cache_bytes(cfg, sv["batch"], sv["max_seq"], cards,
                                model)
    if any(b != want for b in by["cache_bytes"]):
        raise AssertionError(f"{tag}: cache bytes by rank "
                             f"{by['cache_bytes']}, the dry-run's {want}")
    if max(sv["max_abs_prefill"], sv["max_abs_decode"]) > F32_TOL:
        raise AssertionError(
            f"{tag}: float32 prefill {sv['max_abs_prefill']}, decode "
            f"{sv['max_abs_decode']} from the whole run, beyond {F32_TOL}")
    if not sv["toks_equal"]:
        raise AssertionError(f"{tag}: the free-running tokens differ "
                             "between ranks serving the same rows")
    routing = by["routing"]
    lead = [0 if spread else r - r % model for r in range(len(routing))]
    if model > 1 and any(f == MOE for _, f in cfg.block_pattern) and (
            None in routing or any(routing[r] != routing[lead[r]]
                                   for r in range(len(routing)))):
        raise AssertionError(f"{tag}: routing digests {routing}")
    attends = any(m in (ATTN, ATTN_GLOBAL, MLA) for m, _ in cfg.block_pattern)
    if not all(r["rmsnorm"] > 0 and (r["flash_attention"] > 0 or not attends)
               for r in by["launches"]):
        raise AssertionError(f"{tag}: launches by rank {by['launches']}")
    return want


def summary(sv: dict, cache_bytes: int) -> str:
    """One line of :func:`sliced_serve`'s figures."""
    by = sv["by_rank"]
    by_kind = by["collective_s_by_kind"]
    return (
        f"{sv['batch']} prompts of {sv['prompt']} tokens, {sv['tokens']} "
        f"new, cache {sv['max_seq']}, data {sv['data']} x model "
        f"{sv['model']}"
        + (" (every row on every rank)" if sv["batch"] % sv["data"] else "")
        + f", {sv['dtype']}; against rank 0's whole run (which "
        f"added {sv['whole_added_peak_bytes']} B to its allocator's peak; "
        f"nvidia-smi read {sv['smi_memory_used']!r} used at its end): "
        f"float32 prefill logits max abs {sv['max_abs_prefill']:.6g}, "
        f"decode fed the whole run's tokens {sv['max_abs_decode']:.6g} "
        f"(held within {F32_TOL}; |logit| up to "
        f"{sv['logit_max_abs']:.4g}); free-running tokens "
        + ("equal to the whole run's" if sv["first_divergence"] is None
           else f"first differ at new token {sv['first_divergence']}")
        + "; every rank's tokens equal to its model group's"
        + (" and to every other rank's" if sv["batch"] % sv["data"] else "")
        + f"; cache {cache_bytes} B a rank = the dry-run's; params drawn "
        f"sliced in {[round(x, 2) for x in by['draw_s']]} s; prefill s "
        f"{[round(x, 3) for x in by['prefill_s']]}; decode ms a step "
        f"{[round(x, 2) for x in by['decode_ms']]} (free-running, prompt "
        f"replay included); launches {by['launches']}; routing "
        f"{by['routing']}; peak GiB "
        f"{[round(b / 2**30, 2) for b in by['peak_bytes']]}; collective s "
        "by kind: " + "; ".join(
            f"{k} {[round(r.get(k, 0.0), 4) for r in by_kind]}"
            for k in sorted(by_kind[0])))
