"""Dry-run: trace every (architecture x input shape x layout of H100s) on
the ``meta`` device and record per-card FLOPs, bytes moved, collective
bytes and peak memory, without running anything on a card.  The
counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles against forced host devices.

Usage:
  python -m repro_torch dryrun --arch qwen1.5-110b --shape train_4k
  python -m repro_torch dryrun --all --cards 1
  python -m repro_torch dryrun --arch xlstm-350m --cards 8 \\
      --hybrid-rep 4            # group-annealed hybrid step, R groups
  python -m repro_torch dryrun --arch phi4-mini-3.8b --shape train_4k \\
      --cards 4 --model 2       # data 2 x model 2
  python -m repro_torch dryrun --arch deepseek-v2-lite-16b \\
      --shape train_4k --cards 4 --model 4     # MLA + MoE, model 4

A layout is ``--cards N`` H100s: N/M on the data axis and ``--model M``
on the model axis (default 1; M > 1 covers every family without a
frontend, ``parallel/tensor.py``), with ``--hybrid-rep R`` groups of
N/(M R) data positions for the group-annealed step.  Each record holds
two layouts side by side:

* ``spmd_whole_replica``: every card holds its replica whole (params,
  AdamW moments, the decode cache of its batch rows) and a train step
  all-reduces one float32 gradient slab over its group;
* ``fsdp_partition_rules``: the reference's layout, which the SPMD
  driver runs (``parallel/fsdp.py``): params, moments and cache sharded
  over the group's cards by ``parallel/partition.py``.  With more than
  one card a train step's peak and collectives are traced through the
  FSDP step itself: each part gathered where it is used (a
  rematerialised group again in its recompute), each gradient
  reduce-scattered in float32, the whole leaves' gradients all-reduced,
  the update on the shards; with ``--model M`` > 1 on a card's model
  slices, its tensor all-reduces, all-gathers and reduce-scatters
  counted from its calls (``tensor all-reduce``, ``tensor all-gather``,
  ``tensor reduce-scatter``; a recurrence's, its chunks' all-reduces
  among them, from three trip counts, ``launch/cost.py``) and an MoE
  layer's
  one-hot dispatch and combine traced over the card's E/M experts.  A
  serving step at a batch the data axis divides is traced through the
  sliced prefill or decode (ROADMAP A16c.5): one card's model slices
  and FSDP shards, its batch rows and its slice of the cache
  (``parallel/tensor.py::cache_dims``), its collectives counted from
  its calls, the split-softmax combines, the greedy token's gather and
  the MoE's counts apart (``combine all-gather``, ``argmax all-gather``,
  ``routing all-gather``); the cache a card holds sits beside the
  rule's (``cache_bytes_rule``).  At a batch the data axis does not
  divide (``long_500k`` at data > 1, regime (b), ROADMAP A16c.5b) the
  decode is traced the same way on every row, the cache cut along its
  sequence or channels over data x model, the recurrences' per-step
  gathers and sums over the replica group and the data column counted
  apart (``state all-gather``, ``state all-reduce``) and the combines
  over the data column or the replica group with the others.

Collective bytes are what each card sends on a ring: ``2 (g-1)/g`` of
the bytes for an all-reduce over g cards, ``(g-1)/g`` for an all-gather
or a reduce-scatter.  Activations are traced for the per-card batch
through the code the port runs (``launch/cost.py``): train is the plain,
differentiable forward, its gradient (``core/gradient.py``) and the
AdamW update (``launch/steps.py::make_train_step``), rematerialised as
the config says (every registry config's ``remat`` is ``"block"``) or
as ``--remat none|block`` overrides it, as the reference's ``--remat``
does; the record says which.  Under remat the backward's recomputed
forward ops are counted, as the reference's HLO count includes them,
and the peak is what the checkpoints leave live.  Prefill and decode
are the serving forward through the kernels' meta routes.  A model that
does not fit is a result (``fits: false`` and the bytes it would need),
not an error.  ``--mesh pod|multipod`` (a 16-wide ``model`` axis over
every family) is refused (ROADMAP A16c), as are ``--q-block`` (ROADMAP
C.10) and any ``--remat`` but ``none`` and ``block``.

Results are JSON files under ``experiments/dryrun_torch/`` (not the
reference's ``experiments/dryrun/``), reused unless ``--force``, each
named by the remat it was taken with (``..._remat-<value>.json``: the
config's unless ``--remat`` overrides it).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.registry import (ARCH_NAMES, SHAPES, get_config,
                                          input_specs, shape_applicable)
from repro_torch.convert import tree_leaves
from repro_torch.launch import cost as C
from repro_torch.launch.serve import prefill_step
from repro_torch.launch.steps import (card_memory_bytes, chained,
                                      derive_microbatch, make_train_step)
from repro_torch.models import model as M
from repro_torch.models.config import MOE
from repro_torch.models.model import meta_params
from repro_torch.optim import adamw
from repro_torch.parallel.fsdp import GroupShards
from repro_torch.parallel.partition import (cache_shardings,
                                            opt_state_shardings,
                                            param_shardings)
from repro_torch.parallel.tensor import TensorParallel, check_model_axis

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12,    # dense tensor cores
              torch.float32: 67e12}      # outside the tensor cores
# the serving collectives counted apart (``parallel/tensor.py``): the
# split-softmax combines, the greedy token over the vocabulary shards,
# the MoE's per-group counts over the data column (``parallel/fsdp.py``),
# regime (b)'s recurrent states and channels over the replica group and
# the data column (``Spread``)
SERVE_KINDS = ("combine", "argmax", "routing", "state")
SPMD = "spmd_whole_replica"
FSDP = "fsdp_partition_rules"


def bound_seconds(flops: float, nbytes: float, dtype) -> float:
    """The least time an H100 could take: bytes over the memory rate or
    operations over the peak rate of the model's dtype, the larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def _check_mesh(mesh_kind: Optional[str]) -> None:
    if mesh_kind is not None:
        raise ValueError(
            f"--mesh {mesh_kind}: a 16-wide model axis over every family "
            "is ROADMAP A16c.6; the port's layouts are --cards N with "
            "--model M")


def _per_card_batch(B: int, g: int) -> int:
    """Batch rows a card takes: split over the data axis when it divides,
    else replicated (long_500k's B 1), as the reference's batch
    shardings do."""
    return B // g if B % g == 0 else B


class _CountingComm:
    """The collectives of a traced FSDP step (``parallel/fsdp.py``) and
    of its model axis (``parallel/tensor.py``; ``model`` ranks, this
    card at model index 0): nothing moves, the tensors being meta; each
    call's bytes a card sends on a ring are counted by kind.  A tensor
    all-reduce timed as ``"gradient"`` (once a step) counts with the
    whole leaves' ``all-reduce``."""

    def __init__(self, model: int = 1):
        self.model, self.k = model, 0
        self.kind = None
        self.reset()

    def reset(self) -> None:
        self.bytes = {"all-gather": 0.0, "reduce-scatter": 0.0,
                      "all-reduce": 0.0, "tensor all-reduce": 0.0,
                      "tensor all-gather": 0.0,
                      "tensor reduce-scatter": 0.0}

    @contextlib.contextmanager
    def timing(self, kind):
        outer, self.kind = self.kind, kind
        try:
            yield
        finally:
            self.kind = outer

    def model_all_reduce_(self, t):
        key = "all-reduce" if self.kind == "gradient" \
            else "tensor all-reduce"
        self.bytes[key] += 2 * _nbytes(t) * _ring(self.model)

    def _add(self, key: str, n: float) -> None:
        self.bytes[key] = self.bytes.get(key, 0.0) + n

    def model_all_gather_(self, out, t):
        key = f"{self.kind} all-gather" if self.kind in SERVE_KINDS \
            else "tensor all-gather"
        self._add(key, _nbytes(out) * _ring(self.model))

    def model_reduce_scatter_(self, out, t):
        self.bytes["tensor reduce-scatter"] += _nbytes(t) \
            * _ring(self.model)

    def all_gather_(self, out, t, g):
        key = f"{self.kind} all-gather" if self.kind in SERVE_KINDS \
            else "all-gather"
        self._add(key, _nbytes(out) * _ring(g))

    def reduce_scatter_(self, out, t, g):
        self.bytes["reduce-scatter"] += _nbytes(t) * _ring(g)

    def all_reduce_sum_(self, t, g):
        self.bytes["all-reduce"] += 2 * _nbytes(t) * _ring(g)

    def replica_all_gather_(self, out, t, g):
        self._add(f"{self.kind} all-gather", _nbytes(out)
                  * _ring(g * self.model))

    def replica_all_reduce_(self, t, g):
        self._add(f"{self.kind} all-reduce", 2 * _nbytes(t)
                  * _ring(g * self.model))


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def build_step(arch, shape, cards: int = 1, microbatch: int = 1,
               accum_dtype: str = "float32", hybrid_rep: int = 1,
               fsdp: bool = False, optimizer=None, model: int = 1):
    """``(fn, args, info)``: the step a card runs, on meta tensors.
    ``arch`` is a registry name or a ``ModelConfig``, ``shape`` a name in
    ``SHAPES`` or an ``InputShape``.  ``info`` has the config, the
    per-card batch and the state trees.  With ``fsdp`` a train step is
    the FSDP layout's (``parallel/fsdp.py``) over the group's cards:
    params and optimizer state are one card's shards, the forward
    gathers each part where it is used and the backward
    reduce-scatters; with ``model`` M > 1 they are the shards of a
    card's model slices, and the forward and backward run the tensor
    collectives (``parallel/tensor.py``); ``info["comm"]`` counts its
    collective bytes.  The cards are ``cards / model`` data positions,
    ``hybrid_rep`` groups of them; the batch is split over the
    positions.  ``optimizer`` is the train step's (default AdamW, lr
    3e-4)."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if model < 1 or cards % model:
        raise ValueError(f"--model {model} must divide --cards {cards}")
    check_model_axis(cfg, model)
    data = cards // model
    if data % hybrid_rep:
        raise ValueError(f"--hybrid-rep {hybrid_rep} must divide the "
                         f"{data} data positions of --cards {cards}")
    b = _per_card_batch(shape.global_batch, data)
    specs = input_specs(cfg, shape, batch_override=b)
    params = meta_params(cfg)
    info = {"cfg": cfg, "per_card_batch": b, "params": params,
            "group": data // hybrid_rep, "model": model}
    sliced = fsdp and (info["group"] > 1 or model > 1)
    if shape.kind == "train":
        if b % microbatch:
            raise ValueError(f"microbatch {microbatch} does not divide the "
                             f"per-card batch {b}")
        opt = optimizer or adamw(3e-4)
        kw = {}
        if sliced:
            params, tp, sharding = _card_slices(cfg, params, info, model)
            reduce = []
            if tp is not None:
                kw["tensor"] = tp
                if tp.partial:
                    reduce.append(tp.sum_partial)
            if sharding is not None:
                kw["gather"] = sharding.gather
                if any(f == MOE for _, f in cfg.block_pattern):
                    kw["column"] = sharding
                reduce.append(sharding.group_mean)
            kw["reduce_grads"] = chained(reduce)
        opt_state = opt.init(params)
        info["opt_state"] = opt_state
        step = make_train_step(cfg, opt, microbatch=microbatch,
                               accum_dtype=getattr(torch, accum_dtype),
                               **kw)
        if "comm" in info:
            counted = step

            def step(*args):
                # an analysis may trace the step twice: count the last
                info["comm"].reset()
                return counted(*args)
        return step, (params, opt_state, specs["batch"]), info
    # serving: whole on each card, or (sliced) a card's model slices and
    # FSDP shards, its batch rows and its slice of the cache (ROADMAP
    # A16c.5; every row where the data axis does not divide the batch,
    # regime (b), A16c.5b)
    kw, tp = {}, None
    if sliced:
        params, tp, sharding = _card_slices(cfg, params, info, model)
        kw = {"tp": tp, "column": sharding,
              "gather": None if sharding is None else sharding.gather}

    def counted():
        if sliced:
            info["comm"].reset()
    if shape.kind == "prefill":
        def prefill(params, batch):
            counted()
            with torch.no_grad():
                return prefill_step(params, batch, cfg,
                                    global_batch=shape.global_batch, **kw)
        return prefill, (params, specs["batch"]), info
    info["cache"] = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 device="meta", tp=tp, data=info["group"]) \
        if sliced else specs["cache"]
    cur_index = specs["cur_index"]

    def serve_step(params, cache, tokens):
        counted()
        with torch.no_grad():
            logits, cache = M.decode_step(params, cache, tokens, cur_index,
                                          cfg, max_seq=shape.seq_len,
                                          global_batch=shape.global_batch,
                                          **kw)
            tok = torch.argmax(logits, dim=-1).to(torch.int32) \
                if tp is None else tp.argmax(logits)
            return tok, cache
    return serve_step, (params, info["cache"], specs["tokens"]), info


def _card_slices(cfg, params, info, model: int):
    """A card's state of the whole ``params`` at ``info``'s data column
    of ``info["group"]`` positions x ``model``: ``(params, tp,
    sharding)``, its model slices (``tp``, a ``TensorParallel``, None at
    M 1) and their FSDP shards (``sharding``, a ``GroupShards``, None at
    one position).  ``info["comm"]`` counts their collectives."""
    comm = info["comm"] = _CountingComm(model)
    tp = sharding = None
    if model > 1:
        tp = TensorParallel(cfg, params, comm)
        params = tp.slice(params)
    if info["group"] > 1:
        sharding = GroupShards(params, info["group"], 0, comm, model)
        params = sharding.shard(params)
    return params, tp, sharding


def _ring(g: int) -> float:
    return (g - 1) / g


def _layouts(shape, info, report: C.Report, traced=None
             ) -> Dict[str, Any]:
    """Per-card state, peak and collectives in both layouts.  ``traced``
    is ``(report, info)`` of the FSDP layout's own train or serving step
    (:func:`build_step` with ``fsdp``), whose peak and collectives are
    then the traced ones; a traced serving step's cache bytes are what
    the card holds, beside the rule's (``cache_bytes_rule``)."""
    g = info["group"]
    params = info["params"]
    mesh = {"data": g, "model": info["model"]}
    state = {"params": params}
    if "opt_state" in info:
        state["opt_state"] = info["opt_state"]
    if "cache" in info:
        state["cache"] = info["cache"]
    whole = {k: C.tree_bytes(v) for k, v in state.items()}

    # fsdp: shard shapes from the partition rules
    def shard_bytes(shards, tree):
        return sum(C.alloc_bytes(_numel(s) * t.element_size())
                   for s, t in zip(_shape_leaves(shards), tree_leaves(tree)))
    p_sh = param_shardings(params, mesh)
    sharded = {"params": shard_bytes(p_sh, params)}
    if "opt_state" in info:
        sharded["opt_state"] = shard_bytes(
            opt_state_shardings(info["opt_state"], params, mesh),
            info["opt_state"])
    if "cache" in info:
        # the spmd cache holds the card's rows; the fsdp one is the
        # global batch's cache, sharded by the rules
        full = M.init_cache(info["cfg"], shape.global_batch, shape.seq_len,
                            device="meta")
        sharded["cache"] = rule_cache = shard_bytes(
            cache_shardings(full, shape.global_batch, mesh), full)
        if traced is not None:
            sharded["cache"] = C.tree_bytes(traced[1]["cache"])
    spmd_coll = {"all-reduce": 2 * 4 * _num_params(params) * _ring(g)
                 if shape.kind == "train" else 0.0}
    spmd_peak = report.peak_bytes
    if traced is not None:
        f_report, f_info = traced
        counted = f_info["comm"].bytes
        m = f_info["microbatch"]
        fsdp_peak = f_report.peak_bytes
        # a micro-batch's collectives, m times; the gradient's once
        fsdp_coll = {k: v * (1 if k == "all-reduce" else m)
                     for k, v in counted.items()}
    else:
        # a serving step (or one card): the held state shrinks to its
        # shards and one group's layer is gathered whole at a time, each
        # sharded leaf once
        ag = sum(leaf.numel() * leaf.element_size() * _ring(g)
                 for shard, leaf in zip(_shape_leaves(p_sh),
                                        tree_leaves(params))
                 if _numel(shard) < leaf.numel())
        gathered = max(sum(C.alloc_bytes(t[0].numel() * t.element_size())
                           for t in tree_leaves(grp))
                       for grp in params["groups"]) if g > 1 else 0
        fsdp_peak = report.phases["start"]["peak"] - sum(whole.values()) \
            + sum(sharded.values()) + gathered
        if "update" in report.phases:
            fsdp_peak = max(fsdp_peak, report.phases["update"]["peak"])
        fsdp_coll = {"all-gather": ag, "reduce-scatter": 0.0,
                     "all-reduce": 0.0}
    out = {}
    for name, st, peak, coll in (
            (SPMD, whole, spmd_peak, spmd_coll),
            (FSDP, sharded, fsdp_peak, fsdp_coll)):
        out[name] = {
            "state_bytes": st, "state_bytes_total": sum(st.values()),
            "peak_bytes": int(peak),
            "collective_bytes_per_device": {"total": sum(coll.values()),
                                            **coll}}
    out[FSDP]["mesh"] = mesh
    if "cache" in info:
        out[FSDP]["cache_bytes_rule"] = rule_cache
    if traced is not None and shape.kind == "train":
        out[FSDP]["peak_traced"] = (
            "the FSDP train step traced on one card's shards: each part "
            "gathered where it is used, the backward's reduce-scatters, "
            "the tensor collectives of the model axis, the update on the "
            "shards; collectives counted from its calls")
    elif traced is not None:
        out[FSDP]["peak_traced"] = (
            f"the sliced {shape.kind} step traced on one card's model "
            "slices and FSDP shards (each part gathered where it is used), "
            "its batch rows and its slice of the cache; collectives "
            "counted from its calls (ROADMAP A16c.5)")
    else:
        out[FSDP]["peak_is_estimate"] = (
            "the traced peak with the held state replaced by its shards "
            "plus one group's layer gathered whole")
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _shape_leaves(tree):
    """Leaves of a tree whose leaves are shape tuples."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _shape_leaves(v)]
    if isinstance(tree, list) or (isinstance(tree, tuple) and tree
                                  and not isinstance(tree[0], int)):
        return [x for v in tree for x in _shape_leaves(v)]
    return [tree]


def _num_params(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def analyze_step(arch, shape, cards: int = 1, microbatch: int = 1,
                 accum_dtype: str = "float32", hybrid_rep: int = 1,
                 fsdp: bool = False, optimizer=None, model: int = 1):
    """``(Report, info)`` of the step :func:`build_step` builds."""
    fn, args, info = build_step(arch, shape, cards, microbatch, accum_dtype,
                                hybrid_rep, fsdp, optimizer, model)
    info["microbatch"] = microbatch
    _, report = C.analyze(fn, *args)
    return report, info


def fsdp_layout(arch, shape, cards: int, microbatch: int = 1,
                hybrid_rep: int = 1, optimizer=None, model: int = 1
                ) -> Dict[str, Any]:
    """The ``fsdp_partition_rules`` layout of one train step (per-card
    state bytes, peak, collective bytes), its peak traced through the
    FSDP step over ``{"data": cards // model, "model": model}`` with
    ``hybrid_rep`` groups: what a card of the SPMD trainer's phase holds.
    ``shape`` may be an ``InputShape`` of the caller's (a smoke run's
    own batch and length)."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    report, info = analyze_step(arch, shape, cards, microbatch,
                                hybrid_rep=hybrid_rep, optimizer=optimizer,
                                model=model)
    traced = analyze_step(arch, shape, cards, microbatch,
                          hybrid_rep=hybrid_rep, fsdp=True,
                          optimizer=optimizer, model=model) \
        if info["group"] > 1 or model > 1 else None
    return _layouts(shape, info, report, traced)[FSDP]


def run_one(arch: str, shape_name: str, mesh_kind: Optional[str] = None,
            remat: Optional[str] = None, q_block: Optional[int] = None,
            microbatch: Optional[int] = None, accum_dtype: str = "float32",
            tag: str = "", cards: int = 1,
            hybrid_rep: int = 1, model: int = 1) -> Dict[str, Any]:
    """One record.  ``remat`` overrides the config's (None keeps it).
    ``model`` M > 1: the cards are data N/M x model M (a frontend is
    skipped, naming A16c), the micro-batch derived from the traced
    tensor-parallel step's peak."""
    _check_mesh(mesh_kind)
    _check_flags(remat, q_block)
    cfg = get_config(arch)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    shape = SHAPES[shape_name]
    result: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                              "mesh": "card", "cards": cards,
                              "model": model, "hybrid_rep": hybrid_rep,
                              "tag": tag}
    ok, why = shape_applicable(cfg, shape)
    if ok and (cards % model or model < 1):
        raise ValueError(f"--model {model} must divide --cards {cards}")
    try:
        check_model_axis(cfg, model)
    except ValueError as e:
        ok, why = False, str(e)
    if not ok:
        return {**result, "status": "skipped", "reason": why}
    card_bytes = card_memory_bytes("meta")
    result.update({"remat": cfg.remat, "accum_dtype": accum_dtype,
                   "card_memory_bytes": card_bytes})
    t0 = time.time()
    try:
        traced = None
        if shape.kind == "train" and microbatch is None:
            b = _per_card_batch(shape.global_batch, cards // model)
            reports, tp_reports = {}, {}

            def peak_of(m):
                reports[m] = analyze_step(cfg, shape_name, cards, m,
                                          accum_dtype, hybrid_rep,
                                          model=model)
                if model == 1:
                    return reports[m][0].peak_bytes
                # the model axis: what a card of it holds
                tp_reports[m] = analyze_step(cfg, shape_name, cards, m,
                                             accum_dtype, hybrid_rep,
                                             fsdp=True, model=model)
                return tp_reports[m][0].peak_bytes
            microbatch, _ = derive_microbatch(b, peak_of, card_bytes)
            report, info = reports[microbatch]
            traced = tp_reports.get(microbatch)
            result["microbatch_derived"] = True
        else:
            microbatch = microbatch or 1
            report, info = analyze_step(cfg, shape_name, cards,
                                        microbatch, accum_dtype, hybrid_rep,
                                        model=model)
        if traced is None and (info["group"] > 1 or model > 1):
            traced = analyze_step(cfg, shape_name, cards, microbatch,
                                  accum_dtype, hybrid_rep, fsdp=True,
                                  model=model)
        layouts = _layouts(shape, info, report, traced)
        dtype = getattr(torch, cfg.dtype)
        spmd = layouts[SPMD]
        result.update({
            "status": "ok",
            "microbatch": microbatch,
            "per_card_batch": info["per_card_batch"],
            "num_params": _num_params(info["params"]),
            "analysis_s": round(time.time() - t0, 2),
            "flops_per_device": report.cost.flops,
            "hbm_bytes_per_device": report.cost.hbm_bytes,
            "collective_bytes_per_device":
                spmd["collective_bytes_per_device"],
            "kernels": report.kernels,
            "aten_ops": report.ops,
            "memory": {"held_bytes": report.held_bytes,
                       "step_bytes": report.step_bytes,
                       "peak_bytes": report.peak_bytes,
                       "phases": report.phases},
            "peak_bytes_per_device": spmd["peak_bytes"],
            "fits": spmd["peak_bytes"] <= card_bytes,
            "bound_s": bound_seconds(report.cost.flops,
                                     report.cost.hbm_bytes, dtype),
            "layouts": layouts,
        })
        for lay in layouts.values():
            lay["fits"] = lay["peak_bytes"] <= card_bytes
        if not result["fits"]:
            result["needs_bytes"] = spmd["peak_bytes"]
    except Exception as e:  # noqa: BLE001 — record the failure verbatim
        result.update({"status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()[-2000:]})
    return result


def run_hybrid_one(arch: str, rep: int, cards: int,
                   microbatch: Optional[int] = None,
                   tag: str = "", remat: Optional[str] = None,
                   model: int = 1) -> Dict[str, Any]:
    """The group-annealed hybrid train step (train_4k) with ``rep``
    replica groups of ``cards // (model * rep)`` data positions:
    gradients reduce only within a group.  R=1 is the fully synchronous
    endpoint."""
    return run_one(arch, "train_4k", cards=cards, hybrid_rep=rep,
                   microbatch=microbatch, tag=tag or f"hybrid_R{rep}",
                   remat=remat, model=model)


REMAT_CHOICES = ("none", "block")


def _check_flags(remat: Optional[str], q_block: Optional[int]) -> None:
    if remat is not None and remat not in REMAT_CHOICES:
        raise ValueError(
            f"--remat {remat}: the port's remat is 'none' or 'block' "
            "(each block group checkpointed, and the attention's query "
            "blocks and the recurrences' chunks; ROADMAP A17)")
    if q_block is not None:
        raise ValueError("--q-block: the port's kernels tile themselves and "
                         "its plain attention takes no query block "
                         "(ROADMAP C.10)")


def result_path(arch, shape_name, mesh_kind, tag="", out_dir=None,
                remat: Optional[str] = None):
    """Where a record goes; ``remat`` is ``--remat`` (None: the
    config's), so a record is never reused for another remat."""
    out_dir = out_dir or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    remat = remat or get_config(arch).remat
    suffix = (f"_{tag}" if tag else "") + f"_remat-{remat}"
    return os.path.join(out_dir,
                        f"{arch}__{shape_name}__{mesh_kind}{suffix}.json")


def _summary(res) -> str:
    lay = res["layouts"]
    gib = 2 ** 30
    return (f"{res['flops_per_device']:.3e} flops/card, "
            f"{res['hbm_bytes_per_device'] / 1e9:.1f} GB moved, "
            f"peak {res['peak_bytes_per_device'] / gib:.2f} GiB/card "
            f"({'fits' if res['fits'] else 'does not fit'}; fsdp "
            f"{lay[FSDP]['peak_bytes'] / gib:.2f}), coll "
            f"{res['collective_bytes_per_device']['total'] / gib:.3f} GiB, "
            f"microbatch {res['microbatch']}, remat {res['remat']} "
            f"({res['analysis_s']}s)")


def _mesh_kind(args) -> str:
    return f"card{args.cards}" + (f"_model{args.model}"
                                  if args.model > 1 else "")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch dryrun")
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"),
                    default=None,
                    help="pod/multipod/both (a 16-wide model axis over "
                         "every family) are ROADMAP A16c.6 and refused")
    ap.add_argument("--cards", type=int, default=1,
                    help="H100s (default 1): N/M on the data axis, M on "
                         "the model axis")
    ap.add_argument("--model", type=int, default=1,
                    help="the model axis M (default 1); M > 1 covers "
                         "every family without a frontend; a frontend is "
                         "skipped naming ROADMAP A16c")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--remat", default=None,
                    help="none | block (default: the config's own, "
                         "'block' for every registry config)")
    ap.add_argument("--q-block", type=int, default=None,
                    help="refused: no counterpart in the port")
    ap.add_argument("--microbatch", type=int, default=None,
                    help="micro-batches per train step (default: the "
                         "smallest power of two whose peak fits a card)")
    ap.add_argument("--accum-dtype", default="float32")
    ap.add_argument("--hybrid-rep", type=int, default=None,
                    help="the group-annealed hybrid train step with R "
                         "replica groups (train_4k only)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default=None,
                    help=f"where results go (default {OUT_DIR})")
    args = ap.parse_args(argv)
    try:
        _check_mesh(args.mesh)
        _check_flags(args.remat, args.q_block)
        if args.model < 1 or args.cards % args.model:
            raise ValueError(f"--model {args.model} must divide --cards "
                             f"{args.cards}")
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.hybrid_rep is not None:
        if not args.arch:
            print("error: --hybrid-rep requires --arch", file=sys.stderr)
            return 2
        res = run_hybrid_one(args.arch, args.hybrid_rep, args.cards,
                             microbatch=args.microbatch, tag=args.tag,
                             remat=args.remat, model=args.model)
        path = result_path(args.arch, "train_4k", _mesh_kind(args),
                           res["tag"], args.out_dir, args.remat)
        with open(path, "w") as f:
            json.dump(res, f, indent=2)
        if res["status"] == "ok":
            print(f"hybrid R={args.hybrid_rep} on {args.cards} cards: "
                  f"{_summary(res)}")
            return 0
        print("ERROR:", res.get("error", res.get("reason")))
        return 1

    archs = ARCH_NAMES if args.all or not args.arch else (args.arch,)
    shapes = tuple(SHAPES) if args.all or not args.shape else (args.shape,)
    combos = [(a, s) for a in archs for s in shapes]
    failures = 0
    mesh_kind = _mesh_kind(args)
    for a, s in combos:
        path = result_path(a, s, mesh_kind, args.tag, args.out_dir,
                           args.remat)
        if os.path.exists(path) and not args.force:
            with open(path) as f:
                prev = json.load(f)
            print(f"[cached] {a} x {s} x {mesh_kind}: {prev['status']}")
            failures += prev["status"] == "error"
            continue
        print(f"[run] {a} x {s} x {mesh_kind} ...", flush=True)
        res = run_one(a, s, remat=args.remat, microbatch=args.microbatch,
                      accum_dtype=args.accum_dtype, tag=args.tag,
                      cards=args.cards, model=args.model)
        with open(path, "w") as f:
            json.dump(res, f, indent=2)
        if res["status"] == "ok":
            print(f"  ok: {_summary(res)}", flush=True)
        elif res["status"] == "skipped":
            print(f"  skipped: {res['reason']}")
        else:
            failures += 1
            print(f"  ERROR: {res['error']}")
    print(f"done: {len(combos)} combos, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
