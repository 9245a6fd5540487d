"""SPMD training driver (the ``spmd`` backend of :mod:`repro_torch.api`).

Modes:
  * ``sync``   — fully synchronous data parallelism (the paper's
                 synchronous baseline; also the hybrid schedule's end);
  * ``async``  — group size 1 throughout (per-rank local SGD, the SPMD
                 analogue of the asynchronous baseline);
  * ``hybrid`` — the Smooth Switch: the reduction-group size annealed by
                 the threshold schedule, replicas merged at each switch.

Every rank of a ``torch.distributed`` job runs :func:`run_training`
(launched by ``torchrun``; with no process group it is one rank, and
R = 1).  ``mesh_model`` M splits the W ranks into W/M data positions of
M ranks (``launch/mesh.py``); each step a data position takes the
gradient of its own rows of the batch.  With M > 1
(``parallel/tensor.py``) each rank holds its model slice of every leaf,
taken leaf by leaf as the params are drawn, and computes on its heads,
MLP columns, experts, inner channels and vocabulary rows, with
collectives over its model group; a model with
an MoE also reports its aux loss on logged steps and a digest of each
rank's routing, which must be equal across each model group.  With
g > 1 a replica group holds its replica in the reference's FSDP layout
(``parallel/fsdp.py``): each rank keeps its shards of the params and of
the optimizer state, the forward gathers each part along its data
column where it is used, the backward reduce-scatters the gradient,
summed over the column, and the update runs on the shards.

Each model column (the W/M ranks of one model index) runs the merges
and the divergence of its model slices on its own, as a world of W/M
ranks with M = 1 runs them: the slab's P axis is cut into one
tile-aligned chunk per position (``core/slab.py::shard_chunks``) and
position j receives chunk j of every replica's slab (one all-to-all;
each group gathers its replica one leaf at a time, and a rank encodes
only the chunks it sends).  A merge flushes that ``(R, c)``
chunk through the flush kernel (one launch at K = R on each rank),
divides by R, alpha-blends and reshards it; the next phase's replicas
are assembled from the merged chunks (another all-to-all) and sharded
by the next phase's layout.  The flush is elementwise along P, so this
is the unsharded merge bit for bit.  The divergence of a logged step
sums each leaf's squared distances within each chunk, in the leaf's
dtype as the reference does, and all-reduces one vector of those sums
over the world, a leaf whole on every model rank counted from model
index 0 only.  Checkpoints and the returned params are assembled in
rank 0's host memory, piece by piece (each column's position 0 takes
its slices, and the model group of ranks 0..M-1 gathers them leaf by
leaf), so no card holds more than a piece of them; rank 0 writes the
history, the checkpoints and ``out_json``.  Elementwise merge steps, the
divergence and the assembly take a large leaf in pieces
(``core/spmd_hybrid.py::SEGMENT_PIECE``).

Example (equivalently ``python -m repro_torch run --backend spmd ...``):
  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch xlstm-350m --smoke --steps 8 --mode hybrid \\
      --schedule step:4 --batch 4 --seq 32 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import save_checkpoint
from repro_torch.configs.registry import ARCH_NAMES, get_config, smoke_variant
from repro_torch.convert import Device, params_from_numpy, tree_to
from repro_torch.core.slab import SlabCodec, shard_chunks, slab_codec
from repro_torch.core.spmd_hybrid import (SEGMENT_PIECE, build_phases,
                                         merge_rows, reshard_replicas,
                                         slab_segments)
from repro_torch.data.pipeline import shard_batch
from repro_torch.data.synthetic import token_stream
from repro_torch.kernels import hybrid_aggregate
from repro_torch.launch.cost import tree_bytes
from repro_torch.launch.mesh import (Collectives, describe_layout,
                                     distributed, rank_device)
from repro_torch.launch.steps import chained, make_train_step
from repro_torch.models import model as M
from repro_torch.models.config import MOE
from repro_torch.optim.optimizers import adamw, momentum, sgd
from repro_torch.parallel.fsdp import GroupShards, all_gather_leaf
from repro_torch.parallel.tensor import TensorParallel, check_model_axis


def _optimizer(spec):
    """The per-replica optimizer the spec names (the same fields the
    server-side slab optimizer reads)."""
    if spec.optimizer == "adamw":
        return adamw(spec.lr, b1=spec.beta1, b2=spec.beta2,
                     weight_decay=spec.weight_decay)
    if spec.optimizer == "momentum":
        return momentum(spec.lr, beta=spec.beta1)
    return sgd(spec.lr)


def _phases(spec, data_axis: int) -> List[Tuple[int, int]]:
    """``[(t_start, g)]`` from the mode (``src/repro/launch/train.py:109``)."""
    from repro_torch.api.schedules import parse_schedule
    if spec.mode == "sync":
        return [(0, data_axis)]
    if spec.mode == "async":
        return [(0, 1)]
    sched = parse_schedule(spec.schedule, data_axis)
    return [(p.t_start, p.group_size)
            for p in build_phases(sched, spec.steps, data_axis)]


class _Chunks:
    """The slab's P axis split into one tile-aligned chunk per rank
    (``core/slab.py::shard_chunks``; a rank past the tiles has an
    empty one): where a merge and the divergence run.  The ranks are
    the positions of a model column (``comm.all_to_all_``'s); ``rank``
    and ``world`` default to ``comm``'s own.  ``skip`` holds the codec
    indices of leaves whose part of the divergence this rank does not
    add (another column adds them)."""

    def __init__(self, codec: SlabCodec, comm: Collectives,
                 rank: Optional[int] = None, world: Optional[int] = None,
                 skip: Sequence[int] = ()):
        W = comm.world if world is None else world
        rank = comm.rank if rank is None else rank
        sizes = shard_chunks(codec.padded_size, W)
        self.sizes = sizes + (0,) * (W - len(sizes))
        self.offsets = tuple(int(o) for o in
                             np.cumsum((0,) + self.sizes)[:-1])
        self.comm, self.rank, self.world = comm, rank, W
        self.codec = codec
        lo = self.offsets[rank]
        self.mine = slice(lo, lo + self.sizes[rank])
        self.segments = slab_segments(codec, lo, self.mine.stop)
        # (leaf index, a, b, dtype) of each leaf that meets this chunk
        self.dtypes = codec.dtypes
        self.leaves = [(i, max(off, lo) - lo,
                        min(off + n, self.mine.stop) - lo, dt)
                       for i, (off, n, dt) in enumerate(zip(
                           codec.offsets, codec.sizes, codec.dtypes))
                       if max(off, lo) < min(off + n, self.mine.stop)
                       and i not in skip]

    def rows(self, leaves, g: int) -> torch.Tensor:
        """``(R, c)``: this rank's chunk of every replica's slab (one
        all-to-all: member k of group r sends chunk j to the ranks j
        with j % g == k).  ``leaves`` yields the leaves of this rank's
        replica whole, in the slab's order, one at a time: the chunks
        it sends are encoded from each as it comes (float32, the
        padding zero), so the whole slab is never built."""
        W = self.world
        k = self.rank % g
        send = [(self.offsets[j], self.offsets[j] + self.sizes[j])
                for j in range(W) if j % g == k]
        inp = None
        for off, n, leaf in zip(self.codec.offsets, self.codec.sizes,
                                leaves):
            if inp is None:
                inp = torch.zeros((sum(b - a for a, b in send),),
                                  dtype=torch.float32, device=leaf.device)
            flat, at = leaf.reshape(-1), 0
            for a, b in send:
                lo, hi = max(a, off), min(b, off + n)
                if lo < hi:
                    inp[at + lo - a:at + hi - a].copy_(
                        flat[lo - off:hi - off])
                at += b - a
            del flat, leaf
        c = self.sizes[self.rank]
        out = inp.new_empty((W // g * c,))
        self.comm.all_to_all_(
            out, inp, [c if s % g == k else 0 for s in range(W)],
            [self.sizes[j] if j % g == k else 0 for j in range(W)])
        return out.view(W // g, c)

    def assemble(self, rows: torch.Tensor,
                 row_for: Sequence[Optional[int]]) -> Optional[torch.Tensor]:
        """Rank k gets the whole slab of row ``row_for[k]`` of the
        ``(n, c)`` chunk rows every rank holds (one all-to-all); a rank
        whose entry is None gets None."""
        W = self.world
        mine = row_for[self.rank]
        inp = torch.cat([rows[row_for[k]] for k in range(W)
                         if row_for[k] is not None])
        out = rows.new_empty((self.offsets[-1] + self.sizes[-1]
                              if mine is not None else 0,))
        self.comm.all_to_all_(
            out, inp, [self.sizes[j] if mine is not None else 0
                       for j in range(W)],
            [rows.shape[1] if row_for[k] is not None else 0
             for k in range(W)])
        return out if mine is not None else None

    def host_tree(self, row: torch.Tensor) -> Any:
        """On position 0, the params tree of the slab whose chunks the
        ranks hold as ``row`` (``(c,)`` float32 each), in host memory in
        each leaf's dtype (None elsewhere).  The slab crosses in pieces
        of ``SEGMENT_PIECE`` elements, one all-to-all each, and position
        0 copies each piece to the host as it comes, so no card holds
        more than a piece of it."""
        codec, W = self.codec, self.world
        out = [torch.empty(shape, dtype=dt) if self.rank == 0 else None
               for shape, dt in zip(codec.shapes, codec.dtypes)]
        ends = [o + n for o, n in zip(self.offsets, self.sizes)]
        lo, hi = self.mine.start, self.mine.stop
        for p in range(0, ends[-1], SEGMENT_PIECE):
            q = min(ends[-1], p + SEGMENT_PIECE)
            # each rank's part of [p, q), sent to position 0
            parts = [max(0, min(q, e) - max(p, o))
                     for o, e in zip(self.offsets, ends)]
            mine = row[max(p, lo) - lo:max(p, lo) - lo
                       + parts[self.rank]]
            got = row.new_empty((q - p,) if self.rank == 0 else (0,))
            self.comm.all_to_all_(
                got, mine, parts if self.rank == 0 else [0] * W,
                [parts[self.rank]] + [0] * (W - 1))
            if self.rank != 0:
                continue
            got = got.cpu()
            for i, (off, n) in enumerate(zip(codec.offsets, codec.sizes)):
                a, b = max(p, off), min(q, off + n)
                if a < b:
                    out[i].view(-1)[a - off:b - off].copy_(got[a - p:b - p])
        return codec.tree(out) if self.rank == 0 else None

    def merge(self, rows: torch.Tensor, alpha: float) -> torch.Tensor:
        """:func:`merge_rows` on this chunk (one flush launch at K = R),
        as ``(R, c)`` float32 rows."""
        return merge_rows(rows, self.segments, alpha)

    def reshard(self, rows: torch.Tensor, R_new: int) -> torch.Tensor:
        """:func:`reshard_replicas` on this chunk, in each leaf's
        dtype."""
        out = rows.new_zeros((R_new, rows.shape[1]))
        for a, b, dt in self.segments:
            out[:, a:b] = reshard_replicas(rows[:, a:b].to(dt),
                                           R_new).float()
        return out

    def divergence(self, rows: torch.Tensor) -> float:
        """:func:`replica_divergence` of the replicas, from this chunk:
        each leaf's part of the squared distances to the replicas' mean,
        taken in the leaf's dtype as the reference takes them (the mean
        summed in float32 and rounded once), is summed in float64; one
        all-reduce adds the parts of every rank, and each leaf's total,
        rounded to its dtype, is added to the others in the codec's leaf
        order with the reference's dtype promotion."""
        parts = torch.zeros((len(self.dtypes),), dtype=torch.float64,
                            device=rows.device)
        R = rows.shape[0]
        for i, a, b, dt in self.leaves:
            # a large leaf in pieces, each part summed in float64
            for p in range(a, b, SEGMENT_PIECE):
                q = min(b, p + SEGMENT_PIECE)
                reps = rows[:, p:q].to(dt)
                mean = (torch.sum(rows[:, p:q], dim=0) / R).to(dt)
                parts[i] += torch.sum(torch.square(reps - mean),
                                      dtype=torch.float64)
        parts = self.comm.sum_world(parts)
        total = 0
        for part, dt in zip(parts, self.dtypes):
            total = total + part.to(dt)
        return float(torch.sqrt(total))


def _digest(params, tp: TensorParallel, sharding, codec: SlabCodec
            ) -> float:
    """48 bits of the SHA-256 of a rank's leaves whole on every rank of
    its model group (each gathered along ``data`` when ``sharding``
    shards it), in the slab's leaf order (the order of the params the
    run returns, whatever the order of ``params``' dicts), as a float
    (exact)."""
    h = hashlib.sha256()
    with torch.no_grad():
        for path, t in codec.items(params):
            path = tuple(str(n) for n in path)
            if not tp.whole(path):
                continue
            d = sharding.dims[path] if sharding is not None else None
            if d is not None:
                t = all_gather_leaf(t, d, sharding.g, sharding.comm)
            h.update(t.detach().cpu().contiguous().view(torch.uint8)
                     .numpy().tobytes())
    return float(int.from_bytes(h.digest()[:6], "big"))


def run_training(spec, ckpt_dir: Optional[str] = None,
                 out_json: Optional[str] = None, verbose: bool = True,
                 device: Device = None, params: Any = None,
                 microbatch: int = 1):
    """Run this rank's part of the SPMD driver for an
    :class:`repro_torch.api.ExperimentSpec`.

    Returns ``(params_final, history, stats)``.  On rank 0
    ``params_final`` is the final merge of the replicas, in host memory,
    and ``history`` the logged per-step metrics; other ranks return
    ``None`` and ``[]``.
    ``stats`` has the exact counters (``num_updates``, and
    ``num_gradients``: one gradient per replica per step) on every rank,
    and on rank 0 also the layout (``backend``, ``world_size``,
    ``device``), each merge's K (``merges``), the flush launches by K
    (``launches_by_k``; ``flush_launches_by_rank`` has every rank's
    flush launches at each merge's K), ``mesh_model``, each phase's
    layout (``layout``: its g, R and model width, whether it is FSDP,
    and by rank the state bytes, what the card held before the phase's
    first step and the peak of its steps), and each rank's peak device
    memory and seconds in collectives (``collective_s``), split into the
    gradient (the reduce-scatters and the whole leaves' all-reduce), the
    FSDP gathers, with ``mesh_model`` > 1 the tensor collectives of the
    forward and backward, the divergence of logged steps and the merges
    (``collective_s_by_kind``), and the seconds rank 0 took to draw (or
    read) its params and move them to its device (``draw_s``).

    ``params`` (tests) is an initial params tree of numpy arrays, such
    as the reference's, in place of the port's own initialisation.
    ``microbatch`` splits each rank's rows into that many slices a step
    (``launch/steps.py::make_train_step``)."""
    dev = rank_device(device)
    with distributed(dev) as backend:
        return _run(spec, ckpt_dir, out_json, verbose, dev, params,
                    backend or "none", microbatch)


def _run(spec, ckpt_dir, out_json, verbose, dev, params, backend,
         microbatch):
    cfg = get_config(spec.arch)
    if spec.smoke:
        cfg = dataclasses.replace(smoke_variant(cfg), name=cfg.name)
    check_model_axis(cfg, spec.mesh_model)
    if cfg.frontend is not None:
        raise ValueError(f"{spec.arch}: the train driver uses token "
                         "streams, not a frontend's inputs")
    moe = any(ffn == MOE for _, ffn in cfg.block_pattern)
    comm = Collectives(dev, spec.mesh_model)
    rank, W, width = comm.rank, comm.world, comm.model
    # data positions (src/repro/launch/train.py:91-94); the M ranks of a
    # position take the same rows
    data_axis, pos = comm.positions, comm.position
    if dev.type == "cuda":
        from repro_torch.cluster.mptransport import (CUDA_DETERMINISTIC,
                                                     set_torch_flags)
        set_torch_flags(CUDA_DETERMINISTIC)
        torch.cuda.set_device(dev)     # initialises CUDA in this process
        torch.cuda.reset_peak_memory_stats(dev)
    if verbose and rank == 0:
        print(f"[spmd] {describe_layout(dev, backend)}", flush=True)
    opt = _optimizer(spec)
    stream = token_stream(spec.seed, cfg.vocab_size, spec.batch, spec.seq)
    phases = _phases(spec, data_axis)
    # this rank's model slices (the params themselves when M is 1),
    # taken on the host leaf by leaf as the params are drawn (the whole
    # tree is never on this rank's host or card); each model column
    # merges the slab of its own slices
    t_draw = time.time()
    tp = None
    if width > 1:
        tp = TensorParallel(cfg, M.meta_params(cfg), comm)
    if params is None:
        params = M.init_params(torch.Generator().manual_seed(spec.seed),
                               cfg, None if tp is None else tp.take)
    else:
        params = params_from_numpy(params)
        if tp is not None:
            params = tp.slice(params)
    params = tree_to(params, dev)
    draw_s = time.time() - t_draw
    codec = slab_codec(params)
    launches_before = dict(hybrid_aggregate.LAUNCHES_BY_K)

    # a leaf whole on every model rank adds its divergence once, from
    # model index 0
    skip = [i for i, p in enumerate(codec.paths)
            if tp.whole(tuple(str(n) for n in p))] \
        if tp is not None and comm.k else ()
    chunks = _Chunks(codec, comm, pos, data_axis, skip)
    history: List[Dict[str, Any]] = []
    merges: List[Dict[str, Any]] = []
    layout: List[Dict[str, Any]] = []
    mine: List[float] = []     # this rank's state, held, step peak a phase
    t0 = time.time()
    tokens_done = grads_done = step = 0
    rows = params_final = None
    whole_digest = None        # M > 1: this rank's whole leaves at the end
    peak_all = 0
    last: Optional[Tuple[Any, float, Any]] = None   # (rows, alpha, merge)

    def merged(rows, alpha, kind):
        # one merge per phase end: the checkpoint's is reused by the
        # switch or the final merge that takes the same alpha
        nonlocal last
        if last is not None and last[0] is rows and last[1] == alpha:
            return last[2]
        merges.append({"step": step, "K": int(rows.shape[0]),
                       "alpha": alpha, "kind": kind})
        out = chunks.merge(rows, alpha)
        last = (rows, alpha, out)
        return out

    def replica_rows(shards, g):
        # this rank's P-chunk of every replica: each group gathers its
        # replica leaf by leaf (a leaf whole at a time), and the chunks
        # cross ranks in one all-to-all
        def leaves():
            for path, t in codec.items(shards):
                d = None if sharding is None else \
                    sharding.dims[tuple(str(n) for n in path)]
                yield t if d is None else all_gather_leaf(t, d, sharding.g,
                                                          comm)
        return chunks.rows(leaves(), g)

    def assembled(rows, kind):
        # the merged params whole on rank 0, in its host memory (None
        # elsewhere): each column's position 0 takes its slices piece by
        # piece, and ranks 0..M-1 (the model group of position 0) gather
        # them leaf by leaf
        row = merged(rows, 1.0, kind)[0]
        with comm.timing("merge"):
            tree = chunks.host_tree(row)
            if tp is not None and tree is not None:
                tree = tp.gather_host(tree, dev, SEGMENT_PIECE)
        return tree

    def write_checkpoint(rows):
        tree = assembled(rows, "checkpoint")
        if rank == 0:
            save_checkpoint(os.path.join(ckpt_dir, f"step_{step}"),
                            tree, step,
                            extra={"arch": spec.arch, "mode": spec.mode})

    for idx, (t_start, g) in enumerate(phases):
        t_end = phases[idx + 1][0] if idx + 1 < len(phases) else spec.steps
        R = data_axis // g
        if idx > 0:
            # the phase switch (the paper's buffer flush): each rank
            # merges its P-chunk of the replicas through the flush kernel
            # (one launch at K = R_old), reshards it to this phase's R,
            # and every rank takes its new group's replica whole
            new = chunks.reshard(merged(rows, spec.merge_alpha, "switch"),
                                 R)
            rows = last = None
            with comm.timing("merge"):
                slab = chunks.assemble(new, [j // g
                                             for j in range(data_axis)])
            del new
            params = codec.decode(slab)
            del slab
        # the FSDP layout of this phase's groups (parallel/fsdp.py) over
        # each data column: each rank keeps its shards and the optimizer
        # state built on them
        sharding = GroupShards(params, g, pos % g, comm, width) if g > 1 \
            else None
        if sharding is not None:
            params = sharding.shard(params)
        opt_state = opt.init(params)
        # the state as its tensors' allocations, and what the card holds
        # before the phase's first step
        state = tree_bytes(params) + tree_bytes(opt_state)
        held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" \
            else 0
        layout.append({"t_start": t_start, "g": g, "replicas": R,
                       "model": width,
                       "fsdp": sharding is not None and sharding.sharded})
        # whole kv-head leaves summed over the model group, then the
        # mean over the data column
        step_fn = make_train_step(
            cfg, opt, microbatch=microbatch,
            reduce_grads=chained([
                tp.sum_partial if tp is not None and tp.partial else None,
                sharding.group_mean if sharding else None]),
            gather=sharding.gather if sharding else None, tensor=tp,
            column=sharding if sharding and moe else None)
        step_peak = 0

        while step < t_end:
            batch = shard_batch(next(stream), pos, data_axis, dev)
            if dev.type == "cuda":
                peak_all = max(peak_all, torch.cuda.max_memory_allocated(dev))
                torch.cuda.reset_peak_memory_stats(dev)
            params, opt_state, loss, metrics = step_fn(params, opt_state,
                                                       batch)
            if dev.type == "cuda":
                step_peak = max(step_peak,
                                torch.cuda.max_memory_allocated(dev))
            tokens_done += spec.batch * spec.seq
            grads_done += R     # one gradient per replica this step
            if step % spec.log_every == 0 or step == t_end - 1:
                # one loss a data position (its model ranks' are equal)
                reported = [(rid, value, a) for rid, value, k, a in
                            comm.gather_host([pos // g, float(loss),
                                              comm.k, float(metrics["aux"])])
                            if k == 0]
                div = 0.0
                if R > 1:
                    with comm.timing("divergence"):
                        rows = replica_rows(params, g)
                        div = chunks.divergence(rows)
                    if step < t_end - 1:
                        rows = None
                if rank == 0:
                    by_rep: Dict[int, List[Tuple[float, float]]] = {}
                    for rid, value, a in reported:
                        by_rep.setdefault(int(rid), []).append((value, a))
                    per_rep = torch.stack(
                        [torch.tensor(v, dtype=torch.float32).mean(0)
                         for _, v in sorted(by_rep.items())])
                    # the replicas that reported a loss must be the R
                    # this phase runs
                    assert len(by_rep) == R, (len(by_rep), R)
                    rec = {"step": step, "group_size": g, "replicas": R,
                           "loss": float(per_rep[:, 0].mean()),
                           "divergence": div,
                           "wall_s": round(time.time() - t0, 2),
                           "tokens": tokens_done}
                    if moe:
                        rec["aux"] = float(per_rep[:, 1].mean())
                    history.append(rec)
                    if verbose:
                        print(f"step {step:5d}  g={g:3d} R={R:3d} "
                              f"loss={rec['loss']:.4f} div={div:.3e}",
                              flush=True)
            step += 1

        mine += [state, held, step_peak]
        del opt_state, step_fn
        if tp is not None and idx == len(phases) - 1:
            whole_digest = _digest(params, tp, sharding, codec)
        if rows is None:
            # (the phase's last step, logged, left its rows when R > 1)
            with comm.timing("merge"):
                rows = replica_rows(params, g)
        params = None
        if ckpt_dir:
            write_checkpoint(rows)

    # final merge for the returned model, assembled on rank 0
    params_final = assembled(rows, "final")
    stats: Dict[str, Any] = {"num_updates": step,
                             "num_gradients": grads_done}
    kinds = ("gradient", "gather") + ("tensor",) * (width > 1) \
        + ("divergence", "merge")
    if dev.type == "cuda":
        peak_all = max(peak_all, torch.cuda.max_memory_allocated(dev))
    # each rank's flush launches at each merge's K (every rank flushes
    # its own chunk)
    ks = sorted({m["K"] for m in merges})
    flushes = [hybrid_aggregate.LAUNCHES_BY_K.get(("flush", K), 0)
               - launches_before.get(("flush", K), 0) for K in ks]
    by_rank = comm.gather_host(
        [peak_all, comm.seconds] + [comm.seconds_by.get(k, 0.0)
                                    for k in kinds] + mine + flushes
        + ([whole_digest] if tp is not None else [])
        # 48 bits of the routing digest, as a float (exact)
        + ([float(int(tp.routing) % (1 << 48))]
           if tp is not None and moe else []))
    if rank == 0:
        after = hybrid_aggregate.LAUNCHES_BY_K
        by_k: Dict[str, Dict[str, int]] = {}
        for (name, K), n in sorted(after.items()):
            n -= launches_before.get((name, K), 0)
            if n:
                by_k.setdefault(name, {})[str(K)] = n
        n_k = len(kinds) + 2
        for i, ph in enumerate(layout):
            for j, key in enumerate(("state_bytes", "held_bytes",
                                     "step_peak_bytes")):
                ph[key] = [int(r[n_k + 3 * i + j]) for r in by_rank]
        stats.update(
            backend=backend, world_size=W, mesh_model=width, device=str(dev),
            remat=cfg.remat, draw_s=draw_s,
            device_name=torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu",
            merges=merges, launches_by_k=by_k, layout=layout,
            flush_launches_by_rank=[
                {str(K): int(n) for K, n in zip(
                    ks, r[n_k + len(mine):n_k + len(mine) + len(ks)])}
                for r in by_rank],
            peak_memory_bytes=[int(r[0]) for r in by_rank],
            collective_s=[r[1] for r in by_rank],
            collective_s_by_kind=[dict(zip(kinds, r[2:n_k]))
                                  for r in by_rank])
        if tp is not None:
            # a digest of each rank's leaves whole on every model rank,
            # after its last step, and of every MoE layer's routing in
            # every step: equal across each model group
            n = len(kinds) + 2 + len(mine) + len(ks)
            stats["whole_digest_by_rank"] = [int(r[n]) for r in by_rank]
            if moe:
                stats["routing_digest_by_rank"] = [int(r[n + 1])
                                                   for r in by_rank]
        if out_json:
            with open(out_json, "w") as f:
                json.dump({"arch": spec.arch, "mode": spec.mode,
                           "spec": spec.to_dict(), "stats": stats,
                           "history": history}, f, indent=2)
    comm.barrier()
    return params_final, history, stats


def main(argv=None):
    from repro_torch.api.spec import ExperimentSpec

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCH_NAMES, default="xlstm-350m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mode", choices=("sync", "async", "hybrid"),
                    default="hybrid")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="step:30",
                    help='schedule spec, e.g. "step:30" or '
                         '"cosine:horizon=200"')
    ap.add_argument("--merge-alpha", type=float, default=1.0)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where each rank computes (default cuda; a host "
                         "without CUDA needs --device cpu)")
    args = ap.parse_args(argv)

    try:
        spec = ExperimentSpec(
            arch=args.arch, backend="spmd", mode=args.mode,
            schedule=args.schedule if args.mode == "hybrid" else None,
            seed=args.seed, lr=args.lr, batch=args.batch, steps=args.steps,
            seq=args.seq, merge_alpha=args.merge_alpha, smoke=args.smoke)
    except ValueError as e:
        ap.error(str(e))     # clean CLI error, as the old choices= gave
    run_training(spec, ckpt_dir=args.ckpt_dir, out_json=args.out_json,
                 device=args.device)


if __name__ == "__main__":
    main()
