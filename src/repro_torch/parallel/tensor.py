"""The ``model`` axis within a replica group: the counterpart of GSPMD's
partitioning over the reference's ``model`` mesh axis, for attention
(grouped-query and MLA), the MLP and the MoE.

The reference marks its tensor-parallel boundaries with activation
constraints (``src/repro/models/attention.py:55-57`` q/k/v over heads,
``:161-163`` the output over heads and ``y`` whole,
``models/mla.py:71-78``, ``models/mlp.py:25-33``, ``models/moe.py:68``,
``:98-105`` and ``:112``, ``models/model.py:92`` ``x`` whole and
``:123`` the logits over ``vocab``) and lets GSPMD place the
collectives.  Here they are explicit, Megatron-style.  A rank holds the
model slice of each leaf that the partition rules shard over ``model``
(``parallel/partition.py`` over ``{"data": g, "model": M}``, sanitized):
its H/M query heads (MLA's ``wq``, ``w_uk``, ``w_uv`` and ``wo`` too),
KV/M kv heads, d_ff/M MLP columns (the MoE's shared expert's too), E/M
experts and V/M vocabulary rows, contiguous, the k-th of M for model
index k; every other leaf (the norms, MLA's latent projections
``w_dkv``/``w_kr``, the MoE's ``router``) is whole on every rank.

Three autograd Functions carry the boundaries, the loss being computed
alike on every rank of a model group:

* :class:`CopyToModel` (identity forward, all-reduce backward): the
  input of a column-parallel product (q/k/v, ``w_up``/``w_gate``, the
  head, the experts), whose gradient each rank holds a part of, and
  what a rank's heads or experts read of a value every rank computes
  alike (MLA's latent and rope key, the MoE's gate values);
* :class:`ReduceFromModel` (all-reduce forward, identity backward): the
  output of a row-parallel product (``wo``, ``w_down``, the MoE's
  experts and shared expert summed in one) and the vocabulary-parallel
  embedding and gold logit;
* :class:`GatherFromModel` (all-gather forward; the backward keeps the
  rank's own slice, without summing): the local logsumexps of the
  vocabulary-parallel loss.

Each of their collectives is timed as ``"tensor"``.  Where M does not
divide KV, ``wk``/``wv`` (and ``bk``/``bv``) stay whole by the sanitize
rule: a rank takes the kv heads its query heads map to
(:meth:`TensorParallel.kv`) and those leaves' gradients are summed over
the model group once a step (:meth:`TensorParallel.sum_partial`, timed
as ``"gradient"``).  The MoE routes alike on every rank of a group (its
input is whole and equal there); :meth:`TensorParallel.route` keeps a
digest of each MoE layer's routing to show it.  Mamba, mLSTM, sLSTM and
the frontends have no form here yet (ROADMAP A16c) and are refused
(:func:`check_model_axis`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.config import (ATTN, ATTN_GLOBAL, MLA, MLP, MOE,
                                       NONE)
from repro_torch.parallel.fsdp import axis_dims, shard_tree, side_by_side
from repro_torch.parallel.partition import map_with_path

Path = Tuple[str, ...]
MODEL_AXIS_MIXERS = (ATTN, ATTN_GLOBAL, MLA)
MODEL_AXIS_FFNS = (MLP, MOE, NONE)
# the leaves of a kv head: whole when M does not divide KV
KV_LEAVES = ("wk", "wv", "bk", "bv")
# an odd 64-bit multiplier (2**64 / golden ratio, as a signed int64):
# position i of a routing weighs (i + 1) times it in its digest
_GOLDEN = -7046029254386353131


def check_model_axis(cfg, model: int) -> None:
    """Raise ``ValueError`` naming ROADMAP A16c unless ``cfg`` has a
    tensor-parallel form at ``model`` M: attention, MLA, MLP and MoE
    blocks only, no frontend, and M dividing the heads, the MLP width,
    the experts, the shared experts' width and the vocabulary (the kv
    heads may stay whole)."""
    if model == 1:
        return
    mixers = {m for m, _ in cfg.block_pattern}
    ffns = {f for _, f in cfg.block_pattern}
    other = sorted((mixers - set(MODEL_AXIS_MIXERS))
                   | (ffns - set(MODEL_AXIS_FFNS)))
    if other or cfg.frontend is not None:
        what = ", ".join(other) if other else f"the {cfg.frontend} frontend"
        raise ValueError(
            f"mesh_model={model}: {cfg.name} has {what}, which have no "
            "tensor-parallel form in this port yet; the model axis covers "
            "attention, MLA, MLP and MoE blocks, the rest is ROADMAP A16c")
    dims = [("num_heads", cfg.num_heads), ("vocab_size", cfg.vocab_size)]
    if MLP in ffns:
        dims.append(("d_ff", cfg.d_ff))
    if MOE in ffns:
        dims.append(("num_experts", cfg.num_experts))
        if cfg.num_shared_experts:
            dims.append(("moe_d_ff * num_shared_experts",
                         (cfg.moe_d_ff or cfg.d_ff)
                         * cfg.num_shared_experts))
    for name, n in dims:
        if n % model:
            raise ValueError(f"mesh_model={model} does not divide "
                             f"{cfg.name}'s {name} ({n}): ROADMAP A16c")


def model_dims(params, model: int) -> Dict[Path, Optional[int]]:
    """Each leaf's dim over the ``model`` axis (None: whole), by its
    ``map_with_path`` path."""
    return axis_dims(params, {"data": 1, "model": model}, "model")


def _all_reduce(x: torch.Tensor, comm, kind: str = "tensor"
                ) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    with comm.timing(kind):
        comm.model_all_reduce_(out.view(-1))
    return out


class CopyToModel(torch.autograd.Function):
    """``CopyToModel.apply(x, comm)``: ``x`` forward; the gradient summed
    over the model group backward."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.comm), None


class ReduceFromModel(torch.autograd.Function):
    """``ReduceFromModel.apply(x, comm)``: ``x`` summed over the model
    group forward; the gradient as it is backward."""

    @staticmethod
    def forward(ctx, x, comm):
        return _all_reduce(x, comm)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class GatherFromModel(torch.autograd.Function):
    """``GatherFromModel.apply(x, comm)``: the model group's ``x`` laid
    side by side along the last dim forward; backward, the rank's own
    slice of the gradient (every rank computes the same loss, so
    nothing is summed)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.k, ctx.n = comm.k, x.shape[-1]
        x = x.contiguous()
        flat = x.new_empty((comm.model * x.numel(),))
        with comm.timing("tensor"):
            comm.model_all_gather_(flat, x.view(-1))
        return side_by_side(flat, x, comm.model, x.ndim - 1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.k * ctx.n, ctx.n).contiguous(), None


class TensorParallel:
    """One rank's place on the model axis: ``comm.model`` M ranks, this
    one at ``comm.k``, for ``cfg`` (refused by :func:`check_model_axis`
    when it has no tensor-parallel form).  ``params`` is a whole params
    tree (meta tensors do), read for its leaves' model dims (``dims``).
    ``routing`` folds each MoE layer's routing digest (:meth:`route`)
    into one int64 on the device, in call order: None before the first
    MoE layer, read on the host only when the caller wants it."""

    def __init__(self, cfg, params, comm):
        check_model_axis(cfg, comm.model)
        self.comm = comm
        self.M, self.k = comm.model, comm.k
        self.dims = model_dims(params, self.M)
        H, KV = cfg.num_heads, cfg.num_kv_heads
        self.heads = H // self.M
        self.vocab = cfg.vocab_size // self.M
        self.v0 = self.k * self.vocab
        self.experts = cfg.num_experts // self.M
        self.e0 = self.k * self.experts
        self.routing: Optional[torch.Tensor] = None
        # MLA keeps no kv heads: only attention's may stay whole
        self.kv_whole = KV % self.M != 0 and any(
            m in (ATTN, ATTN_GLOBAL) for m, _ in cfg.block_pattern)
        self.kv_range = None
        if self.kv_whole:
            # local query head i is head k*heads + i, whose kv head is
            # that over H/KV; the local attention maps i to local kv
            # head i // (heads / n)
            group = H // KV
            heads = [self.k * self.heads + i for i in range(self.heads)]
            first = heads[0] // group
            n = heads[-1] // group - first + 1
            if self.heads % n or any(
                    h // group - first != i // (self.heads // n)
                    for i, h in enumerate(heads)):
                raise ValueError(
                    f"mesh_model={self.M}: the query heads of model index "
                    f"{self.k} do not map onto contiguous kv heads "
                    f"(H {H}, KV {KV}): ROADMAP A16c")
            self.kv_range = (first, n)
        self.partial = {p for p, d in self.dims.items()
                        if self.kv_whole and p[0] == "groups"
                        and p[-1] in KV_LEAVES}

    # ------------------------------------------------------------ leaves

    def slice(self, tree):
        """This rank's model slices of a whole tree shaped like the
        params (fresh contiguous tensors; a whole leaf is the leaf)."""
        return shard_tree(tree, self.k, self.M, self.dims)

    def gather_host(self, tree, device: torch.device, piece: int):
        """On model index 0, the whole tree of a host tree of model
        slices, in host memory (None on the other ranks): each sliced
        leaf is all-gathered over the model group through ``device`` in
        pieces along its first dim of at most ``piece`` elements a rank,
        each piece copied to the host as it comes."""
        def one(path, t):
            d = self.dims[path]
            if d is None:
                return t
            n0 = t.shape[0]
            full = list(t.shape)
            full[d] *= self.M
            out = torch.empty(full, dtype=t.dtype) if self.k == 0 else None
            step = max(1, piece // max(1, t[0].numel()))
            for i in range(0, n0, step):
                part = t[i:i + step].to(device).contiguous()
                flat = part.new_empty((self.M * part.numel(),))
                self.comm.model_all_gather_(flat, part.view(-1))
                if out is None:
                    continue
                if d == 0:
                    # slice k holds rows k*n0 .. (k+1)*n0 of the leaf
                    parts = flat.view((self.M,) + tuple(part.shape)).cpu()
                    for k in range(self.M):
                        out[k * n0 + i:k * n0 + i + part.shape[0]] = \
                            parts[k]
                else:
                    out[i:i + part.shape[0]] = side_by_side(
                        flat, part, self.M, d).cpu()
            return out
        with torch.no_grad():
            tree = map_with_path(one, tree)
        return tree if self.k == 0 else None

    def whole(self, path: Path) -> bool:
        """Whether every rank of the model group holds the leaf at
        ``path`` whole."""
        return self.dims[path] is None

    def kv(self, leaf: torch.Tensor, dim: int) -> torch.Tensor:
        """The kv heads this rank's query heads use, of a kv-head leaf
        (``wk``/``wv`` along dim 1, ``bk``/``bv`` along dim 0): the leaf
        as it is when it is sliced, else its heads' range of the whole
        leaf."""
        if self.kv_range is None:
            return leaf
        return leaf.narrow(dim, *self.kv_range)

    def sum_partial(self, grads):
        """``grads`` with the gradients of whole kv-head leaves, which
        each rank computes from its own query heads only, summed over
        the model group."""
        if not self.partial:
            return grads

        def one(path, t):
            if path not in self.partial:
                return t
            return _all_reduce(t, self.comm, "gradient")
        return map_with_path(one, grads)

    # ----------------------------------------------------------- routing

    def route(self, gate_idx: torch.Tensor, keep: torch.Tensor) -> None:
        """Fold one MoE layer's routing into ``routing``: a digest of its
        experts (``gate_idx``) and its capacity cut (``keep``), taken on
        the device in int64 (wrapping sums and products are exact in any
        order, so equal routings give equal digests on any rank and
        device), then ``routing * _GOLDEN + digest``.  Nothing leaves the
        card."""
        v = (gate_idx.long() * 2 + keep.long()).reshape(-1)
        w = torch.arange(1, v.numel() + 1, dtype=torch.int64,
                         device=v.device) * _GOLDEN
        d = torch.sum((v + 1) * w)
        self.routing = d if self.routing is None \
            else self.routing * _GOLDEN + d

    # ------------------------------------------------------- activations

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return CopyToModel.apply(x, self.comm)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return ReduceFromModel.apply(x, self.comm)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor
              ) -> torch.Tensor:
        """The vocabulary-parallel lookup: this rank's rows of the
        embedding (``table``, V/M rows) for the tokens it holds, zeros
        for the others, summed over the model group."""
        local = tokens.long() - self.v0
        held = (local >= 0) & (local < self.vocab)
        x = table[local.clamp(0, self.vocab - 1)]
        x = torch.where(held[..., None], x, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
        return self.reduce(x)

    def cross_entropy(self, logits: torch.Tensor, labels: torch.Tensor
                      ) -> torch.Tensor:
        """Per-position ``logsumexp - gold`` from this rank's float32
        logits over its V/M vocabulary rows: the local logsumexps
        gathered over the model group and combined by one more
        logsumexp; the gold logit from the rank that holds it, zeros
        from the others, summed."""
        lse = torch.logsumexp(GatherFromModel.apply(
            torch.logsumexp(logits, dim=-1)[..., None], self.comm), dim=-1)
        local = labels.long() - self.v0
        held = (local >= 0) & (local < self.vocab)
        gold = torch.gather(logits, -1, local.clamp(0, self.vocab - 1)
                            [..., None])[..., 0]
        gold = self.reduce(torch.where(held, gold, torch.zeros_like(gold)))
        return lse - gold
