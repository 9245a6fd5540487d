"""The ``model`` axis within a replica group for the dense families: the
counterpart of GSPMD's partitioning over the reference's ``model`` mesh
axis.

The reference marks its tensor-parallel boundaries with activation
constraints (``src/repro/models/attention.py:55-57`` q/k/v over heads,
``:161-163`` the output over heads and ``y`` whole,
``models/mlp.py:25-33``, ``models/model.py:92`` ``x`` whole and ``:123``
the logits over ``vocab``) and lets GSPMD place the collectives.  Here
they are explicit, Megatron-style.  A rank holds the model slice of
each leaf that the partition rules shard over ``model``
(``parallel/partition.py`` over ``{"data": g, "model": M}``, sanitized):
its H/M query heads, KV/M kv heads, d_ff/M MLP columns and V/M
vocabulary rows, contiguous, the k-th of M for model index k; every
other leaf (the norms) is whole on every rank.

Three autograd Functions carry the boundaries, the loss being computed
alike on every rank of a model group:

* :class:`CopyToModel` (identity forward, all-reduce backward): the
  input of a column-parallel product (q/k/v, ``w_up``/``w_gate``, the
  head), whose gradient each rank holds a part of;
* :class:`ReduceFromModel` (all-reduce forward, identity backward): the
  output of a row-parallel product (``wo``, ``w_down``) and the
  vocabulary-parallel embedding and gold logit;
* :class:`GatherFromModel` (all-gather forward; the backward keeps the
  rank's own slice, without summing): the local logsumexps of the
  vocabulary-parallel loss.

Each of their collectives is timed as ``"tensor"``.  Where M does not
divide KV, ``wk``/``wv`` (and ``bk``/``bv``) stay whole by the sanitize
rule: a rank takes the kv heads its query heads map to
(:meth:`TensorParallel.kv`) and those leaves' gradients are summed over
the model group once a step (:meth:`TensorParallel.sum_partial`, timed
as ``"gradient"``).  Any other mixer or FFN has no
form here yet (ROADMAP A16c) and is refused (:func:`check_dense`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.config import ATTN, ATTN_GLOBAL, MLP, NONE
from repro_torch.parallel.fsdp import axis_dims, shard_tree, side_by_side
from repro_torch.parallel.partition import map_with_path

Path = Tuple[str, ...]
DENSE_MIXERS = (ATTN, ATTN_GLOBAL)
DENSE_FFNS = (MLP, NONE)
# the leaves of a kv head: whole when M does not divide KV
KV_LEAVES = ("wk", "wv", "bk", "bv")


def check_dense(cfg, model: int) -> None:
    """Raise ``ValueError`` naming ROADMAP A16c unless ``cfg`` has a
    tensor-parallel form at ``model`` M: attention and MLP blocks only,
    no frontend, and M dividing the heads, the MLP width and the
    vocabulary (the kv heads may stay whole)."""
    if model == 1:
        return
    other = sorted({m for m, _ in cfg.block_pattern
                    if m not in DENSE_MIXERS}
                   | {f for _, f in cfg.block_pattern
                      if f not in DENSE_FFNS})
    if other or cfg.frontend is not None:
        what = ", ".join(other) if other else f"the {cfg.frontend} frontend"
        raise ValueError(
            f"mesh_model={model}: {cfg.name} has {what}, which have no "
            "tensor-parallel form in this port yet; the model axis covers "
            "the dense families (attention and MLP blocks), the rest is "
            "ROADMAP A16c")
    for name, n in (("num_heads", cfg.num_heads), ("d_ff", cfg.d_ff),
                    ("vocab_size", cfg.vocab_size)):
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
    one at ``comm.k``, for ``cfg`` (refused by :func:`check_dense` when
    it has no tensor-parallel form).  ``params`` is a whole params tree
    (meta tensors do), read for its leaves' model dims (``dims``)."""

    def __init__(self, cfg, params, comm):
        check_dense(cfg, comm.model)
        self.comm = comm
        self.M, self.k = comm.model, comm.k
        self.dims = model_dims(params, self.M)
        H, KV = cfg.num_heads, cfg.num_kv_heads
        self.heads = H // self.M
        self.vocab = cfg.vocab_size // self.M
        self.v0 = self.k * self.vocab
        self.kv_whole = KV % self.M != 0
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

    def gather_tree(self, tree):
        """The whole tree of a tree of model slices (no autograd): each
        sliced leaf all-gathered over the model group."""
        def one(path, t):
            d = self.dims[path]
            if d is None:
                return t
            t = t.contiguous()
            flat = t.new_empty((self.M * t.numel(),))
            self.comm.model_all_gather_(flat, t.view(-1))
            return side_by_side(flat, t, self.M, d)
        with torch.no_grad():
            return map_with_path(one, tree)

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
