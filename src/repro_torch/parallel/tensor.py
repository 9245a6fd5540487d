"""The ``model`` axis within a replica group: the counterpart of GSPMD's
partitioning over the reference's ``model`` mesh axis, for attention
(grouped-query and MLA), the MLP, the MoE, mamba and the xLSTM cells.

The reference marks its tensor-parallel boundaries with activation
constraints (``src/repro/models/attention.py:55-57`` q/k/v over heads,
``:161-163`` the output over heads and ``y`` whole,
``models/mla.py:71-78``, ``models/mlp.py:25-33``, ``models/moe.py:68``,
``:98-105`` and ``:112``, ``models/mamba.py:75`` and ``:99-101``,
``models/xlstm.py:139``, ``models/model.py:92`` ``x`` whole and
``:123`` the logits over ``vocab``) and lets GSPMD place the
collectives.  Here they are explicit, Megatron-style.  A rank holds the
model slice of each leaf that the partition rules shard over ``model``
(``parallel/partition.py`` over ``{"data": g, "model": M}``, sanitized):
its H/M query heads (MLA's ``wq``, ``w_uk``, ``w_uv`` and ``wo`` too),
KV/M kv heads, d_ff/M MLP columns (the MoE's shared expert's too), E/M
experts, V/M vocabulary rows, di/M of mamba's and the mLSTM's inner
channels and d/M of the sLSTM's gate channels (with its H/M heads of
``r_h``), contiguous, the k-th of M for model index k; every other leaf
(the norms, MLA's latent projections ``w_dkv``/``w_kr``, the MoE's
``router``, the mLSTM's ``lq``/``lk``/``lv``/``w_if``/``b_if``, the
sLSTM's ``gn_scale`` and its FFN where M does not divide its width) is
whole on every rank.  Mamba's ``w_in`` holds ``xi`` and ``z`` side by
side (``src/repro/models/mamba.py:73-74``): a rank holds columns
``[k di/M, (k+1) di/M)`` of each half, the two side by side
(:data:`PAIRED`), so its channels of both come from one product;
:meth:`TensorParallel.slice` and :meth:`TensorParallel.gather_host`
convert from and to the reference's whole leaf.

Five autograd Functions carry the boundaries, the loss being computed
alike on every rank of a model group.  Which one a value takes depends
on whether the ranks then use it alike or each for its own slice:

* :class:`CopyToModel` (identity forward, all-reduce backward): the
  input of a column-parallel product (q/k/v, ``w_up``/``w_gate``, the
  head, the experts, mamba's ``w_in``, the xLSTM's up-projections and
  ``w_x``), whose gradient each rank holds a part of, and what a rank's
  heads or experts read of a value every rank computes alike (MLA's
  latent and rope key, the MoE's gate values);
* :class:`ReduceFromModel` (all-reduce forward, identity backward): the
  output of a row-parallel product that every rank then uses alike
  (``wo``, ``w_down``, mamba's ``w_out``, the MoE's experts and shared
  expert summed in one) and the vocabulary-parallel embedding and gold
  logit;
* :class:`SumOverModel` (all-reduce forward and backward): a
  row-parallel product that each rank then reads for its own channels
  only (mamba's ``proj``, ``xc @ w_x``, in each scan chunk): the
  gradient parts are summed as the forward's parts are;
* :class:`GatherFromModel` (all-gather forward; the backward keeps the
  rank's own slice, without summing): a value every rank then uses
  alike (the local logsumexps of the vocabulary-parallel loss, the
  sLSTM's gate pre-activations and its ``r_h``, whose recurrence every
  rank runs whole);
* :class:`GatherForModel` (all-gather forward; reduce-scatter
  backward): a value each rank then reads for its own heads only (the
  mLSTM's ``xc`` and ``u``, which its q, k, v and gates contract over
  all di): the gradient parts are summed.

Each of their collectives is timed as ``"tensor"``.  Where M does not
divide KV, ``wk``/``wv`` (and ``bk``/``bv``) stay whole by the sanitize
rule: a rank takes the kv heads its query heads map to
(:meth:`TensorParallel.kv`).  Those leaves, and the mLSTM's whole
``lq``/``lk``/``lv``/``w_if``/``b_if`` that a rank reads for its own
heads, get a part of their gradient on each rank, summed over the model
group once a step (:meth:`TensorParallel.sum_partial`, timed as
``"gradient"``).  The MoE routes alike on every rank of a group (its
input is whole and equal there); :meth:`TensorParallel.route` keeps a
digest of each MoE layer's routing to show it.  The frontends have no
form here yet (ROADMAP A16c) and are refused (:func:`check_model_axis`).

The serving forward (ROADMAP A16c.5, regime (a): a batch the data axis
divides) runs on the same slices.  A rank holds its slice of the
decode cache (:func:`cache_dims`, after ``parallel/partition.py``'s
``cache_specs``): its B/g batch rows, and over ``model`` the rule's dim
(an attention cache's kv heads where M divides them, else its
sequence; MLA's latent sequence; a state's trailing dim), except where
the port's compute splits another dim of equal bytes (mamba's ``h`` on
its channels, the mLSTM's ``C`` and ``n`` on their heads: ROADMAP
C.53).  Where the cache's sequence is split, a rank scores every
head's query over its slots and the group combines the partial
softmaxes (:meth:`TensorParallel.softmax`).  The greedy token is the
argmax over the vocabulary shards (:meth:`TensorParallel.argmax`).

A batch the data positions do not divide (``long_500k``'s B 1) is
regime (b) (ROADMAP A16c.5b): its rows are replicated on every rank of
the replica group of D data positions x M model ranks (:class:`Spread`),
and no leaf of the cache is cut along its batch.  A rank holds, after
the rule's tiny-batch branch, a k/v cache's sequence over ``data`` (its
kv heads over ``model``; the sequence over ``data x model`` where M does
not divide the kv heads), MLA's latent sequence over ``data x model``
and each state's channel dim over ``data x model``: one contiguous chunk
of D M, the chunk ``d M + k`` (:class:`Cut`), except where the port's
compute reads the chunk for its model slice of the params (``conv`` and
mamba's ``h``: the chunk ``k D + d``, the d-th part of its model slice,
the same dim and bytes: ROADMAP C.54).  A split sequence is combined
over the data column or the replica group (:func:`group_softmax`); the
recurrences gather and sum their channels over the replica group each
step (:meth:`Spread.gather`, :meth:`Spread.sum`).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import activations as act
from repro_torch.models.config import (ATTN, ATTN_GLOBAL, MAMBA, MLA, MLP,
                                       MLSTM, MOE, NONE, SLSTM)
from repro_torch.models.xlstm import _mlstm_dims
from repro_torch.parallel.fsdp import axis_dims, side_by_side
from repro_torch.parallel.partition import cache_leaf_specs, map_with_path

Path = Tuple[str, ...]
MODEL_AXIS_MIXERS = (ATTN, ATTN_GLOBAL, MLA, MAMBA, MLSTM, SLSTM)
MODEL_AXIS_FFNS = (MLP, MOE, NONE)
# the leaves of a kv head: whole when M does not divide KV
KV_LEAVES = ("wk", "wv", "bk", "bv")
# the mLSTM's leaves whole over ``model`` that a rank reads for its own
# heads only: their gradients are summed over the model group
HEAD_READ_LEAVES = ("lq", "lk", "lv", "w_if", "b_if")
# leaves holding several tensors side by side along their model dim: a
# rank holds its slice of each (mamba's ``w_in``: ``xi`` and ``z``)
PAIRED = {"w_in": 2}
# decode-cache leaves the port splits over ``model`` on another dim than
# the partition rule's, with the same bytes (ROADMAP C.53), by (name,
# ndim): mamba's ``h`` (G, B, di, ds) on its channels, the mLSTM's ``C``
# (G, B, H, dh, dh) and ``n`` (G, B, H, dh) on their heads
CACHE_DIM = {("h", 4): 2, ("C", 5): 2, ("n", 4): 2}
# decode-cache leaves whose sequence the rule may cut: every other leaf
# is a state
SEQUENCE_LEAVES = ("k", "v", "c_kv", "k_rope")
# regime (b)'s cuts over data x model that the port takes model-major
# (chunk k D + d), by (name, ndim): ``conv`` (G, B, dc - 1, di) of mamba
# and the mLSTM and mamba's ``h`` (G, B, di, ds), whose channels a rank
# reads with its model slice of the params (ROADMAP C.54)
MODEL_MAJOR = {("conv", 4), ("h", 4)}
# an odd 64-bit multiplier (2**64 / golden ratio, as a signed int64):
# position i of a routing weighs (i + 1) times it in its digest
_GOLDEN = -7046029254386353131


def check_model_axis(cfg, model: int) -> None:
    """Raise ``ValueError`` naming ROADMAP A16c unless ``cfg`` has a
    tensor-parallel form at ``model`` M: no frontend, and M dividing the
    heads, the vocabulary, the MLP width, the experts, the shared
    experts' width, mamba's inner width, the mLSTM's inner width and the
    sLSTM's d_model (the kv heads may stay whole)."""
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
            "attention, MLA, MLP, MoE, mamba, mLSTM and sLSTM blocks, the "
            "rest is ROADMAP A16c")
    dims = [("num_heads", cfg.num_heads), ("vocab_size", cfg.vocab_size)]
    if MLP in ffns:
        dims.append(("d_ff", cfg.d_ff))
    if MOE in ffns:
        dims.append(("num_experts", cfg.num_experts))
        if cfg.num_shared_experts:
            dims.append(("moe_d_ff * num_shared_experts",
                         (cfg.moe_d_ff or cfg.d_ff)
                         * cfg.num_shared_experts))
    if MAMBA in mixers:
        dims.append(("mamba_d_inner", cfg.mamba_d_inner))
    if MLSTM in mixers:
        dims.append(("mLSTM inner width", _mlstm_dims(cfg)[0]))
    if SLSTM in mixers:
        dims.append(("d_model (the sLSTM's gate channels)", cfg.d_model))
    for name, n in dims:
        if n % model:
            raise ValueError(f"mesh_model={model} does not divide "
                             f"{cfg.name}'s {name} ({n}): ROADMAP A16c")


class Cut(NamedTuple):
    """How a rank holds a decode-cache leaf: ``data`` and ``model`` are
    the dims it holds a contiguous slice of over the data positions and
    over the model ranks (None: whole along that axis).  Where both name
    one dim (regime (b)'s cuts over data x model) a rank holds one chunk
    of D M: the chunk ``d M + k`` (the rule's, the mesh axes' order),
    or, ``model_major``, the chunk ``k D + d``."""
    data: Optional[int]
    model: Optional[int]
    model_major: bool = False


def cache_dims(cache, batch: int, data: int, model: int
               ) -> Dict[Path, Cut]:
    """Each leaf of a whole decode cache (``models/model.py::init_cache``
    at the global ``batch``) as the :class:`Cut` a rank of ``data``
    positions x ``model`` ranks holds, after the partition rule: regime
    (a) (a batch the data axis divides) with :data:`CACHE_DIM`'s
    deviations, regime (b) (a batch it does not divide) with
    :data:`MODEL_MAJOR`'s.  In regime (b) a state leaf the D M ranks do
    not divide, which the rule keeps whole, is refused naming ROADMAP
    A16c.6."""
    specs = cache_leaf_specs(cache, batch, {"data": data, "model": model})
    dims = {}
    for path, spec in specs.items():
        leaf_key = (path[-1], len(spec))
        if batch % data == 0:
            mdim = next((d for d, axes in enumerate(spec)
                         if axes == "model"), None) if model > 1 else None
            if model > 1 and leaf_key in CACHE_DIM:
                mdim = CACHE_DIM[leaf_key]
            dims[path] = Cut(1 if data > 1 else None, mdim)
            continue

        def over(axis):
            return next((d for d, axes in enumerate(spec)
                         if axes == axis or (isinstance(axes, tuple)
                                             and axis in axes)), None)
        if over("data") is None and path[-1] not in SEQUENCE_LEAVES:
            raise ValueError(
                f"a batch of {batch} over {data} data positions: the "
                f"{data * model} ranks of data x model do not divide the "
                f"cache leaf {'/'.join(path)}, which the rule keeps "
                "whole: ROADMAP A16c.6")
        dims[path] = Cut(over("data"), over("model") if model > 1 else None,
                         model > 1 and leaf_key in MODEL_MAJOR)
    return dims


def slice_shape(shape, dims, data: int, model: int) -> Tuple[int, ...]:
    """What a rank holds of a cache leaf of ``shape`` cut as ``dims``
    (its :func:`cache_dims` entry) over ``data`` x ``model`` ranks."""
    out = list(shape)
    for d, n in zip(dims, (data, model)):
        if d is not None:
            out[d] //= n
    return tuple(out)


def slice_cache(cache, dims, position: int, k: int, data: int,
                model: int):
    """The slice of a whole decode cache that data position
    ``position``, model index ``k`` holds (fresh contiguous tensors)."""
    def one(path, t):
        cut = dims[path]
        steps = [(cut.data, position, data), (cut.model, k, model)]
        for d, i, n in (steps[::-1] if cut.model_major else steps):
            if d is not None:
                w = t.shape[d] // n
                t = t.narrow(d, i * w, w)
        return t.clone(memory_format=torch.contiguous_format)
    return map_with_path(one, cache)


def _cat(ts, dim: Optional[int]) -> torch.Tensor:
    return ts[0] if dim is None else torch.cat(ts, dim=dim)


def unslice_cache(parts, dims, data: int, model: int):
    """The whole decode cache of the W = data x model ranks' slices
    ``parts`` (rank ``position * model + k``'s at index r): the inverse
    of :func:`slice_cache`."""
    def one(path, *ts):
        cut = dims[path]
        if cut.model_major:
            return _cat([_cat([ts[p * model + k] for p in range(data)],
                              cut.data) for k in range(model)], cut.model)
        return _cat([_cat(list(ts[p * model:(p + 1) * model]), cut.model)
                     for p in range(data)], cut.data)
    leaves = [dict(_flat(p)) for p in parts]
    return map_with_path(lambda path, _: one(path, *(l[path]
                                                     for l in leaves)),
                         parts[0])


def _flat(tree):
    out = []
    map_with_path(lambda p, t: out.append((p, t)), tree)
    return out


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


class SumOverModel(torch.autograd.Function):
    """``SumOverModel.apply(x, comm)``: ``x`` summed over the model group
    forward; backward, the gradient summed over the group too (each
    rank reads the sum for its own channels, so each holds a part of
    its gradient)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return _all_reduce(x, comm)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.comm), None


def _gather(x: torch.Tensor, comm, dim: int) -> torch.Tensor:
    x = x.contiguous()
    flat = x.new_empty((comm.model * x.numel(),))
    with comm.timing("tensor"):
        comm.model_all_gather_(flat, x.view(-1))
    return side_by_side(flat, x, comm.model, dim)


class GatherFromModel(torch.autograd.Function):
    """``GatherFromModel.apply(x, comm, dim=-1)``: the model group's
    ``x`` laid side by side along ``dim`` forward; backward, the rank's
    own slice of the gradient (every rank then computes alike, so the
    gradient is the same on every rank and nothing is summed)."""

    @staticmethod
    def forward(ctx, x, comm, dim: int = -1):
        ctx.dim = dim % x.ndim
        ctx.k, ctx.n = comm.k, x.shape[ctx.dim]
        return _gather(x, comm, ctx.dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.k * ctx.n, ctx.n).contiguous(),
                None, None)


class GatherForModel(torch.autograd.Function):
    """``GatherForModel.apply(x, comm, dim)``: the model group's ``x``
    laid side by side along ``dim`` forward; backward, the rank's slice
    of the gradient summed over the group (a reduce-scatter, in float32
    and cast back): each rank reads the whole value for its own heads,
    so each holds a part of its gradient."""

    @staticmethod
    def forward(ctx, x, comm, dim: int):
        ctx.dim, ctx.comm = dim % x.ndim, comm
        return _gather(x, comm, ctx.dim)

    @staticmethod
    def backward(ctx, grad):
        comm, M = ctx.comm, ctx.comm.model
        parts = grad.unflatten(ctx.dim, (M, -1)).movedim(ctx.dim, 0)
        staged = torch.empty(parts.shape, dtype=torch.float32,
                             device=grad.device)
        staged.copy_(parts)
        out = staged.new_empty(staged.shape[1:])
        with comm.timing("tensor"):
            comm.model_reduce_scatter_(out.view(-1), staged.view(-1))
        return out.to(grad.dtype), None, None


def group_softmax(scores: torch.Tensor, weigh, comm, over: str,
                  data: int = 1) -> torch.Tensor:
    """The softmax over the keys of a group of ranks, each holding
    ``scores`` (..., L/n) float32 for its own: ``weigh(e)`` is a rank's
    sum of its values weighted by ``e`` (..., dv).  ``over`` names the
    group: ``"model"`` (the model group), ``"data"`` (the data column
    of a replica group of ``data`` positions) or ``"replica"`` (that
    replica group, ``data`` x M ranks).  Each rank gives its largest
    score m, ``sum(exp(score - m))`` and ``weigh(exp(score - m))``; one
    all-gather (timed as ``"combine"``), and every rank adds the parts
    in rank order, so each gets the same float32 result (ROADMAP C.53).
    A rank with no valid key yet (its scores all masked at -1e30) weighs
    its part by ``exp(-1e30 - top) = 0``: it adds exactly nothing."""
    top = torch.amax(scores, dim=-1, keepdim=True)
    e = act.exp(scores - top)
    mine = torch.cat([top, torch.sum(e, dim=-1, keepdim=True),
                      weigh(e)], dim=-1).contiguous()
    n = {"model": comm.model, "data": data,
         "replica": data * comm.model}[over]
    flat = mine.new_empty((n * mine.numel(),))
    with comm.timing("combine"):
        if over == "model":
            comm.model_all_gather_(flat, mine.view(-1))
        elif over == "data":
            comm.all_gather_(flat, mine.view(-1), data)
        else:
            comm.replica_all_gather_(flat, mine.view(-1), data)
    parts = flat.view((n,) + tuple(mine.shape))
    top = torch.amax(parts[..., :1], dim=0)
    s_all = o_all = None
    for k in range(n):
        w = act.exp(parts[k, ..., :1] - top)
        s_k, o_k = w * parts[k, ..., 1:2], w * parts[k, ..., 2:]
        s_all = s_k if s_all is None else s_all + s_k
        o_all = o_k if o_all is None else o_all + o_k
    return o_all / s_all


class Spread:
    """Regime (b)'s place of one rank (ROADMAP A16c.5b): a batch the
    data positions do not divide is replicated on every rank of the
    replica group of ``data`` positions D x M model ranks (``comm``'s
    M), this rank at ``position`` d and model index k.  Its cache holds
    one chunk of D M of a split sequence or channel dim: the chunk
    ``r = d M + k`` (:meth:`chunk`), or of a value over its model slice
    the d-th part (:meth:`mine`, the chunk ``k D + d`` of the whole:
    :data:`MODEL_MAJOR`).  The recurrences' collectives over the replica
    group and the data column are timed as ``"state"``."""

    def __init__(self, comm, data: int, position: int):
        self.comm = comm
        self.D, self.d = int(data), int(position)
        self.M, self.k = comm.model, comm.k
        self.R = self.D * self.M
        self.r = self.d * self.M + self.k
        # the whole's chunk c = k D + d comes from replica rank d M + k
        self._model_major = [(c % self.D) * self.M + c // self.D
                             for c in range(self.R)]

    def mine(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The d-th of D contiguous parts of ``t`` along ``dim``."""
        n = t.shape[dim] // self.D
        return t.narrow(dim, self.d * n, n)

    def chunk(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Chunk ``d M + k`` of D M of ``t`` along ``dim``."""
        n = t.shape[dim] // self.R
        return t.narrow(dim, self.r * n, n)

    def softmax(self, scores: torch.Tensor, weigh, over: str
                ) -> torch.Tensor:
        """:func:`group_softmax` over the data column (``"data"``) or the
        replica group (``"replica"``)."""
        return group_softmax(scores, weigh, self.comm, over, self.D)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the replica group in float32 (one
        all-reduce: every rank gets the same sum)."""
        out = t.to(torch.float32, copy=True).contiguous()
        with self.comm.timing("state"):
            self.comm.replica_all_reduce_(out.view(-1), self.D)
        return out

    def gather(self, *parts):
        """Each part ``(t, dim, model_major)`` is a rank's chunk of a
        value along ``dim`` (chunk ``d M + k``, or ``k D + d`` where
        ``model_major``): the values whole, from one all-gather over the
        replica group in float32, each cast back to its dtype."""
        flat = torch.cat([t.float().reshape(-1) for t, _, _ in parts])
        out = flat.new_empty((self.R * flat.numel(),))
        with self.comm.timing("state"):
            self.comm.replica_all_gather_(out, flat, self.D)
        rows = out.view(self.R, -1)
        whole, at = [], 0
        for t, dim, model_major in parts:
            chunks = rows[:, at:at + t.numel()].unflatten(1, t.shape)
            if model_major:
                chunks = chunks[self._model_major]
            dim %= t.ndim
            whole.append(chunks.movedim(0, dim).flatten(dim, dim + 1)
                         .to(t.dtype))
            at += t.numel()
        return whole

    def column(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The data column's ``t`` laid side by side along ``dim`` in
        position order: a rank's model slice of a value whose d-th part
        (:meth:`mine`) each rank holds."""
        t = t.contiguous()
        flat = t.new_empty((self.D * t.numel(),))
        with self.comm.timing("state"):
            self.comm.all_gather_(flat, t.view(-1), self.D)
        return side_by_side(flat, t, self.D, dim % t.ndim)


def _pair_view(t: torch.Tensor, dim: int, pairs: int) -> torch.Tensor:
    """``t`` with ``dim`` split into (pairs, rest)."""
    return t.unflatten(dim, (pairs, t.shape[dim] // pairs))


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
        self.shapes: Dict[Path, Tuple[int, ...]] = {}
        map_with_path(lambda p, t: self.shapes.__setitem__(
            p, tuple(t.shape)), params)
        # the sliced leaves holding tensors side by side (PAIRED)
        self.pairs = {p: PAIRED[p[-1]] for p, d in self.dims.items()
                      if d is not None and p[-1] in PAIRED}
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
        # the sLSTM's FFN is sliced only where M divides its width (in no
        # registry config): then column- and row-parallel as the MLP
        self.slstm_ffn = any(
            self.dims[("groups", str(j), "mixer", "w_up")] is not None
            for j, (m, _) in enumerate(cfg.block_pattern) if m == SLSTM)
        self.partial = {p for p, d in self.dims.items()
                        if d is None and p[0] == "groups" and (
                            (self.kv_whole and p[-1] in KV_LEAVES)
                            or p[-1] in HEAD_READ_LEAVES)}

    # ------------------------------------------------------------ leaves

    def take(self, path: Path, leaf: torch.Tensor) -> torch.Tensor:
        """This rank's model slice of the whole leaf at ``path`` (a fresh
        contiguous tensor; a whole leaf is the leaf).  A leaf under
        ``"groups"`` may come without its stacked group dim (one group's
        draw) or with it."""
        d = self.dims[path]
        if d is None:
            return leaf
        full = len(self.shapes[path])
        d -= full - leaf.ndim
        pairs = self.pairs.get(path, 1)
        t = _pair_view(leaf, d, pairs)
        n = t.shape[d + 1] // self.M
        return t.narrow(d + 1, self.k * n, n).flatten(d, d + 1).clone(
            memory_format=torch.contiguous_format)

    def slice(self, tree):
        """This rank's model slices of a whole tree shaped like the
        params (fresh contiguous tensors; a whole leaf is the leaf)."""
        return map_with_path(self.take, tree)

    def gather_host(self, tree, device: torch.device, piece: int):
        """On model index 0, the whole tree of a host tree of model
        slices, in host memory (None on the other ranks): each sliced
        leaf is all-gathered over the model group through ``device`` in
        pieces along its first dim of at most ``piece`` elements a rank,
        each piece copied to the host as it comes.  A paired leaf's
        slices are laid back into the reference's whole layout."""
        def one(path, t):
            d = self.dims[path]
            if d is None:
                return t
            n0 = t.shape[0]
            full = list(t.shape)
            full[d] *= self.M
            out = torch.empty(full, dtype=t.dtype) if self.k == 0 else None
            step = max(1, piece // max(1, t[0].numel()))
            pairs = self.pairs.get(path, 1)
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
                    continue
                whole = side_by_side(flat, part, self.M, d)
                if pairs > 1:
                    # (M, pairs, n) along d, as the ranks hold it, to
                    # (pairs, M, n), the reference's order
                    whole = whole.unflatten(d, (self.M, pairs, -1)) \
                        .transpose(d, d + 1).flatten(d, d + 2)
                out[i:i + part.shape[0]] = whole.cpu()
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
        """``grads`` with the gradients of the whole leaves that each rank
        reads for its own heads only (kv-head leaves where M does not
        divide KV, the mLSTM's ``lq``/``lk``/``lv``/``w_if``/``b_if``),
        summed over the model group."""
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

    # ------------------------------------------------------------ serving

    def softmax(self, scores: torch.Tensor, weigh, over: str = "model"
                ) -> torch.Tensor:
        """:func:`group_softmax` over the model group (regime (a); the
        data column and the replica group are :class:`Spread`'s)."""
        return group_softmax(scores, weigh, self.comm, over)

    def argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """The greedy token (int32, ``logits``' shape without its last
        dim) from this rank's V/M vocabulary columns: each rank's largest
        logit and its index, gathered over the model group; the largest
        wins, a tie going to the lower index, as ``torch.argmax`` takes
        the first."""
        val, idx = torch.max(logits, dim=-1)
        mine = torch.stack([val.double(), (idx + self.v0).double()], -1)
        flat = mine.new_empty((self.M * mine.numel(),))
        with self.comm.timing("argmax"):
            self.comm.model_all_gather_(flat, mine.reshape(-1))
        parts = flat.view((self.M,) + tuple(mine.shape))
        best = parts[0]
        for k in range(1, self.M):
            best = torch.where((parts[k, ..., :1] > best[..., :1]),
                               parts[k], best)
        return best[..., 1].to(torch.int32)

    # ------------------------------------------------------- activations

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return CopyToModel.apply(x, self.comm)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return ReduceFromModel.apply(x, self.comm)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """:class:`SumOverModel`: a row-parallel product each rank then
        reads for its own channels."""
        return SumOverModel.apply(x, self.comm)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """:class:`GatherFromModel`: the whole of ``x`` along ``dim``,
        which every rank then uses alike."""
        return GatherFromModel.apply(x, self.comm, dim)

    def gather_for_heads(self, x: torch.Tensor, dim: int = -1
                         ) -> torch.Tensor:
        """:class:`GatherForModel`: the whole of ``x`` along ``dim``,
        which each rank then reads for its own heads."""
        return GatherForModel.apply(x, self.comm, dim)

    def my_heads(self, leaf: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's H/M heads of a leaf whole over ``model`` (the
        mLSTM's ``lq``/``lk``/``lv``/``w_if``/``b_if``), along ``dim``."""
        return leaf.narrow(dim, self.k * self.heads, self.heads)

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
        lse = torch.logsumexp(self.gather(
            torch.logsumexp(logits, dim=-1)[..., None]), dim=-1)
        local = labels.long() - self.v0
        held = (local >= 0) & (local < self.vocab)
        gold = torch.gather(logits, -1, local.clamp(0, self.vocab - 1)
                            [..., None])[..., 0]
        gold = self.reduce(torch.where(held, gold, torch.zeros_like(gold)))
        return lse - gold
