"""The language model, after the reference's ``models/model.py``:
embedding -> block groups -> final norm -> head.

Parameters keep the reference's tree: ``params["groups"]`` is a tuple
with one dict per ``block_pattern`` entry, each leaf stacked on a
leading ``num_groups`` axis, and the leaf names and shapes are the
reference's (``wq`` (d, H, hd), ``wo`` (H, hd, d), ``embed`` (V, D),
``lm_head`` (D, V), f32 norm scales).  The reference's ``lax.scan`` over
groups is a Python loop over that axis here.  There is no sharding
constraint.  With ``cfg.remat == "block"`` (every registry config's
default) the training forward checkpoints each block group, as the
reference's ``jax.checkpoint(group_body, policy=nothing_saveable)``
(``src/repro/models/model.py:112-114``): only the group's input is kept
for the backward, and the group runs again there (``models/remat.py``;
the gradient is taken with ``core/gradient.py``).  The frontends are
the reference's stubs (``src/repro/models/model.py:40-53``,
``:64-86``): an audio model (hubert) projects precomputed frame
features into d_model and has no token embedding; a vision model
(phi-3-vision) projects precomputed patch embeddings and puts them
before the text tokens, and its loss covers the text only.

Two forwards share the code: the serving one (``plain=False``) takes
every norm and full-sequence attention through the kernels, and the
training one (``plain=True``, what :func:`loss_fn` runs) through their
plain PyTorch versions, which autograd differentiates.  The reference
trains through jnp the same way
(``src/repro/kernels/flash_attention.py:82-83``); the kernels have no
backward, and their wrappers refuse inputs that require grad.

The training forward also runs over the ``model`` axis for every
family without a frontend (``tp``, ``parallel/tensor.py``): the
embedding takes its vocabulary rows in parallel, each block its heads,
MLP columns, experts or inner channels, the head gives a rank's V/M
logits, and :func:`loss_fn` takes a vocabulary-parallel cross-entropy
from them.
The MoE's aux loss is the same on every rank of a model group and is
added once, as the cross-entropy is.  The serving forward runs there too
(ROADMAP A16c.5): the prefill is the forward through the kernels on a
rank's slices, and :func:`decode_step` takes a rank's slices, its FSDP
shards and its slice of the cache (:func:`init_cache` with ``tp`` and
``data``, ``parallel/tensor.py::cache_dims``) and gives its V/M logits.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from repro_torch.models import remat
from repro_torch.models.blocks import (init_layer, init_layer_cache,
                                       layer_decode, layer_forward,
                                       rope_tables)
from repro_torch.models.config import ModelConfig
from repro_torch.models.norms import apply_norm, init_norm
from repro_torch.parallel.partition import map_with_path
from repro_torch.parallel.tensor import Spread, cache_dims, slice_shape


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _with_path(fn, tree, path: Tuple[str, ...]):
    """``fn(path, leaf)`` over a dict tree, paths as ``map_with_path``
    gives them in the params tree."""
    if isinstance(tree, dict):
        return {k: _with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def _stacked_init(make, n: int, take=None, path: Tuple[str, ...] = ()):
    """``n`` draws of the dict tree ``make()``, stacked on a leading axis
    (the reference's ``vmap``-ed init).  Each draw is copied into place
    as it is made, so the peak is the stack and one draw (a model of
    many groups at full width would not fit twice).  ``take(path,
    leaf)``, when given, keeps its part of each drawn leaf (``path``:
    the stacked leaf's in the params tree), so only those parts are
    stacked."""
    def draw():
        tree = make()
        return tree if take is None else _with_path(take, tree, path)
    first = draw()
    out = _map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    _map(lambda o, t: o[0].copy_(t), out, first)
    del first
    for g in range(1, n):
        _map(lambda o, t: o[g].copy_(t), out, draw())
    return out


def _index(tree, g: int):
    """Group ``g`` of a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def _unstack(tree, n: int):
    """The ``n`` groups of a stacked tree (views, no copy), taken by one
    ``unbind`` per leaf: its backward stacks the groups' gradients once,
    where indexing each group would write a zero-filled gradient of the
    whole stack per group and add them up."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[g] for k, v in parts.items()} for g in range(n)]
    return torch.unbind(tree)


# ------------------------------------------------------------------ init

def init_params(gen: torch.Generator, cfg: ModelConfig, take=None
                ) -> Dict[str, Any]:
    """Random params drawn from ``gen``, on ``gen``'s device.  ``take(path,
    leaf)`` (``TensorParallel.take``), when given, keeps its part of each
    leaf as it is drawn (a block group's leaf without its stacked group
    dim): the draws, and so every value, are those of the whole tree,
    and only one layer's leaves are ever whole."""
    cfg.validate()
    dtype = _dtype(cfg)
    dev = gen.device
    keep = take or _whole

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    params: Dict[str, Any] = {}
    if cfg.frontend != "audio":
        params["embed"] = keep(("embed",), normal(
            (cfg.vocab_size, cfg.d_model), cfg.d_model ** -0.5))
    if cfg.frontend is not None:
        fd, d = cfg.frontend_dim, cfg.d_model
        params["frontend_proj"] = {
            "w1": keep(("frontend_proj", "w1"), normal((fd, d), fd ** -0.5)),
            "w2": keep(("frontend_proj", "w2"), normal((d, d), d ** -0.5))}
    params["groups"] = tuple(
        _stacked_init(lambda: init_layer(gen, mixer, ffn, cfg, dtype),
                      cfg.num_groups, take, ("groups", str(j)))
        for j, (mixer, ffn) in enumerate(cfg.block_pattern))
    params["final_norm"] = _with_path(
        keep, init_norm(cfg.norm, cfg.d_model, device=dev), ("final_norm",))
    if cfg.frontend == "audio" or not cfg.tie_embeddings:
        params["lm_head"] = keep(("lm_head",), (torch.randn(
            (cfg.d_model, cfg.vocab_size), generator=gen, device=dev)
            * cfg.d_model ** -0.5).to(dtype))
    return params


class _OnMeta(TorchFunctionMode):
    """Every factory call with a ``device=`` lands on ``meta``: the
    model's own init code, unchanged, builds shapes without memory."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if "device" in kwargs:
            kwargs = {**kwargs, "device": "meta"}
        return func(*args, **kwargs)


_META: Dict[Any, Any] = {}


def meta_params(cfg: ModelConfig) -> Dict[str, Any]:
    """The model's params as meta tensors (cached by config): the leaf
    shapes and dtypes of :func:`init_params`, without memory."""
    if cfg not in _META:
        with _OnMeta():
            _META[cfg] = init_params(torch.Generator(), cfg)
    return _META[cfg]


# ------------------------------------------------------------- embedding

def embed_inputs(params, batch: Dict[str, Any], cfg: ModelConfig, tp=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,D), positions (B,S)).  Audio: ``features`` (B, S,
    frontend_dim); vision: ``image_embeds`` (B, N, frontend_dim) before
    ``tokens`` (B, S - N); else ``tokens`` (B, S), looked up in a rank's
    vocabulary rows under ``tp``."""
    dtype = _dtype(cfg)
    if cfg.frontend is not None:
        w = params["frontend_proj"]
        key = "features" if cfg.frontend == "audio" else "image_embeds"
        x = F.gelu(batch[key].to(dtype) @ w["w1"], approximate="tanh") \
            @ w["w2"]
        if cfg.frontend == "vision":
            x = torch.cat([x, params["embed"][batch["tokens"]]], dim=1)
    elif tp is not None:
        x = tp.embed(params["embed"], batch["tokens"])
    else:
        x = params["embed"][batch["tokens"]]
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    return x, positions


def _head(params, cfg: ModelConfig, take=None) -> torch.Tensor:
    take = take or _whole
    return take(("embed",), params["embed"]).T if cfg.tie_embeddings \
        else take(("lm_head",), params["lm_head"])


def _whole(path, tree):
    return tree


# the input leaves each frontend reads: the text embedding (vision reads
# both), the frontend's projection
_INPUTS = {None: ("embed",), "audio": ("frontend_proj",),
           "vision": ("embed", "frontend_proj")}


# --------------------------------------------------------------- forward

def forward(params, batch: Dict[str, Any], cfg: ModelConfig,
            plain: bool = False, gather=None, tp=None, column=None):
    """Full-sequence forward.  Returns (logits, aux_loss).  ``plain``
    takes norms and attention through their plain versions (the
    differentiable training path) instead of the kernels.

    ``params`` may be a rank's FSDP shards (``parallel/fsdp.py``); then
    ``gather(path, subtree)`` returns the whole leaves of the subtree at
    ``path``, and each part is gathered where it is used: the embedding
    (and frontend) at the input, each block group's layer inside its
    group body, one group at a time (a checkpointed group gathers again
    in its recompute), the final norm and the head at the output.

    ``tp`` (``parallel/tensor.py``): ``params`` are a rank's model slices
    (under ``gather``, their FSDP shards), and the logits are the rank's
    V/M vocabulary columns.  ``column`` (a ``GroupShards``): the
    MoE groups its tokens and takes its aux loss over the data column's
    batch (``models/moe.py``)."""
    take = gather or _whole
    inputs = {k: take((k,), params[k]) for k in _INPUTS[cfg.frontend]}
    x, positions = embed_inputs(inputs, batch, cfg, tp)
    del inputs
    ropes = rope_tables(positions, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def group_body(x, aux, group):
        group = take(("groups",), group)
        for j, (mixer, ffn) in enumerate(cfg.block_pattern):
            x, a = layer_forward(group[j], x, mixer, ffn, cfg, ropes, plain,
                                 tp, column)
            aux = aux + a
        return x, aux

    checkpointed = plain and remat.blocks_on(cfg)
    for group in zip(*(_unstack(p, cfg.num_groups)
                       for p in params["groups"])):
        x, aux = remat.run(checkpointed, group_body, x, aux, group)
    x = apply_norm(cfg.norm, take(("final_norm",), params["final_norm"]),
                   x, cfg.norm_eps, plain)
    if tp is not None:
        x = tp.copy(x)
    return x @ _head(params, cfg, take), aux


def loss_fn(params, batch: Dict[str, Any], cfg: ModelConfig,
            gather=None, tp=None, column=None):
    """Cross-entropy LM loss over the plain (differentiable) forward,
    after the reference's ``models/model.py:127-147``: float32 logits,
    logsumexp minus the gold logit, averaged over ``loss_mask`` when the
    batch has one, plus ``router_aux_coef * aux``; a vision model's loss
    covers the text positions only.  ``gather`` is :func:`forward`'s (a
    rank's FSDP shards); under ``tp`` the cross-entropy is
    vocabulary-parallel (``TensorParallel.cross_entropy``), the same loss
    on every rank of the model group; ``column`` is :func:`forward`'s.
    Returns (loss, metrics)."""
    logits, aux = forward(params, batch, cfg, plain=True, gather=gather,
                          tp=tp, column=column)
    if cfg.frontend == "vision":
        logits = logits[:, cfg.num_image_tokens:]
    logits = logits.float()
    if tp is not None:
        nll = tp.cross_entropy(logits, batch["labels"])
    else:
        nll = torch.logsumexp(logits, dim=-1) - torch.gather(
            logits, -1, batch["labels"].long()[..., None])[..., 0]
    if "loss_mask" in batch:
        mask = batch["loss_mask"].float()
        loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    else:
        loss = torch.mean(nll)
    return loss + cfg.router_aux_coef * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------- decode

def _whole_cache(cfg: ModelConfig, batch: int, max_seq: int, device):
    return tuple(
        _map(lambda v: torch.stack([v] * cfg.num_groups),
             init_layer_cache(mixer, cfg, batch, max_seq, _dtype(cfg),
                              device=device))
        for mixer, _ in cfg.block_pattern)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None,
               tp=None, data: int = 1):
    """Per-pattern-entry caches (KV, latent, SSM or xLSTM state), each
    leaf stacked on a leading ``num_groups`` axis (the reference's
    tree).  With ``tp`` (a ``TensorParallel``) or ``data`` g > 1 data
    positions, the slice of the whole cache of ``batch`` rows that a
    rank holds, made at its own size (every rank's has the same shape
    and initial values; ``parallel/tensor.py::cache_dims``): its rows'
    where g divides ``batch`` (regime (a)), else every row's, cut along
    the sequence or the channels (regime (b))."""
    g, M_ = data, 1 if tp is None else tp.M
    if M_ == 1 and g == 1:
        return _whole_cache(cfg, batch, max_seq, device)
    with _OnMeta():
        shapes = _whole_cache(cfg, batch, max_seq, None)
    dims = cache_dims(shapes, batch, g, M_)
    # each leaf's initial value (zeros; -30 for the stabilizers ``m``)
    fills = {}
    map_with_path(lambda p, t: fills.__setitem__(p, t.reshape(-1)[0]),
                  _whole_cache(cfg, 1, 1, "cpu"))

    def one(path, t):
        return torch.full(slice_shape(t.shape, dims[path], g, M_),
                          fills[path].item(), dtype=t.dtype, device=device)
    return map_with_path(one, shapes)


@functools.lru_cache(maxsize=None)
def sequence_split(cfg: ModelConfig, max_seq: int, model: int,
                   batch: int = 1, data: int = 1) -> Tuple[bool, ...]:
    """Whether each pattern entry's cache of length ``max_seq`` holds a
    slice of its sequence, as the partition rule cuts it over ``data``
    positions x ``model`` ranks at a global ``batch``
    (``parallel/tensor.py::cache_dims``): over the model ranks where the
    data axis divides the batch (attention's where M does not divide its
    kv heads, MLA's), else (regime (b)) over the data positions or all
    D M ranks (attention's and MLA's); each where they divide its
    length."""
    with _OnMeta():
        shapes = _whole_cache(cfg, batch, max_seq, None)
    dims = cache_dims(shapes, batch, data, model)
    return tuple(any(2 in dims[(str(j), k)][:2] for k in ("k", "c_kv")
                     if (str(j), k) in dims)
                 for j in range(len(cfg.block_pattern)))


def served_batch(global_batch: int, data: int) -> int:
    """``global_batch``, checked: the regime follows from it and the
    ``data`` positions, so a sliced call over more than one position
    must name it (0 only where ``data`` is 1)."""
    if data > 1 and global_batch < 1:
        raise ValueError(f"serving over {data} data positions needs "
                         "global_batch, the batch they serve between them")
    return global_batch


def decode_step(params, cache, tokens, cur_index: int, cfg: ModelConfig,
                gather=None, tp=None, column=None, max_seq: int = 0,
                global_batch: int = 0):
    """One-token decode.  tokens: (B, 1) int; ``cur_index``: tokens
    already in the cache (a Python int).  Returns (logits, cache); the
    cache is updated in place and returned.  ``gather``, ``tp`` and
    ``column`` are :func:`forward`'s: ``params`` a rank's model slices
    (under ``gather``, their FSDP shards, each block group's layer
    gathered in its turn), ``cache`` its slice (:func:`init_cache` at
    ``max_seq`` and ``global_batch``, which say how it is cut:
    :func:`sequence_split`), the logits its V/M vocabulary columns.
    ``global_batch`` is the batch the data positions serve between them,
    needed where there are more than one (a ``ValueError`` without it);
    where they do not divide it (regime (b)) ``tokens`` are all its
    rows, replicated on every rank, and the layers run under a
    ``Spread`` of the column's replica group."""
    data = 1 if column is None else column.g
    batch = served_batch(global_batch, data) or tokens.shape[0]
    sp = None if batch % data == 0 else Spread(column.comm, data,
                                               column.rank)
    split = (False,) * len(cfg.block_pattern)
    if (tp is not None and tp.M > 1) or sp is not None:
        if max_seq < 1:
            raise ValueError("a sliced decode_step needs max_seq, the "
                             "length its cache was made at")
        split = sequence_split(cfg, max_seq, 1 if tp is None else tp.M,
                               batch, data)
    take = gather or _whole
    embed = take(("embed",), params["embed"])
    x = (embed[tokens] if tp is None else tp.embed(embed, tokens)
         ).to(_dtype(cfg))
    del embed
    positions = torch.full(tuple(tokens.shape), cur_index, dtype=torch.int32,
                           device=x.device)
    ropes = rope_tables(positions, cfg)
    for g in range(cfg.num_groups):
        group = take(("groups",), tuple(_index(p, g)
                                        for p in params["groups"]))
        for j, (mixer, ffn) in enumerate(cfg.block_pattern):
            x, _ = layer_decode(group[j], x, _index(cache[j], g), cur_index,
                                mixer, ffn, cfg, ropes, tp,
                                column if sp is None else None, split[j],
                                sp)
        del group
    x = apply_norm(cfg.norm, take(("final_norm",), params["final_norm"]),
                   x, cfg.norm_eps)
    if tp is not None:
        x = tp.copy(x)
    return x @ _head(params, cfg, take), cache
