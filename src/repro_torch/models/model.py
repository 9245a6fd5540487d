"""The language model, after the reference's ``models/model.py``:
embedding -> block groups -> final norm -> head.

Parameters keep the reference's tree: ``params["groups"]`` is a tuple
with one dict per ``block_pattern`` entry, each leaf stacked on a
leading ``num_groups`` axis, and the leaf names and shapes are the
reference's (``wq`` (d, H, hd), ``wo`` (H, hd, d), ``embed`` (V, D),
``lm_head`` (D, V), f32 norm scales).  The reference's ``lax.scan`` over
groups is a Python loop over that axis here.  There is no sharding
constraint and no rematerialisation.  Token inputs only; the audio and
vision frontends are not ported yet (ROADMAP A12b).

Two forwards share the code: the serving one (``plain=False``) takes
every norm and full-sequence attention through the kernels, and the
training one (``plain=True``, what :func:`loss_fn` runs) through their
plain PyTorch versions, which autograd and ``torch.func.grad``
differentiate.  The reference trains through jnp the same way
(``src/repro/kernels/flash_attention.py:82-83``); the kernels have no
backward, and their wrappers refuse inputs that require grad.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.blocks import (init_layer, init_layer_cache,
                                       layer_decode, layer_forward)
from repro_torch.models.config import ModelConfig
from repro_torch.models.norms import apply_norm, init_norm
from repro_torch.models.rope import rope_table


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _refuse_frontend(cfg: ModelConfig) -> None:
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend is not ported yet "
            "(ROADMAP A12b)")


def _stack(trees):
    """A list of same-shaped dicts of tensors -> one dict of stacked
    tensors (the reference's ``vmap``-ed init)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, g: int):
    """Group ``g`` of a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


# ------------------------------------------------------------------ init

def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Random params drawn from ``gen``, on ``gen``'s device."""
    cfg.validate()
    _refuse_frontend(cfg)
    dtype = _dtype(cfg)
    dev = gen.device
    params: Dict[str, Any] = {
        "embed": (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                              device=dev) * cfg.d_model ** -0.5).to(dtype)}
    params["groups"] = tuple(
        _stack([init_layer(gen, mixer, ffn, cfg, dtype)
                for _ in range(cfg.num_groups)])
        for mixer, ffn in cfg.block_pattern)
    params["final_norm"] = init_norm(cfg.norm, cfg.d_model, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = (torch.randn(
            (cfg.d_model, cfg.vocab_size), generator=gen, device=dev)
            * cfg.d_model ** -0.5).to(dtype)
    return params


# ------------------------------------------------------------- embedding

def embed_inputs(params, batch: Dict[str, Any], cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,D), positions (B,S))."""
    _refuse_frontend(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    return x, positions


def _head(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# --------------------------------------------------------------- forward

def forward(params, batch: Dict[str, Any], cfg: ModelConfig,
            plain: bool = False):
    """Full-sequence forward.  Returns (logits, aux_loss).  ``plain``
    takes norms and attention through their plain versions (the
    differentiable training path) instead of the kernels."""
    x, positions = embed_inputs(params, batch, cfg)
    rope = rope_table(positions, cfg.resolved_head_dim, cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(cfg.num_groups):
        for j, (mixer, ffn) in enumerate(cfg.block_pattern):
            x, a = layer_forward(_index(params["groups"][j], g), x, mixer,
                                 ffn, cfg, rope, plain)
            aux = aux + a
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps, plain)
    return x @ _head(params, cfg), aux


def loss_fn(params, batch: Dict[str, Any], cfg: ModelConfig):
    """Cross-entropy LM loss over the plain (differentiable) forward,
    after the reference's ``models/model.py:127-147``: float32 logits,
    logsumexp minus the gold logit, averaged over ``loss_mask`` when the
    batch has one, plus ``router_aux_coef * aux``.  Returns (loss,
    metrics)."""
    logits, aux = forward(params, batch, cfg, plain=True)
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, batch["labels"].long()[..., None])[..., 0]
    if "loss_mask" in batch:
        mask = batch["loss_mask"].float()
        loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    else:
        loss = torch.mean(nll)
    return loss + cfg.router_aux_coef * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------- decode

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Per-pattern-entry KV caches, each leaf stacked on a leading
    ``num_groups`` axis (the reference's tree)."""
    dtype = _dtype(cfg)
    return tuple(
        {k: torch.stack([v] * cfg.num_groups) for k, v in
         init_layer_cache(mixer, cfg, batch, max_seq, dtype,
                          device=device).items()}
        for mixer, _ in cfg.block_pattern)


def decode_step(params, cache, tokens, cur_index: int, cfg: ModelConfig):
    """One-token decode.  tokens: (B, 1) int; ``cur_index``: tokens
    already in the cache (a Python int).  Returns (logits, cache); the
    cache is updated in place and returned."""
    x = params["embed"][tokens].to(_dtype(cfg))
    positions = torch.full(tuple(tokens.shape), cur_index, dtype=torch.int32,
                           device=x.device)
    rope = rope_table(positions, cfg.resolved_head_dim, cfg.rope_theta)
    for g in range(cfg.num_groups):
        for j, (mixer, ffn) in enumerate(cfg.block_pattern):
            x, _ = layer_decode(_index(params["groups"][j], g), x,
                                _index(cache[j], g), cur_index, mixer, ffn,
                                cfg, rope)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    return x @ _head(params, cfg), cache
