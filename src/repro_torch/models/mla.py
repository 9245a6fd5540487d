"""DeepSeek-V2 multi-head latent attention (MLA), after the reference's
``models/mla.py``.

Keys and values are compressed into a low-rank latent ``c_kv``
(``kv_lora_rank``) plus one shared rope key (``rope_head_dim``);
per-head keys and values are expanded from the latent.  The
full-sequence path runs the flash_attention kernel with q and k of
width ``head_dim + rope_head_dim`` and v of ``v_head_dim`` (as the
reference passes them to ``rowblock_attention`` with
``global_layer=True``: no window, no chunk), or with ``plain=True`` its
plain version in query blocks, checkpointed under remat
(``attention.py::plain_attention``).  The decode cache holds only
``(c_kv, k_rope)`` and decode is the absorbed form, plain PyTorch in
float32 as the reference's jnp.

With a tensor-parallel context ``tp`` (``parallel/tensor.py``; the
training forward at ``mesh_model`` M > 1) a rank holds its H/M heads of
``wq``, ``w_uk``, ``w_uv`` and ``wo`` and the latent projections
``w_dkv``/``w_kr`` whole, as the reference's partition rules place them
(``src/repro/parallel/partition.py:44-57``).  Every rank computes the
latent and the rope key alike; its heads read them through
``tp.copy``, so their gradients, partial on each rank, are summed there
and ``w_dkv``/``w_kr`` get the same full gradient on every rank.  The
queries' input goes through ``tp.copy`` too; ``wo`` is row-parallel and
its output is summed over the model group.  The decode takes ``tp``
too (the sliced serving forward, ROADMAP A16c.5): where M divides the
cache's length the partition rule splits the latent cache's sequence
over the model group (``seq``: ``models/model.py::sequence_split``), so
a rank writes the new latent and rope key only into a slot it holds,
gathers every head's absorbed query over the group (``w_uk`` is split
over heads), scores its slots for all heads, the group combines the
partial softmaxes in latent space (``tp.softmax``), and a rank
up-projects its own heads with its ``w_uv`` before the row-parallel
``wo``; else the cache is whole on every rank and a rank attends with
its own heads.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ops
from repro_torch.models.attention import (NEG_INF, plain_attention,
                                          seq_group)
from repro_torch.models.config import ModelConfig
from repro_torch.models.rope import RopeTable, apply_rope


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    hd, r, rh = cfg.resolved_head_dim, cfg.kv_lora_rank, cfg.rope_head_dim
    vh = cfg.resolved_v_head_dim
    dev = gen.device

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    s = d ** -0.5
    return {
        "wq": normal((d, H, hd + rh), s),        # nope + rope part per head
        "w_dkv": normal((d, r), s),              # down to the latent
        "w_kr": normal((d, rh), s),              # the shared rope key
        "w_uk": normal((r, H, hd), r ** -0.5),   # latent -> k_nope
        "w_uv": normal((r, H, vh), r ** -0.5),   # latent -> v
        "wo": normal((H, vh, d), (H * vh) ** -0.5),
    }


def _latent(params, x, rope: RopeTable):
    c_kv = x @ params["w_dkv"]
    k_rope = apply_rope((x @ params["w_kr"])[:, :, None, :], rope)
    return c_kv, k_rope[:, :, 0, :]                   # (B,S,r), (B,S,rh)


def _queries(params, x, cfg: ModelConfig, rope: RopeTable):
    hd = cfg.resolved_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    return torch.cat([q[..., :hd], apply_rope(q[..., hd:], rope)], dim=-1)


def mla_forward(params, x, cfg: ModelConfig, rope: RopeTable,
                plain: bool = False, tp=None):
    """x (B, S, D) -> (B, S, D); ``rope`` is the table at x's positions
    and ``rope_head_dim``.  ``tp``: a rank's heads (see above)."""
    B, S, _ = x.shape
    c_kv, k_rope = _latent(params, x, rope)
    if tp is not None:
        x, c_kv, k_rope = tp.copy(x), tp.copy(c_kv), tp.copy(k_rope)
    q = _queries(params, x, cfg, rope)                # (B,S,H,hd+rh)
    H = q.shape[2]                                    # H/M under tp
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, params["w_uk"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, params["w_uv"]).contiguous()
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, k_rope.shape[-1])], dim=-1)
    attend = functools.partial(plain_attention, cfg=cfg) if plain \
        else ops.flash_attention
    out = attend(q.contiguous(), k, v, causal=cfg.causal)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y if tp is None else tp.reduce(y)


def init_mla_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                   device=None) -> dict:
    return {
        "c_kv": torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_seq, cfg.rope_head_dim),
                              dtype=dtype, device=device),
    }


def mla_decode(params, x, cache, cur_index: int, cfg: ModelConfig,
               rope: RopeTable, tp=None, seq: bool = False, sp=None):
    """One-token decode from the latent cache, absorbed: the score is
    ``q_nope . (c W_uk) + q_rope . k_rope`` and the output is taken in
    latent space, then up-projected by ``W_uv``.  The cache is written in
    place and returned.  ``tp``: a rank's heads and its slice of the
    cache, a slice of its sequence where ``seq`` (see above); ``sp``
    (regime (b)): the rows replicated, the sequence split over the
    replica group."""
    hd, rh = cfg.resolved_head_dim, cfg.rope_head_dim
    q = _queries(params, x, cfg, rope)                # (B,1,H,hd+rh)
    c_new, kr_new = _latent(params, x, rope)
    c, kr = cache["c_kv"], cache["k_rope"]
    over, _, i = seq_group(seq, tp, sp)
    first = i * c.shape[1]
    if first <= cur_index < first + c.shape[1]:
        c[:, cur_index - first] = c_new[:, 0].to(c.dtype)
        kr[:, cur_index - first] = kr_new[:, 0].to(kr.dtype)

    heads = q.shape[2]
    q_nope, q_rope = q[..., :hd].float(), q[..., hd:].float()
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, params["w_uk"].float())
    every = over is not None and tp is not None
    if every:
        # every head's absorbed query, then the rope part
        q_lat, q_rope = tp.gather(torch.cat([q_lat, q_rope], -1), 2) \
            .split([q_lat.shape[-1], rh], dim=-1)
    s_lat = torch.einsum("bshr,btr->bhst", q_lat, c.float())
    s_rope = torch.einsum("bshk,btk->bhst", q_rope, kr.float())
    scores = (s_lat + s_rope) * ((hd + rh) ** -0.5)
    valid = torch.arange(first, first + c.shape[1],
                         device=x.device) <= cur_index
    scores = torch.where(valid, scores, NEG_INF)
    if over is not None:
        o_lat = (tp if sp is None else sp).softmax(
            scores, lambda e: torch.einsum("bhst,btr->bhsr", e, c.float()),
            over).transpose(1, 2)
        if every:
            o_lat = o_lat.narrow(2, tp.k * heads, heads)
    else:
        w = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bhst,btr->bshr", w, c.float())
    out = torch.einsum("bshr,rhk->bshk", o_lat,
                       params["w_uv"].float()).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return (y, cache) if tp is None else (tp.reduce(y), cache)
