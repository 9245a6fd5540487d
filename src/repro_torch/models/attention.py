"""Softmax attention, after the reference's ``models/attention.py``:
GQA/MHA, optional QKV bias, RoPE, sliding-window and chunked-local
(llama4's ``attn_chunk``) variants, full-sequence and single-token
decode paths.  ``attn_global`` layers take neither mask.

The full-sequence path goes through the flash_attention kernel, which
computes the function of the reference's ``rowblock_attention`` (the
JAX package's tests pin the two together:
``tests/kernels/test_kernels.py::test_flash_matches_model_rowblock``),
or with ``plain=True`` (the training path: the reference trains through
jnp, and the kernel has no backward) through the plain PyTorch version,
which autograd differentiates (:func:`plain_attention`): at S above
``Q_BLOCK`` in query blocks of ``Q_BLOCK`` rows, as the reference's
``rowblock_attention`` with its default ``q_block``, and, when the
config rematerialises, each block checkpointed
(``src/repro/models/attention.py:149``), so no layer keeps an (S, S)
score matrix for the backward.  Each block takes every key: the
reference's narrower key slab for a window or a chunk is not taken
(ROADMAP C.41).
Decode attention stays plain PyTorch, as it is jnp outside any Pallas
kernel in the reference.

With a tensor-parallel context ``tp`` (``parallel/tensor.py``; the
training forward at ``mesh_model`` M > 1) a rank projects its H/M query
heads and the kv heads they map to from its slices of ``wq``/``wk``/
``wv`` (and ``bq``/``bk``/``bv``), attends over them, and ``wo`` is
row-parallel: its partial output is summed over the model group.  The
decode takes ``tp`` too (the sliced serving forward, ROADMAP A16c.5):
where M divides KV a rank holds its kv heads of the cache and attends
locally; else the cache's sequence is split over the model group
(``seq``, the partition rule's: ``models/model.py::sequence_split``): a
rank writes the new key and value only into a slot it holds, scores
every head's query (gathered over the group) over its slots, and the
group combines the partial softmaxes (``tp.softmax``); where M divides
neither, the cache is whole on every rank.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import remat
from repro_torch.models.config import ModelConfig
from repro_torch.models.rope import RopeTable, apply_rope

NEG_INF = -1e30
# the reference's query block (``q_block=512``,
# ``src/repro/models/model.py:98-99``)
Q_BLOCK = 512


# ---------------------------------------------------------------- params

def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    dev = gen.device

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    scale = d ** -0.5
    p = {
        "wq": normal((d, H, hd), scale),
        "wk": normal((d, KV, hd), scale),
        "wv": normal((d, KV, hd), scale),
        "wo": normal((H, hd, d), (H * hd) ** -0.5),
    }
    if cfg.attn_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((KV, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((KV, hd), dtype=dtype, device=dev)
    return p


def _project_qkv(params, x, cfg: ModelConfig, rope: RopeTable, tp=None):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd), rope applied
    from ``rope``, the table at x's positions (a rank's heads under
    ``tp``)."""
    kv = (lambda leaf, dim: leaf) if tp is None else tp.kv
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, kv(params["wk"], 1))
    v = torch.einsum("bsd,dhk->bshk", x, kv(params["wv"], 1))
    if cfg.attn_bias:
        q = q + params["bq"]
        k = k + kv(params["bk"], 0)
        v = v + kv(params["bv"], 0)
    return apply_rope(q, rope), apply_rope(k, rope), v.contiguous()


# ------------------------------------------------------------- full-seq

def plain_attention(q, k, v, cfg: ModelConfig, *, causal: bool,
                    window: Optional[int] = None,
                    chunk: Optional[int] = None):
    """The training attention: ``ref.attention_ref``'s arithmetic in
    query blocks of ``Q_BLOCK`` rows, each block checkpointed when S is
    longer and ``cfg.remat`` is on (the reference checkpoints none when
    one block covers S)."""
    S = q.shape[1]
    rows = functools.partial(ref.attention_rows, causal=causal,
                             window=window, chunk=chunk)
    blocked = S > Q_BLOCK and remat.on(cfg)
    return torch.cat([remat.run(blocked, rows, q, k, v, r0,
                                min(S, r0 + Q_BLOCK))
                      for r0 in range(0, S, Q_BLOCK)], dim=1)


def attention_forward(params, x, cfg: ModelConfig, rope: RopeTable,
                      global_layer: bool = False, plain: bool = False,
                      tp=None):
    """Full-sequence attention.  x: (B, S, D) -> (B, S, D).  ``rope`` is
    the table at positions ``arange(S)`` for every row (``model.forward``
    gives that), which is what the kernel's masks assume.  ``tp``: a
    rank's heads, ``wo`` row-parallel."""
    if tp is not None:
        x = tp.copy(x)
    q, k, v = _project_qkv(params, x, cfg, rope, tp)
    attend = functools.partial(plain_attention, cfg=cfg) if plain \
        else ops.flash_attention
    out = attend(q, k, v, causal=cfg.causal,
                 window=None if global_layer else cfg.sliding_window,
                 chunk=None if global_layer else cfg.attn_chunk)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y if tp is None else tp.reduce(y)


# ---------------------------------------------------------------- decode

def init_attn_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                    global_layer: bool = False, device=None) -> dict:
    """KV cache for one attention layer.  Sliding-window and chunked
    layers keep a ring buffer of the window (chunk) size."""
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if not global_layer and cfg.sliding_window is not None:
        L = min(max_seq, cfg.sliding_window)
    elif not global_layer and cfg.attn_chunk is not None:
        L = min(max_seq, cfg.attn_chunk)
    else:
        L = max_seq
    return {
        "k": torch.zeros((batch, L, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, L, KV, hd), dtype=dtype, device=device),
    }


def attention_decode(params, x, cache, cur_index: int, cfg: ModelConfig,
                     rope: RopeTable, global_layer: bool = False, tp=None,
                     seq: bool = False, sp=None):
    """One-token decode.  x: (B, 1, D); ``cur_index``: tokens so far (a
    Python int); ``rope``: the table at position ``cur_index``.  Returns
    (y, cache).  The new key and value are written
    into ``cache`` in place (the reference returns a new cache), and the
    same dict is returned.  ``tp``: a rank's heads and its slice of the
    cache, a slice of its sequence where ``seq`` (see above); ``sp``
    (regime (b)): the rows replicated over the replica group, the
    sequence split over its data column, or over the whole group where
    M does not divide KV."""
    B = x.shape[0]
    # a rank's wq holds its query heads; wk/wv its kv heads, or every kv
    # head where M does not divide KV, which the cache then holds too
    q, k, v = _project_qkv(params, x, cfg, rope)
    over, n, i = seq_group(seq, tp, sp, cfg.num_kv_heads)

    ck, cv = cache["k"], cache["v"]
    L = ck.shape[1] * n
    slot = cur_index % L                  # ring for SWA/chunked; linear else
    first = i * ck.shape[1]
    if first <= slot < first + ck.shape[1]:
        ck[:, slot - first] = k[:, 0].to(ck.dtype)
        cv[:, slot - first] = v[:, 0].to(cv.dtype)

    # positions held in each cache slot (ring-aware)
    slots = torch.arange(first, first + ck.shape[1], device=x.device)
    slot_pos = cur_index - torch.remainder(cur_index - slots, L)
    valid = (slot_pos >= 0) & (slot_pos <= cur_index)
    if not global_layer and cfg.sliding_window is not None:
        valid &= slot_pos > cur_index - cfg.sliding_window
    if not global_layer and cfg.attn_chunk is not None:
        valid &= torch.div(slot_pos, cfg.attn_chunk, rounding_mode="floor") \
            == cur_index // cfg.attn_chunk

    hd = cfg.resolved_head_dim
    heads = q.shape[2]
    # every head's query over this rank's slots where its slots hold
    # every kv head
    every = over in ("model", "replica")
    if every:
        q = tp.gather(q, 2)
    elif tp is not None and tp.kv_whole:
        # the kv heads this rank's query heads map to
        ck, cv = ck.narrow(2, *tp.kv_range), cv.narrow(2, *tp.kv_range)
    KV, H = ck.shape[2], q.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          ck.float()) * (hd ** -0.5)
    scores = torch.where(valid, scores, NEG_INF)
    if over is not None:
        # the softmax over the group's slots; then this rank's heads
        out = (tp if sp is None else sp).softmax(
            scores, lambda e: torch.einsum("bkgqs,bskd->bkgqd", e,
                                           cv.float()), over)
        out = out.permute(0, 3, 1, 2, 4).reshape(B, 1, H, hd)
        if every:
            out = out.narrow(2, tp.k * heads, heads)
    else:
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", w, cv.float())
    out = out.reshape(B, 1, heads, hd).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return (y, cache) if tp is None else (tp.reduce(y), cache)


def seq_group(seq: bool, tp, sp, kv_heads: Optional[int] = None):
    """``(over, n, i)``: the group over which a decode cache's sequence
    is split (None: it is not), its size and this rank's index in it.
    Regime (a) splits it over the model group; regime (b) (``sp``) over
    the data column where M divides ``kv_heads`` (a rank holds its own
    kv heads), else (MLA's latent: None) over the whole replica
    group."""
    if not seq:
        return None, 1, 0
    if sp is None:
        return "model", tp.M, tp.k
    if kv_heads is not None and kv_heads % sp.M == 0:
        return "data", sp.D, sp.d
    return "replica", sp.R, sp.r
