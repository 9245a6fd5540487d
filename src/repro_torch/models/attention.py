"""Softmax attention, after the reference's ``models/attention.py``:
GQA/MHA, optional QKV bias, RoPE, sliding window, full-sequence and
single-token decode paths.

The full-sequence path goes through the flash_attention kernel, which
computes the function of the reference's ``rowblock_attention`` (the
JAX package's tests pin the two together:
``tests/kernels/test_kernels.py::test_flash_matches_model_rowblock``).
Decode attention stays plain PyTorch, as it is jnp outside any Pallas
kernel in the reference.  Chunked-local attention (``attn_chunk``,
llama4) is not ported yet: the kernel has no chunk mask.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.rope import RopeTable, apply_rope

NEG_INF = -1e30


def _refuse_chunked(cfg: ModelConfig) -> None:
    if cfg.attn_chunk is not None:
        raise NotImplementedError(
            f"{cfg.name}: chunked-local attention (attn_chunk) is not "
            "ported yet (ROADMAP A12)")


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


def _project_qkv(params, x, cfg: ModelConfig, rope: RopeTable):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd), rope applied
    from ``rope``, the table at x's positions."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.attn_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return apply_rope(q, rope), apply_rope(k, rope), v.contiguous()


# ------------------------------------------------------------- full-seq

def attention_forward(params, x, cfg: ModelConfig, rope: RopeTable,
                      global_layer: bool = False):
    """Full-sequence attention.  x: (B, S, D) -> (B, S, D).  ``rope`` is
    the table at positions ``arange(S)`` for every row (``model.forward``
    gives that), which is what the kernel's masks assume."""
    _refuse_chunked(cfg)
    q, k, v = _project_qkv(params, x, cfg, rope)
    out = ops.flash_attention(
        q, k, v, causal=cfg.causal,
        window=None if global_layer else cfg.sliding_window)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


# ---------------------------------------------------------------- decode

def init_attn_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                    global_layer: bool = False, device=None) -> dict:
    """KV cache for one attention layer.  Sliding-window layers keep a
    ring buffer of the window size."""
    _refuse_chunked(cfg)
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if not global_layer and cfg.sliding_window is not None:
        L = min(max_seq, cfg.sliding_window)
    else:
        L = max_seq
    return {
        "k": torch.zeros((batch, L, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, L, KV, hd), dtype=dtype, device=device),
    }


def attention_decode(params, x, cache, cur_index: int, cfg: ModelConfig,
                     rope: RopeTable, global_layer: bool = False):
    """One-token decode.  x: (B, 1, D); ``cur_index``: tokens so far (a
    Python int); ``rope``: the table at position ``cur_index``.  Returns
    (y, cache).  The new key and value are written
    into ``cache`` in place (the reference returns a new cache), and the
    same dict is returned."""
    _refuse_chunked(cfg)
    B = x.shape[0]
    q, k, v = _project_qkv(params, x, cfg, rope)

    ck, cv = cache["k"], cache["v"]
    L = ck.shape[1]
    slot = cur_index % L                  # ring for SWA; linear else
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)

    # positions held in each cache slot (ring-aware)
    slots = torch.arange(L, device=x.device)
    slot_pos = cur_index - torch.remainder(cur_index - slots, L)
    valid = (slot_pos >= 0) & (slot_pos <= cur_index)
    if not global_layer and cfg.sliding_window is not None:
        valid &= slot_pos > cur_index - cfg.sliding_window

    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    H = cfg.num_heads
    g = H // KV
    qg = q.reshape(B, 1, KV, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          ck.float()) * (hd ** -0.5)
    scores = torch.where(valid, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, cv.float())
    out = out.reshape(B, 1, H, hd).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, cache
