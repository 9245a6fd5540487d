"""Per-layer block assembly, after the reference's ``models/blocks.py``:
(mixer, ffn) pairs with pre-norm residuals.

Ported: the ``attn`` / ``attn_global`` mixers with the dense ``mlp``
FFN.  The other mixers (mla, mamba, mlstm, slstm) and the MoE FFN raise
``NotImplementedError``; they are ROADMAP A12b.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.config import ATTN, ATTN_GLOBAL, MLP, NONE, \
    ModelConfig
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.models.norms import apply_norm, init_norm
from repro_torch.models.rope import RopeTable


def _check(mixer: str, ffn: str) -> None:
    if mixer not in (ATTN, ATTN_GLOBAL):
        raise NotImplementedError(
            f"mixer {mixer!r} is not ported yet (ROADMAP A12b)")
    if ffn not in (MLP, NONE):
        raise NotImplementedError(
            f"ffn {ffn!r} is not ported yet (ROADMAP A12b)")


def init_layer(gen: torch.Generator, mixer: str, ffn: str,
               cfg: ModelConfig, dtype) -> Dict[str, Any]:
    _check(mixer, ffn)
    dev = gen.device
    p: Dict[str, Any] = {
        "mixer_norm": init_norm(cfg.norm, cfg.d_model, device=dev),
        "mixer": attn_mod.init_attention(gen, cfg, dtype),
    }
    if ffn != NONE:
        p["ffn_norm"] = init_norm(cfg.norm, cfg.d_model, device=dev)
        p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype)
    return p


def layer_forward(p, x, mixer: str, ffn: str, cfg: ModelConfig,
                  rope: RopeTable, plain: bool = False):
    """Full-sequence layer; ``rope`` is the table at x's positions;
    ``plain`` takes norm and attention through their plain versions.
    Returns (x, aux); aux is 0 without MoE."""
    _check(mixer, ffn)
    h = apply_norm(cfg.norm, p["mixer_norm"], x, cfg.norm_eps, plain)
    h = attn_mod.attention_forward(p["mixer"], h, cfg, rope,
                                   global_layer=(mixer == ATTN_GLOBAL),
                                   plain=plain)
    x = x + h
    if ffn != NONE:
        h = apply_norm(cfg.norm, p["ffn_norm"], x, cfg.norm_eps, plain)
        x = x + mlp_forward(p["ffn"], h, cfg.mlp_act)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def init_layer_cache(mixer: str, cfg: ModelConfig, batch: int, max_seq: int,
                     dtype, device=None):
    _check(mixer, MLP)
    return attn_mod.init_attn_cache(cfg, batch, max_seq, dtype,
                                    global_layer=(mixer == ATTN_GLOBAL),
                                    device=device)


def layer_decode(p, x, cache, cur_index: int, mixer: str, ffn: str,
                 cfg: ModelConfig, rope: RopeTable):
    """One-token layer step; ``rope`` is the table at ``cur_index``.
    Returns (x, cache); the cache is updated in place."""
    _check(mixer, ffn)
    h = apply_norm(cfg.norm, p["mixer_norm"], x, cfg.norm_eps)
    h, cache = attn_mod.attention_decode(
        p["mixer"], h, cache, cur_index, cfg, rope,
        global_layer=(mixer == ATTN_GLOBAL))
    x = x + h
    if ffn != NONE:
        h = apply_norm(cfg.norm, p["ffn_norm"], x, cfg.norm_eps)
        x = x + mlp_forward(p["ffn"], h, cfg.mlp_act)
    return x, cache
