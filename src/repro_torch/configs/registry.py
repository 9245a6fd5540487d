"""Architecture registry: configs, input shapes, applicability, smoke
variants and the dry-run's input specs.

A copy of the reference's ``configs/registry.py``; its
``ShapeDtypeStruct`` specs are tensors on the ``meta`` device here.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig

_MODULES = {
    "xlstm-350m": "xlstm_350m",
    "qwen1.5-110b": "qwen15_110b",
    "qwen2.5-32b": "qwen25_32b",
    "llama4-scout-17b-a16e": "llama4_scout_17b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "hubert-xlarge": "hubert_xlarge",
    "phi-3-vision-4.2b": "phi3_vision",
    "h2o-danube-1.8b": "h2o_danube_18b",
    "jamba-v0.1-52b": "jamba_52b",
    "phi4-mini-3.8b": "phi4_mini_38b",
}

ARCH_NAMES = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """(applicable, reason-if-not), the reference's rules."""
    if shape.kind == "decode" and cfg.encoder_only:
        return False, "encoder-only: no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full attention: 500k decode cache is not sub-quadratic"
    return True, ""


def applicable_pairs():
    out = []
    for name in ARCH_NAMES:
        cfg = get_config(name)
        for shape in SHAPES.values():
            ok, why = shape_applicable(cfg, shape)
            out.append((name, shape.name, ok, why))
    return out


# ----------------------------------------------------------- input specs

def input_specs(cfg: ModelConfig, shape: InputShape,
                batch_override: Optional[int] = None):
    """Every model input as a tensor on the ``meta`` device (no memory).

    train/prefill -> ``{"batch": ...}`` for ``loss_fn``/``forward``;
    decode -> ``cache``, ``tokens`` and ``cur_index`` for ``decode_step``
    (one new token against a ``seq_len``-deep cache).  ``cur_index`` is
    a Python int in the port (ROADMAP C.9): the last position.
    """
    from repro_torch.models import model as M

    B = batch_override or shape.global_batch
    S = shape.seq_len
    i32, f32 = torch.int32, torch.float32

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "audio":
            batch = {"features": meta((B, S, cfg.frontend_dim), f32),
                     "labels": meta((B, S), i32),
                     "loss_mask": meta((B, S), f32)}
        elif cfg.frontend == "vision":
            n_img = cfg.num_image_tokens
            batch = {"tokens": meta((B, S - n_img), i32),
                     "image_embeds": meta((B, n_img, cfg.frontend_dim), f32),
                     "labels": meta((B, S - n_img), i32)}
        else:
            batch = {"tokens": meta((B, S), i32), "labels": meta((B, S), i32)}
        return {"batch": batch}
    return {
        "cache": M.init_cache(cfg, B, S, device="meta"),
        "tokens": meta((B, 1), i32),
        "cur_index": S - 1,
    }


# --------------------------------------------------------- smoke variants

def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: <=2 layers, d_model<=512, <=4 experts."""
    pattern = cfg.block_pattern
    if len(pattern) > 2:
        # keep family diversity: first occurrence of each distinct mixer/ffn
        seen, keep = set(), []
        for pair in pattern:
            if pair not in seen:
                keep.append(pair)
                seen.add(pair)
            if len(keep) == 2:
                break
        pattern = tuple(keep)
    heads = min(cfg.num_heads, 4) or 4
    kv = max(1, min(cfg.num_kv_heads, heads))
    if heads % kv:
        kv = heads
    d_model = min(cfg.d_model, 256)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=d_model,
        vocab_size=min(cfg.vocab_size, 512),
        block_pattern=pattern,
        num_groups=1,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=min(cfg.resolved_head_dim, 64),
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        moe_d_ff=min(cfg.moe_d_ff, 256) if cfg.moe_d_ff else 0,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        num_experts_per_tok=(min(cfg.num_experts_per_tok, 2)
                             if cfg.num_experts else 0),
        num_shared_experts=min(cfg.num_shared_experts, 1),
        kv_lora_rank=min(cfg.kv_lora_rank, 64) if cfg.kv_lora_rank else 0,
        rope_head_dim=min(cfg.rope_head_dim, 16),
        v_head_dim=min(cfg.resolved_v_head_dim, 64) if cfg.v_head_dim else 0,
        sliding_window=(min(cfg.sliding_window, 16)
                        if cfg.sliding_window else None),
        attn_chunk=min(cfg.attn_chunk, 16) if cfg.attn_chunk else None,
        frontend_dim=min(cfg.frontend_dim, 32) if cfg.frontend_dim else 0,
        num_image_tokens=(min(cfg.num_image_tokens, 8)
                          if cfg.num_image_tokens else 0),
        ssm_chunk=8,
        mamba_dt_rank=8,
        dtype="float32",
        remat="none",
    )


def smoke_batch(cfg: ModelConfig, batch: int = 2, seq: int = 32):
    """Concrete (tiny) host batch matching input_specs' train layout."""
    import numpy as np
    rng = np.random.default_rng(0)
    if cfg.frontend == "audio":
        return {
            "features": rng.normal(size=(batch, seq, cfg.frontend_dim)
                                   ).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (batch, seq)
                                   ).astype(np.int32),
            "loss_mask": (rng.random((batch, seq)) < 0.5).astype(np.float32),
        }
    if cfg.frontend == "vision":
        n_img = cfg.num_image_tokens
        return {
            "tokens": rng.integers(0, cfg.vocab_size, (batch, seq - n_img)
                                   ).astype(np.int32),
            "image_embeds": rng.normal(size=(batch, n_img, cfg.frontend_dim)
                                       ).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (batch, seq - n_img)
                                   ).astype(np.int32),
        }
    return {
        "tokens": rng.integers(0, cfg.vocab_size, (batch, seq)
                               ).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (batch, seq)
                               ).astype(np.int32),
    }
