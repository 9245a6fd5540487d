"""Per-layer block assembly, after the reference's ``models/blocks.py``:
(mixer, ffn) pairs with pre-norm residuals, for every mixer (``attn``,
``attn_global``, ``mla``, ``mamba``, ``mlstm``, ``slstm``) and FFN
(``mlp``, ``moe``, ``none``).

``ropes`` maps a rotary dim to its cos/sin table at the positions of x
(:func:`rope_tables`): attention rotates ``head_dim``-wide heads, MLA
its ``rope_head_dim``-wide part.  ``tp`` is the tensor-parallel context
of the training forward at ``mesh_model`` M > 1 (``parallel/tensor.py``):
every mixer and FFN takes it, in the full-sequence forward and in the
one-token decode.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core import counting
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.config import (ATTN, ATTN_GLOBAL, MAMBA, MLA, MLP,
                                       MLSTM, NONE, SLSTM, ModelConfig)
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.models.moe import init_moe, moe_forward
from repro_torch.models.norms import apply_norm, init_norm
from repro_torch.models.rope import RopeTable, rope_table

MIXER_INIT = {
    ATTN: attn_mod.init_attention,
    ATTN_GLOBAL: attn_mod.init_attention,
    MLA: mla_mod.init_mla,
    MAMBA: mamba_mod.init_mamba,
    MLSTM: xlstm_mod.init_mlstm,
    SLSTM: xlstm_mod.init_slstm,
}


def rope_tables(positions: torch.Tensor, cfg: ModelConfig
                ) -> Dict[int, RopeTable]:
    """The rope tables the config's mixers need, by rotary dim."""
    dims = set()
    for mixer, _ in cfg.block_pattern:
        if mixer in (ATTN, ATTN_GLOBAL):
            dims.add(cfg.resolved_head_dim)
        elif mixer == MLA:
            dims.add(cfg.rope_head_dim)
    return {d: rope_table(positions, d, cfg.rope_theta) for d in dims}


def init_layer(gen: torch.Generator, mixer: str, ffn: str,
               cfg: ModelConfig, dtype) -> Dict[str, Any]:
    dev = gen.device
    p: Dict[str, Any] = {
        "mixer_norm": init_norm(cfg.norm, cfg.d_model, device=dev),
        "mixer": MIXER_INIT[mixer](gen, cfg, dtype),
    }
    if ffn != NONE:
        p["ffn_norm"] = init_norm(cfg.norm, cfg.d_model, device=dev)
        if ffn == MLP:
            p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                                dtype)
        else:
            p["ffn"] = init_moe(gen, cfg, dtype)
    return p


def _ffn(p, x, ffn: str, cfg: ModelConfig, plain: bool = False, tp=None,
         column=None):
    """The FFN half: (x, aux).  ``column``: ``moe_forward``'s."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == NONE:
        return x, aux
    h = apply_norm(cfg.norm, p["ffn_norm"], x, cfg.norm_eps, plain)
    if ffn == MLP:
        h = mlp_forward(p["ffn"], h, cfg.mlp_act, tp)
    else:
        # the aux loss is computed alike on every model rank
        h, aux = moe_forward(p["ffn"], h, cfg, tp, column)
    return x + h, aux


def layer_forward(p, x, mixer: str, ffn: str, cfg: ModelConfig,
                  ropes: Dict[int, RopeTable], plain: bool = False,
                  tp=None, column=None):
    """Full-sequence layer; ``plain`` takes norm and attention through
    their plain versions.  Returns (x, aux); aux is 0 without MoE.
    ``column``: ``moe_forward``'s."""
    h = apply_norm(cfg.norm, p["mixer_norm"], x, cfg.norm_eps, plain)
    if mixer in (ATTN, ATTN_GLOBAL):
        h = attn_mod.attention_forward(
            p["mixer"], h, cfg, ropes[cfg.resolved_head_dim],
            global_layer=(mixer == ATTN_GLOBAL), plain=plain, tp=tp)
    elif mixer == MLA:
        h = mla_mod.mla_forward(p["mixer"], h, cfg,
                                ropes[cfg.rope_head_dim], plain=plain,
                                tp=tp)
    elif mixer == MAMBA:
        h = counting.recurrence(mamba_mod.mamba_forward, p["mixer"], h, cfg,
                                unit=min(cfg.ssm_chunk, h.shape[1]), tp=tp)
    elif mixer == MLSTM:
        h = counting.recurrence(xlstm_mod.mlstm_forward, p["mixer"], h, cfg,
                                unit=min(xlstm_mod.MLSTM_CHUNK, h.shape[1]),
                                tp=tp)
    else:
        h = counting.recurrence(xlstm_mod.slstm_forward, p["mixer"], h, cfg,
                                unit=1, tp=tp)
    return _ffn(p, x + h, ffn, cfg, plain, tp, column)


def init_layer_cache(mixer: str, cfg: ModelConfig, batch: int, max_seq: int,
                     dtype, device=None):
    if mixer in (ATTN, ATTN_GLOBAL):
        return attn_mod.init_attn_cache(cfg, batch, max_seq, dtype,
                                        global_layer=(mixer == ATTN_GLOBAL),
                                        device=device)
    if mixer == MLA:
        return mla_mod.init_mla_cache(cfg, batch, max_seq, dtype, device)
    if mixer == MAMBA:
        return mamba_mod.init_mamba_cache(cfg, batch, dtype, device)
    if mixer == MLSTM:
        return xlstm_mod.init_mlstm_cache(cfg, batch, dtype, device)
    if mixer == SLSTM:
        return xlstm_mod.init_slstm_cache(cfg, batch, dtype, device)
    raise ValueError(mixer)


def layer_decode(p, x, cache, cur_index: int, mixer: str, ffn: str,
                 cfg: ModelConfig, ropes: Dict[int, RopeTable], tp=None,
                 column=None, seq: bool = False, sp=None):
    """One-token layer step; ``ropes`` at ``cur_index``.  Returns
    (x, cache); the cache is updated in place.  ``tp``: a rank's slices
    of the layer and of its cache, which holds a slice of its sequence
    where ``seq`` (``models/model.py::sequence_split``); ``column``:
    ``moe_forward``'s; ``sp``: regime (b)'s rows replicated over the
    replica group (``parallel/tensor.py::Spread``)."""
    h = apply_norm(cfg.norm, p["mixer_norm"], x, cfg.norm_eps)
    if mixer in (ATTN, ATTN_GLOBAL):
        h, cache = attn_mod.attention_decode(
            p["mixer"], h, cache, cur_index, cfg,
            ropes[cfg.resolved_head_dim],
            global_layer=(mixer == ATTN_GLOBAL), tp=tp, seq=seq, sp=sp)
    elif mixer == MLA:
        h, cache = mla_mod.mla_decode(p["mixer"], h, cache, cur_index, cfg,
                                      ropes[cfg.rope_head_dim], tp, seq, sp)
    elif mixer == MAMBA:
        h, cache = mamba_mod.mamba_decode(p["mixer"], h, cache, cfg, tp, sp)
    elif mixer == MLSTM:
        h, cache = xlstm_mod.mlstm_decode(p["mixer"], h, cache, cfg, tp, sp)
    else:
        h, cache = xlstm_mod.slstm_decode(p["mixer"], h, cache, cfg, tp, sp)
    x, _ = _ffn(p, x + h, ffn, cfg, tp=tp, column=column)
    return x, cache
