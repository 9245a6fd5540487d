"""Mixture-of-experts FFN, after the reference's ``models/moe.py``
(GShard-style grouped dispatch with one-hot einsums).

Tokens are cut into groups of ``cfg.moe_group_size`` (one group when the
token count is not a multiple, as in decode); each group routes its
tokens top-k into per-expert buffers of ``C`` slots and drops what does
not fit.  Shared experts (DeepSeek, llama4) run densely on every token.
Returns the Switch load-balance auxiliary loss beside the output.

Top-k: ``jax.lax.top_k`` orders equal probabilities by lower expert
index, and a token's queue position in an expert depends on that order
(the ``cumsum`` below), so the port takes its top k from a stable
descending sort, which keeps that order (ROADMAP C.26).  Plain PyTorch,
as the reference's dispatch is jnp outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import init_mlp, mlp_forward


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, E = cfg.d_model, cfg.num_experts
    ff = cfg.moe_d_ff or cfg.d_ff
    dev = gen.device

    def normal(shape, scale, dt=dtype):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dt)

    s_in, s_out = d ** -0.5, ff ** -0.5
    p = {
        "router": normal((d, E), s_in, torch.float32),
        "experts": {
            "w_gate": normal((E, d, ff), s_in),
            "w_up": normal((E, d, ff), s_in),
            "w_down": normal((E, ff, d), s_out),
        },
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, d, ff * cfg.num_shared_experts, "swiglu",
                               dtype)
    return p


def _group_size(cfg: ModelConfig, T: int) -> int:
    sg = getattr(cfg, "moe_group_size", 512) or 512
    if T % sg:
        sg = T            # tiny batches (decode): one group
    return min(sg, T)


def _capacity(sg: int, cfg: ModelConfig) -> int:
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = int(sg * k * cfg.moe_capacity_factor / E)
    cap = max(cap, k, 4)
    return ((cap + 3) // 4) * 4


def top_k(x: torch.Tensor, k: int):
    """The k largest along the last axis, largest first, ties by lower
    index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_forward(params, x, cfg: ModelConfig):
    """x (B, S, D) -> (y, aux)."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    sg = _group_size(cfg, T)
    G = T // sg
    xg = x.reshape(G, sg, D)

    logits = torch.einsum("gsd,de->gse", xg.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)                       # (G,sg,E)
    gate_vals, gate_idx = top_k(probs, k)                       # (G,sg,k)
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)

    # load-balance aux (Switch): E * sum_e f_e * p_e
    me = torch.mean(probs, dim=(0, 1))
    onehot = F.one_hot(gate_idx, E).float()                     # (G,sg,k,E)
    ce = torch.mean(torch.sum(onehot, dim=2), dim=(0, 1))
    aux = E * torch.sum(me * ce)

    # capacity-limited positions within each group's expert queue
    C = _capacity(sg, cfg)
    flat = onehot.reshape(G, sg * k, E)
    pos = torch.cumsum(flat, dim=1) - flat
    pos_in_e = torch.sum(pos * flat, dim=-1).reshape(G, sg, k)
    keep = pos_in_e < C
    gate_vals = gate_vals * keep.float()
    slot = torch.where(keep, pos_in_e, torch.full_like(pos_in_e, C))
    pos_oh = F.one_hot(slot.long(), C + 1).float()[..., :C]    # (G,sg,k,C)
    dispatch = torch.einsum("gske,gskc->gsec", onehot * keep[..., None],
                            pos_oh)
    combine = torch.einsum("gske,gskc,gsk->gsec", onehot, pos_oh, gate_vals)

    xe = torch.einsum("gsec,gsd->gecd", dispatch, xg.float()).to(x.dtype)
    ep = params["experts"]
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, ep["w_gate"])) \
        * torch.einsum("gecd,edf->gecf", xe, ep["w_up"])
    ye = torch.einsum("gecf,efd->gecd", h, ep["w_down"])
    y = torch.einsum("gsec,gecd->gsd", combine, ye.float())
    y = y.to(x.dtype).reshape(B, S, D)
    if "shared" in params:
        y = y + mlp_forward(params["shared"], x, "swiglu")
    return y, aux
