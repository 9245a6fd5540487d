"""Plain PyTorch versions of the port's kernels.

The kernel wrappers in :mod:`repro_torch.kernels` run these for tensors
on the CPU, and ``chip_smoke.py`` holds each CUDA kernel against them on
the card.  For the flushes the reduction is the fixed-order fold
of the reference's CPU path (``src/repro/core/slab.py:377-379``):
``agg = w[0]*g[0]``, then ``agg = agg + w[k]*g[k]`` for every row in
staging order, in float32.  Every row is multiplied, so a zero-weight
row adds exactly 0 even over stale finite junk.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _fold(grads: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    g = grads.float()
    w = weights.float()
    agg = w[0] * g[0]
    for k in range(1, g.shape[0]):
        agg = agg + w[k] * g[k]
    return agg


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root of ``x`` on any device,
    as the CUDA kernels' ``__fsqrt_rn``: taken in float64 and rounded
    once (53 >= 2*24 + 2 bits, so rounding twice loses nothing).

    ``torch.sqrt`` of a float32 CPU tensor runs MKL's VML sqrt, which
    is within 1 ulp but not always correctly rounded, over chunks split
    across the intra-op threads.  The first such call of a process has,
    about once in 200 processes, returned one thread's chunk with
    relative errors up to 2.9e-4 (ROADMAP C.8)."""
    return torch.sqrt(x.double()).float()


def flush_ref(grads: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """grads (K, P), weights (K,) -> (P,) weighted sum in grads' dtype."""
    return _fold(grads, weights).to(grads.dtype)


def flush_momentum_ref(grads, weights, momentum, beta: float):
    """``m' = beta*m + sum_k w[k] g[k]``.  Returns ``(m' in grads' dtype,
    m' in momentum's dtype)``; the inputs are not modified."""
    m_new = beta * momentum.float() + _fold(grads, weights)
    return m_new.to(grads.dtype), m_new.to(momentum.dtype)


def flush_adamw_ref(grads, weights, params, mu, nu, bc1, bc2, scale, *,
                    b1: float, b2: float, eps: float, weight_decay: float):
    """Fused flush + AdamW.  ``weights`` are pre-normalized (the weighted
    sum IS the mean gradient); ``bc1``/``bc2`` are the bias corrections
    ``1 - b^count``.  Returns ``(new_params, new_mu, new_nu)``, all f32;
    the inputs are not modified."""
    g = _fold(grads, weights)
    m_new = b1 * mu.float() + (1 - b1) * g
    v_new = b2 * nu.float() + (1 - b2) * torch.square(g)
    p = params.float()
    upd = (m_new / bc1) / (sqrt_rn(v_new / bc2) + eps) + weight_decay * p
    return p - scale * upd, m_new, v_new


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis, in f32,
    returned in x's dtype (``src/repro/kernels/ref.py:rmsnorm_ref``)."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def attention_mask(S: int, causal: bool, window: Optional[int], device):
    """(S, S) bool, True = query row may attend key column."""
    pos_q = torch.arange(S, device=device)[:, None]
    pos_k = torch.arange(S, device=device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= pos_k <= pos_q
    if window is not None:
        mask &= pos_k > pos_q - window
    return mask


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  scale: Optional[float] = None):
    """q (B,S,H,d), k/v (B,S,KV,d) -> (B,S,H,d).  Naive f32 softmax over
    the full (S, S) scores; fully masked rows give 0
    (``src/repro/kernels/ref.py:attention_ref``)."""
    B, S, H, d = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(B, S, KV, G, d).float() * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    mask = attention_mask(S, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None], p, 0.0)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, S, H, d).to(q.dtype)
