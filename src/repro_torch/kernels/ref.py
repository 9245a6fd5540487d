"""Plain PyTorch versions of the flush kernels.

The kernel wrappers in :mod:`repro_torch.kernels.hybrid_aggregate` run
these for tensors on the CPU, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.  The reduction is the fixed-order fold
of the reference's CPU path (``src/repro/core/slab.py:377-379``):
``agg = w[0]*g[0]``, then ``agg = agg + w[k]*g[k]`` for every row in
staging order, in float32.  Every row is multiplied, so a zero-weight
row adds exactly 0 even over stale finite junk.
"""
from __future__ import annotations

import torch


def _fold(grads: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    g = grads.float()
    w = weights.float()
    agg = w[0] * g[0]
    for k in range(1, g.shape[0]):
        agg = agg + w[k] * g[k]
    return agg


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
    upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) + weight_decay * p
    return p - scale * upd, m_new, v_new
