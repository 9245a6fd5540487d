"""The model's entry points to the kernels, after the reference's
``src/repro/kernels/ops.py:115-143``.

A CPU tensor runs the plain version (inside the wrapper) and a CUDA
tensor launches the kernel or raises.  The reference's tile-size
arguments (``q_block``, ``kv_block``) and its ``use_pallas`` switch have
no counterpart: the CUDA kernel tiles 64 x 64 on its own, and the plain
versions are called from ``kernels/ref.py`` directly.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import rmsnorm as _rmsnorm


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """x (..., D), scale (D,) -> (..., D) in x's dtype."""
    D = x.shape[-1]
    return _rmsnorm.rmsnorm(x.reshape(-1, D), scale, eps).reshape(x.shape)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """q (B,S,H,d), k/v (B,S,KV,d) -> (B,S,H,d)."""
    return _flash.flash_attention(q, k, v, causal=causal, window=window)
