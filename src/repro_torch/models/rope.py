"""Rotary position embeddings: the half-split rotation (not interleaved)
of the reference's ``models/rope.py``, in float32.

The model computes the cos/sin table once per forward and once per
decode step (:func:`rope_table`) and hands it to every layer, as XLA's
common-subexpression elimination does for the reference."""
from __future__ import annotations

from typing import Tuple

import torch

RopeTable = Tuple[torch.Tensor, torch.Tensor]


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)                               # (half,)


def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float) -> RopeTable:
    """positions (..., seq) int -> (cos, sin), each (..., seq, 1, half)
    float32: the correctly rounded cos and sin of the float32 angles.

    They are taken in float64 through ``torch.polar`` and rounded once.
    On the CPU ``torch.polar`` evaluates libm's cos and sin per element,
    while ``torch.cos``/``torch.sin`` run MKL's VML over chunks split
    across the intra-op threads, and a process's first such call has
    returned one thread's chunk inexact, in float32 and float64 alike
    (ROADMAP C.8)."""
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = (positions[..., None].float() * inv).double()        # (..., seq, half)
    z = torch.polar(torch.ones_like(ang), ang)
    return (z.real.float()[..., None, :], z.imag.float()[..., None, :])


def apply_rope(x: torch.Tensor, table: RopeTable) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); ``table`` from :func:`rope_table`
    at x's positions and head_dim."""
    cos, sin = table
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
