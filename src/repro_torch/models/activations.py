"""Elementwise functions of the recurrent mixers, as JAX computes them.

``exp`` and ``tanh`` of a CPU tensor run MKL's VML split over the
intra-op threads, and a process's first such call has returned one
thread's chunk inexact (ROADMAP C.8).  Here they are taken in float64
and rounded once, on every device, so the CPU run and the card's agree
with the reference to an ulp.  ``softplus`` is ``jax.nn.softplus``,
``logaddexp(x, 0)`` (no threshold), and ``log_sigmoid`` is
``jax.nn.log_sigmoid``, ``-softplus(-x)``; ``torch.logaddexp`` takes
``exp`` and ``log1p`` outside VML.
"""
from __future__ import annotations

import torch


def exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.double()).to(x.dtype)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x.double()).to(x.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -softplus(-x)
