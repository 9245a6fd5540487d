"""Optimizers as ``(init, update)`` pairs over dicts of tensors.

``update(grads, state, params) -> (updates, new_state)``; apply with
``params + updates``.  All state is f32 whatever the params' dtype.  A
flat slab is a one-leaf tree, so the slab aggregator's plain path runs
the same ``update``.  Mirrors ``src/repro/optim/optimizers.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.kernels.ref import sqrt_rn


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _cast_like(src, ref):
    return _map(lambda s, r: s.to(r.dtype), src, ref)


def bias_correction(count, b1: float, b2: float):
    """Adam bias corrections ``(1 - b1^count, 1 - b2^count)`` from the
    int32 update count carried in optimizer state, *after* this step's
    increment (first step -> 1).  ``count`` may be an int or a tensor;
    the result is f32 on the count's device, so no host sync."""
    cf = torch.as_tensor(count, dtype=torch.int32).to(torch.float32)
    return 1 - torch.pow(b1, cf), 1 - torch.pow(b2, cf)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _count(params) -> torch.Tensor:
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return {"count": _count(params)}

    def update(grads, state, params):
        updates = _map(lambda g: -lr * g.float(), grads)
        return _cast_like(updates, params), {"count": state["count"] + 1}

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9, nesterov: bool = False
             ) -> Optimizer:
    def init(params):
        return {"count": _count(params), "mu": _map(_zeros_f32, params)}

    def update(grads, state, params):
        mu = _map(lambda m, g: beta * m + g.float(), state["mu"], grads)
        if nesterov:
            upd = _map(lambda m, g: -lr * (beta * m + g.float()), mu, grads)
        else:
            upd = _map(lambda m: -lr * m, mu)
        return _cast_like(upd, params), {"count": state["count"] + 1,
                                         "mu": mu}

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"count": _count(params), "mu": _map(_zeros_f32, params),
                "nu": _map(_zeros_f32, params)}

    def update(grads, state, params):
        c = state["count"] + 1
        mu = _map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                  state["mu"], grads)
        nu = _map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                  state["nu"], grads)
        bc1, bc2 = bias_correction(c, b1, b2)

        def u(m, v, p):
            return -lr * ((m / bc1) / (sqrt_rn(v / bc2) + eps)
                          + weight_decay * p.float())
        upd = _map(u, mu, nu, params)
        return _cast_like(upd, params), {"count": c, "mu": mu, "nu": nu}

    return Optimizer(init, update)
