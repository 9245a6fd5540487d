"""Normalization layers (functional, dict params), after the reference's
``models/norms.py``.  ``rmsnorm`` goes through the rmsnorm kernel, or
with ``plain=True`` (the training path) through its plain PyTorch
version, which autograd differentiates; ``layernorm`` stays plain
PyTorch, as it is plain jnp in the reference."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref


def init_rmsnorm(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-5, plain: bool = False):
    if plain:
        return ref.rmsnorm_ref(x, params["scale"], eps)
    return ops.rmsnorm(x, params["scale"], eps)


def init_layernorm(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def init_norm(kind: str, dim: int, dtype=torch.float32, device=None):
    return init_rmsnorm(dim, dtype, device) if kind == "rmsnorm" \
        else init_layernorm(dim, dtype, device)


def apply_norm(kind: str, params, x, eps: float = 1e-5,
               plain: bool = False):
    return rmsnorm(params, x, eps, plain) if kind == "rmsnorm" \
        else layernorm(params, x, eps)
