"""Fused RMSNorm: the wrapper around the CUDA kernel.

``y = x * rsqrt(mean(x^2) + eps) * scale`` over the last axis of an
(N, D) ``x``, float32 inside, returned in x's dtype.  The kernel is in
``csrc/rmsnorm.cu`` (CUDA C++ for ``sm_90a``); it replaces the Pallas
kernel ``src/repro/kernels/rmsnorm.py:23 rmsnorm_pallas``.  For tensors
on the CPU the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.rmsnorm_ref`); for CUDA tensors it
launches the kernel on the current stream, adds one to
``LAUNCHES["rmsnorm"]``, and raises if the launch failed; for ``meta``
tensors it returns the kernel's output as a meta tensor and reports
:func:`cost`.  Forward only: an input that requires grad is refused.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core import counting
from repro_torch.kernels import ref
from repro_torch.kernels._build import load
from repro_torch.kernels._launch import bind, launch, on_cuda

LAUNCHES: Dict[str, int] = {"rmsnorm": 0}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P = ctypes.c_void_p
_SIGNATURE = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
              _P]


def reset_launch_counts() -> None:
    LAUNCHES["rmsnorm"] = 0


def _lib() -> ctypes.CDLL:
    return bind(load("rmsnorm"),
                {f"rmsnorm_{s}": _SIGNATURE for s in _SUFFIX.values()},
                "rmsnorm_error_string")


def cost(N: int, D: int, itemsize: int):
    """(flops, bytes) of one launch: x read and y written once, the f32
    scale once; square, sum, and two products an element."""
    return 4 * N * D, 2 * N * D * itemsize + 4 * D


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x (N, D) float32 or bfloat16, scale (D,) float32 -> (N, D) in x's
    dtype."""
    if x.dim() != 2:
        raise ValueError(f"x must be (N, D), got shape {tuple(x.shape)}")
    N, D = x.shape
    if x.dtype not in _SUFFIX:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if tuple(scale.shape) != (D,) or scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32 of shape ({D},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if x.requires_grad or scale.requires_grad:
        raise RuntimeError("the rmsnorm kernel is forward only; its "
                           "inputs must not require grad")
    if not on_cuda("rmsnorm", x, scale):
        if x.is_meta:
            counting.kernel("rmsnorm", *cost(N, D, x.element_size()))
            return torch.empty_like(x)
        return ref.rmsnorm_ref(x, scale, eps)
    y = torch.empty_like(x)
    if N == 0:
        return y
    with torch.cuda.device(x.device):
        lib = _lib()
        launch(LAUNCHES, "rmsnorm", getattr(lib, f"rmsnorm_{_SUFFIX[x.dtype]}"),
               x.data_ptr(), scale.data_ptr(), y.data_ptr(), N, D,
               float(eps), error_string=lib.rmsnorm_error_string)
    return y
