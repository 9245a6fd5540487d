"""Forward online-softmax attention: the wrapper around the CUDA kernel.

q (B, S, H, d), k/v (B, S, KV, d) -> (B, S, H, d), with GQA (H % KV ==
0), causal and sliding-window (key > query - window) masks, scale
d^-0.5, and 0 for a fully masked row.  The kernel is in
``csrc/flash_attention.cu`` (CUDA C++ for ``sm_90a``); it replaces the
Pallas kernel ``src/repro/kernels/flash_attention.py:75
flash_attention_pallas``.  Unlike that kernel it takes any S: the
tail of the last tile is masked.  For tensors on the CPU the wrapper
runs the plain version (:func:`repro_torch.kernels.ref.attention_ref`);
for CUDA tensors it launches the kernel on the current stream, adds
one to ``LAUNCHES["flash_attention"]``, and raises if the launch
failed.  Forward only, as the reference: an input that requires grad is
refused.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import load
from repro_torch.kernels._launch import bind, launch, on_cuda

LAUNCHES: Dict[str, int] = {"flash_attention": 0}
HEAD_DIMS = (16, 32, 64, 80, 96, 128)   # instantiated in the CUDA source

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
              _P]


def reset_launch_counts() -> None:
    LAUNCHES["flash_attention"] = 0


def _lib() -> ctypes.CDLL:
    lib = load("flash_attention")
    if not getattr(lib, "_repro_bound", False):
        dims = (ctypes.c_int * 16)()
        n = lib.flash_attention_head_dims(dims, 16)
        if tuple(dims[:n]) != HEAD_DIMS:
            raise RuntimeError("csrc/flash_attention.cu disagrees with the "
                               "wrapper on the head dims it takes")
    return bind(lib, {f"flash_attention_{s}": _SIGNATURE
                      for s in _SUFFIX.values()},
                "flash_attention_error_string")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B,S,H,d) and k, v (B,S,KV,d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, d = q.shape
    KV = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, d) or H % KV:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)} (need H % KV == 0)")
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("the flash_attention kernel is forward only; "
                           "its inputs must not require grad")
    if not on_cuda("flash_attention", q, k, v):
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIMS}")
    o = torch.empty_like(q)
    if B * S == 0:
        return o
    with torch.cuda.device(q.device):
        lib = _lib()
        launch(LAUNCHES, "flash_attention",
               getattr(lib, f"flash_attention_{_SUFFIX[q.dtype]}"),
               q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               B, S, H, KV, d, int(causal), window or 0, d ** -0.5,
               error_string=lib.flash_attention_error_string)
    return o
