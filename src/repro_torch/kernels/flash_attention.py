"""Forward online-softmax attention: the wrapper around the CUDA kernel.

q (B, S, H, d), k (B, S, KV, d), v (B, S, KV, d_v) -> (B, S, H, d_v),
with GQA (H % KV == 0), causal, sliding-window (key > query - window)
and chunked-local (key // chunk == query // chunk) masks, scale d^-0.5,
and 0 for a fully masked row.  ``(d, d_v)`` is one of ``HEAD_DIMS``:
square pairs, and MLA's wider query/key head (deepseek-v2-lite's
(192, 128) and its smoke variant's (80, 64)).  The kernels are in
``csrc/flash_attention.cu`` (CUDA C++ for ``sm_90a``); they replace the
Pallas kernel ``src/repro/kernels/flash_attention.py:75
flash_attention_pallas``.  bfloat16 inputs take the tensor-core kernel
(``wgmma`` with TMA-staged k/v tiles; p split into two bf16 parts for
the PV product), float32 inputs the CUDA-core kernel.  Unlike the
Pallas kernel they take any S: the tail of the last tile is masked.
For tensors on the CPU the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.attention_ref`); for CUDA tensors it
launches the kernel on the current stream, adds one to
``LAUNCHES["flash_attention"]``, and raises if the launch failed; for
``meta`` tensors it returns the kernel's output as a meta tensor and
reports :func:`cost`.  Forward only, as the reference: an input that
requires grad is refused.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.core import counting
from repro_torch.kernels import ref
from repro_torch.kernels._build import load
from repro_torch.kernels._launch import bind, launch, on_cuda

LAUNCHES: Dict[str, int] = {"flash_attention": 0}
# the (d, d_v) pairs instantiated in the CUDA source
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (80, 80), (96, 96), (128, 128),
             (80, 64), (192, 128))

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
              ctypes.c_float, _P]


def reset_launch_counts() -> None:
    LAUNCHES["flash_attention"] = 0


def _lib() -> ctypes.CDLL:
    lib = load("flash_attention")
    if not getattr(lib, "_repro_bound", False):
        dims = (ctypes.c_int * 64)()
        n = lib.flash_attention_head_dims(dims, 64)
        if tuple(zip(dims[0:2 * n:2], dims[1:2 * n:2])) != HEAD_DIMS:
            raise RuntimeError("csrc/flash_attention.cu disagrees with the "
                               "wrapper on the head dims it takes")
        lib.flash_attention_bf16_smem_bytes.argtypes = [ctypes.c_int,
                                                        ctypes.c_int]
        lib.flash_attention_bf16_smem_bytes.restype = ctypes.c_int
    return bind(lib, {f"flash_attention_{s}": _SIGNATURE
                      for s in _SUFFIX.values()},
                "flash_attention_error_string")


def _seq_pairs(L: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs of one unchunked sequence of length ``L``."""
    w = window or 0
    if causal:
        if not w or L <= w:
            return L * (L + 1) // 2
        return w * (w + 1) // 2 + (L - w) * w
    if not w or L <= w:
        return L * L
    return L * L - (L - w) * (L - w + 1) // 2


def reachable_pairs(S: int, causal: bool, window: Optional[int] = None,
                    chunk: Optional[int] = None) -> int:
    """(query, key) pairs the causal, window and chunk masks leave: the
    work of one (batch, head), in closed form.  A chunk mask cuts the
    sequence into independent chunks (``S // chunk`` whole ones and the
    rest), and within one the window counts from the chunk's start."""
    if not chunk or chunk >= S:
        return _seq_pairs(S, causal, window)
    return (S // chunk) * _seq_pairs(chunk, causal, window) \
        + _seq_pairs(S % chunk, causal, window)


def cost(B: int, S: int, H: int, KV: int, d: int, dv: int, itemsize: int,
         causal: bool = True, window: Optional[int] = None,
         chunk: Optional[int] = None):
    """(flops, bytes) of one launch: QK^T and PV over the reachable pairs
    (2 d and 2 d_v a pair and head), q, k, v read and o written once."""
    flops = 2 * (d + dv) * B * H * reachable_pairs(S, causal, window, chunk)
    nbytes = itemsize * B * S * (H * d + KV * (d + dv) + H * dv)
    return flops, nbytes


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    chunk: Optional[int] = None) -> torch.Tensor:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            k.shape[:3] != v.shape[:3]:
        raise ValueError(f"q must be (B,S,H,d), k (B,S,KV,d) and v "
                         f"(B,S,KV,d_v), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, d = q.shape
    KV, dv = k.shape[2], v.shape[3]
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, d) or H % KV:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)} (need H % KV == 0)")
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be None or >= 1, got {chunk}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("the flash_attention kernel is forward only; "
                           "its inputs must not require grad")
    if not on_cuda("flash_attention", q, k, v):
        if q.is_meta:
            counting.kernel("flash_attention", *cost(
                B, S, H, KV, d, dv, q.element_size(), causal, window, chunk))
            return q.new_empty((B, S, H, dv))
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 chunk=chunk)
    if (d, dv) not in HEAD_DIMS:
        raise ValueError(f"head dims (d, d_v) = {(d, dv)}: the kernel takes "
                         f"{HEAD_DIMS}")
    o = q.new_empty((B, S, H, dv))
    if B * S == 0:
        return o
    with torch.cuda.device(q.device):
        lib = _lib()
        launch(LAUNCHES, "flash_attention",
               getattr(lib, f"flash_attention_{_SUFFIX[q.dtype]}"),
               q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               B, S, H, KV, d, dv, int(causal), window or 0, chunk or 0,
               d ** -0.5,
               error_string=lib.flash_attention_error_string)
    return o
