"""Hybrid gradient-buffer flush: wrappers around the CUDA kernels.

The Smooth Switch flush aggregates K staged gradient slabs into one
update::

    out[p] = sum_k w[k] * g[k, p]      (+ optional fused optimizer step)

The kernels are in ``csrc/hybrid_aggregate.cu`` (CUDA C++ for
``sm_90a``); they replace the Pallas kernels of
``src/repro/kernels/hybrid_aggregate.py``.  Each wrapper checks its
inputs, then:

* for tensors on the CPU runs the plain PyTorch version in
  :mod:`repro_torch.kernels.ref`;
* for CUDA tensors launches its kernel on the current stream, adds one
  to its count in :data:`LAUNCHES` and to its count at this many staging
  rows in :data:`LAUNCHES_BY_K`, and raises if the launch failed;
* for ``meta`` tensors returns the kernel's outputs as meta tensors (the
  moment and parameter slabs it updates in place are returned as they
  are) and reports its :func:`cost`.

There is no fallback from CUDA to the plain version.  No wrapper reads a
device value on the host, so a flush never waits for the card.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import counting
from repro_torch.kernels import ref
from repro_torch.kernels._build import load
from repro_torch.kernels._launch import bind, launch, on_cuda

# the slab's padding unit (src/repro/core/slab.py:133): wire frames and
# slab layouts depend on it.  It is not the CUDA block size
TILE_P = 8 * 128 * 8
BLOCK_P = 1024        # P elements per CUDA block: P must be a multiple
MAX_K = 4096          # staging rows the kernels' shared memory takes

LAUNCHES: Dict[str, int] = {"flush": 0, "flush_momentum": 0,
                            "flush_adamw": 0}
# the same launches by (kernel, K staging rows): an elastic fleet grows
# K while the run goes on
LAUNCHES_BY_K: Dict[Tuple[str, int], int] = {}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "hybrid_flush": [_P, _P, _P, _I, _L, _P],
    "hybrid_flush_momentum": [_P, _P, _P, _I, _L, _F, _P],
    "hybrid_flush_adamw": [_P, _P, _F, _P, _F, _P, _F, _P, _P, _P, _P, _I,
                           _L, _F, _F, _F, _F, _F, _F, _P],
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_BY_K.clear()


def _lib() -> ctypes.CDLL:
    lib = load("hybrid_aggregate")
    if not getattr(lib, "_repro_bound", False):
        lib.hybrid_max_k.restype = ctypes.c_int
        lib.hybrid_block_p.restype = ctypes.c_int
        if (lib.hybrid_max_k(), lib.hybrid_block_p()) != (MAX_K, BLOCK_P):
            raise RuntimeError("csrc/hybrid_aggregate.cu disagrees with "
                               "the wrapper on MAX_K or BLOCK_P")
    return bind(lib, {f"{base}_{suffix}": argtypes
                      for base, argtypes in _SIGNATURES.items()
                      for suffix in _SUFFIX.values()},
                "hybrid_error_string")


def _check_rows(grads: torch.Tensor, weights: torch.Tensor
                ) -> Tuple[int, int]:
    if grads.dim() != 2:
        raise ValueError(f"grads must be (K, P), got shape "
                         f"{tuple(grads.shape)}")
    K, P = grads.shape
    if grads.dtype not in _SUFFIX:
        raise TypeError(f"grads must be float32 or bfloat16, got "
                        f"{grads.dtype}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K} staging rows; the kernels take "
                         f"1..{MAX_K}")
    if P % BLOCK_P:
        raise ValueError(f"P={P} must be a multiple of {BLOCK_P}")
    if tuple(weights.shape) != (K,) or weights.dtype != torch.float32:
        raise ValueError(f"weights must be float32 of shape ({K},), got "
                         f"{weights.dtype} {tuple(weights.shape)}")
    return K, P


def _check_slab(name: str, t: torch.Tensor, P: int) -> None:
    if tuple(t.shape) != (P,) or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 of shape ({P},), got "
                         f"{t.dtype} {tuple(t.shape)}")


def _launch(name: str, K: int, fn, *args) -> None:
    launch(LAUNCHES, name, fn, *args,
           error_string=_lib().hybrid_error_string)
    LAUNCHES_BY_K[name, K] = LAUNCHES_BY_K.get((name, K), 0) + 1


def cost(kind: str, K: int, P: int, itemsize: int):
    """(flops, bytes) of one launch of ``kind`` ("flush",
    "flush_momentum", "flush_adamw") on (K, P) staging rows of
    ``itemsize`` bytes: the K x P multiply-adds, the staging rows and f32
    weights read once; the plain flush writes the (P,) sum in the rows'
    dtype, momentum reads and writes its f32 moment (and adds beta m),
    AdamW reads and writes params, mu and nu (16 operations an element)
    and reads its three f32 scalars."""
    flops, nbytes = 2 * K * P, K * P * itemsize + 4 * K
    if kind == "flush":
        return flops, nbytes + P * itemsize
    if kind == "flush_momentum":
        return flops + 2 * P, nbytes + 2 * 4 * P
    if kind == "flush_adamw":
        return flops + 16 * P, nbytes + 12 + 2 * 3 * 4 * P
    raise ValueError(f"no flush kernel {kind!r}")


def _meta(kind: str, grads: torch.Tensor) -> None:
    K, P = grads.shape
    counting.kernel(kind, *cost(kind, K, P, grads.element_size()))


def flush(grads: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """grads (K, P) f32 or bf16, weights (K,) f32 -> (P,) weighted sum
    in grads' dtype, accumulated in f32.  Replaces ``flush_pallas``."""
    K, P = _check_rows(grads, weights)
    if not on_cuda("flush", grads, weights):
        if grads.is_meta:
            _meta("flush", grads)
            return grads.new_empty((P,))
        return ref.flush_ref(grads, weights)
    out = torch.empty((P,), dtype=grads.dtype, device=grads.device)
    with torch.cuda.device(grads.device):
        fn = getattr(_lib(), f"hybrid_flush_{_SUFFIX[grads.dtype]}")
        _launch("flush", K, fn, weights.data_ptr(), grads.data_ptr(),
                out.data_ptr(), K, P)
    return out


def flush_momentum(grads: torch.Tensor, weights: torch.Tensor,
                   momentum: torch.Tensor, beta: float):
    """Fused flush + heavy-ball momentum: ``m' = beta*m + sum_k w[k] g[k]``
    with ``weights`` normalized by the caller.  Returns ``(update,
    new_momentum)`` like ``flush_momentum_pallas``.

    On CUDA the kernel writes m' **into** ``momentum`` in place and
    returns that tensor as ``new_momentum`` and, for f32 grads, as the
    update too (for bf16 grads the update is m' cast to bf16).  On the
    CPU the inputs are left as they are and both results are new."""
    K, P = _check_rows(grads, weights)
    _check_slab("momentum", momentum, P)
    if not on_cuda("flush", grads, weights, momentum):
        if grads.is_meta:
            _meta("flush_momentum", grads)
            return momentum.to(grads.dtype), momentum
        return ref.flush_momentum_ref(grads, weights, momentum, beta)
    with torch.cuda.device(grads.device):
        fn = getattr(_lib(), f"hybrid_flush_momentum_{_SUFFIX[grads.dtype]}")
        _launch("flush_momentum", K, fn, weights.data_ptr(), grads.data_ptr(),
                momentum.data_ptr(), K, P, float(beta))
    return momentum.to(grads.dtype), momentum


def _scalar(name: str, value, device) -> Tuple[Optional[int], float]:
    """``(pointer, 0.0)`` for an f32 one-element tensor on ``device``,
    ``(None, value)`` for a number: the kernel reads the first from the
    device and takes the second by value, so no scalar costs a launch."""
    if not isinstance(value, torch.Tensor):
        return None, float(value)
    if value.numel() != 1 or value.dtype != torch.float32 \
            or value.device != device:
        raise ValueError(f"{name} must be a number or a one-element float32 "
                         f"tensor on {device}, got {value.dtype} "
                         f"{tuple(value.shape)} on {value.device}")
    return value.data_ptr(), 0.0


def flush_adamw(grads, weights, params, mu, nu, bc1, bc2, scale, *,
                b1: float, b2: float, eps: float, weight_decay: float):
    """Fused flush + AdamW step.  ``weights`` are pre-normalized;
    ``bc1``/``bc2`` are the bias corrections ``1 - b^count`` and
    ``scale`` the learning rate, each a float or an f32 device scalar.
    Returns ``(new_params, new_mu, new_nu)``.

    On CUDA the kernel updates ``params``, ``mu`` and ``nu`` **in place**
    and returns them, and it is the only launch: a tensor scalar reaches
    it as a device pointer, a number by value (the Pallas kernel takes
    the three as one ``h`` array).  On the CPU the inputs are left as
    they are and the results are new."""
    K, P = _check_rows(grads, weights)
    for name, t in (("params", params), ("mu", mu), ("nu", nu)):
        _check_slab(name, t, P)
    if not on_cuda("flush", grads, weights, params, mu, nu):
        if grads.is_meta:
            _meta("flush_adamw", grads)
            return params, mu, nu
        return ref.flush_adamw_ref(grads, weights, params, mu, nu, bc1,
                                   bc2, scale, b1=b1, b2=b2, eps=eps,
                                   weight_decay=weight_decay)
    scalars = [x for name, v in (("bc1", bc1), ("bc2", bc2),
                                 ("scale", scale))
               for x in _scalar(name, v, grads.device)]
    with torch.cuda.device(grads.device):
        fn = getattr(_lib(), f"hybrid_flush_adamw_{_SUFFIX[grads.dtype]}")
        _launch("flush_adamw", K, fn, weights.data_ptr(), *scalars,
                grads.data_ptr(), params.data_ptr(), mu.data_ptr(),
                nu.data_ptr(), K, P, b1, 1 - b1, b2, 1 - b2, eps,
                weight_decay)
    return params, mu, nu
