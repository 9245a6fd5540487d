"""What every kernel wrapper of the port does around a launch: pick the
device path from its inputs, and launch on the current stream."""
from __future__ import annotations

import ctypes
from typing import Callable, Dict

import torch


def on_cuda(what: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix, on
    another device type, and on CUDA tensors the kernels cannot read."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what} inputs are on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what} kernels run on cuda or cpu, not {dev}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} kernels need contiguous, 16-byte "
                             "aligned tensors")
    return True


def launch(counts: Dict[str, int], name: str, fn, *args,
           error_string: Callable[[int], bytes]) -> None:
    """Call a launcher with the current stream appended; raise if the
    launch failed, else add one to ``counts[name]``."""
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        msg = error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    counts[name] += 1


def bind(lib: ctypes.CDLL, signatures: Dict[str, list],
         error_fn: str) -> ctypes.CDLL:
    """Declare argument and result types of a freshly loaded library's
    launchers (each returns an int error code) once."""
    if not getattr(lib, "_repro_bound", False):
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        err = getattr(lib, error_fn)
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib
