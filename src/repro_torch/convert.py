"""Devices, and parameter trees between numpy and the port.

``params_from_numpy``/``params_to_numpy`` carry a tree of nested dicts,
tuples and lists of arrays (the JAX package's parameters or KV caches,
read out as numpy) into the port and back, keeping structure, names,
shapes and dtypes.  numpy has no
bfloat16 of its own: a bf16 leaf travels as ``ml_dtypes.bfloat16``, the
type JAX hands out.
"""
from __future__ import annotations

from typing import Any, List, Union

import numpy as np
import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and
    the host has none: the port never carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' "
            "(or --device cpu) to run on the CPU")
    return dev


def to_device(array, device: torch.device) -> torch.Tensor:
    """A host array on ``device``.  CUDA copies go through pinned memory
    and do not block the host, so a loop that feeds the card never waits
    for it."""
    t = torch.as_tensor(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a, copy=True).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes     # the bf16 numpy type; only bf16 leaves need it
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def tree_map(fn, *trees: Any) -> Any:
    """``fn`` on the leaves of nested dicts, tuples and lists (several
    trees of one structure: leaf by leaf)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of nested dicts, tuples and lists, in iteration order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def params_from_numpy(tree: Any, device: Device = "cpu") -> Any:
    """Tree of arrays -> the same tree of tensors on ``device``."""
    return tree_map(lambda a: _leaf_from_numpy(a, device), tree)


def params_to_numpy(tree: Any) -> Any:
    """Tree of tensors -> the same tree of numpy arrays (host copies
    that later updates of the tensors do not touch)."""
    return tree_map(_leaf_to_numpy, tree)


def tree_to(tree: Any, device: torch.device) -> Any:
    """Tensors or arrays of a tree, as tensors on ``device``."""
    return tree_map(lambda leaf: _leaf_to(leaf, device), tree)


def _leaf_to(leaf: Any, device: torch.device) -> torch.Tensor:
    if not isinstance(leaf, torch.Tensor):
        leaf = _leaf_from_numpy(leaf, "cpu")
    return leaf.to(device)
