"""Parameter-tree checkpoints (npz plus a JSON sidecar).

A port of ``src/repro/checkpoint/ckpt.py`` with the same files, so a
checkpoint written by either package restores in the other.  Leaves are
copied to the host and stored in one ``.npz`` under ``/``-joined key
paths: the reference's ``jax.tree_util`` paths, i.e. dict keys (sorted)
and list/tuple indices.  bf16 leaves are stored as float32 (npz has no
bf16) and cast back to the template's dtype on restore.

Optimizer slab state (the server-side moments and update count of
:mod:`repro_torch.core.slab`) rides in the same ``.npz`` under the
reserved ``__opt__/`` prefix, with the moment names and the count in
the sidecar.  A checkpoint without that block (an SGD run's, or an old
one) gives ``None`` from :func:`load_opt_state`, and a restore starts
the moments from zero.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_OPT_PREFIX = "__opt__/"    # reserved npz namespace for optimizer slabs


def _leaves_with_keys(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs in the reference's flatten order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in items:
        out.extend(_leaves_with_keys(v, f"{prefix}/{k}" if prefix else k))
    return out


def _rebuild(tree, leaves) -> Any:
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:    # npz has no bf16: upcast
            return leaf.float().cpu().numpy()
        return leaf.cpu().numpy().copy()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fiub" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def save_checkpoint(path: str, params, step: int,
                    extra: Optional[Dict[str, Any]] = None,
                    opt_state: Optional[Dict[str, Any]] = None) -> None:
    """Write ``path.npz`` and its sidecar ``path.json``.

    ``opt_state`` is :meth:`repro_torch.core.slab.SlabAggregator.
    opt_state_host`'s form (f32 ``(P_pad,)`` moment slabs by name plus
    an int ``"count"``) or ``None``.  Both files are written under a
    temporary name and renamed, the sidecar last: it is the commit
    marker :func:`latest_step` looks for, so a reader never sees a
    partial checkpoint."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _to_host(v) for k, v in _leaves_with_keys(params)}
    if any(k.startswith(_OPT_PREFIX) for k in flat):
        raise ValueError(f"params tree collides with the reserved "
                         f"{_OPT_PREFIX!r} keys")
    meta: Dict[str, Any] = {"step": int(step), "extra": extra or {},
                            "keys": sorted(flat.keys())}
    if opt_state is not None:
        names = sorted(k for k in opt_state if k != "count")
        for name in names:
            flat[_OPT_PREFIX + name] = np.asarray(opt_state[name],
                                                  np.float32)
        meta["opt"] = {"names": names, "count": int(opt_state["count"])}
    # savez appends ".npz" to a name without it, hence ".tmp.npz"
    np.savez(path + ".tmp.npz", **flat)
    os.replace(path + ".tmp.npz", path + ".npz")
    with open(path + ".json.tmp", "w") as f:
        json.dump(meta, f)
    os.replace(path + ".json.tmp", path + ".json")


def restore_checkpoint(path: str, like) -> Tuple[Any, int]:
    """Restore into the structure of ``like``, a tree of tensors: each
    leaf comes back with the template leaf's dtype and device.  Returns
    ``(params, step)``."""
    with open(path + ".json") as f:
        meta = json.load(f)
    leaves = []
    with np.load(path + ".npz") as data:
        for key, leaf in _leaves_with_keys(like):
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {key!r} has shape "
                                 f"{arr.shape}, the template "
                                 f"{tuple(leaf.shape)}")
            leaves.append(torch.from_numpy(arr).to(device=leaf.device,
                                                   dtype=leaf.dtype))
    return _rebuild(like, iter(leaves)), int(meta["step"])


def load_opt_state(path: str) -> Optional[Dict[str, Any]]:
    """The optimizer slab state saved with a checkpoint (moment slabs as
    f32 numpy arrays plus the int ``"count"``), or ``None`` when the
    checkpoint carries none."""
    with open(path + ".json") as f:
        meta = json.load(f)
    opt = meta.get("opt")
    if not opt:
        return None
    with np.load(path + ".npz") as data:
        state: Dict[str, Any] = {name: data[_OPT_PREFIX + name]
                                 for name in opt["names"]}
    state["count"] = int(opt["count"])
    return state


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The highest step with a committed checkpoint in ``ckpt_dir``."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(name[len("step_"):-len(".json")])
             for name in os.listdir(ckpt_dir)
             if name.startswith("step_") and name.endswith(".json")]
    return max(steps) if steps else None
