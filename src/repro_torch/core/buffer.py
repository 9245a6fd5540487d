"""Server-side gradient buffer with staleness-aware aggregation, after
the reference's ``core/buffer.py``.

The buffer stores worker gradients together with the parameter *version*
they were computed against.  A flush aggregates the buffered gradients into
one update:

    g_agg = Σ_i w_i · g_i / Σ_i w_i,   w_i = staleness_decay^(v_now - v_i)

With staleness_decay=1.0 (default) this is the plain mean, which matches
the paper (their flush gives every buffered gradient equal weight); the
decay knob is the beyond-paper extension.

This module is the **legacy tree reference**: the live hot paths
(cluster server, simulator) aggregate on the slab path instead --
:class:`repro_torch.core.slab.SlabBuffer` staging into the flush kernels
(``kernels/hybrid_aggregate.py``).  ``aggregate_flush`` stays as the
per-leaf oracle that parity tests compare the slab path against.  A
gradient is a tree of tensors (nested dicts, tuples and lists).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np

from repro_torch.convert import tree_map


def aggregate_flush(grads: List[Any], weights: np.ndarray):
    """Weighted mean of a list of gradient trees.  weights: (K,)."""
    wsum = float(np.sum(weights))
    ws = [float(w) / wsum for w in weights]

    def comb(*leaves):
        out = ws[0] * leaves[0]
        for w, leaf in zip(ws[1:], leaves[1:]):
            out = out + w * leaf
        return out

    return tree_map(comb, *grads)


@dataclasses.dataclass
class GradientBuffer:
    staleness_decay: float = 1.0

    def __post_init__(self):
        self._grads: List[Any] = []
        self._versions: List[int] = []

    def __len__(self) -> int:
        return len(self._grads)

    def add(self, grad, version: int) -> None:
        self._grads.append(grad)
        self._versions.append(version)

    def flush(self, current_version: int):
        """Aggregate + clear.  Returns (g_agg, num_aggregated)."""
        if not self._grads:
            raise ValueError("flush of an empty buffer")
        n = len(self._grads)
        if n == 1:
            # the weighted mean of one gradient is itself (w/w = 1)
            agg = self._grads[0]
        else:
            stale = current_version - np.asarray(self._versions, np.float64)
            weights = self.staleness_decay ** stale
            agg = aggregate_flush(self._grads, weights)
        self._grads, self._versions = [], []
        return agg, n

    def drain(self):
        """Take the buffered (grads, versions) and clear, without
        aggregating -- for callers that fuse the aggregation into their
        own update."""
        grads, versions = self._grads, self._versions
        self._grads, self._versions = [], []
        return grads, versions

    def staleness(self, current_version: int) -> List[int]:
        return [current_version - v for v in self._versions]
