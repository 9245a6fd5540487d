"""Per-worker data shards for the cluster runtime.

The part of ``src/repro/data/pipeline.py`` the cluster backend needs;
its mesh and sharding helpers are JAX's and stay there.  The same
``(seed, worker_id, generation)`` draws the same batch indices in both
packages.
"""
from __future__ import annotations

from typing import Iterator, List

import numpy as np


def worker_shards(n_samples: int, num_workers: int) -> List[np.ndarray]:
    """Deterministic round-robin shard indices (the simulator's data
    partition across PS workers)."""
    return [np.arange(w, n_samples, num_workers) for w in range(num_workers)]


def shard_indices(n_samples: int, worker_id: int, num_workers: int,
                  batch: int, seed: int = 0,
                  generation: int = 0) -> Iterator[np.ndarray]:
    """Infinite stream of one worker's minibatch indices into its shard.
    Deterministic per ``(seed, worker_id, generation)``: the i-th batch a
    worker draws is the same in every run, which is what makes the sync
    policy bitwise reproducible; ``generation`` bumps on respawn so a
    resurrected worker does not replay its dead predecessor's stream."""
    idx = worker_shards(n_samples, num_workers)[worker_id]
    rng = np.random.default_rng((seed, worker_id, generation))
    while True:
        yield rng.choice(idx, size=batch, replace=True)


def shard_iterator(x, y, worker_id: int, num_workers: int, batch: int,
                   seed: int = 0, generation: int = 0) -> Iterator:
    """Infinite per-worker ``(x, y)`` minibatch iterator over the
    worker's shard of numpy arrays (the reference's function)."""
    for take in shard_indices(x.shape[0], worker_id, num_workers, batch,
                              seed=seed, generation=generation):
        yield x[take], y[take]
