"""Per-worker data shards for the cluster runtime, and a rank's rows of
a batch for the SPMD backend.

The parts of ``src/repro/data/pipeline.py`` the two backends need.  The
same ``(seed, worker_id, generation)`` draws the same batch indices in
both packages.  The reference's ``batch_sharding``/``shard_batch`` place
a global batch on a mesh, split along the data axis; here each rank of
a ``torch.distributed`` job is one position on that axis and takes its
own rows (:func:`rank_rows`, :func:`shard_batch`).
"""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np
import torch

from repro_torch.convert import to_device


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


def rank_rows(batch: int, rank: int, world_size: int) -> slice:
    """Rows ``[rank*B/W, (rank+1)*B/W)`` of a global batch of ``batch``
    rows: the rows the reference's batch sharding puts on data-axis
    position ``rank``."""
    if batch % world_size:
        raise ValueError(f"batch {batch} does not split over "
                         f"{world_size} ranks")
    n = batch // world_size
    return slice(rank * n, (rank + 1) * n)


def shard_batch(batch: Dict[str, np.ndarray], rank: int, world_size: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """This rank's rows of a host batch, as tensors on ``device``."""
    rows = rank_rows(next(iter(batch.values())).shape[0], rank, world_size)
    return {k: to_device(v[rows], device) for k, v in batch.items()}
