"""What a worker outside the parameter server's process rebuilds.

A port of ``build_slab_worker_fn`` from ``src/repro/cluster/
hostlink.py``, which ``proc`` worker processes call; the multi-host
leader and ``join`` (the rest of that module) come with ROADMAP A10b.
"""
from __future__ import annotations

import torch

from repro_torch.cluster.worker import wait_for
from repro_torch.convert import to_device
from repro_torch.core.slab import slab_codec
from repro_torch.data.pipeline import shard_indices, worker_shards


def build_slab_worker_fn(spec, worker_id: int, num_workers: int,
                         generation: int, *, batch: int, seed: int,
                         device: torch.device):
    """Rebuild one worker's world from an ``ExperimentSpec``: the
    slab-in/slab-out gradient function, already run once on ``device``,
    and a factory for its deterministic minibatch stream.  The spec is
    the whole cross-process contract: the workload is rebuilt through
    ``SIM_WORKLOADS``, and only this worker's shard of the training set
    stays, on the device (the rest is freed here).  The stream draws the
    batches an in-process worker of the same ``(seed, worker_id,
    generation)`` draws, row for row."""
    from repro_torch.api.trainers import SIM_WORKLOADS

    loss_fn, init_params, data, _ = SIM_WORKLOADS[spec.arch](spec, device)
    n = data[0].shape[0]
    rows = worker_shards(n, num_workers)[worker_id]
    x, y = to_device(data[0][rows], device), to_device(data[1][rows], device)
    del data
    codec = slab_codec(init_params, spec.slab_dtype)
    grad_fn = torch.func.grad(loss_fn)

    def grad(p_slab, xb, yb):
        return codec.encode(grad_fn(codec.decode(p_slab), xb, yb))

    def fresh_batches():
        # the shard is round robin: global row r is local row r // N
        for take in shard_indices(n, worker_id, num_workers, batch,
                                  seed=seed, generation=generation):
            idx = to_device(take // num_workers, device)
            yield x[idx], y[idx]

    # warm up on a throwaway stream: the training stream must start at
    # batch 0, exactly like an in-process worker's
    wx, wy = next(fresh_batches())
    wait_for(grad(codec.encode(init_params), wx, wy))
    return grad, fresh_batches
