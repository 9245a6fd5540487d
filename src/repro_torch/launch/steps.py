"""The train step of the SPMD driver and the examples.

After ``src/repro/launch/steps.py::make_train_step``: a gradient of the
model's loss (the plain, differentiable forward, rematerialised as the
config says), an optional gradient accumulation over micro-batches, and
the optimizer's update.  The gradient is taken with
``core/gradient.py`` (``torch.autograd.grad``), which a checkpointed
forward needs.  The reference's ``q_block`` is a constant here
(``models/attention.py::Q_BLOCK``; ROADMAP C.10).  In place of
its per-arch ``TRAIN_MICROBATCH`` table, sized for a 16 GiB TPU,
:func:`derive_microbatch` picks the micro-batch count from a predicted
peak (``launch/dryrun.py`` predicts it on the meta device) and the
card's memory (:func:`card_memory_bytes`).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.convert import tree_map
from repro_torch.core import counting, gradient
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


# torch.cuda.get_device_properties(0).total_memory of the H100 the port
# is measured on ("NVIDIA H100 80GB HBM3", 700 W power limit; read by
# chip_smoke.py's [dryrun] phase, PERF.md section 6): what a dry-run on
# the meta device takes for a card's memory
H100_MEMORY_BYTES = 85_017_493_504


def card_memory_bytes(device="cuda") -> int:
    """A card's memory in bytes: its properties on a CUDA device, the
    H100's constant on the meta device (a dry-run, no card)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    if device.type == "meta":
        return H100_MEMORY_BYTES
    raise ValueError(f"no card memory for device {device}")


def derive_microbatch(per_card_batch: int, peak_of: Callable[[int], int],
                      card_bytes: int) -> Tuple[int, bool]:
    """The smallest power of two ``m`` dividing ``per_card_batch`` whose
    predicted peak ``peak_of(m)`` fits in ``card_bytes``, and True; if
    none fits, the largest such ``m`` (one row a slice when the batch is
    a power of two) and False.  A peak falls as ``m`` grows (each slice
    is smaller), so the count is bisected: ``peak_of`` is called about
    log2(log2(batch)) + 1 times."""
    cands = [m for m in (2 ** i for i in range(per_card_batch.bit_length()))
             if per_card_batch % m == 0]
    if peak_of(cands[-1]) > card_bytes:
        return cands[-1], False
    lo, hi = 0, len(cands) - 1          # cands[hi] fits
    while lo < hi:
        mid = (lo + hi) // 2
        if peak_of(cands[mid]) <= card_bytes:
            hi = mid
        else:
            lo = mid + 1
    return cands[hi], True


def chained(fns) -> Optional[Callable]:
    """One ``reduce_grads`` applying each of ``fns`` in turn (None when
    there are none)."""
    fns = [f for f in fns if f is not None]
    if not fns:
        return None

    def run(grads):
        for f in fns:
            grads = f(grads)
        return grads
    return run


def make_train_step(cfg: ModelConfig, opt, microbatch: int = 1,
                    accum_dtype: torch.dtype = torch.float32,
                    reduce_grads: Optional[Callable] = None,
                    gather: Optional[Callable] = None, tensor=None,
                    column=None):
    """``(params, opt_state, batch) -> (params, opt_state, loss,
    metrics)``: ``metrics`` is ``loss_fn``'s (``ce`` and the MoE's
    ``aux``), averaged over the micro-batches as the loss is.

    ``microbatch > 1`` splits the batch into that many slices taken one
    after another, their gradients summed in ``accum_dtype`` and divided
    by ``microbatch``; the loss is the mean of theirs.
    ``reduce_grads(grads) -> grads``, when given, runs between the
    gradient and the update: the SPMD driver averages the gradient over
    a replica group there.  ``gather`` is the model's (params and
    optimizer state are a rank's FSDP shards, ``parallel/fsdp.py``):
    each micro-batch's backward then reduce-scatters its gradient, and
    the update runs on the shards.  ``tensor`` is the model's
    tensor-parallel context (``parallel/tensor.py``; params are a rank's
    model slices): the forward and backward then run their collectives
    over the model group, and ``reduce_grads`` sums the gradients of
    whole leaves over the data column only.  ``column``
    (a ``GroupShards``) groups the MoE's tokens and takes its aux loss
    over the replica group's batch."""
    grad_fn = gradient.grad_and_value(
        lambda p, b: M.loss_fn(p, b, cfg, gather=gather, tp=tensor,
                               column=column),
        has_aux=True)

    def train_step(params, opt_state, batch):
        if microbatch == 1:
            grads, (loss, metrics) = grad_fn(params, batch)
        else:
            slices = {k: v.reshape((microbatch, v.shape[0] // microbatch)
                                   + tuple(v.shape[1:]))
                      for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=accum_dtype, device=p.device), params)
            loss, metrics = 0.0, {}
            for i in counting.trips(microbatch):
                g, (l_i, m_i) = grad_fn(params,
                                        {k: v[i] for k, v in slices.items()})
                grads = tree_map(lambda a, gg: a + gg.to(accum_dtype),
                                 grads, g)
                loss = loss + l_i
                metrics = {k: metrics.get(k, 0.0) + v
                           for k, v in m_i.items()}
            grads = tree_map(lambda g: g / microbatch, grads)
            loss = loss / microbatch
            metrics = {k: v / microbatch for k, v in metrics.items()}
        counting.phase("update")
        if reduce_grads is not None:
            grads = reduce_grads(grads)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = tree_map(lambda p, u: p + u, params, updates)
        return params, opt_state, loss, metrics

    return train_step
