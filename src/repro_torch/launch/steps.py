"""The train step of the SPMD driver and the examples.

After ``src/repro/launch/steps.py::make_train_step``: a gradient of the
model's loss (the plain, differentiable forward), an optional gradient
accumulation over micro-batches, and the optimizer's update.  The
reference's ``q_block`` has no counterpart (ROADMAP C.10), nor its
per-arch ``TRAIN_MICROBATCH`` table, which is sized for a 16 GiB TPU
(ROADMAP A14b derives the card's).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.convert import tree_map
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def make_train_step(cfg: ModelConfig, opt, microbatch: int = 1,
                    accum_dtype: torch.dtype = torch.float32,
                    reduce_grads: Optional[Callable] = None):
    """``(params, opt_state, batch) -> (params, opt_state, loss)``.

    ``microbatch > 1`` splits the batch into that many slices taken one
    after another, their gradients summed in ``accum_dtype`` and divided
    by ``microbatch``; the loss is the mean of theirs.
    ``reduce_grads(grads) -> grads``, when given, runs between the
    gradient and the update: the SPMD driver averages the gradient over
    a replica group there."""
    grad_fn = torch.func.grad_and_value(
        lambda p, b: M.loss_fn(p, b, cfg), has_aux=True)

    def train_step(params, opt_state, batch):
        if microbatch == 1:
            grads, (loss, _) = grad_fn(params, batch)
        else:
            slices = {k: v.reshape((microbatch, v.shape[0] // microbatch)
                                   + tuple(v.shape[1:]))
                      for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=accum_dtype, device=p.device), params)
            loss = 0.0
            for i in range(microbatch):
                g, (l_i, _) = grad_fn(params,
                                      {k: v[i] for k, v in slices.items()})
                grads = tree_map(lambda a, gg: a + gg.to(accum_dtype),
                                 grads, g)
                loss = loss + l_i
            grads = tree_map(lambda g: g / microbatch, grads)
            loss = loss / microbatch
        if reduce_grads is not None:
            grads = reduce_grads(grads)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = tree_map(lambda p, u: p + u, params, updates)
        return params, opt_state, loss

    return train_step
