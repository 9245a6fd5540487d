"""Rematerialisation of the training forward (``cfg.remat``), after the
reference's ``jax.checkpoint`` sites: each block group when ``remat ==
"block"`` (``src/repro/models/model.py:112-114``), and, when ``remat !=
"none"``, each query block of the plain attention
(``attention.py:149``), each mamba scan chunk (``mamba.py:92``) and each
mLSTM chunk (``xlstm.py:131``).

A checkpointed function keeps only its inputs for the backward and runs
again there (``torch.utils.checkpoint``, non-reentrant, which is what
``jax.checkpoint`` with ``nothing_saveable`` keeps).  It works through
saved-tensor hooks, which ``torch.func``'s transforms refuse, so a
rematerialising gradient is taken with ``core/gradient.py``; under a
``torch.func`` transform :func:`run` raises instead of running the
forward without remat.  Every site asks :func:`run` with its own switch
(:func:`on` or :func:`blocks_on`).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from repro_torch.models.config import ModelConfig


def on(cfg: ModelConfig) -> bool:
    """Whether the mixers' chunks and query blocks rematerialise: the
    config asks for it and a gradient may be taken."""
    return cfg.remat != "none" and torch.is_grad_enabled()


def blocks_on(cfg: ModelConfig) -> bool:
    """Whether each block group rematerialises."""
    return cfg.remat == "block" and torch.is_grad_enabled()


def _under_functorch() -> bool:
    try:
        from torch._C._functorch import peek_interpreter_stack
    except ImportError:     # an older torch: its own error stands
        return False
    return peek_interpreter_stack() is not None


def run(enabled: bool, fn, *args):
    """``fn(*args)``; when ``enabled``, checkpointed: only ``args`` are
    kept for the backward and ``fn`` runs again there.  The model draws
    no random numbers, so no RNG state is stashed."""
    if not enabled:
        return fn(*args)
    if _under_functorch():
        raise ValueError(
            "a rematerialising config (remat != 'none') cannot be "
            "differentiated under torch.func: take its gradient with "
            "repro_torch.core.gradient (ROADMAP A17)")
    return _checkpoint(fn, *args, use_reentrant=False,
                       preserve_rng_state=False)
