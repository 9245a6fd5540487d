"""The port's gradient routine for training a registry model:
``torch.func.grad`` and ``grad_and_value`` over the first argument,
taken with ``torch.autograd.grad``.

A rematerialising forward (``cfg.remat != "none"``: the block groups,
the query blocks of the plain attention, the mamba and mLSTM chunks)
runs under ``torch.utils.checkpoint``'s non-reentrant checkpoint, which
works through saved-tensor hooks.  ``torch.func.grad`` does not take
saved-tensor hooks, so ``launch/steps.py::make_train_step`` (the SPMD
driver, the dry-run) and a rematerialising replica step
(``core/spmd_hybrid.py``) take their gradients here: the param leaves
are detached copies that require grad (the batch and the other
arguments do not), the loss is evaluated with grad enabled, and
``torch.autograd.grad`` returns the gradient.  With or without a
checkpoint it is the same autograd graph, so remat does not change a
bit of it (``tests/test_torch_remat.py``).  Against ``torch.func``'s
gradient it agrees to f32 rounding, not bit for bit: functorch's
transform takes some ops by other decompositions (up to 1.5e-7 apart on
the CPU, ROADMAP C.40).  A leaf the loss does not reach gets zeros, as
under ``torch.func``.  The simulator and the cluster keep
``torch.func.grad``: their workloads do not rematerialise, and a
rematerialising config there raises (``models/remat.py``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.convert import tree_leaves, tree_map


def _detach(tree):
    return tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor)
                    else t, tree)


def grad_and_value(fn: Callable, has_aux: bool = False) -> Callable:
    """``fn(params, *args) -> loss`` (or ``(loss, aux)`` with
    ``has_aux``) to ``g(params, *args) -> (grads, loss)`` (or
    ``(grads, (loss, aux))``), grads a tree like ``params``."""
    def g(params, *args):
        leaves_tree = tree_map(lambda p: p.detach().requires_grad_(True),
                               params)
        leaves = tree_leaves(leaves_tree)
        with torch.enable_grad():
            out = fn(leaves_tree, *args)
        loss, aux = out if has_aux else (out, None)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
        grads = tree_map(
            lambda p: _zeros_if_none(next(grads), p), leaves_tree)
        loss = loss.detach()
        return (grads, (loss, _detach(aux))) if has_aux else (grads, loss)
    return g


def _zeros_if_none(g, p):
    return torch.zeros_like(p) if g is None else g
