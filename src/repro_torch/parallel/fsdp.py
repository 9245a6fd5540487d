"""The reference's FSDP layout within a replica group: the counterpart of
``src/repro/core/spmd_hybrid.py:185-207 replica_param_shardings``.

A replica group of g ranks holds its replica sharded.  Each leaf's spec
is ``parallel/partition.py``'s over the mesh ``{"data": g, "model": 1}``,
sanitized as the reference's ``sanitize_sharding`` does: a leaf whose
spec names the ``data`` axis on a dim that g divides (the FSDP axis
"embed", a weight's d_model dim) is cut along that dim into g equal
contiguous slices, and rank k of the group holds the k-th, as a
``NamedSharding`` lays a dim out over its mesh axis; every other leaf
stays whole on every rank of the group.  Optimizer state shards exactly
as its params do (``opt_state_shardings``): the moments are built from
the shards, and the count stays whole.

A sharded leaf is made whole where it is used and only there:
:class:`Gather` all-gathers it along its dim in the forward, and its
backward reduce-scatters the whole gradient back to the shard, summed
over the group (in float32, cast back to the leaf's dtype).  The model
(``models/model.py::forward``) gathers each block group's layer inside
the group's body, so a rematerialised group gathers again in its
recompute and no gathered layer outlives its use.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.parallel.partition import leaf_spec, map_with_path

Path = Tuple[str, ...]


def leaf_dims(params, g: int) -> Dict[Path, Optional[int]]:
    """Each leaf's sharded dim in a group of ``g`` ranks (None: whole),
    by its path (``map_with_path``'s, sequence indices as strings)."""
    mesh = {"data": g, "model": 1}
    dims: Dict[Path, Optional[int]] = {}

    def visit(path, leaf):
        spec = leaf_spec(path, leaf, mesh)
        dims[path] = next(
            (d for d, axes in enumerate(spec) if axes == "data" or (
                isinstance(axes, tuple) and "data" in axes)), None) \
            if g > 1 else None
    map_with_path(visit, params)
    return dims


def _take(leaf: torch.Tensor, dim: int, k: int, g: int) -> torch.Tensor:
    n = leaf.shape[dim] // g
    return leaf.narrow(dim, k * n, n).clone(
        memory_format=torch.contiguous_format)


def shard_tree(tree, rank_in_group: int, g: int,
               dims: Optional[Dict[Path, Optional[int]]] = None):
    """Rank ``rank_in_group``'s shards of ``tree`` (fresh contiguous
    tensors; a whole leaf is the leaf itself).  ``dims`` are
    :func:`leaf_dims` of ``tree``, computed when not given."""
    dims = leaf_dims(tree, g) if dims is None else dims
    return map_with_path(lambda p, t: t if dims[p] is None
                         else _take(t, dims[p], rank_in_group, g), tree)


def all_gather_leaf(shard: torch.Tensor, dim: int, g: int, comm
                    ) -> torch.Tensor:
    """The whole tensor of which each rank of the group holds ``shard``
    (no autograd): one all-gather, then the slices laid side by side
    along ``dim``."""
    shard = shard.contiguous()
    flat = shard.new_empty((g * shard.numel(),))
    comm.all_gather_(flat, shard.view(-1), g)
    parts = flat.view((g,) + tuple(shard.shape))
    full = list(shard.shape)
    full[dim] *= g
    return parts.view(full) if dim == 0 else \
        parts.movedim(0, dim).reshape(full)


def reduce_scatter_leaf(grad: torch.Tensor, dim: int, g: int, comm
                        ) -> torch.Tensor:
    """This rank's slice along ``dim`` of ``grad`` summed over the group,
    the sum taken in float32 and cast back to ``grad``'s dtype."""
    n = grad.shape[dim] // g
    parts = grad.unflatten(dim, (g, n)).movedim(dim, 0)
    staged = torch.empty(parts.shape, dtype=torch.float32,
                         device=grad.device)
    staged.copy_(parts)
    out = staged.new_empty(staged.shape[1:])
    comm.reduce_scatter_(out.view(-1), staged.view(-1), g)
    return out.to(grad.dtype)


class Gather(torch.autograd.Function):
    """``Gather.apply(shard, dim, g, comm)``: the whole leaf in the
    forward (an all-gather, timed as ``"gather"``); in the backward the
    whole gradient reduce-scattered to this rank's shard, summed over
    the group (timed as ``"gradient"``)."""

    @staticmethod
    def forward(ctx, shard, dim: int, g: int, comm):
        ctx.dim, ctx.g, ctx.comm = dim, g, comm
        with comm.timing("gather"):
            return all_gather_leaf(shard, dim, g, comm)

    @staticmethod
    def backward(ctx, grad):
        with ctx.comm.timing("gradient"):
            return (reduce_scatter_leaf(grad, ctx.dim, ctx.g, ctx.comm),
                    None, None, None)


class GroupShards:
    """One rank's FSDP layout of a replica group of size ``g`` (ranks of
    the group ``comm`` talks to), built from a whole params tree.

    ``dims`` maps each leaf's path to its sharded dim.  :meth:`gather`
    is what the model's forward takes as ``gather``; :meth:`group_mean`
    is the train step's ``reduce_grads``."""

    def __init__(self, params, g: int, rank_in_group: int, comm):
        self.g = int(g)
        self.rank = int(rank_in_group)
        self.comm = comm
        self.dims = leaf_dims(params, self.g)

    @property
    def sharded(self) -> bool:
        return any(d is not None for d in self.dims.values())

    def shard(self, tree):
        """This rank's shards of a whole tree shaped like the params."""
        return shard_tree(tree, self.rank, self.g, self.dims)

    def gather(self, path: Path, tree):
        """The whole leaves of the subtree at ``path`` (autograd runs
        through :class:`Gather`).  A subtree under ``"groups"`` is one
        block group's layer: its leaves lack the stacked group dim."""
        def one(p, leaf):
            d = self.dims[p]
            if d is None:
                return leaf
            return Gather.apply(leaf, d - (p[0] == "groups"), self.g,
                                self.comm)
        return map_with_path(one, tree, path)

    def gather_tree(self, shards):
        """The whole tree of a shard tree (no autograd)."""
        with torch.no_grad():
            return map_with_path(
                lambda p, t: t if self.dims[p] is None
                else all_gather_leaf(t, self.dims[p], self.g, self.comm),
                shards)

    def group_mean(self, grads):
        """The gradient averaged over the group: a sharded leaf's
        gradient arrives summed over the group (the gather's backward)
        and is divided by g; the whole leaves' gradients are summed in
        one float32 all-reduce and divided by g, as the whole-replica
        layout does with its slab."""
        whole = []
        map_with_path(lambda p, t: whole.append(t)
                      if self.dims[p] is None else None, grads)
        pieces = iter(())
        if whole:
            buf = torch.cat([t.float().reshape(-1) for t in whole])
            with self.comm.timing("gradient"):
                self.comm.all_reduce_sum_(buf, self.g)
            pieces = iter((buf / self.g).split([t.numel() for t in whole]))
        return map_with_path(
            lambda p, t: t / self.g if self.dims[p] is not None
            else next(pieces).view(t.shape).to(t.dtype), grads)
