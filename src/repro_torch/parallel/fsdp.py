"""The reference's FSDP layout within a replica group: the counterpart of
``src/repro/core/spmd_hybrid.py:185-207 replica_param_shardings``.

A replica group of g data positions holds its replica sharded.  Each
leaf's spec is ``parallel/partition.py``'s over the mesh ``{"data": g,
"model": M}``, sanitized as the reference's ``sanitize_sharding`` does:
a leaf whose spec names the ``data`` axis on a dim that g divides (the
FSDP axis "embed", a weight's d_model dim) is cut along that dim into g
equal contiguous slices, and the d-th rank of a data column
(``launch/mesh.py::data_column``) holds the d-th, as a
``NamedSharding`` lays a dim out over its mesh axis; every other leaf
stays whole along ``data``.  With M > 1 a rank's leaves are its model
slices (``parallel/tensor.py``), which keep their d_model dims whole, so
the FSDP layout runs over each data column as it runs over a whole
replica group with M = 1.  Optimizer state shards exactly
as its params do (``opt_state_shardings``): the moments are built from
the shards, and the count stays whole.

A sharded leaf is made whole where it is used and only there:
:class:`Gather` all-gathers it along its dim in the forward, and its
backward reduce-scatters the whole gradient back to the shard, summed
over the group (in float32, cast back to the leaf's dtype).  The model
(``models/model.py::forward``) gathers each block group's layer inside
the group's body, so a rematerialised group gathers again in its
recompute and no gathered layer outlives its use.

The MoE's load-balance loss is a product of two means over the
replica's batch (``src/repro/models/moe.py:83-87``, "global means"):
:meth:`GroupShards.column_mean` averages the per-rank means over the
data column (:class:`ColumnMean`), so every rank of the group computes
the reference's aux loss from its own rows.  The reference also groups
the replica's whole batch for the MoE's dispatch
(``src/repro/models/moe.py:60``): where a rank's rows do not fill whole
groups, a group spans data positions, and an expert's queue in it
continues from the positions before: :meth:`GroupShards.counts_before`
gives a rank those positions' counts with one all-gather.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.parallel.partition import leaf_spec, map_with_path

Path = Tuple[str, ...]


def axis_dims(params, mesh, axis: str) -> Dict[Path, Optional[int]]:
    """Each leaf's dim that mesh axis ``axis`` shards (None: whole along
    it), by its path (``map_with_path``'s, sequence indices as
    strings): the leaf's partition-rules spec over ``mesh``,
    sanitized."""
    dims: Dict[Path, Optional[int]] = {}

    def visit(path, leaf):
        spec = leaf_spec(path, leaf, mesh)
        dims[path] = next(
            (d for d, axes in enumerate(spec) if axes == axis or (
                isinstance(axes, tuple) and axis in axes)), None) \
            if mesh[axis] > 1 else None
    map_with_path(visit, params)
    return dims


def leaf_dims(params, g: int, model: int = 1
              ) -> Dict[Path, Optional[int]]:
    """Each leaf's sharded dim in a data column of ``g`` ranks (None:
    whole)."""
    return axis_dims(params, {"data": g, "model": model}, "data")


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
    """The whole tensor of which each rank of the data column holds
    ``shard`` (no autograd): one all-gather, then the slices laid side
    by side along ``dim``."""
    shard = shard.contiguous()
    flat = shard.new_empty((g * shard.numel(),))
    comm.all_gather_(flat, shard.view(-1), g)
    return side_by_side(flat, shard, g, dim)


def side_by_side(flat: torch.Tensor, shard: torch.Tensor, n: int,
                 dim: int) -> torch.Tensor:
    """``flat``, n tensors shaped like ``shard`` one after another, as
    one tensor with the n laid side by side along ``dim``."""
    parts = flat.view((n,) + tuple(shard.shape))
    full = list(shard.shape)
    full[dim] *= n
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


class ColumnMean(torch.autograd.Function):
    """``ColumnMean.apply(x, g, comm)``: the mean of ``x`` over the data
    column of g ranks (float32) forward; backward, the gradient summed
    over the column and divided by g, as each rank's ``x`` reaches every
    rank's output (timed as ``"gradient"``)."""

    @staticmethod
    def forward(ctx, x, g: int, comm):
        ctx.g, ctx.comm = g, comm
        return _column_mean(x, g, comm)

    @staticmethod
    def backward(ctx, grad):
        return _column_mean(grad, ctx.g, ctx.comm), None, None


def _column_mean(x: torch.Tensor, g: int, comm) -> torch.Tensor:
    out = x.to(torch.float32, copy=True).contiguous()
    with comm.timing("gradient"):
        comm.all_reduce_sum_(out.view(-1), g)
    return out / g


class GroupShards:
    """One rank's FSDP layout of a replica group of ``g`` data positions
    (its data column is the ranks ``comm`` gathers over), built from a
    params tree whole along ``data`` (a rank's model slices when
    ``model`` > 1).

    ``dims`` maps each leaf's path to its sharded dim.  :meth:`gather`
    is what the model's forward takes as ``gather``; :meth:`group_mean`
    is the train step's ``reduce_grads``."""

    def __init__(self, params, g: int, rank_in_group: int, comm,
                 model: int = 1):
        self.g = int(g)
        self.rank = int(rank_in_group)
        self.comm = comm
        self.dims = leaf_dims(params, self.g, model)

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

    def column_mean(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, a per-rank mean over its rows, as the mean over the
        data column's rows (autograd runs through :class:`ColumnMean`)."""
        return ColumnMean.apply(x, self.g, self.comm)

    def counts_before(self, counts: torch.Tensor) -> torch.Tensor:
        """The sum of ``counts`` (float32, the same shape on every rank)
        over the data column's positions before this one: one
        all-gather (timed as ``"routing"``), then the exclusive prefix,
        added in position order."""
        counts = counts.to(torch.float32).contiguous()
        flat = counts.new_empty((self.g * counts.numel(),))
        with self.comm.timing("routing"):
            self.comm.all_gather_(flat, counts.view(-1), self.g)
        parts = flat.view((self.g,) + tuple(counts.shape))
        out = torch.zeros_like(counts)
        for d in range(self.rank):
            out = out + parts[d]
        return out

    def group_mean(self, grads):
        """The gradient averaged over the data column: a sharded leaf's
        gradient arrives summed over it (the gather's backward) and is
        divided by g; the whole leaves' gradients are summed in one
        float32 all-reduce over the column and divided by g, as the
        whole-replica layout does with its slab."""
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
