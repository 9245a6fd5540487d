"""Group-size-annealed data parallelism: the Smooth Switch on ranks.

The paper's threshold K(t) ("how many gradients aggregate per update")
maps onto data parallelism as the *reduction-group size* g:

  * the data axis (the data positions of a ``torch.distributed`` job,
    ``mesh_model`` ranks each) is split into R = axis/g replica groups
    of g consecutive positions; group r holds ranks ``[r*g*M,
    (r+1)*g*M)`` (:func:`repro_torch.launch.mesh.replica_groups`, the
    order of the reference's mesh reshape) and trains a replica of its
    own;
  * a step averages the gradient only *inside* each group (the analogue
    of "K gradients aggregated per update");
  * groups evolve independently ("async": divergence is staleness) until
    a **merge**, where replicas are averaged: the analogue of the
    paper's buffer flush, and the same flush kernel;
  * the threshold schedule anneals g: 1 -> axis (R: axis -> 1), ending
    in fully synchronous data parallelism.

This module holds the single-process pieces, held against
``src/repro/core/spmd_hybrid.py``: trees with a leading replica axis of
size R, their merge, reshard and divergence, the replica step
and the phase plan.  :mod:`repro_torch.launch.train` runs them across
ranks.  The reference's ``factored_mesh`` is the rank-group layout of
:mod:`repro_torch.launch.mesh`; within a group the replica is sharded
FSDP-style and over ``model`` by :func:`replica_param_shardings`
(``parallel/fsdp.py`` and ``parallel/tensor.py`` place the tensors).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.convert import tree_leaves, tree_map
from repro_torch.core import gradient
from repro_torch.core.schedule import ThresholdSchedule, group_size_phases
from repro_torch.core.slab import slab_codec
from repro_torch.kernels.hybrid_aggregate import flush
from repro_torch.parallel.partition import param_shardings


def replica(params_R, r: int):
    """Replica ``r`` of a tree with a leading replica axis (views)."""
    return tree_map(lambda p: p[r], params_R)


def stack_replicas(trees):
    """Trees of one replica each -> one tree with a leading replica axis."""
    return tree_map(lambda *ps: torch.stack(ps), *trees)


def replicate_params(params, R: int):
    """Add the leading replica axis (same initial values in every group)."""
    return tree_map(lambda p: p.unsqueeze(0).repeat(
        (R,) + (1,) * p.dim()), params)


def merge_replicas(params_R, alpha: float = 1.0):
    """Flush: average the replicas.

    alpha < 1 gives a partial (Lookahead-style) merge:
    θ_r <- α·mean + (1-α)·θ_r.  This is the per-leaf reference; phase
    switches use :func:`merge_rows`, which takes the same reduction
    through the flush kernel."""
    def m(p):
        mean = torch.mean(p, dim=0, keepdim=True)
        return alpha * mean.expand(p.shape) + (1 - alpha) * p
    return tree_map(m, params_R)


# the longest segment an elementwise step takes at once: its temporaries
# stay near a GB however large a model's leaves are
SEGMENT_PIECE = 1 << 26


def slab_segments(codec, lo: int = 0, hi: Optional[int] = None,
                  join: bool = True) -> List[Tuple[int, int, torch.dtype]]:
    """The live parts of ``codec``'s slab within ``[lo, hi)`` as
    ``(a, b, dtype)`` relative to ``lo``, in the codec's leaf order (the
    padding left out).  ``join`` joins neighbouring leaves of one dtype
    and cuts the result into pieces of at most ``SEGMENT_PIECE``
    elements (for steps that are elementwise); without it there is one
    entry per leaf that meets the range."""
    hi = codec.padded_size if hi is None else hi
    out: List[Tuple[int, int, torch.dtype]] = []
    for off, n, dt in zip(codec.offsets, codec.sizes, codec.dtypes):
        a, b = max(off, lo) - lo, min(off + n, hi) - lo
        if a >= b:
            continue
        if join and out and out[-1][1] == a and out[-1][2] == dt:
            out[-1] = (out[-1][0], b, dt)
        else:
            out.append((a, b, dt))
    if not join:
        return out
    return [(p, min(b, p + SEGMENT_PIECE), dt) for a, b, dt in out
            for p in range(a, b, SEGMENT_PIECE)]


def merge_rows(rows: torch.Tensor, segments, alpha: float = 1.0
               ) -> torch.Tensor:
    """The merge on ``(R, c)`` float32 rows, R replicas' slabs or the
    same P-range of each (``segments`` from :func:`slab_segments` over
    that range): the R rows summed by the parameter server's flush
    kernel (:func:`repro_torch.kernels.hybrid_aggregate.flush` with
    weights ``ones(R)``: one launch at K = R on the card), divided by R,
    and per segment cast to the leaf's dtype and alpha-blended with each
    replica, as :func:`merge_replicas` does a leaf.  Returns ``(R, c)``
    float32 rows (the padding zero).  Elementwise along P, so merging a
    slab's P-chunks one by one is merging it whole, bit for bit."""
    R, c = rows.shape
    out = torch.zeros_like(rows)
    if c == 0:
        return out
    mean = flush(rows, torch.ones((R,), dtype=torch.float32,
                                  device=rows.device))
    mean /= R
    for a, b, dt in segments:
        reps = rows[:, a:b].to(dt)
        out[:, a:b] = (alpha * mean[a:b].to(dt).unsqueeze(0).expand(
            reps.shape) + (1 - alpha) * reps).float()
    return out


def merge_replicas_slab(params_R, alpha: float = 1.0):
    """The hybrid flush on the slab path: the R replicas are encoded into
    an ``(R, P)`` float32 slab, merged by :func:`merge_rows` (the flush
    kernel at K = R) and decoded; the same values as
    :func:`merge_replicas`.  The train driver runs :func:`merge_rows`
    on each rank's P-chunk of the slab."""
    codec = slab_codec(replica(params_R, 0))
    R = tree_leaves(params_R)[0].shape[0]
    rows = torch.stack([codec.encode_master(replica(params_R, r))
                        for r in range(R)])
    merged = merge_rows(rows, slab_segments(codec), alpha)
    return stack_replicas([codec.decode(merged[r]) for r in range(R)])


def reshard_replicas(params_R, R_new: int):
    """Change the replica count at a phase switch: merge down (average
    consecutive groups) or split up (copies)."""
    R_old = tree_leaves(params_R)[0].shape[0]
    if R_new == R_old:
        return params_R
    if R_new < R_old:
        assert R_old % R_new == 0, (R_old, R_new)
        f = R_old // R_new
        return tree_map(lambda p: torch.mean(
            p.reshape((R_new, f) + tuple(p.shape[1:])), dim=1), params_R)
    assert R_new % R_old == 0, (R_old, R_new)
    f = R_new // R_old
    return tree_map(lambda p: torch.repeat_interleave(p, f, dim=0),
                    params_R)


def replica_divergence(params_R) -> torch.Tensor:
    """Root of the summed squared distance of the replicas from their
    mean: the SPMD analogue of the paper's staleness (how far apart the
    groups have drifted)."""
    def d(p):
        mean = torch.mean(p, dim=0, keepdim=True)
        return torch.sum(torch.square(p - mean))
    return torch.sqrt(sum(d(p) for p in tree_leaves(params_R)))


def make_replica_step(loss_fn: Callable, opt_update: Callable):
    """Build ``step(params_R, opt_R, batch_R) -> (params, opt, metrics)``.

    ``loss_fn(params, batch) -> (loss, metrics)``; ``opt_update(grads,
    opt, params) -> (updates, new_opt)``.  Every replica steps on its own
    slice of the leading axis, one after another, and the results are
    stacked, so no gradient crosses replicas.  The gradient is taken with
    ``core/gradient.py``, which a rematerialising loss needs (the
    reference's ``vmap`` has no counterpart that takes a checkpoint).
    The metrics are the reference's: ``loss`` (mean over replicas),
    ``loss_per_replica``, ``replicas`` (the replica axis the step ran,
    one gradient each) and ``divergence``, plus the mean of each of
    ``loss_fn``'s metrics."""
    grad_fn = gradient.grad_and_value(loss_fn, has_aux=True)

    def one(params, opt_state, batch):
        grads, (loss, metrics) = grad_fn(params, batch)
        updates, new_opt = opt_update(grads, opt_state, params)
        new_params = tree_map(lambda p, u: p + u, params, updates)
        return new_params, new_opt, loss, metrics

    def step(params_R, opt_R, batch_R):
        R = tree_leaves(params_R)[0].shape[0]
        outs = [one(*tree_map(lambda t: t[r], (params_R, opt_R, batch_R)))
                for r in range(R)]
        new_p, new_o, loss, metrics = tree_map(lambda *xs: torch.stack(xs),
                                               *outs)
        return new_p, new_o, {
            "loss": torch.mean(loss), "loss_per_replica": loss,
            "replicas": torch.tensor(loss.shape[0], dtype=torch.int32),
            "divergence": replica_divergence(new_p),
            **{k: torch.mean(v) for k, v in metrics.items()}}

    return step


@dataclasses.dataclass
class HybridPhase:
    t_start: int
    group_size: int
    num_replicas: int


def build_phases(schedule: ThresholdSchedule, horizon: int,
                 data_axis: int, g_min: int = 1) -> List[HybridPhase]:
    """Threshold schedule -> [(t_start, g, R)] with g clamped to >= g_min."""
    phases: List[HybridPhase] = []
    for t_start, g in group_size_phases(schedule, horizon, data_axis):
        g = max(g, g_min)
        R = data_axis // g
        if phases and phases[-1].group_size == g:
            continue
        phases.append(HybridPhase(t_start, g, R))
    if not phases or phases[0].t_start > 0:
        phases.insert(0, HybridPhase(0, max(g_min, 1),
                                     data_axis // max(g_min, 1)))
    return phases


def min_group_size(param_bytes: int, opt_bytes: int, model_axis: int,
                   hbm_per_chip: Optional[int] = None,
                   act_budget_frac: float = 0.5,
                   device: Optional[torch.device] = None) -> int:
    """Smallest replica-group size whose per-card state fits in device
    memory, the replica sharded over its group
    (:func:`replica_param_shardings`).  ``hbm_per_chip`` is read from
    ``device``'s properties when not given; on the CPU the caller passes
    it."""
    if hbm_per_chip is None:
        dev = torch.device(device) if device is not None else None
        if dev is None or dev.type != "cuda":
            raise ValueError("min_group_size needs hbm_per_chip, or a "
                             "CUDA device to read it from")
        hbm_per_chip = torch.cuda.get_device_properties(dev).total_memory
    budget = hbm_per_chip * (1 - act_budget_frac)
    g = 1
    while (param_bytes + opt_bytes) / (g * model_axis) > budget:
        g *= 2
    return g


def replica_param_shardings(params, g: int, model: int = 1):
    """What each rank of a replica group of ``g`` data positions of
    ``model`` ranks holds of each leaf: its shard shape under the
    logical partition rules, FSDP over ``data`` and the tensor axes over
    ``model`` (``parallel/tensor.py``), sanitized for divisibility.  The
    reference returns the ``NamedSharding``s
    (``src/repro/core/spmd_hybrid.py:185-207``) with a leading ``rep``
    axis; a rank here holds one replica, so the shapes have none."""
    return param_shardings(params, {"data": g, "model": model})
