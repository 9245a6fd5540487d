"""Mixture-of-experts FFN, after the reference's ``models/moe.py``
(GShard-style grouped dispatch with one-hot einsums).

Tokens are cut into groups of ``cfg.moe_group_size`` (one group when the
token count is not a multiple, as in decode); each group routes its
tokens top-k into per-expert buffers of ``C`` slots and drops what does
not fit.  With the batch split over a data column the groups are the
column's (ROADMAP C.52): a group may span data positions, and a
position's queue in it continues from the positions before.  Where the
rows are replicated on every data position instead (a batch the data
axis does not divide, regime (b), ROADMAP A16c.5b) the caller passes no
column: the groups, the capacity and the aux loss' means come from the
rows once, as the reference's replicated batch gives them, and every
rank of the replica group routes alike.  Shared experts (DeepSeek,
llama4) run densely on every token.
Returns the Switch load-balance auxiliary loss beside the output.

Top-k: ``jax.lax.top_k`` orders equal probabilities by lower expert
index, and a token's queue position in an expert depends on that order
(the ``cumsum`` below), so the port takes its top k from a stable
descending sort, which keeps that order (ROADMAP C.26).  Plain PyTorch,
as the reference's dispatch is jnp outside any Pallas kernel.

With a tensor-parallel context ``tp`` (``parallel/tensor.py``; the
training forward at ``mesh_model`` M > 1) a rank holds E/M experts
(contiguous, the k-th of M) and its columns of the shared expert, the
``router`` whole.  The tokens are already whole and equal on every rank
of the model group, so no all-to-all is needed: every rank routes alike
(router, softmax, top-k, capacity, the aux loss) and takes its own
experts' columns of the dispatch and combine, so those one-hot einsums
shrink by M.  Its experts' outputs and its part of the shared expert
are summed over the model group in one float32 all-reduce.  The experts' input
and the gate values read through ``tp.copy``: a rank's gradient of the
gate values covers its own experts' slots only, and the sum makes the
router's gradient, and the input's through the router, whole and equal
on every rank.  The aux loss' gradient is equal on every rank already
and is not summed.  Each call folds a digest of its routing into
``tp.routing``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import init_mlp, mlp_forward


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, E = cfg.d_model, cfg.num_experts
    ff = cfg.moe_d_ff or cfg.d_ff
    dev = gen.device

    def normal(shape, scale, dt=dtype):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dt)

    s_in, s_out = d ** -0.5, ff ** -0.5
    p = {
        "router": normal((d, E), s_in, torch.float32),
        "experts": {
            "w_gate": normal((E, d, ff), s_in),
            "w_up": normal((E, d, ff), s_in),
            "w_down": normal((E, ff, d), s_out),
        },
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, d, ff * cfg.num_shared_experts, "swiglu",
                               dtype)
    return p


def _group_size(cfg: ModelConfig, T: int) -> int:
    sg = getattr(cfg, "moe_group_size", 512) or 512
    if T % sg:
        sg = T            # tiny batches (decode): one group
    return min(sg, T)


def _capacity(sg: int, cfg: ModelConfig) -> int:
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = int(sg * k * cfg.moe_capacity_factor / E)
    cap = max(cap, k, 4)
    return ((cap + 3) // 4) * 4


def top_k(x: torch.Tensor, k: int):
    """The k largest along the last axis, largest first, ties by lower
    index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _place(t: torch.Tensor, lead: int, G: int, sg: int) -> torch.Tensor:
    """``t`` (1, T, ...), a rank's tokens, laid into G groups of sg from
    ``lead`` on, zeros around them: (G, sg, ...)."""
    t = t.reshape((-1,) + tuple(t.shape[2:]))
    out = t.new_zeros((G * sg,) + tuple(t.shape[1:]))
    out[lead:lead + t.shape[0]] = t
    return out.view((G, sg) + tuple(t.shape[1:]))


def moe_forward(params, x, cfg: ModelConfig, tp=None, column=None):
    """x (B, S, D) -> (y, aux).  ``tp``: a rank's experts (see above).
    ``column`` (a ``GroupShards``; x is a rank's rows of its data
    column's batch): the groups and the capacity come from the column's
    tokens, as the reference groups a replica's whole batch, and the
    aux loss' means are taken over the column's batch.  A rank's tokens
    take their places in the column's groups (batch-major, the
    positions' rows one after another in rank order); where they do not
    fill whole groups, each expert's queue in a group continues from
    the counts of the positions before (``column.counts_before``, one
    all-gather), so keep and gate values are the reference's token for
    token.  Rows that fill whole groups route as without ``column``."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    sg = _group_size(cfg, T * (1 if column is None else column.g))
    # a rank whose tokens do not fill whole groups routes them as they
    # are, then lays them into the G groups of the column's that hold
    # them, from ``lead`` tokens into group ``g0``
    spans = T % sg != 0
    start = 0 if column is None else column.rank * T
    g0, lead = divmod(start, sg)
    G = (start + T - 1) // sg - g0 + 1 if spans else T // sg
    xg = x.reshape(1, T, D) if spans else x.reshape(G, sg, D)

    logits = torch.einsum("gsd,de->gse", xg.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)                       # (G,sg,E)
    gate_vals, gate_idx = top_k(probs, k)                       # (G,sg,k)
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)

    # load-balance aux (Switch): E * sum_e f_e * p_e
    me = torch.mean(probs, dim=(0, 1))
    onehot = F.one_hot(gate_idx, E).float()                     # (G,sg,k,E)
    ce = torch.mean(torch.sum(onehot, dim=2), dim=(0, 1))
    if column is not None:
        me, ce = column.column_mean(torch.cat([me, ce])).split(E)
    aux = E * torch.sum(me * ce)

    if spans:
        if tp is not None:
            # the gate values' gradient, summed over the model group for
            # this rank's tokens only
            gate_vals = tp.copy(gate_vals)
        gate_vals, gate_idx, onehot = (_place(t, lead, G, sg)
                                       for t in (gate_vals, gate_idx, onehot))
    # capacity-limited positions within each group's expert queue
    C = _capacity(sg, cfg)
    flat = onehot.reshape(G, sg * k, E)
    pos = torch.cumsum(flat, dim=1) - flat
    if spans:
        # the queue of each (group, expert) before this rank's tokens
        counts = flat.new_zeros((T * column.g // sg, E))
        counts[g0:g0 + G] = torch.sum(flat, dim=1)
        pos = pos + column.counts_before(counts)[g0:g0 + G, None, :]
    pos_in_e = torch.sum(pos * flat, dim=-1).reshape(G, sg, k)
    keep = pos_in_e < C
    if spans:
        held = torch.zeros(G * sg, dtype=torch.bool, device=x.device)
        held[lead:lead + T] = True
        keep = keep & held.view(G, sg, 1)
    gate_vals = gate_vals * keep.float()
    if tp is not None:
        tp.route(gate_idx, keep)
        # a rank's experts: their columns of the one-hots, their input
        # and gate values through the model group's backward sum
        if not spans:
            gate_vals = tp.copy(gate_vals)
        onehot = onehot[..., tp.e0:tp.e0 + tp.experts]
        x = tp.copy(x)
    xg = _place(x.reshape(1, T, D), lead, G, sg) if spans \
        else x.reshape(G, sg, D)
    slot = torch.where(keep, pos_in_e, torch.full_like(pos_in_e, C))
    pos_oh = F.one_hot(slot.long(), C + 1).float()[..., :C]    # (G,sg,k,C)
    dispatch = torch.einsum("gske,gskc->gsec", onehot * keep[..., None],
                            pos_oh)
    combine = torch.einsum("gske,gskc,gsk->gsec", onehot, pos_oh, gate_vals)

    xe = torch.einsum("gsec,gsd->gecd", dispatch, xg.float()).to(x.dtype)
    ep = params["experts"]
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, ep["w_gate"])) \
        * torch.einsum("gecd,edf->gecf", xe, ep["w_up"])
    ye = torch.einsum("gecf,efd->gecd", h, ep["w_down"])
    y = torch.einsum("gsec,gecd->gsd", combine, ye.float())
    if spans:
        y = y.reshape(G * sg, D)[lead:lead + T]
    y = y.reshape(B, S, D)
    if tp is None:
        y = y.to(x.dtype)
        if "shared" in params:
            y = y + mlp_forward(params["shared"], x, "swiglu")
        return y, aux
    # a rank's experts and its columns of the shared expert, partial
    # sums, summed over the model group in one float32 all-reduce (the
    # reference's combine over experts sharded on ``model`` sums in
    # float32) and rounded once
    if "shared" in params:
        y = y + mlp_forward(params["shared"], x, "swiglu").float()
    return tp.reduce(y).to(x.dtype), aux
