"""Mamba-1 selective SSM block, after the reference's ``models/mamba.py``.

The reference scans each chunk of ``cfg.ssm_chunk`` positions with
``associative_scan`` and carries the state across chunks.  The port
builds the scan inputs one chunk at a time as well (so only one chunk's
``(B, chunk, d_inner, d_state)`` tensors exist at once) and runs the
recurrence ``h_t = a_t h_{t-1} + bx_t`` position by position in float32.
The two add in a different order; ROADMAP C.24 states the gap.  When
the config rematerialises, each chunk is checkpointed with its carry in
and out (``src/repro/models/mamba.py:92``).  Plain PyTorch, as the
reference's scan is jnp outside any Pallas kernel.

Under the ``model`` axis (``tp``, ``parallel/tensor.py``) a rank holds
di/M of the inner channels: its columns of ``w_in``'s two halves side
by side, and its channels of ``conv_w``, ``conv_b``, ``w_dt``,
``dt_bias``, ``A_log`` and ``D``, so the conv and the scan are local.
``w_x`` (di, dt_rank + 2 d_state) is row-parallel: each rank's ``proj``
is a partial sum over its channels, summed over the model group inside
each chunk (in float32, rounded once to the activations' dtype, the
dtype the reference's einsum gives) before the rank reads it for its
own channels (``tp.sum``: its gradient is summed too).  Under remat the
chunk's all-reduce runs again in its recompute, in the same order on
every rank.  ``w_out`` is row-parallel (``tp.reduce``).  The decode
takes ``tp`` the same way: a rank holds its channels of the ``conv``
and ``h`` caches.  A batch the data axis does not divide (regime (b),
``sp``, ``parallel/tensor.py::Spread``) replicates the rows on every
rank of the replica group, and a rank holds di/(D M) channels of the
caches, the d-th part of its model slice's.
"""
from __future__ import annotations


import torch
import torch.nn.functional as F

from repro_torch.models import activations as act
from repro_torch.models import remat
from repro_torch.models.config import ModelConfig


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, di = cfg.d_model, cfg.mamba_d_inner
    ds, dc, dtr = cfg.mamba_d_state, cfg.mamba_d_conv, cfg.resolved_dt_rank
    dev = gen.device

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    s = d ** -0.5
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float64,
                                   device=dev)).float()
    return {
        "w_in": normal((d, 2 * di), s),
        "conv_w": normal((dc, di), dc ** -0.5),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "w_x": normal((di, dtr + 2 * ds), di ** -0.5),
        "w_dt": normal((dtr, di), dtr ** -0.5),
        "dt_bias": torch.full((di,), -4.6, dtype=torch.float32,
                              device=dev),       # softplus^-1(0.01)
        "A_log": a_log.expand(di, ds).clone(),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "w_out": normal((di, d), di ** -0.5),
    }


def causal_conv(x, w, b, d_conv: int, init_state=None):
    """Depthwise causal conv.  x (B, S, di) -> (y, last d_conv - 1
    inputs)."""
    if init_state is None:
        init_state = x.new_zeros((x.shape[0], d_conv - 1, x.shape[2]))
    xp = torch.cat([init_state, x], dim=1)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0]
    for i in range(1, d_conv):
        y = y + xp[:, i:i + S] * w[i]
    return y + b, xp[:, xp.shape[1] - (d_conv - 1):]


def _ssm_inputs(params, xc, cfg: ModelConfig, tp=None, sp=None):
    """xc (B,S,di) after the conv -> a, bx (B,S,di,ds) and C (B,S,ds),
    float32.  Under ``tp`` xc holds a rank's di/M channels and ``proj``
    is summed over the model group; under ``sp`` (regime (b)) its
    di/(D M) channels, summed over the replica group."""
    ds, dtr = cfg.mamba_d_state, cfg.resolved_dt_rank
    proj = xc @ params["w_x"]
    if sp is not None:
        proj = sp.sum(proj).to(xc.dtype)
    elif tp is not None:
        proj = tp.sum(proj.float()).to(xc.dtype)
    proj = proj.float()
    dt, Bm, Cm = torch.split(proj, [dtr, ds, ds], dim=-1)
    dt = act.softplus(dt @ params["w_dt"].float() + params["dt_bias"])
    A = -act.exp(params["A_log"])                                 # (di,ds)
    a = act.exp(dt[..., None] * A)
    bx = (dt * xc.float())[..., None] * Bm[:, :, None, :]
    return a, bx, Cm


def mamba_forward(params, x, cfg: ModelConfig, tp=None):
    """x (B, S, D) -> (B, S, D); ``tp``: a rank's inner channels."""
    B, S, D = x.shape
    chunk = min(cfg.ssm_chunk, S)
    if tp is not None:
        x = tp.copy(x)
    xi, z = torch.chunk(x @ params["w_in"], 2, dim=-1)
    di = xi.shape[-1]
    xc, _ = causal_conv(xi, params["conv_w"], params["conv_b"],
                        cfg.mamba_d_conv)
    xc = F.silu(xc)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the scan "
                         f"chunk {chunk}")

    def body(h, xci):
        a, bx, Cm = _ssm_inputs(params, xci, cfg, tp)
        ys = []
        for t in range(a.shape[1]):
            h = a[:, t] * h + bx[:, t]
            ys.append(torch.einsum("bds,bs->bd", h, Cm[:, t]))
        return h, torch.stack(ys, dim=1)

    h = x.new_zeros((B, di, cfg.mamba_d_state), dtype=torch.float32)
    ys = []
    for c0 in range(0, S, chunk):
        h, y = remat.run(remat.on(cfg), body, h, xc[:, c0:c0 + chunk])
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y + params["D"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    y = y @ params["w_out"]
    return y if tp is None else tp.reduce(y)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> dict:
    di = cfg.mamba_d_inner
    return {
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, di, cfg.mamba_d_state),
                         dtype=torch.float32, device=device),
    }


# the leaves over a rank's inner channels the decode reads for its
# part of them under ``sp``, by the dim of their channels
_CHANNEL_DIMS = {"conv_w": 1, "conv_b": 0, "w_x": 0, "w_dt": 1,
                 "dt_bias": 0, "A_log": 0, "D": 0}


def mamba_decode(params, x, cache, cfg: ModelConfig, tp=None, sp=None):
    """One-token recurrence.  x (B, 1, D).  The cache is updated in
    place and returned.  ``tp``: a rank's inner channels; ``sp`` (regime
    (b)): the rows replicated, a rank advancing the d-th D-th of its
    model slice's channels (its ``conv`` and ``h``), ``proj`` summed
    over the replica group, ``y``'s channels gathered over the data
    column before the row-parallel ``w_out``."""
    xi, z = torch.chunk(x @ params["w_in"], 2, dim=-1)
    p = params
    if sp is not None:
        xi, z = sp.mine(xi, -1), sp.mine(z, -1)
        p = {**params, **{k: sp.mine(params[k], d)
                          for k, d in _CHANNEL_DIMS.items()}}
    xc, conv = causal_conv(xi, p["conv_w"], p["conv_b"],
                           cfg.mamba_d_conv, cache["conv"])
    xc = F.silu(xc)
    a, bx, Cm = _ssm_inputs(p, xc, cfg, tp, sp)
    h = a[:, 0] * cache["h"] + bx[:, 0]
    y = torch.einsum("bds,bs->bd", h, Cm[:, 0])[:, None]
    y = y + p["D"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    cache["conv"].copy_(conv)
    cache["h"].copy_(h)
    if sp is not None:
        y = sp.column(y, -1)
    y = y @ params["w_out"]
    return (y, cache) if tp is None else (tp.reduce(y), cache)
