"""xLSTM blocks, after the reference's ``models/xlstm.py``: mLSTM (matrix
memory) and sLSTM (scalar memory).

mLSTM runs the stabilized chunkwise form: a loop over chunks of
``MLSTM_CHUNK`` carries ``(C, n, m)`` in float32, and within a chunk the
update is dense products; when the config rematerialises, each chunk
is checkpointed with its carry in and out
(``src/repro/models/xlstm.py:131``).  sLSTM has recurrent gate
connections and is a loop over time with per-head recurrent weights.
Plain PyTorch, as the reference's are jnp outside any Pallas kernel;
``exp``, ``tanh`` and ``log_sigmoid`` come from
:mod:`repro_torch.models.activations`.

Under the ``model`` axis (``tp``, ``parallel/tensor.py``):

* mLSTM: a rank holds di/M channels of ``w_up``, ``w_z``, ``conv_w``
  and ``conv_b``, H/M heads of ``gn_scale`` and di/M rows of
  ``w_down``; ``lq``, ``lk``, ``lv``, ``w_if`` and ``b_if`` are whole.
  Its q, k, v and gates contract all di, so ``xc`` and ``u`` are
  gathered whole (``tp.gather_for_heads``: the backward reduce-scatters,
  as each rank reads them for its own heads), each rank computes its
  H/M heads (the whole leaves narrowed to them: their gradients are
  partial, summed over the model group once a step), its heads' channels
  are its di/M channels of ``z``, and ``w_down``'s output is summed
  (``tp.reduce``).
* sLSTM: ``w_x`` and ``b`` are split on their d output channels and
  ``r_h`` over heads.  The reference lays the recurrent term of head h
  (B, H, 4, dh) out as (B, 4, H dh) as it lies, so gate channel e reads
  heads of every rank's slice: the recurrence cannot be cut by channel
  without a collective in every step.  So the gate pre-activations and
  ``r_h`` are gathered whole (``tp.gather``: every rank then runs the
  whole recurrence, the norm over all d and the FFN alike, so the
  backward keeps the rank's slice), and the FFN, whose width M divides
  in no registry config (1365 for xlstm-350m), stays whole; where M
  divides it, it is column- and row-parallel as the MLP.

The decodes take ``tp`` the same way (the sliced serving forward,
ROADMAP A16c.5).  The mLSTM's cache holds a rank's heads of ``C``,
``n`` and ``m`` and its channels of ``conv``.  The sLSTM's holds a
rank's d/M channels of ``c``, ``n``, ``m`` and ``h``, the partition
rule's split (ROADMAP C.53): each step gathers them with the gate
pre-activations in one all-gather, runs the recurrence whole, and keeps
its channels.  A batch the data axis does not divide (regime (b),
``sp``, ``parallel/tensor.py::Spread``) replicates the rows over the
replica group of D x M ranks: the mLSTM's rank computes every head's
q, k, v and gates from ``xc`` and ``u`` gathered over the group (its
conv runs on the d-th part of its model slice's channels), holds its
chunk of ``C``'s and ``n``'s first dh and of ``m``'s heads, and sums its
partial numerator and normalizer over the group; the sLSTM's holds
d/(D M) of the states, gathered with its part of the gate
pre-activations each step.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models import activations as act
from repro_torch.models import remat
from repro_torch.models.config import ModelConfig

MLSTM_CHUNK = 64


def _normal(gen, shape, scale, dtype):
    return (torch.randn(shape, generator=gen, device=gen.device) * scale
            ).to(dtype)


# ================================================================= mLSTM

def _mlstm_dims(cfg: ModelConfig):
    di = int(cfg.xlstm_proj_factor * cfg.d_model)
    return di, cfg.num_heads, di // cfg.num_heads


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d = cfg.d_model
    di, H, dh = _mlstm_dims(cfg)
    dev = gen.device
    s, si = d ** -0.5, di ** -0.5
    f32 = torch.float32
    return {
        "w_up": _normal(gen, (d, di), s, dtype),
        "w_z": _normal(gen, (d, di), s, dtype),
        "conv_w": _normal(gen, (cfg.xlstm_conv, di),
                          cfg.xlstm_conv ** -0.5, dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "lq": _normal(gen, (di, H, dh), si, dtype),
        "lk": _normal(gen, (di, H, dh), si, dtype),
        "lv": _normal(gen, (di, H, dh), si, dtype),
        # scalar input/forget gates per head
        "w_if": _normal(gen, (di, H, 2), si, f32),
        "b_if": torch.stack([torch.zeros(H, device=dev),
                             torch.full((H,), 3.0, device=dev)], dim=-1),
        "gn_scale": torch.ones((H, dh), dtype=f32, device=dev),
        "w_down": _normal(gen, (di, d), si, dtype),
    }


def _mlstm_qkv_gates(params, x, cfg: ModelConfig, conv_state=None,
                     tp=None):
    """q, k, v, the log gates, z and the conv's last inputs; under ``tp``
    a rank's heads of q, k, v and the gates and its channels of z."""
    if tp is not None:
        x = tp.copy(x)
    u = x @ params["w_up"]
    z = x @ params["w_z"]
    xc, new_conv = _conv_silu(u, params["conv_w"], params["conv_b"],
                              cfg.xlstm_conv, conv_state)
    lq, lk, lv = params["lq"], params["lk"], params["lv"]
    w_if, b_if = params["w_if"], params["b_if"]
    if tp is not None:
        xc, u = tp.gather_for_heads(xc), tp.gather_for_heads(u)
        lq, lk, lv, w_if = (tp.my_heads(t, 1) for t in (lq, lk, lv, w_if))
        b_if = tp.my_heads(b_if, 0)
    return _project(xc, u, lq, lk, lv, w_if, b_if) + (z, new_conv)


def _conv_silu(u, conv_w, conv_b, dc: int, conv_state=None):
    """The depthwise causal conv of ``u`` (B, S, c) after
    ``conv_state``'s last dc - 1 inputs, through silu, and the conv's
    last dc - 1 inputs."""
    if conv_state is None:
        conv_state = u.new_zeros((u.shape[0], dc - 1, u.shape[-1]))
    up = torch.cat([conv_state, u], dim=1)
    S = u.shape[1]
    xc = up[:, 0:S] * conv_w[0]
    for i in range(1, dc):
        xc = xc + up[:, i:i + S] * conv_w[i]
    return F.silu(xc + conv_b), up[:, up.shape[1] - (dc - 1):]


def _project(xc, u, lq, lk, lv, w_if, b_if):
    """q, k, v and the log gates of the heads of ``lq``/``lk``/``lv``/
    ``w_if``/``b_if`` from ``xc`` and ``u`` over all di."""
    q = torch.einsum("bse,ehk->bshk", xc, lq)
    k = torch.einsum("bse,ehk->bshk", xc, lk)
    v = torch.einsum("bse,ehk->bshk", u, lv)
    gates = torch.einsum("bse,ehg->bshg", xc.float(), w_if) + b_if
    li = gates[..., 0]                          # log input gate (B,S,H)
    lf = act.log_sigmoid(gates[..., 1])         # log forget gate
    return q, k, v, li, lf


def _spread_gates(params, x, cfg: ModelConfig, cache, sp):
    """Regime (b)'s q, k, v and log gates of every head, z over the
    rank's model slice, the conv's last inputs over the d-th part of it,
    and every head's stabilizer ``m``: the conv runs on the rank's part
    of the channels, and its ``xc`` and ``u`` and the cache's chunk of
    ``m`` are gathered over the replica group in one all-gather."""
    u, z = x @ params["w_up"], x @ params["w_z"]
    u = sp.mine(u, -1)
    xc, conv = _conv_silu(u, sp.mine(params["conv_w"], 1),
                          sp.mine(params["conv_b"], 0), cfg.xlstm_conv,
                          cache["conv"])
    xc, u, m = sp.gather((xc, -1, True), (u, -1, True),
                         (cache["m"], -1, False))
    return _project(xc, u, params["lq"], params["lk"], params["lv"],
                    params["w_if"], params["b_if"]) + (z, conv, m)


def _headnorm(h, scale, eps: float = 1e-5):
    """Per-head RMS norm over dh.  h (..., H, dh) float32."""
    var = torch.mean(torch.square(h), dim=-1, keepdim=True)
    return h * torch.rsqrt(var + eps) * scale


def _mlstm_chunk(carry, q, k, v, li, lf, dh: int):
    """One chunk.  carry: C (B,H,dh,dh), n (B,H,dh), m (B,H) float32;
    q, k, v (B,c,H,dh), li, lf (B,c,H)."""
    C0, n0, m0 = carry
    q = q.float() * dh ** -0.5
    k = k.float()
    v = v.float()
    b = torch.cumsum(lf, dim=1)                                   # (B,c,H)
    # intra-chunk log weights: D[t,s] = b_t - b_s + li_s  (s <= t)
    ld = b[:, :, None, :] - b[:, None, :, :] + li[:, None, :, :]  # (B,t,s,H)
    c = q.shape[1]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    ld = torch.where(tri[None, :, :, None], ld, -torch.inf)
    m_intra = torch.amax(ld, dim=2)                               # (B,t,H)
    m_inter = b + m0[:, None, :]
    m_t = torch.clamp(torch.maximum(m_inter, m_intra), min=-30.0)

    Dw = act.exp(ld - m_t[:, :, None, :])                         # (B,t,s,H)
    qk = torch.einsum("bthd,bshd->btsh", q, k)
    w = Dw * qk
    h_intra = torch.einsum("btsh,bshd->bthd", w, v)
    inter_scale = act.exp(m_inter - m_t)                          # (B,t,H)
    h_inter = torch.einsum("bthd,bhde->bthe", q, C0) \
        * inter_scale[..., None]
    n_inter = torch.einsum("bthd,bhd->bth", q, n0) * inter_scale
    n_intra = torch.sum(w, dim=2)
    h = h_intra + h_inter
    n = n_intra + n_inter
    denom = torch.maximum(torch.abs(n), act.exp(-m_t))[..., None]
    out = h / denom                                               # (B,c,H,dh)

    # end-of-chunk state
    bc = b[:, -1, :]                                              # (B,H)
    m_state = torch.maximum(bc + m0,
                            torch.amax(bc[:, None] - b + li, dim=1))
    m_state = torch.clamp(m_state, min=-30.0)
    sw = act.exp(bc[:, None] - b + li - m_state[:, None])         # (B,c,H)
    decay = act.exp(bc + m0 - m_state)
    C_new = decay[:, :, None, None] * C0 \
        + torch.einsum("bch,bchd,bche->bhde", sw, k, v)
    n_new = decay[:, :, None] * n0 + torch.einsum("bch,bchd->bhd", sw, k)
    return (C_new, n_new, m_state), out


def mlstm_forward(params, x, cfg: ModelConfig, tp=None):
    """x (B, S, D) -> (B, S, D); ``tp``: a rank's heads."""
    B, S, D = x.shape
    di, H, dh = _mlstm_dims(cfg)
    if tp is not None:
        di, H = di // tp.M, tp.heads
    q, k, v, li, lf, z, _ = _mlstm_qkv_gates(params, x, cfg, tp=tp)
    c = min(MLSTM_CHUNK, S)
    if S % c:
        raise ValueError(f"sequence {S} is not a multiple of the mLSTM "
                         f"chunk {c}")
    carry = (x.new_zeros((B, H, dh, dh), dtype=torch.float32),
             x.new_zeros((B, H, dh), dtype=torch.float32),
             x.new_zeros((B, H), dtype=torch.float32))
    chunk = functools.partial(_mlstm_chunk, dh=dh)
    outs = []
    for c0 in range(0, S, c):
        sl = slice(c0, c0 + c)
        carry, out = remat.run(remat.on(cfg), chunk, carry, q[:, sl],
                               k[:, sl], v[:, sl], li[:, sl], lf[:, sl])
        outs.append(out)
    h = torch.cat(outs, dim=1)
    h = _headnorm(h, params["gn_scale"]).reshape(B, S, di).to(x.dtype)
    y = (h * F.silu(z)) @ params["w_down"]
    return y if tp is None else tp.reduce(y)


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> dict:
    di, H, dh = _mlstm_dims(cfg)
    f32 = torch.float32
    return {
        "conv": torch.zeros((batch, cfg.xlstm_conv - 1, di), dtype=dtype,
                            device=device),
        "C": torch.zeros((batch, H, dh, dh), dtype=f32, device=device),
        "n": torch.zeros((batch, H, dh), dtype=f32, device=device),
        "m": torch.full((batch, H), -30.0, dtype=f32, device=device),
    }


def mlstm_decode(params, x, cache, cfg: ModelConfig, tp=None, sp=None):
    """x (B, 1, D) -> (y, cache): one recurrent step; the cache is
    updated in place and returned.  ``tp``: a rank's heads; ``sp``
    (regime (b)): the rows replicated, a rank computing every head and
    holding its chunk of ``C``'s and ``n``'s first dh and of ``m``'s
    heads (the rule's cut), the numerator and normalizer summed over the
    replica group, then its own heads."""
    di, H, dh = _mlstm_dims(cfg)
    if tp is not None:
        di = di // tp.M
    if sp is None:
        q, k, v, li, lf, z, conv = _mlstm_qkv_gates(params, x, cfg,
                                                    cache["conv"], tp)
        m = cache["m"]
    else:
        q, k, v, li, lf, z, conv, m = _spread_gates(params, x, cfg, cache,
                                                    sp)
    q = q[:, 0].float() * dh ** -0.5
    k = k[:, 0].float()
    v = v[:, 0].float()
    if sp is not None:
        q, k = sp.chunk(q, -1), sp.chunk(k, -1)
    li, lf = li[:, 0], lf[:, 0]                                    # (B,H)
    m_new = torch.clamp(torch.maximum(lf + m, li), min=-30.0)
    fdec = act.exp(lf + m - m_new)[:, :, None]
    iexp = act.exp(li - m_new)[:, :, None]
    # C[d, e] = k_d v_e, the layout of the chunkwise state update
    C = fdec[..., None] * cache["C"] + iexp[..., None] * k[:, :, :, None] \
        * v[:, :, None, :]
    nst = fdec * cache["n"] + iexp * k
    num = torch.einsum("bhde,bhd->bhe", C, q)
    nq = torch.einsum("bhd,bhd->bh", nst, q)
    if sp is not None:
        both = sp.sum(torch.cat([num, nq[..., None]], -1))
        num, nq = both[..., :-1], both[..., -1]
    den = torch.maximum(torch.abs(nq), act.exp(-m_new))[..., None]
    h = num / den
    if sp is not None and tp is not None:
        h = tp.my_heads(h, 1)
    h = _headnorm(h, params["gn_scale"])
    h = h.reshape(x.shape[0], 1, di).to(x.dtype)
    out = (h * F.silu(z)) @ params["w_down"]
    if sp is not None:
        m_new = sp.chunk(m_new, -1)
    for name, val in (("conv", conv), ("C", C), ("n", nst), ("m", m_new)):
        cache[name].copy_(val)
    return (out, cache) if tp is None else (tp.reduce(out), cache)


# ================================================================= sLSTM

def init_slstm(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    dh = d // H
    dev = gen.device
    s = d ** -0.5
    f32 = torch.float32
    up = int(4 * d / 3)
    # gates: z, i, f, o
    return {
        "w_x": _normal(gen, (d, 4, d), s, f32),
        "r_h": _normal(gen, (H, dh, 4, dh), dh ** -0.5, f32),
        "b": torch.zeros((4, d), dtype=f32, device=dev),
        "gn_scale": torch.ones((d,), dtype=f32, device=dev),
        "w_up": _normal(gen, (d, up), s, dtype),
        "w_down": _normal(gen, (up, d), (4 * d / 3) ** -0.5, dtype),
    }


def _slstm_step(params, xg, state, H: int, dh: int):
    """xg (B, 4, d): W_x x + b; state (c, n, m, h), each (B, d)."""
    c0, n0, m0, h0 = state
    rec = torch.einsum("bhd,hdge->bhge", h0.reshape(-1, H, dh),
                       params["r_h"])
    # the reference reshapes (B, H, 4, dh) to (B, 4, H*dh) as it lies
    g = xg + rec.reshape(xg.shape[0], 4, H * dh)
    z = act.tanh(g[:, 0])
    li = g[:, 1]
    lf = act.log_sigmoid(g[:, 2])
    o = torch.sigmoid(g[:, 3])
    m1 = torch.clamp(torch.maximum(lf + m0, li), min=-30.0)
    fdec = act.exp(lf + m0 - m1)
    iexp = act.exp(li - m1)
    c1 = fdec * c0 + iexp * z
    n1 = fdec * n0 + iexp
    h1 = o * c1 / torch.clamp(n1, min=1e-6)
    return c1, n1, m1, h1


def _slstm_out(params, h, dtype, tp=None):
    """The norm over all d and the FFN; under ``tp`` the FFN is column-
    and row-parallel where its leaves are sliced, else whole."""
    var = torch.mean(torch.square(h), dim=-1, keepdim=True)
    h = (h * torch.rsqrt(var + 1e-5) * params["gn_scale"]).to(dtype)
    sliced = tp is not None and tp.slstm_ffn
    if sliced:
        h = tp.copy(h)
    up = h @ params["w_up"]
    y = F.gelu(up, approximate="tanh") @ params["w_down"]
    return tp.reduce(y) if sliced else y


def slstm_forward(params, x, cfg: ModelConfig, tp=None):
    """x (B, S, D) -> (B, S, D); under ``tp`` a rank's d/M gate channels
    of ``w_x`` and ``b`` and H/M heads of ``r_h``, gathered whole before
    the recurrence."""
    B, S, D = x.shape
    H = cfg.num_heads
    r_h = params["r_h"]
    if tp is not None:
        x = tp.copy(x)
    xg = torch.einsum("bsd,dge->bsge", x.float(), params["w_x"]) \
        + params["b"]
    if tp is not None:
        xg, r_h = tp.gather(xg, -1), tp.gather(r_h, 0)
    p = {"r_h": r_h}
    zeros = x.new_zeros((B, D), dtype=torch.float32)
    state = (zeros, zeros, torch.full_like(zeros, -30.0), zeros)
    hs = []
    for t in range(S):
        state = _slstm_step(p, xg[:, t], state, H, D // H)
        hs.append(state[3])
    return _slstm_out(params, torch.stack(hs, dim=1), x.dtype, tp)


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> dict:
    d = cfg.d_model
    f32 = torch.float32

    def zeros():
        return torch.zeros((batch, d), dtype=f32, device=device)

    return {"c": zeros(), "n": zeros(),
            "m": torch.full((batch, d), -30.0, dtype=f32, device=device),
            "h": zeros()}


def slstm_decode(params, x, cache, cfg: ModelConfig, tp=None, sp=None):
    """x (B, 1, D) -> (y, cache): one recurrent step; the cache is
    updated in place and returned.  ``tp``: a rank's gate channels, its
    d/M of the states (see above); ``sp`` (regime (b)): the rows
    replicated, its d/(D M) of the states."""
    B, _, D = x.shape
    H = cfg.num_heads
    names = ("c", "n", "m", "h")
    xg = torch.einsum("bsd,dge->bsge", x.float(), params["w_x"])[:, 0] \
        + params["b"]
    state = tuple(cache[name] for name in names)
    p = params
    if sp is not None:
        # the gate pre-activations (the d-th part of the rank's model
        # slice) and the states' chunks, whole, in one gather
        xg, whole = sp.gather((sp.mine(xg, -1), -1, True),
                              (torch.stack(state, 1), -1, False))
        state = tuple(whole.unbind(1))
    elif tp is not None:
        # the gate pre-activations and the states, whole, in one gather
        whole = tp.gather(torch.cat([xg, torch.stack(state, 1)], 1), -1)
        xg, state = whole[:, :4], tuple(whole[:, 4:].unbind(1))
    if tp is not None:
        p = {"r_h": tp.gather(params["r_h"], 0)}
    new = _slstm_step(p, xg, state, H, D // H)
    for name, val in zip(names, new):
        if sp is not None:
            val = sp.chunk(val, -1)
        elif tp is not None:
            val = val.narrow(-1, tp.k * (D // tp.M), D // tp.M)
        cache[name].copy_(val)
    return _slstm_out(params, new[3], x.dtype, tp)[:, None], cache
