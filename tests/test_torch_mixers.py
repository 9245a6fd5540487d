"""The port's mixers and MoE FFN against the JAX package's, one module at
a time.

Each case builds a small config in both packages, takes the reference's
initial params (``convert.params_from_numpy``), feeds the same numpy
inputs through the reference module and the port's, then steps both
decode paths token by token.  Mixers: attention with a chunk
(``attn_chunk``, its ring cache), MLA (full sequence through the
flash_attention wrapper, absorbed decode), MoE (grouped top-k dispatch,
capacity, shared expert, aux loss), mamba (chunked scan), mLSTM
(chunkwise, two chunks) and sLSTM (time loop).  On the CPU the kernel
wrappers run their plain versions.

Tolerance, f32 throughout: rtol 1e-5 / atol 2e-6 on each mixer's
output (outputs of order 1).  The scans add in another order than the
reference's ``associative_scan`` / ``lax.scan`` (ROADMAP C.24): measured
at most 2.1e-6 apart (mLSTM), 1.3e-6 (mamba), 9.5e-7 (sLSTM, MLA
decode), 7.2e-7 and below elsewhere.  The aux loss is held at rtol
1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import attention as JA
from repro.models import config as jconfig
from repro.models import mamba as JMB
from repro.models import mla as JMLA
from repro.models import moe as JMOE
from repro.models import xlstm as JX
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ref
from repro_torch.models import attention as TA
from repro_torch.models import config as tconfig
from repro_torch.models import mamba as TMB
from repro_torch.models import mla as TMLA
from repro_torch.models import moe as TMOE
from repro_torch.models import xlstm as TX
from repro_torch.models.rope import rope_table

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=2e-6)
BASE = dict(name="t", arch_type="dense", d_model=64, vocab_size=97,
            block_pattern=(("attn", "mlp"),), num_groups=1, num_heads=4,
            num_kv_heads=2, head_dim=16, d_ff=128, dtype="float32",
            remat="none")


def _cfgs(**kw):
    fields = dict(BASE, **kw)
    return jconfig.ModelConfig(**fields), tconfig.ModelConfig(**fields)


def _both(tree):
    """A JAX tree and the port's copy of it."""
    return tree, params_from_numpy(jax.tree.map(
        lambda a: np.array(a, copy=True), tree))


def _x(seed, shape):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(a.copy()), torch.from_numpy(a.copy())


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               **(tol or TOL))


def _rope(S, dim, theta=10_000.0, start=0):
    pos = torch.arange(start, start + S, dtype=torch.int32)[None]
    return rope_table(pos, dim, theta)


def _decode_both(jstep, tstep, jcache, tcache, xj, xt):
    """Step both decoders over every position (the reference's step
    jitted once); returns the stacked outputs (reference, port)."""
    jstep = jax.jit(jstep)
    outs_j, outs_t = [], []
    for i in range(xj.shape[1]):
        yj, jcache = jstep(xj[:, i:i + 1], jcache, jnp.int32(i))
        yt, tcache = tstep(xt[:, i:i + 1], tcache, i)
        outs_j.append(np.asarray(yj))
        outs_t.append(yt.numpy())
    return np.concatenate(outs_j, 1), np.concatenate(outs_t, 1)


# ------------------------------------------------- plain attention

@pytest.mark.parametrize("case", [
    # B, S, H, KV, d, d_v, causal, window, chunk, q_block
    (2, 40, 4, 2, 16, 16, True, None, 8, 8),      # chunk < tile, blocked
    (1, 64, 4, 1, 16, 16, True, None, 24, 16),    # chunk straddles blocks
    (1, 37, 4, 2, 16, 16, True, 6, 8, 37),        # ragged S, window too
    (1, 48, 4, 4, 24, 16, True, None, None, 16),  # d_v != d (MLA)
    (2, 32, 2, 2, 40, 32, False, None, 16, 8),    # encoder, both
])
def test_attention_ref_matches_rowblock(case):
    """``ref.attention_ref`` with a chunk and with d_v != d against the
    reference's ``rowblock_attention`` (its blocked path, which slices
    each query block's reachable keys)."""
    B, S, H, KV, d, dv, causal, window, chunk, qb = case
    jcfg, _ = _cfgs(num_heads=H, num_kv_heads=KV, head_dim=d,
                    causal=causal, sliding_window=window, attn_chunk=chunk)
    (qj, qt), (kj, kt) = _x(1, (B, S, H, d)), _x(2, (B, S, KV, d))
    vj, vt = _x(3, (B, S, KV, dv))
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    # The blocked path needs S % q_block == 0, and with a chunk that
    # q_block does not divide it drops keys (ROADMAP C.27): there the
    # function is its one-block path.
    blocked = S % qb == 0 and (chunk is None or chunk % qb == 0)
    want = JA.rowblock_attention(qj, kj, vj, pos, jcfg,
                                 q_block=qb if blocked else S)
    got = ref.attention_ref(qt, kt, vt, causal=causal, window=window,
                            chunk=chunk)
    assert tuple(got.shape) == (B, S, H, dv)
    _close(got, want)
    # evaluated a query block at a time, the same function
    blocked = ref.attention_ref(qt, kt, vt, causal=causal, window=window,
                                chunk=chunk, q_block=7)
    _close(blocked, got, rtol=0, atol=0)


def test_attention_ref_chunk_matches_reference_oracle():
    """Chunk mask as the reference's own oracle would give it: the
    same-chunk mask applied to the full score matrix."""
    (qj, qt), (kj, kt), (vj, vt) = (_x(s, (1, 33, 2, 16)) for s in (4, 5, 6))
    got = ref.attention_ref(qt, kt, vt, causal=True, chunk=5)
    mask = ref.attention_mask(33, True, None, "cpu", chunk=5).numpy()
    s = np.einsum("bqhd,bkhd->bhqk", np.asarray(qj), np.asarray(kj)) * 0.25
    s = np.where(mask, s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bhqk,bkhd->bqhd", p, np.asarray(vj))
    _close(got, want, rtol=1e-5, atol=1e-6)
    want_j = jref.attention_ref(qj, kj, vj, causal=True)
    assert not np.allclose(np.asarray(want_j), got.numpy())


# ---------------------------------------------------- chunked attention

@pytest.mark.parametrize("global_layer", [False, True])
def test_chunked_attention_forward_and_decode(global_layer):
    jcfg, tcfg = _cfgs(attn_chunk=8)
    jp, tp = _both(JA.init_attention(jax.random.PRNGKey(0), jcfg,
                                     jnp.float32))
    B, S = 2, 24
    xj, xt = _x(7, (B, S, 64))
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    want = jax.jit(lambda x: JA.attention_forward(
        jp, x, jcfg, pos, global_layer=global_layer))(xj)
    got = TA.attention_forward(tp, xt, tcfg, _rope(S, 16),
                               global_layer=global_layer)
    _close(got, want)
    jc = JA.init_attn_cache(jcfg, B, S, jnp.float32, global_layer)
    tc = TA.init_attn_cache(tcfg, B, S, torch.float32, global_layer)
    assert tc["k"].shape == jc["k"].shape == \
        (B, S if global_layer else 8, 2, 16)
    dj, dt = _decode_both(
        lambda x, c, i: JA.attention_decode(jp, x, c, i, jcfg,
                                            global_layer),
        lambda x, c, i: TA.attention_decode(tp, x, c, i, tcfg,
                                            _rope(1, 16, start=i),
                                            global_layer),
        jc, tc, xj, xt)
    _close(dt, dj)
    _close(dt, want, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------ MLA

MLA_CFG = dict(block_pattern=(("mla", "mlp"),), num_kv_heads=4,
               kv_lora_rank=32, rope_head_dim=8, v_head_dim=12)


@pytest.mark.parametrize("causal", [True, False])
def test_mla_forward_matches_reference(causal):
    jcfg, tcfg = _cfgs(causal=causal, **MLA_CFG)
    jp, tp = _both(JMLA.init_mla(jax.random.PRNGKey(1), jcfg, jnp.float32))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    B, S = 2, 20
    xj, xt = _x(8, (B, S, 64))
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    want = jax.jit(lambda x: JMLA.mla_forward(jp, x, jcfg, pos))(xj)
    got = TMLA.mla_forward(tp, xt, tcfg, _rope(S, 8))
    _close(got, want)
    _close(TMLA.mla_forward(tp, xt, tcfg, _rope(S, 8), plain=True), got,
           rtol=0, atol=0)


def test_mla_decode_matches_reference():
    jcfg, tcfg = _cfgs(**MLA_CFG)
    jp, tp = _both(JMLA.init_mla(jax.random.PRNGKey(2), jcfg, jnp.float32))
    B, S = 2, 12
    xj, xt = _x(9, (B, S, 64))
    jc = JMLA.init_mla_cache(jcfg, B, S, jnp.float32)
    tc = TMLA.init_mla_cache(tcfg, B, S, torch.float32)
    dj, dt = _decode_both(
        lambda x, c, i: JMLA.mla_decode(jp, x, c, i, jcfg),
        lambda x, c, i: TMLA.mla_decode(tp, x, c, i, tcfg,
                                        _rope(1, 8, start=i)),
        jc, tc, xj, xt)
    _close(dt, dj)
    full = TMLA.mla_forward(tp, xt, tcfg, _rope(S, 8))
    _close(dt, full, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------ MoE

MOE_CFG = dict(block_pattern=(("attn", "moe"),), num_experts=4,
               num_experts_per_tok=2, moe_d_ff=32, num_shared_experts=1)


@pytest.mark.parametrize("case", [
    dict(),                                     # drops at capacity 1.25
    dict(moe_capacity_factor=4.0),              # none dropped
    dict(moe_group_size=16),                    # several groups
    dict(num_shared_experts=0, num_experts_per_tok=1),
])
def test_moe_matches_reference(case):
    jcfg, tcfg = _cfgs(**dict(MOE_CFG, **case))
    jp, tp = _both(JMOE.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32))
    xj, xt = _x(10, (2, 24, 64))
    yj, aj = jax.jit(lambda x: JMOE.moe_forward(jp, x, jcfg))(xj)
    yt, at = TMOE.moe_forward(tp, xt, tcfg)
    _close(yt, yj)
    _close(at, aj, rtol=1e-6, atol=0)


def test_moe_top_k_ties_keep_the_reference_order():
    """With a zero router every expert ties: ``jax.lax.top_k`` takes the
    lowest indices in order, and the capacity queue positions follow
    from that order.  A tight capacity makes any other order visible."""
    jcfg, tcfg = _cfgs(**dict(MOE_CFG, moe_capacity_factor=0.5))
    jp = JMOE.init_moe(jax.random.PRNGKey(4), jcfg, jnp.float32)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    jp, tp = _both(jp)
    xj, xt = _x(11, (1, 32, 64))
    vals, idx = TMOE.top_k(torch.full((3, 4), 0.25), 2)
    assert idx.tolist() == [[0, 1]] * 3 and vals.tolist() == [[0.25] * 2] * 3
    yj, aj = JMOE.moe_forward(jp, xj, jcfg)
    yt, at = TMOE.moe_forward(tp, xt, tcfg)
    _close(yt, yj)
    _close(at, aj, rtol=1e-6, atol=0)


# ---------------------------------------------------------------- mamba

MAMBA_CFG = dict(block_pattern=(("mamba", "mlp"),), ssm_chunk=8,
                 arch_type="ssm", mamba_dt_rank=8)


@pytest.mark.parametrize("S", [8, 24])
def test_mamba_forward_and_decode(S):
    jcfg, tcfg = _cfgs(**MAMBA_CFG)
    jp = JMB.init_mamba(jax.random.PRNGKey(5), jcfg, jnp.float32)
    # a visible conv bias and a spread of step sizes
    jp = dict(jp, conv_b=0.1 * jnp.ones_like(jp["conv_b"]),
              dt_bias=jnp.linspace(-6.0, 1.0, jp["dt_bias"].shape[0]))
    jp, tp = _both(jp)
    xj, xt = _x(12, (2, S, 64))
    want = jax.jit(lambda x: JMB.mamba_forward(jp, x, jcfg))(xj)
    got = TMB.mamba_forward(tp, xt, tcfg)
    _close(got, want)
    jc = JMB.init_mamba_cache(jcfg, 2, jnp.float32)
    tc = TMB.init_mamba_cache(tcfg, 2, torch.float32)
    dj, dt = _decode_both(
        lambda x, c, i: JMB.mamba_decode(jp, x, c, jcfg),
        lambda x, c, i: TMB.mamba_decode(tp, x, c, tcfg), jc, tc, xj, xt)
    _close(dt, dj)
    _close(dt, got, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- xLSTM

XLSTM_CFG = dict(block_pattern=(("mlstm", "none"), ("slstm", "none")),
                 num_kv_heads=4, arch_type="ssm")


@pytest.mark.parametrize("S", [24, 128])
def test_mlstm_forward_and_decode(S):
    """S 128 runs two chunks of 64, carrying (C, n, m) across."""
    jcfg, tcfg = _cfgs(**XLSTM_CFG)
    jp, tp = _both(JX.init_mlstm(jax.random.PRNGKey(6), jcfg, jnp.float32))
    xj, xt = _x(13, (2, S, 64))
    want = jax.jit(lambda x: JX.mlstm_forward(jp, x, jcfg))(xj)
    got = TX.mlstm_forward(tp, xt, tcfg)
    _close(got, want)
    jc = JX.init_mlstm_cache(jcfg, 2, jnp.float32)
    tc = TX.init_mlstm_cache(tcfg, 2, torch.float32)
    n = min(S, 24)
    dj, dt = _decode_both(
        lambda x, c, i: JX.mlstm_decode(jp, x, c, jcfg),
        lambda x, c, i: TX.mlstm_decode(tp, x, c, tcfg), jc, tc,
        xj[:, :n], xt[:, :n])
    _close(dt, dj)


@pytest.mark.parametrize("S", [1, 24])
def test_slstm_forward_and_decode(S):
    jcfg, tcfg = _cfgs(**XLSTM_CFG)
    jp = JX.init_slstm(jax.random.PRNGKey(7), jcfg, jnp.float32)
    jp = dict(jp, b=0.5 * jax.random.normal(jax.random.PRNGKey(8),
                                            jp["b"].shape))
    jp, tp = _both(jp)
    xj, xt = _x(14, (2, S, 64))
    want = jax.jit(lambda x: JX.slstm_forward(jp, x, jcfg))(xj)
    got = TX.slstm_forward(tp, xt, tcfg)
    _close(got, want)
    jc = JX.init_slstm_cache(jcfg, 2, jnp.float32)
    tc = TX.init_slstm_cache(tcfg, 2, torch.float32)
    dj, dt = _decode_both(
        lambda x, c, i: JX.slstm_decode(jp, x, c, jcfg),
        lambda x, c, i: TX.slstm_decode(tp, x, c, tcfg), jc, tc, xj, xt)
    _close(dt, dj)
    _close(dt, got, rtol=1e-5, atol=1e-6)


def test_log_sigmoid_and_softplus_are_the_references():
    """``jax.nn.log_sigmoid`` / ``softplus`` at the far tails too, where
    torch's ``F.softplus`` switches to its threshold form."""
    from repro_torch.models import activations as act
    a = np.concatenate([np.linspace(-60, 60, 241),
                        np.random.default_rng(0).normal(0, 8, 500)]
                       ).astype(np.float32)
    _close(act.log_sigmoid(torch.from_numpy(a)),
           jax.nn.log_sigmoid(jnp.asarray(a)), rtol=2e-7, atol=0)
    _close(act.softplus(torch.from_numpy(a)),
           jax.nn.softplus(jnp.asarray(a)), rtol=2e-7, atol=0)
