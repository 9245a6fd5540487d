"""Rematerialisation in the port's training path (``cfg.remat``).

- The gradient with ``remat="block"`` (each block group, each 512-row
  query block of the plain attention, each mamba and mLSTM chunk
  checkpointed) is bitwise equal to the port's own with ``remat="none"``
  for every mixer family, at S 1024 where attention takes two query
  blocks, and within f32 rtol 1e-5 / atol 1e-6 of ``jax.grad`` of the
  reference's ``loss_fn`` with ``remat="block"`` on the reference's
  initial params.  On the CPU the embedding's backward (an index_put
  accumulate over threads) varies run to run unless PyTorch's
  deterministic algorithms are on, so the bitwise cases turn them on.
- The outer forward saves the group inputs and the head's and loss's
  tensors and no (S, S) score matrix; an attention layer under remat
  saves no score block at all.
- ``core/gradient.py`` agrees with ``torch.func``'s gradient within f32
  rounding without remat; under a ``torch.func`` transform a
  rematerialising forward raises, naming A17.
- ``make_train_step`` (micro-batches too) and ``make_replica_step``
  with a rematerialising loss equal their no-remat results.
- The square-root sweep's comparison logic; ``sqrt_rn``'s devices.

On the card, ``tests/test_torch_cuda_kernels.py`` holds remat against no
remat (marked ``cuda``; that file imports no JAX).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import model as JM
from repro_torch import sqrt_sweep
from repro_torch.configs import registry as tregistry
from repro_torch.convert import params_from_numpy, tree_leaves, tree_map
from repro_torch.core import gradient
from repro_torch.core import spmd_hybrid as spmd
from repro_torch.kernels import ref
from repro_torch.launch.steps import make_train_step
from repro_torch.models import attention as attn
from repro_torch.models import model as TM
from repro_torch.optim import adamw, sgd

torch.set_num_threads(2)

GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
# family -> (arch, config overrides, sequence length)
FAMILIES = {
    # sliding window 16, two groups, two 512-row query blocks
    "dense-window": ("h2o-danube-1.8b", dict(num_groups=2), 1024),
    "mla-moe": ("deepseek-v2-lite-16b", dict(num_groups=2), 1024),
    "mamba-attn": ("jamba-v0.1-52b",
                   dict(block_pattern=(("mamba", "mlp"), ("attn", "moe"))),
                   1024),
    # two mLSTM chunks; no attention, so no query block
    "mlstm-slstm": ("xlstm-350m", dict(num_groups=2), 128),
}


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _cfgs(family, remat="block"):
    arch, kw, S = FAMILIES[family]
    jcfg = dataclasses.replace(
        jregistry.smoke_variant(jregistry.get_config(arch)), remat=remat,
        **kw)
    tcfg = dataclasses.replace(
        tregistry.smoke_variant(tregistry.get_config(arch)), remat=remat,
        **kw)
    return jcfg, tcfg, S


def _batch(cfg, S, seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (1, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _torch_batch(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


def _grad(cfg, params, batch):
    g, (loss, _) = gradient.grad_and_value(
        lambda p, b: TM.loss_fn(p, b, cfg), has_aux=True)(params, batch)
    return tree_leaves(g), loss


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_gradient_bitwise_equals_no_remat(family, deterministic):
    _, cfg, S = _cfgs(family)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    b = _torch_batch(_batch(cfg, S))
    g_none, l_none = _grad(dataclasses.replace(cfg, remat="none"), params, b)
    g_block, l_block = _grad(cfg, params, b)
    assert torch.equal(l_none, l_block)
    assert len(g_none) == len(g_block)
    for a, c in zip(g_none, g_block):
        assert torch.equal(a, c)
    assert any(bool(g.abs().sum() > 0) for g in g_block)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_gradient_matches_reference(family):
    jcfg, tcfg, S = _cfgs(family)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(lambda a: np.array(a, copy=True),
                                        jp))
    b = _batch(tcfg, S)
    jb = {k: jax.numpy.asarray(v) for k, v in b.items()}
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jb, jcfg), has_aux=True))(jp)
    tg, tloss = _grad(tcfg, tp, _torch_batch(b))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = jax.tree.leaves(jg)
    assert len(want) == len(tg)
    for w, g in zip(want, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def _saved(cfg, params, batch):
    """(shape, bytes) of every tensor the forward of ``loss_fn`` saves
    for the backward outside any checkpoint, the param leaves' own
    storages left out."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    own = {t.untyped_storage().data_ptr() for t in tree_leaves(leaves)}
    saved = []

    def pack(t):
        if t.untyped_storage().data_ptr() not in own:
            saved.append((tuple(t.shape), t.numel() * t.element_size()))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        TM.loss_fn(leaves, batch, cfg)
    return saved


def test_remat_outer_forward_saves_group_inputs_head_and_loss():
    _, cfg, S = _cfgs("dense-window")
    cfg = dataclasses.replace(cfg, num_groups=4)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    b = _torch_batch(_batch(cfg, S))
    B, D, V = 1, cfg.d_model, cfg.vocab_size
    x = B * S * D * 4                   # a (B, S, D) f32 activation
    logits = B * S * V * 4
    # the group inputs; the final norm's input, output and statistics
    # and the head's input; the logits and the loss's float copies;
    # per-position indices and reductions
    bound = cfg.num_groups * x + 4 * x + 3 * logits + 64 * B * S
    block = _saved(cfg, params, b)
    none = _saved(dataclasses.replace(cfg, remat="none"), params, b)
    assert not any(len(s) >= 2 and s[-2:] == (S, S) for s, _ in block)
    assert sum(n for _, n in block) <= bound
    # without remat every layer keeps its activations and score blocks
    assert sum(n for _, n in none) > 4 * bound
    assert any(len(s) >= 2 and s[-1] == S and s[-2] == attn.Q_BLOCK
               for s, _ in none)


def test_remat_attention_saves_no_score_block():
    _, cfg, S = _cfgs("dense-window")
    g = torch.Generator().manual_seed(0)
    H, KV, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = torch.randn(1, S, H, d, generator=g, requires_grad=True)
    k = torch.randn(1, S, KV, d, generator=g, requires_grad=True)
    v = torch.randn(1, S, KV, d, generator=g, requires_grad=True)
    outs = {}
    for remat in ("none", "block"):
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = attn.plain_attention(
                q, k, v, dataclasses.replace(cfg, remat=remat), causal=True,
                window=cfg.sliding_window)
        outs[remat] = (out, shapes)
    assert any(s[-1] == S and len(s) >= 2 and s[-2] == attn.Q_BLOCK
               for s in outs["none"][1])
    assert not any(s[-1] == S and len(s) >= 2 and s[-2] >= attn.Q_BLOCK
                   for s in outs["block"][1])
    assert torch.equal(outs["none"][0], outs["block"][0])
    want = ref.attention_ref(q, k, v, causal=True, window=cfg.sliding_window)
    torch.testing.assert_close(outs["block"][0], want, rtol=0, atol=0)


def test_gradient_routine_agrees_with_torch_func():
    """Without remat, the autograd routine against ``torch.func`` (what
    the train step took before): within f32 rounding, not bitwise
    (functorch decomposes some ops its own way)."""
    _, cfg, S = _cfgs("mla-moe", remat="none")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    b = _torch_batch(_batch(cfg, 64))
    ours, loss = _grad(cfg, params, b)
    theirs, (tloss, _) = torch.func.grad_and_value(
        lambda p, bb: TM.loss_fn(p, bb, cfg), has_aux=True)(params, b)
    torch.testing.assert_close(loss, tloss, **GRAD_TOL)
    for a, c in zip(ours, tree_leaves(theirs)):
        torch.testing.assert_close(a, c, **GRAD_TOL)


def test_gradient_routine_gives_zeros_for_unreached_leaves():
    g, loss = gradient.grad_and_value(
        lambda p, x: torch.sum(p["a"] * x))(
            {"a": torch.ones(3), "b": torch.ones(2)}, torch.arange(3.0))
    assert torch.equal(g["a"], torch.arange(3.0))
    assert torch.equal(g["b"], torch.zeros(2)) and float(loss) == 3.0


def test_remat_under_torch_func_raises():
    _, cfg, S = _cfgs("dense-window")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    b = _torch_batch(_batch(cfg, 32))
    with pytest.raises(ValueError, match="A17"):
        torch.func.grad(lambda p: TM.loss_fn(p, b, cfg)[0])(params)
    # without a gradient the forward runs plain: nothing to recompute
    with torch.no_grad():
        TM.loss_fn(params, b, cfg)


@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_with_remat_equals_without(microbatch, deterministic):
    _, cfg, _ = _cfgs("dense-window")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(3)
    b = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 576))
                             .astype(np.int32))
         for k in ("tokens", "labels")}
    outs = {}
    for remat in ("none", "block"):
        opt = adamw(1e-3)
        step = make_train_step(dataclasses.replace(cfg, remat=remat), opt,
                               microbatch=microbatch)
        outs[remat] = step(params, opt.init(params), b)
    (p0, s0, l0, _), (p1, s1, l1, _) = outs["none"], outs["block"]
    assert torch.equal(l0, l1)
    for a, c in zip(tree_leaves((p0, s0)), tree_leaves((p1, s1))):
        assert torch.equal(a, c)


def _vmap_replica_step(loss_fn, opt_update):
    """The replica step as ``torch.func.vmap`` of one replica's
    ``torch.func`` gradient and update (what ``make_replica_step`` did
    before it stepped replicas one by one), for a loss without remat."""
    def one(params, opt_state, batch):
        grads, (loss, metrics) = torch.func.grad_and_value(
            loss_fn, has_aux=True)(params, batch)
        updates, new_opt = opt_update(grads, opt_state, params)
        return (tree_map(lambda p, u: p + u, params, updates), new_opt,
                loss, metrics)

    def step(params_R, opt_R, batch_R):
        new_p, new_o, loss, metrics = torch.func.vmap(one)(
            params_R, opt_R, batch_R)
        return new_p, new_o, {
            "loss": torch.mean(loss), "loss_per_replica": loss,
            "replicas": torch.tensor(loss.shape[0], dtype=torch.int32),
            "divergence": spmd.replica_divergence(new_p),
            **{k: torch.mean(v) for k, v in metrics.items()}}
    return step


def test_replica_step_with_remat_equals_vmap():
    """Two replicas of a small LM: ``make_replica_step`` (replica by
    replica) through the rematerialising loss against ``vmap`` of the
    loss without remat."""
    _, cfg, _ = _cfgs("dense-window")
    cfg = dataclasses.replace(cfg, sliding_window=None)
    R, S = 2, 16
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    params_R = spmd.replicate_params(params, R)
    rng = np.random.default_rng(5)
    batch_R = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (R, 2, S))
                                   .astype(np.int64))
               for k in ("tokens", "labels")}
    opt = sgd(0.1)
    opt_R = torch.func.vmap(opt.init)(params_R)
    none = dataclasses.replace(cfg, remat="none")
    block = dataclasses.replace(cfg, remat="block")
    p0, o0, m0 = _vmap_replica_step(lambda p, b: TM.loss_fn(p, b, none),
                                    opt.update)(params_R, opt_R, batch_R)
    p1, o1, m1 = spmd.make_replica_step(
        lambda p, b: TM.loss_fn(p, b, block), opt.update)(
            params_R, opt_R, batch_R)
    for a, c in zip(tree_leaves((p0, o0)), tree_leaves((p1, o1))):
        torch.testing.assert_close(c, a, **GRAD_TOL)
    assert set(m0) == set(m1) and int(m1["replicas"]) == R
    for k in m0:
        torch.testing.assert_close(m1[k].float(), m0[k].float(), **GRAD_TOL)
    assert float(m1["divergence"]) > 0


def test_sqrt_sweep_finds_the_first_mismatch():
    def off_at(bits):
        def cand(x):
            hit = x.view(torch.int32) == bits
            return torch.where(hit, x + 1, sqrt_sweep.float64_root(x))
        return cand
    res = sqrt_sweep.sweep("cpu", 1 << 14, 1 << 10, candidate=off_at(3000))
    assert res["compared"] == (1 << 14) + 1 and res["mismatches"] == 1
    assert res["first_mismatch"]["x_bits"] == "0x00000bb8"
    res = sqrt_sweep.sweep("cpu", 1 << 12, candidate=sqrt_sweep.float64_root)
    assert res["mismatches"] == 0 and res["first_mismatch"] is None


def test_sqrt_rn_takes_float64_on_the_cpu_only():
    x = torch.tensor([2.0, 1e-40, 0.0, float("inf")])
    assert torch.equal(ref.sqrt_rn(x), torch.sqrt(x.double()).float())
    m = ref.sqrt_rn(torch.empty(3, device="meta"))
    assert m.dtype == torch.float32 and m.device.type == "meta"
