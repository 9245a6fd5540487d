"""Every registry architecture in the port against the JAX package's.

For each config in ``configs/registry.py`` the reduced same-family
variant (``smoke_variant``: 1-2 layers, d <= 256, <= 4 experts, f32)
runs in both packages on the reference's initial params: the logits of
the serving forward (the kernel wrappers, plain versions on the CPU)
and the training loss against the reference's; one SGD step through
autograd; and, where the config decodes, each decode step against the
reference's decode step and against the forward.  These port
``tests/test_arch_smoke.py`` and the model-level cases of
``tests/test_models.py`` (frontends, encoder attention, MoE routing).

Tolerances: logits rtol 1e-4 / atol 1e-4 (values up to ~5; measured at
most 7.8e-6 apart, xlstm), losses rtol 1e-5; decode against the
reference's decode 1e-4; decode against the forward rtol 2e-3 / atol
1e-3, the reference's own bound (``test_models.py``), with a capacity
factor that drops no token (the forward routes B*S tokens per group, a
decode step B, so drops would differ).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import model as JM
from repro_torch.configs import registry as tregistry
from repro_torch.convert import params_from_numpy
from repro_torch.models import model as TM

torch.set_num_threads(2)

ARCHS = jregistry.ARCH_NAMES
DECODE_ARCHS = [a for a in ARCHS if jregistry.get_config(a).has_decode]
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# a 27-layer bf16 MLA + MoE model's prefill (flash_attention and rmsnorm
# wrappers) against its decode replay (absorbed MLA, plain attention), at
# a capacity that drops no token in either: over seeds 0-7 the two differ
# by 0.096-0.172 here (PERF.md, PR 18); chip_smoke.py holds the
# full-width model to its own bound, read on the card
MLA_PREFILL_DECODE_ATOL = 0.3


def _smoke(arch, **kw):
    jcfg = jregistry.smoke_variant(jregistry.get_config(arch))
    tcfg = tregistry.smoke_variant(tregistry.get_config(arch))
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)


def _params(jcfg, seed=0):
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(
        lambda a: np.array(a, copy=True), jp))


def _batches(cfg):
    b = jregistry.smoke_batch(cfg)
    return ({k: jnp.asarray(v.copy()) for k, v in b.items()},
            {k: torch.from_numpy(v.copy()) for k, v in b.items()})


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_loss_match_reference(arch):
    jcfg, tcfg = _smoke(arch)
    jp, tp = _params(jcfg)
    jb, tb = _batches(jcfg)
    want, jaux = jax.jit(lambda p, b: JM.forward(p, b, jcfg))(jp, jb)
    jloss, jm = jax.jit(lambda p, b: JM.loss_fn(p, b, jcfg))(jp, jb)
    with torch.no_grad():
        got, aux = TM.forward(tp, tb, tcfg)
        loss, m = TM.loss_fn(tp, tb, tcfg)
    S = 32      # smoke sequence (vision: image + text tokens)
    assert tuple(got.shape) == (2, S, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step(arch):
    """One SGD step (lr 0.1) through autograd on the port's own init:
    finite loss before and after, and every param that the loss reaches
    moves (the reference's ``test_arch_smoke.py::test_smoke_train_step``)."""
    _, cfg = _smoke(arch)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    _, batch = _batches(cfg)
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = TM.loss_fn(params, batch, cfg)
    assert torch.isfinite(loss)
    loss.backward()
    with torch.no_grad():
        delta = 0.0
        for t in leaves:
            if t.grad is not None:
                delta += float(t.grad.abs().sum())
                t -= 0.1 * t.grad
        assert delta > 0.0
        loss2, _ = TM.loss_fn(params, batch, cfg)
    assert torch.isfinite(loss2)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_smoke_decode_matches_reference_and_forward(arch):
    """24 decode steps (past llama4's smoke chunk of 16 and danube's
    window of 16): each step's logits against the reference's decode
    step, and all against the port's forward (a vision model's decode
    takes text tokens: its forward without the image prefix)."""
    jcfg, tcfg = _smoke(arch, moe_capacity_factor=8.0)
    jp, tp = _params(jcfg)
    B, S = 2, 24
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jstep = jax.jit(lambda p, c, t, i: JM.decode_step(p, c, t, i, jcfg))
    jc = JM.init_cache(jcfg, B, S)
    tc = TM.init_cache(tcfg, B, S)
    assert [tuple(t.shape) for t in jax.tree.leaves(tc)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jc)]
    outs = []
    with torch.no_grad():
        full, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)},
                             dataclasses.replace(tcfg, frontend=None))
        for i in range(S):
            want, jc = jstep(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                             jnp.int32(i))
            got, tc = TM.decode_step(tp, tc, torch.from_numpy(
                toks[:, i:i + 1]), i, tcfg)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)
            outs.append(got[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=1e-3)


def test_exact_assigned_configs():
    """The port's full configs are the published shapes (the reference's
    ``test_arch_smoke.py::test_exact_assigned_configs``)."""
    get = tregistry.get_config
    c = get("qwen1.5-110b")
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
            c.d_ff, c.vocab_size) == (80, 8192, 64, 8, 49152, 152064)
    assert c.attn_bias
    c = get("qwen2.5-32b")
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
            c.d_ff, c.vocab_size) == (64, 5120, 40, 8, 27648, 152064)
    c = get("llama4-scout-17b-a16e")
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
            c.vocab_size, c.attn_chunk) == (48, 5120, 40, 8, 202048, 8192)
    assert c.num_experts == 16 and c.num_experts_per_tok == 1
    c = get("deepseek-v2-lite-16b")
    assert (c.num_layers, c.d_model, c.num_heads, c.vocab_size) \
        == (27, 2048, 16, 102400)
    assert (c.kv_lora_rank, c.num_experts, c.num_experts_per_tok,
            c.num_shared_experts) == (512, 64, 6, 2)
    assert (c.resolved_head_dim + c.rope_head_dim,
            c.resolved_v_head_dim) == (192, 128)
    c = get("hubert-xlarge")
    assert (c.num_layers, c.d_model, c.num_heads, c.d_ff, c.vocab_size) \
        == (48, 1280, 16, 5120, 504)
    assert c.encoder_only and not c.causal
    c = get("phi-3-vision-4.2b")
    assert (c.num_layers, c.d_model, c.num_heads, c.d_ff, c.vocab_size,
            c.num_image_tokens) == (32, 3072, 32, 8192, 32064, 576)
    c = get("h2o-danube-1.8b")
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.d_ff,
            c.vocab_size) == (24, 2560, 32, 8, 6912, 32000)
    assert c.sliding_window == 4096
    c = get("jamba-v0.1-52b")
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.d_ff,
            c.vocab_size) == (32, 4096, 32, 8, 14336, 65536)
    assert c.num_experts == 16 and c.num_experts_per_tok == 2
    mixers = [m for m, _ in c.block_pattern]
    assert mixers.count("attn") == 1 and mixers.count("mamba") == 7
    c = get("phi4-mini-3.8b")
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.d_ff,
            c.vocab_size) == (32, 3072, 24, 8, 8192, 200064)
    c = get("xlstm-350m")
    assert (c.num_layers, c.d_model, c.num_heads, c.vocab_size) \
        == (24, 1024, 4, 50304)


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_params_keep_the_reference_tree(arch):
    """Leaf paths, shapes and dtypes of the port's init equal the
    reference's, for every family (so ``params_from_numpy`` carries the
    reference's params across unchanged)."""
    jcfg, tcfg = _smoke(arch)
    want = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    got = TM.init_params(torch.Generator().manual_seed(0), tcfg)
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    tflat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == \
        [jax.tree_util.keystr(p) for p, _ in tflat]
    tleaves = [t for _, t in tflat]
    assert [tuple(a.shape) for _, a in jflat] == \
        [tuple(t.shape) for t in tleaves]
    assert [str(a.dtype) for _, a in jflat] == \
        [str(t.dtype).replace("torch.", "") for t in tleaves]


# ------------------------------------------------ frontends and encoder

def _tiny(**kw):
    from repro_torch.models.config import ModelConfig
    base = dict(name="t", arch_type="dense", d_model=64, vocab_size=128,
                block_pattern=(("attn", "mlp"),), num_groups=2,
                num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
                dtype="float32", remat="none")
    return ModelConfig(**dict(base, **kw))


def test_vision_frontend_prefix_and_loss_region():
    cfg = _tiny(frontend="vision", frontend_dim=24, num_image_tokens=4,
                arch_type="vlm")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    B, S_text = 2, 12
    batch = {"tokens": torch.ones((B, S_text), dtype=torch.int32),
             "image_embeds": torch.ones((B, 4, 24)),
             "labels": torch.ones((B, S_text), dtype=torch.int32)}
    with torch.no_grad():
        logits, _ = TM.forward(params, batch, cfg)
        assert tuple(logits.shape) == (B, 4 + S_text, cfg.vocab_size)
        loss, _ = TM.loss_fn(params, batch, cfg)
        assert torch.isfinite(loss)
        batch2 = dict(batch, image_embeds=2.0 * batch["image_embeds"])
        logits2, _ = TM.forward(params, batch2, cfg)
    assert not torch.allclose(logits[:, 4:], logits2[:, 4:])


def test_audio_frontend_masked_loss_and_bidirectional_encoder():
    cfg = _tiny(frontend="audio", frontend_dim=24, encoder_only=True,
                causal=False, arch_type="audio", vocab_size=32)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    assert "embed" not in params and "lm_head" in params
    B, S = 2, 16
    feats = torch.randn((B, S, 24), generator=torch.Generator()
                        .manual_seed(1))
    labels = torch.ones((B, S), dtype=torch.int32)
    m1 = torch.zeros((B, S))
    m1[:, :4] = 1.0
    with torch.no_grad():
        l1, _ = TM.loss_fn(params, {"features": feats, "labels": labels,
                                    "loss_mask": m1}, cfg)
        l2, _ = TM.loss_fn(params, {"features": feats, "labels": labels,
                                    "loss_mask": torch.ones((B, S))}, cfg)
        out1, _ = TM.forward(params, {"features": feats}, cfg)
        feats2 = feats.clone()
        feats2[:, -1] = 99.0
        out2, _ = TM.forward(params, {"features": feats2}, cfg)
    assert torch.isfinite(l1) and torch.isfinite(l2)
    assert abs(float(l1) - float(l2)) > 1e-6          # the mask matters
    # position 0 of an encoder sees the last position
    assert not torch.allclose(out1[:, 0], out2[:, 0])


def test_moe_router_aux_and_capacity():
    """The aux loss is at least 1 (E * sum f p >= 1); with a generous
    capacity no token is dropped and the output is the dense mixture
    over both experts (the reference's ``test_models.py`` MoE cases)."""
    import torch.nn.functional as F
    from repro_torch.models.moe import init_moe, moe_forward
    cfg = _tiny(block_pattern=(("attn", "moe"),), num_experts=2,
                num_experts_per_tok=2, moe_d_ff=32,
                moe_capacity_factor=8.0, moe_group_size=32)
    params = init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn((1, 32, 64), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y, aux = moe_forward(params, x, cfg)
        w = torch.softmax(x @ params["router"], -1)
        ep = params["experts"]
        h = F.silu(torch.einsum("bsd,edf->besf", x, ep["w_gate"])) \
            * torch.einsum("bsd,edf->besf", x, ep["w_up"])
        want = torch.einsum("bse,besd->bsd", w,
                            torch.einsum("besf,efd->besd", h, ep["w_down"]))
    torch.testing.assert_close(y, want, rtol=2e-4, atol=2e-4)
    assert float(aux) >= 1.0 - 1e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_mla_moe_prefill_matches_decode_replay_at_full_depth(seed):
    """At deepseek-v2-lite's depth (27 MLA + MoE layers) in bf16, with 6
    of 8 experts and 2 shared, at a capacity factor of E (no token
    dropped by either path), the prefill's last-position logits (the
    flash_attention and rmsnorm wrappers) and the decode replay's
    (absorbed MLA, plain attention) stay within the bound; a row whose
    prefill margin exceeds twice the bound agrees on top-1, and greedy's
    first token is the replay's argmax (chip_smoke.py's rules)."""
    from repro_torch.launch import serve as tserve
    cfg = dataclasses.replace(
        tregistry.smoke_variant(tregistry.get_config("deepseek-v2-lite-16b")),
        num_groups=27, dtype="bfloat16", d_model=128, vocab_size=512,
        num_experts=8, num_experts_per_tok=6, num_shared_experts=2,
        moe_capacity_factor=8.0)
    with torch.inference_mode():
        params = TM.init_params(torch.Generator().manual_seed(seed), cfg)
        toks = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (4, 32)).astype(np.int32))
        pre = tserve.prefill_step(params, {"tokens": toks}, cfg).float()
        cache = TM.init_cache(cfg, 4, 32)
        for i in range(32):
            dec, cache = TM.decode_step(params, cache, toks[:, i:i + 1], i,
                                        cfg)
        first = tserve.greedy_generate(cfg, params, toks.numpy(), 1)[:, 32]
    dec = dec[:, 0].float()
    diff = float((pre - dec).abs().max())
    assert diff <= MLA_PREFILL_DECODE_ATOL, diff
    top2 = pre.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * MLA_PREFILL_DECODE_ATOL
    assert bool((pre.argmax(-1) == dec.argmax(-1))[clear].all())
    assert np.array_equal(first, dec.argmax(-1).numpy())
