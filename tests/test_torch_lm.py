"""The port's model stack and serving path against the JAX package's.

A small GQA + sliding-window config (d 64, H 4, KV 2, hd 16, d_ff 128,
vocab 97, 2 groups, window 8, S 32) runs through both packages on the
JAX package's initial params, carried over as numpy arrays
(``convert.params_from_numpy``).  The JAX forward takes its blocked
window path (``q_block=8``); the port's forward goes through
``ops.flash_attention`` and ``ops.rmsnorm``, which on the CPU run their
plain versions.

Tolerances: f32 logits rtol/atol 1e-4 (two attention algorithms and
two matmul libraries; measured 3.4e-6 apart on logits up to 4); bf16
logits 6e-2 absolute, two bf16 ulps at the largest logits (|logit| < 8;
measured 4.3e-2), since the two frameworks round the bf16 activations at
different places.  In f32 the
greedy tokens are equal; in bf16 every token the port picks is within
that tolerance of the reference's best logit on the same prefix.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import serve as jserve
from repro.models import config as jconfig
from repro.models import model as JM
from repro_torch.api.cli import main
from repro_torch.configs import registry as tregistry
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import rmsnorm as trms
from repro_torch.launch import serve as tserve
from repro_torch.models import config as tconfig
from repro_torch.models import model as TM

torch.set_num_threads(2)

BASE = dict(name="t", arch_type="dense", d_model=64, vocab_size=97,
            block_pattern=(("attn", "mlp"),), num_groups=2, num_heads=4,
            num_kv_heads=2, head_dim=16, d_ff=128, sliding_window=8,
            dtype="float32", remat="none")
B, S = 2, 32
LOGIT_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=0.0, atol=6e-2)}
# chip_smoke.py holds h2o-danube-1.8b's prefill and decode replay to this
PREFILL_DECODE_ATOL = 0.25


def _cfgs(**kw):
    fields = dict(BASE, **kw)
    return jconfig.ModelConfig(**fields), tconfig.ModelConfig(**fields)


def _host(tree):
    """A JAX tree as numpy arrays that share no memory with it."""
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _params(jcfg, seed=0):
    """The JAX package's initial params, and the port's copy of them."""
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(_host(jp))


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape
                                                ).astype(np.int32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _jax_decode(jcfg):
    return jax.jit(lambda p, c, t, i: JM.decode_step(p, c, t, i, jcfg))


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", jregistry.ARCH_NAMES)
def test_configs_are_the_references(arch):
    assert tregistry.ARCH_NAMES == jregistry.ARCH_NAMES
    jcfg, tcfg = jregistry.get_config(arch), tregistry.get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tregistry.smoke_variant(tcfg)) == \
        dataclasses.asdict(jregistry.smoke_variant(jcfg))
    assert (tcfg.num_layers, tcfg.kv_groups, tcfg.subquadratic) == \
        (jcfg.num_layers, jcfg.kv_groups, jcfg.subquadratic)
    jb = jregistry.smoke_batch(jregistry.smoke_variant(jcfg))
    tb = tregistry.smoke_batch(tregistry.smoke_variant(tcfg))
    assert sorted(jb) == sorted(tb)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])


def test_h2o_danube_is_published_width():
    cfg = tregistry.get_config("h2o-danube-1.8b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.sliding_window, cfg.mlp_act, cfg.tie_embeddings,
            cfg.dtype) == (24, 2560, 32, 8, 80, 6912, 32000, 4096,
                           "swiglu", False, "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_keeps_the_reference_tree(dtype):
    """Same nesting (tuple of per-pattern dicts stacked on num_groups),
    leaf names, shapes and dtypes as the JAX package's init."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    want = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    got = TM.init_params(torch.Generator().manual_seed(0), tcfg)
    assert isinstance(got["groups"], tuple) and len(got["groups"]) == 1
    jflat, jdef = jax.tree_util.tree_flatten_with_path(want)
    tflat, tdef = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, params_to_numpy(got)))
    assert jdef == tdef
    for (jpath, j), (tpath, t) in zip(jflat, tflat):
        assert jpath == tpath
        assert (tuple(t.shape), np.dtype(t.dtype)) == \
            (tuple(j.shape), np.dtype(j.dtype)), jpath


def test_rope_angles_are_correctly_rounded():
    """Rope's cos and sin are the correctly rounded float32 values of
    the float32 angles (float64, rounded once), never the CPU's
    thread-split VML result (ROADMAP C.8); with x = [1, 0] halves the
    rotation returns [cos, sin] itself.  4096 angles: more than one VML
    chunk."""
    from repro_torch.models.rope import apply_rope, rope_freqs, rope_table
    S, hd, theta = 512, 16, 10_000.0
    x = torch.cat([torch.ones(1, S, 1, hd // 2),
                   torch.zeros(1, S, 1, hd // 2)], dim=-1)
    pos = torch.arange(S, dtype=torch.int32)[None]
    out = apply_rope(x, rope_table(pos, hd, theta))[0, :, 0].numpy()
    ang = (pos[..., None].float() * rope_freqs(hd, theta))[0].numpy()
    np.testing.assert_array_equal(
        out[:, :hd // 2], np.cos(ang.astype(np.float64)).astype(np.float32))
    np.testing.assert_array_equal(
        out[:, hd // 2:], np.sin(ang.astype(np.float64)).astype(np.float32))


def test_vml_check_finds_polar_exact(capsys):
    """The C.8 diagnostic runs, and in a fresh process rope's way of
    taking cos/sin (``torch.polar`` in float64) is correctly rounded."""
    from repro_torch import vml_check
    assert vml_check.main(["--procs", "1", "--jobs", "1",
                           "--way", "polar"]) == 0
    assert capsys.readouterr().out.startswith("polar: 1 processes, 0 inexact")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    """The port's rope (one table, applied to q and k) against the JAX
    package's ``apply_rope`` on the same inputs: f32 within 2e-6 (XLA's
    float32 cos/sin against correctly rounded ones, on |x| < 5), bf16
    within one bf16 ulp (8e-3 relative)."""
    from repro.models.rope import apply_rope as japply
    from repro_torch.models.rope import apply_rope, rope_table
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)).copy()
    want = japply(jnp.asarray(x.copy()).astype(dtype),
                  jnp.asarray(pos.copy()), 10_000.0)
    got = apply_rope(torch.from_numpy(x.copy()).to(getattr(torch, dtype)),
                     rope_table(torch.from_numpy(pos.copy()), 16, 10_000.0))
    tol = dict(rtol=2e-6, atol=2e-6) if dtype == "float32" else \
        dict(rtol=8e-3, atol=1e-6)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# ------------------------------------------------------------- forward

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _params(jcfg)
    toks = _tokens(1, (B, S), jcfg.vocab_size)
    want, jaux = JM.forward(jp, {"tokens": jnp.asarray(toks.copy())}, jcfg,
                            q_block=8)
    got, aux = TM.forward(tp, {"tokens": torch.from_numpy(toks.copy())},
                          tcfg)
    assert got.shape == (B, S, jcfg.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), **LOGIT_TOL[dtype])
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("global_layer", [False, True])
def test_forward_global_layer_matches_reference(global_layer):
    """An attn_global layer ignores the window in both packages."""
    pattern = (("attn_global" if global_layer else "attn", "mlp"),
               ("attn", "mlp"))
    jcfg, tcfg = _cfgs(block_pattern=pattern, num_groups=1)
    jp, tp = _params(jcfg, seed=3)
    toks = _tokens(4, (B, S), jcfg.vocab_size)
    want, _ = JM.forward(jp, {"tokens": jnp.asarray(toks.copy())}, jcfg,
                         q_block=8)
    got, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks.copy())},
                        tcfg)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_forward_path_runs_through_the_kernel_wrappers(monkeypatch):
    """Every norm and every full-sequence attention of the forward goes
    through the kernels' wrappers (on the CPU they run the plain
    versions inside)."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    calls = {"rmsnorm": 0, "flash_attention": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(trms, "rmsnorm", counting("rmsnorm", trms.rmsnorm))
    monkeypatch.setattr(tflash, "flash_attention",
                        counting("flash_attention", tflash.flash_attention))
    TM.forward(tp, {"tokens": torch.from_numpy(_tokens(1, (B, S), 97))},
               tcfg)
    assert calls == {"rmsnorm": 2 * tcfg.num_layers + 1,
                     "flash_attention": tcfg.num_layers}
    calls.update(rmsnorm=0, flash_attention=0)
    cache = TM.init_cache(tcfg, B, 4)
    TM.decode_step(tp, cache, torch.zeros((B, 1), dtype=torch.int32), 0,
                   tcfg)
    assert calls == {"rmsnorm": 2 * tcfg.num_layers + 1,
                     "flash_attention": 0}


# -------------------------------------------------------------- decode

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(dtype):
    """Every step's logits and the ring-buffer cache after S steps (the
    window-8 ring wraps four times)."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _params(jcfg)
    toks = _tokens(2, (B, S), jcfg.vocab_size)
    jstep = _jax_decode(jcfg)
    jcache, tcache = JM.init_cache(jcfg, B, S), TM.init_cache(tcfg, B, S)
    tt = torch.from_numpy(toks.copy())
    for i in range(S):
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, i:i + 1]),
                           jnp.int32(i))
        tl, tcache = TM.decode_step(tp, tcache, tt[:, i:i + 1], i, tcfg)
        np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL[dtype],
                                   err_msg=f"step {i}")
    for jc, tc in zip(jax.tree.leaves(jcache),
                      jax.tree.leaves(params_to_numpy(tcache))):
        assert tc.shape == jc.shape and tc.dtype == jc.dtype
        np.testing.assert_allclose(_np(tc), _np(jc), **LOGIT_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_greedy_generate_matches_reference(dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _params(jcfg, seed=1)
    prompts = _tokens(3, (B, 12), jcfg.vocab_size)
    gen = 10
    got = tserve.greedy_generate(tcfg, tp, prompts.copy(), gen)
    assert got.shape == (B, 12 + gen) and got.dtype == np.int32
    np.testing.assert_array_equal(got[:, :12], prompts)
    want = jserve.greedy_generate(jcfg, jp, prompts.copy(), gen)
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
        return
    # bf16: replay the port's tokens through the reference; each token
    # the port picked is the reference's best up to the logit tolerance
    jstep = _jax_decode(jcfg)
    cache = JM.init_cache(jcfg, B, 12 + gen)
    for i in range(12 + gen - 1):
        logits, cache = jstep(jp, cache, jnp.asarray(got[:, i:i + 1]),
                              jnp.int32(i))
        if i >= 11:
            lg = _np(logits)[:, 0]
            picked = lg[np.arange(B), got[:, i + 1]]
            assert np.all(lg.max(-1) - picked <=
                          LOGIT_TOL[dtype]["atol"]), i


DECODE_CONFIGS = {
    "dense_gqa": dict(sliding_window=None),
    "dense_bias": dict(sliding_window=None, attn_bias=True),
    "swa_ring": dict(),
    "global_and_swa": dict(block_pattern=(("attn_global", "mlp"),
                                          ("attn", "mlp")), num_groups=1),
    "gelu": dict(mlp_act="gelu"),
    "tied": dict(tie_embeddings=True),
}


@pytest.mark.parametrize("name", list(DECODE_CONFIGS))
def test_decode_matches_forward(name):
    """The port's counterpart of the JAX package's
    ``test_models.py::test_decode_matches_forward``, on the port's own
    init, at that test's tolerance."""
    _, cfg = _cfgs(**DECODE_CONFIGS[name])
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    if cfg.attn_bias:     # zeros at init: make the bias path visible
        for g in params["groups"]:
            for k in ("bq", "bk", "bv"):
                g["mixer"][k].normal_(generator=torch.Generator()
                                      .manual_seed(1))
    steps = 24
    toks = torch.from_numpy(_tokens(5, (B, steps), cfg.vocab_size))
    full, _ = TM.forward(params, {"tokens": toks}, cfg)
    cache = TM.init_cache(cfg, B, steps)
    outs = []
    for i in range(steps):
        lg, cache = TM.decode_step(params, cache, toks[:, i:i + 1], i, cfg)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=1e-3)


def test_prefill_step_is_the_last_position():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    toks = _tokens(6, (B, S), jcfg.vocab_size)
    got = tserve.prefill_step(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    full, _ = JM.forward(jp, {"tokens": jnp.asarray(toks.copy())}, jcfg,
                         q_block=8)
    assert got.shape == (B, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), _np(full)[:, -1], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_matches_decode_replay_at_full_depth(seed):
    """At h2o-danube-1.8b's depth (24 layers) in bf16, the prefill's
    logits at the prompt's last position (flash_attention and rmsnorm
    wrappers) and the decode replay's (plain attention) stay within the
    bound that chip_smoke.py holds the full-width model to; measured
    0.047-0.055 here."""
    _, cfg = _cfgs(dtype="bfloat16", num_groups=24, d_model=128,
                   head_dim=32, d_ff=256, vocab_size=512,
                   sliding_window=16)
    with torch.inference_mode():
        params = TM.init_params(torch.Generator().manual_seed(seed), cfg)
        toks = torch.from_numpy(_tokens(seed, (4, S), cfg.vocab_size))
        pre = tserve.prefill_step(params, {"tokens": toks}, cfg).float()
        cache = TM.init_cache(cfg, 4, S)
        for i in range(S):
            dec, cache = TM.decode_step(params, cache, toks[:, i:i + 1], i,
                                        cfg)
    diff = float((pre - dec[:, 0].float()).abs().max())
    assert diff <= PREFILL_DECODE_ATOL, diff


@pytest.mark.parametrize("what", ["chunked", "mla", "mamba", "xlstm", "moe",
                                  "vision"])
def test_unported_parts_raise(what):
    """The parts the port once refused (chunked attention, MLA, mamba,
    xLSTM, MoE, the vision frontend) now build and run: no
    ``NotImplementedError`` naming a ROADMAP item is left, and the
    forward gives finite logits of the right shape.  Their parity with
    the reference is in ``test_torch_mixers.py`` and
    ``test_torch_arch.py``."""
    kw = {
        "chunked": dict(attn_chunk=8),
        "mla": dict(block_pattern=(("mla", "mlp"),), kv_lora_rank=32),
        "mamba": dict(block_pattern=(("mamba", "mlp"),)),
        "xlstm": dict(block_pattern=(("mlstm", "none"),)),
        "moe": dict(block_pattern=(("attn", "moe"),), num_experts=4,
                    num_experts_per_tok=2, moe_d_ff=32),
        "vision": dict(frontend="vision", frontend_dim=16,
                       num_image_tokens=4),
    }[what]
    _, cfg = _cfgs(**kw)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    if what == "vision":
        batch["image_embeds"] = torch.ones((1, 4, 16))
    with torch.no_grad():
        logits, aux = TM.forward(params, batch, cfg)
    n = 12 if what == "vision" else 8
    assert tuple(logits.shape) == (1, n, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))


# ------------------------------------------------------------- convert

def test_convert_round_trips_params_and_cache_trees():
    """Tuples and lists survive; bf16 leaves come back bit for bit."""
    jcfg, _ = _cfgs(dtype="bfloat16")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jstep = _jax_decode(jcfg)
    cache = JM.init_cache(jcfg, B, 4)
    for i in range(3):
        _, cache = jstep(jp, cache, jnp.full((B, 1), i + 1, jnp.int32),
                         jnp.int32(i))
    for tree in (_host(jp), _host(cache), [_host(cache)[0], {"x": (
            np.arange(3, dtype=np.float32),)}]):
        back = params_to_numpy(params_from_numpy(tree))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    leaves = jax.tree.leaves(params_from_numpy(_host(cache)))
    assert leaves and all(t.dtype == torch.bfloat16 for t in leaves)


# ------------------------------------------------------------- surface

def test_cli_serve_smoke_on_cpu(capsys):
    assert main(["serve", "--smoke", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "5", "--gen-len", "3", "--seed", "1"]) == 0
    out = capsys.readouterr().out
    assert "arch=h2o-danube-1.8b" in out and "device=cpu" in out
    assert "generated 6 tokens" in out


def test_cli_serve_without_cuda_is_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["serve", "--smoke", "--batch", "1", "--prompt-len", "2",
              "--gen-len", "1"])


def test_serve_module_entry_point(capsys):
    assert tserve.main(["--smoke", "--device", "cpu", "--batch", "1",
                        "--prompt-len", "3", "--gen-len", "2"]) == 0
    assert "generated 2 tokens" in capsys.readouterr().out


# ------------------------------------------------- training (lm-tiny)
# lm-tiny (d 64, vocab 128, 2 layers, 4x16 heads, d_ff 128, f32, tied)
# trained through loss_fn's plain forward.  Loss and the f32 gradient
# slab within rtol 1e-5 / atol 1e-6 of the reference on its weights
# (measured: loss 3.3e-6 apart at 5.36, slab 4.3e-8); the bf16 slab
# within one bf16 ulp (2^-7 of the value, rtol 8e-3; atol 1e-5 for the
# entries near zero): both sides round gradients that agree to 1e-5.
GRAD_TOL = {"f32": dict(rtol=1e-5, atol=1e-6),
            "bf16": dict(rtol=8e-3, atol=1e-5)}


def _lm_tiny(seed=0):
    """Both packages' lm-tiny workloads on the reference's initial params
    (carried over), and the shared data."""
    from repro.api import ExperimentSpec as JaxSpec
    from repro.serve import workload as jworkload
    from repro_torch.api import ExperimentSpec
    from repro_torch.serve import workload as tworkload
    jw = jworkload.lm_tiny_workload(JaxSpec(arch="lm-tiny", smoke=True,
                                            seed=seed))
    tw = tworkload.lm_tiny_workload(ExperimentSpec(arch="lm-tiny",
                                                   smoke=True, seed=seed),
                                    torch.device("cpu"))
    return jw, tw, params_from_numpy(_host(jw[1]))


def test_lm_tiny_config_and_data_are_the_references():
    from repro.serve import workload as jworkload
    from repro_torch.core.slab import slab_codec
    from repro_torch.serve import workload as tworkload
    assert dataclasses.asdict(tworkload.lm_tiny_config()) == \
        dataclasses.asdict(jworkload.lm_tiny_config())
    jw, tw, tp = _lm_tiny()
    for a, b in zip(jw[2], tw[2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    codec = slab_codec(tp)
    assert (codec.size, codec.padded_size) == (90_432, 98_304)
    assert codec.decode(codec.encode(tp))["groups"][1]["mixer"]["wq"] \
        .shape == (1, 64, 4, 16)


@pytest.mark.parametrize("slab_dtype", ["f32", "bf16"])
def test_lm_tiny_loss_and_gradient_slab_match_reference(slab_dtype):
    from repro.core.slab import slab_codec as jslab_codec
    from repro_torch.core.slab import slab_codec
    (jloss, jp, jdata, _), (tloss, _, _, _), tp = _lm_tiny()
    x, y = jdata[0][:32], jdata[1][:32]
    tx, ty = torch.from_numpy(x.copy()), torch.from_numpy(y.copy())
    np.testing.assert_allclose(float(tloss(tp, tx, ty)),
                               float(jloss(jp, x, y)), rtol=1e-5, atol=1e-6)
    want = np.asarray(jslab_codec(jp, slab_dtype).encode(
        jax.grad(jloss)(jp, x, y))).astype(np.float32)
    got = slab_codec(tp, slab_dtype).encode(
        torch.func.grad(tloss)(tp, tx, ty))
    assert got.dtype == (torch.float32 if slab_dtype == "f32"
                         else torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **GRAD_TOL[slab_dtype])


def test_loss_fn_mask_and_metrics_match_reference():
    """``loss_mask`` averages over the masked tokens only, and the
    metrics carry the cross-entropy and the aux loss."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=2)
    toks = _tokens(5, (B, S), jcfg.vocab_size)
    labels = _tokens(6, (B, S), jcfg.vocab_size)
    mask = (np.arange(S)[None, :] < np.array([[S // 2], [S]])
            ).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "loss_mask": jnp.asarray(mask)}
    tb = {"tokens": torch.from_numpy(toks.copy()),
          "labels": torch.from_numpy(labels.copy()),
          "loss_mask": torch.from_numpy(mask.copy())}
    (jl, jm), (tl, tm) = JM.loss_fn(jp, jb, jcfg, q_block=8), \
        TM.loss_fn(tp, tb, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]),
                               rtol=1e-5, atol=1e-6)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0


@pytest.mark.parametrize("what", ["rmsnorm", "attention"])
def test_plain_kernels_differentiate_like_reference(what):
    """The plain versions the training forward runs, differentiated by
    ``torch.func.grad``, against ``jax.grad`` of the reference's plain
    versions: f32 rtol 1e-5 / atol 1e-6."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(7)
    if what == "rmsnorm":
        args = [rng.normal(size=(6, 64)).astype(np.float32),
                (1 + 0.1 * rng.normal(size=64)).astype(np.float32)]
        jf, tf = jref.rmsnorm_ref, tref.rmsnorm_ref
    else:
        args = [rng.normal(size=(2, 16, n, 16)).astype(np.float32)
                for n in (4, 2, 2)]
        jf = lambda q, k, v: jref.attention_ref(   # noqa: E731
            q, k, v, causal=True, window=8)
        tf = lambda q, k, v: tref.attention_ref(   # noqa: E731
            q, k, v, causal=True, window=8)
    w = rng.normal(size=jf(*args).shape).astype(np.float32)
    argnums = tuple(range(len(args)))
    want = jax.grad(lambda *a: jnp.sum(jf(*a) * w), argnums)(*args)
    got = torch.func.grad(lambda *a: torch.sum(tf(*a) * torch.from_numpy(w)),
                          argnums)(*(torch.from_numpy(a) for a in args))
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)


def test_training_forward_never_reaches_the_kernel_wrappers(monkeypatch):
    """``loss_fn`` selects the plain path by its argument: the kernel
    wrappers are never called, so they keep refusing inputs that
    require grad, and the serving forward keeps its kernels."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)

    def refuse(*a, **k):
        raise AssertionError("the training forward called a kernel")

    monkeypatch.setattr(trms, "rmsnorm", refuse)
    monkeypatch.setattr(tflash, "flash_attention", refuse)
    toks = torch.from_numpy(_tokens(1, (B, S), 97))
    loss = torch.func.grad(lambda p: TM.loss_fn(
        p, {"tokens": toks, "labels": toks}, tcfg)[0])(tp)
    assert torch.isfinite(loss["embed"]).all()
    monkeypatch.undo()
    x = torch.ones(2, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        trms.rmsnorm(x, torch.ones(64))


def test_lm_tiny_sim_matches_reference():
    """A 3-gradient hybrid simulator run on lm-tiny, the port against
    the JAX ``SimulatorTrainer`` on the same initial params and data:
    the same events, and metrics within rtol 1e-5 / atol 1e-6."""
    from repro.api import ExperimentSpec as JaxSpec
    from repro.api import SimulatorTrainer as JaxSimulatorTrainer
    from repro.core.simulator import WorkerPool as JaxWorkerPool
    from repro_torch.api import ExperimentSpec, SimulatorTrainer
    jspec = JaxSpec(arch="lm-tiny", smoke=True, mode="hybrid",
                    schedule="step:2", horizon=0.07, sample_every=0.035,
                    pool=JaxWorkerPool(num_workers=3, delay_fraction=0.0))
    jw, tw, tp = _lm_tiny()
    jres = JaxSimulatorTrainer(*jw).run(jspec)
    tres = SimulatorTrainer(tw[0], tp, tw[2], tw[3], device="cpu").run(
        ExperimentSpec.from_json(jspec.to_json()))
    assert (tres.num_gradients, tres.num_updates) == \
        (jres.num_gradients, jres.num_updates)
    assert tres.num_gradients == 3 and tres.grid == jres.grid
    for k, v in jres.metrics.items():
        np.testing.assert_allclose(tres.metrics[k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert tres.metrics["train_loss"][-1] < tres.metrics["train_loss"][0]
