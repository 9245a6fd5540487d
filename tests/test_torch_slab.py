"""The port's slab codec and aggregator against the JAX package's.

Encoding the same numpy parameters must give byte-equal slabs; the
aggregator must track JAX ``SlabAggregator(use_pallas=False)`` flush by
flush.  On the CPU the port's aggregator runs the kernels' plain
versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import slab as jslab
from repro.models.cnn import init_cnn, init_mlp_clf
from repro.optim import SlabOptimizer as JaxSlabOptimizer
from repro.optim import adamw as jadamw, momentum as jmomentum
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import slab as tslab
from repro_torch.optim import SlabOptimizer
from repro_torch.optim import adamw as tadamw, momentum as tmomentum

torch.set_num_threads(2)

WORKLOADS = {
    "mlp": lambda: init_mlp_clf(jax.random.PRNGKey(0)),
    "cnn-mnist": lambda: init_cnn(jax.random.PRNGKey(1), (28, 28, 1)),
    "cnn-cifar": lambda: init_cnn(jax.random.PRNGKey(2), (32, 32, 3)),
}


def _np_params(arch):
    return jax.tree.map(np.asarray, WORKLOADS[arch]())


def _bytes(x):
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


@pytest.mark.parametrize("arch", sorted(WORKLOADS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slabs_byte_equal(arch, dtype):
    params = _np_params(arch)
    jc = jslab.slab_codec(params, slab_dtype=dtype)
    tc = tslab.slab_codec(params_from_numpy(params), slab_dtype=dtype)
    assert (tc.size, tc.padded_size) == (jc.size, jc.padded_size)
    assert tc.sizes == jc.sizes and tc.offsets == jc.offsets
    assert _bytes(tc.encode(params_from_numpy(params))) == \
        _bytes(jc.encode(params))
    assert _bytes(tc.encode_master(params_from_numpy(params))) == \
        _bytes(jc.encode_master(params))


@pytest.mark.parametrize("arch", sorted(WORKLOADS))
def test_padded_size_and_shard_chunks(arch):
    params = _np_params(arch)
    p_pad = tslab.slab_codec(params_from_numpy(params)).padded_size
    assert p_pad == jslab.slab_codec(params).padded_size
    for shards in (1, 2, 3, 7, 1000):
        assert tslab.shard_chunks(p_pad, shards) == \
            jslab.shard_chunks(p_pad, shards)


def test_decode_restores_dtypes_and_nesting():
    rng = np.random.default_rng(0)
    tree = {"z": {"b": torch.from_numpy(rng.normal(size=(3, 5))
                                        .astype(np.float16)),
                  "a": torch.from_numpy(rng.normal(size=7)
                                        .astype(np.float32))},
            "m": torch.randn(4, generator=torch.Generator().manual_seed(1))
            .to(torch.bfloat16)}
    for sd in ("f32", "bf16"):
        codec = tslab.slab_codec(tree, slab_dtype=sd)
        back = codec.decode(codec.encode(tree))
        for path in (("z", "a"), ("z", "b"), ("m",)):
            want = tree[path[0]] if len(path) == 1 \
                else tree[path[0]][path[1]]
            got = back[path[0]] if len(path) == 1 \
                else back[path[0]][path[1]]
            assert got.dtype == want.dtype and got.shape == want.shape
            if sd == "f32":
                assert torch.equal(got, want)
    # leaf order is the reference's: sorted keys, depth first
    jtree = jax.tree.map(lambda t: np.asarray(t.float()), tree)
    jc = jslab.slab_codec(jtree)
    tc = tslab.slab_codec(tree)
    assert tc.offsets == jc.offsets and tc.sizes == jc.sizes


@pytest.mark.parametrize("bad", [torch.int32, torch.float64])
def test_codec_rejects_leaf_naming_path(bad):
    tree = {"ok": torch.zeros(3), "inner": {"bad": torch.zeros(2,
                                                               dtype=bad)}}
    with pytest.raises(TypeError, match=r"\['inner'\]\['bad'\]"):
        tslab.slab_codec(tree)


def _agg_pair(opt, k_max=5):
    params = _np_params("mlp")
    kw = dict(beta1=0.9, beta2=0.95, weight_decay=0.01) \
        if opt == "adamw" else {}
    jagg = jslab.SlabAggregator(jslab.slab_codec(params), params, k_max,
                                use_pallas=False,
                                optimizer=JaxSlabOptimizer(opt, **kw))
    tparams = params_from_numpy(params)
    tagg = tslab.SlabAggregator(tslab.slab_codec(tparams), tparams, k_max,
                                optimizer=SlabOptimizer(opt, **kw))
    return jagg, tagg, jslab.slab_codec(params).padded_size


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_aggregator_matches_reference(opt):
    jagg, tagg, p_pad = _agg_pair(opt)
    rng = np.random.default_rng(3)
    for step, k in enumerate((1, 3, 5, 3)):
        for slot in range(k):
            row = rng.normal(size=p_pad).astype(np.float32)
            jagg.stage(jnp.asarray(row), slot)
            tagg.stage(torch.from_numpy(row), slot)
        w = 0.5 ** rng.integers(0, 3, size=k)
        jpub = jagg.flush_apply(w, 0.01 * k)
        tpub = tagg.flush_apply(w, 0.01 * k)
        np.testing.assert_allclose(tpub.numpy(), np.asarray(jpub),
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"flush {step}")
    jstate, tstate = jagg.opt_state_host(), tagg.opt_state_host()
    if opt == "sgd":
        assert jstate is None and tstate is None
        return
    assert tstate["count"] == jstate["count"] == 4
    for name in SlabOptimizer(opt).moment_names:
        np.testing.assert_allclose(tstate[name], jstate[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_published_and_decoded_survive_later_flushes(opt):
    _, tagg, p_pad = _agg_pair(opt)
    g = torch.ones(p_pad)
    tagg.stage(g, 0)
    pub = tagg.flush_apply(np.ones(1), 0.1)
    tree = tagg.params_tree()
    pub_copy = pub.clone()
    tree_copy = {k: v.clone() for k, v in tree.items()}
    for _ in range(2):
        tagg.stage(g, 0)
        tagg.flush_apply(np.ones(1), 0.1)
    assert not torch.equal(tagg.params_slab, pub_copy)
    assert torch.equal(pub, pub_copy)
    for k in tree:
        assert torch.equal(tree[k], tree_copy[k]), k
    assert tagg.params_slab.data_ptr() != tagg._slab.data_ptr()


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_warmup_leaves_state_unchanged(opt):
    """A warmup before training changes no params, moments or count, and
    the flushes after it still track the reference's."""
    jagg, tagg, p_pad = _agg_pair(opt)
    before_params = tagg.params_slab.clone()
    before = tagg.opt_state_host()
    tagg.warmup()
    jagg.warmup()
    assert torch.equal(tagg.params_slab, before_params)
    after = tagg.opt_state_host()
    if opt != "sgd":
        assert after["count"] == before["count"] == 0
        for name in SlabOptimizer(opt).moment_names:
            np.testing.assert_array_equal(after[name], before[name])
    row = np.random.default_rng(5).normal(size=p_pad).astype(np.float32)
    tagg.stage(torch.from_numpy(row), 0)
    jagg.stage(jnp.asarray(row), 0)
    np.testing.assert_allclose(tagg.flush_apply(np.ones(1), 0.05).numpy(),
                               np.asarray(jagg.flush_apply(np.ones(1),
                                                           0.05)),
                               rtol=1e-5, atol=1e-6)


def test_reset_and_wipe():
    _, tagg, p_pad = _agg_pair("adamw")
    init = tagg.params_slab.clone()
    tagg.stage(torch.full((p_pad,), float("inf")), 0)
    tagg.wipe_staging()
    tagg.flush_apply(np.ones(1), 0.1)
    assert torch.isfinite(tagg.params_slab).all()
    tagg.reset_params(params_from_numpy(_np_params("mlp")))
    tagg.reset_opt_state()
    assert torch.equal(tagg.params_slab, init)
    state = tagg.opt_state_host()
    assert state["count"] == 0
    assert not state["mu"].any() and not state["nu"].any()


@pytest.mark.parametrize("name", ["momentum", "adamw"])
def test_tree_optimizers_match_reference(name):
    rng = np.random.default_rng(11)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": {"c": rng.normal(size=5).astype(np.float32)}}
    jopt = jmomentum(0.1, 0.9) if name == "momentum" \
        else jadamw(0.1, weight_decay=0.01)
    topt = tmomentum(0.1, 0.9) if name == "momentum" \
        else tadamw(0.1, weight_decay=0.01)
    jp, tp = params, params_from_numpy(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        g = jax.tree.map(lambda p: rng.normal(size=p.shape)
                         .astype(np.float32), params)
        ju, js = jopt.update(g, js, jp)
        tu, ts = topt.update(params_from_numpy(g), ts, tp)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = {k: (tp[k] + tu[k]) if k == "a"
              else {"c": tp["b"]["c"] + tu["b"]["c"]} for k in tp}
    got, want = params_to_numpy(tp), jax.tree.map(np.asarray, jp)
    np.testing.assert_allclose(got["a"], want["a"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["b"]["c"], want["b"]["c"], rtol=1e-5,
                               atol=1e-6)
    assert int(ts["count"]) == int(js["count"]) == 3
