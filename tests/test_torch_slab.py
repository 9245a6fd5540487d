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
    """The JAX init as numpy arrays that share no memory with it."""
    return jax.tree.map(lambda a: np.array(a, copy=True), WORKLOADS[arch]())


def _assert_close(got, want, name, rtol=1e-5, atol=1e-6):
    """allclose, with the output's name, the share of elements out of
    tolerance and the largest error in the message."""
    a, b = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bad = ~np.isclose(a, b, rtol=rtol, atol=atol)
    np.testing.assert_allclose(
        a, b, rtol=rtol, atol=atol,
        err_msg=f"{name}: {bad.mean():.4%} of {bad.size} elements out of "
                f"tolerance, max abs err {np.abs(a - b).max():.3e}")


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
    jparams = jax.tree.map(lambda a: jnp.asarray(a.copy()), params)
    jagg = jslab.SlabAggregator(jslab.slab_codec(jparams), jparams, k_max,
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
            jagg.stage(jnp.asarray(row.copy()), slot)
            tagg.stage(torch.from_numpy(row.copy()), slot)
        w = 0.5 ** rng.integers(0, 3, size=k)
        jpub = jagg.flush_apply(w.copy(), 0.01 * k)
        tpub = tagg.flush_apply(w.copy(), 0.01 * k)
        _assert_close(tpub.numpy(), np.asarray(jpub),
                      f"{opt} params published by flush {step}")
    jstate, tstate = jagg.opt_state_host(), tagg.opt_state_host()
    if opt == "sgd":
        assert jstate is None and tstate is None
        return
    assert tstate["count"] == jstate["count"] == 4
    for name in SlabOptimizer(opt).moment_names:
        _assert_close(tstate[name], jstate[name], f"{opt} moment {name}")


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_inputs_survive_the_reference_donated_flush(opt):
    """The numpy inputs of a parity test are byte-unchanged after the
    JAX aggregator's donated stage and flush, and so are the port's
    tensors made from them."""
    params = _np_params("mlp")
    before = jax.tree.map(lambda a: a.tobytes(), params)
    jagg, tagg, p_pad = _agg_pair(opt)
    rows = np.random.default_rng(4).normal(size=(3, p_pad)
                                           ).astype(np.float32)
    rows_bytes = rows.tobytes()
    trows = torch.from_numpy(rows.copy())
    for slot in range(3):
        jagg.stage(jnp.asarray(rows[slot].copy()), slot)
        tagg.stage(trows[slot], slot)
    for _ in range(2):
        jax.block_until_ready(jagg.flush_apply(np.ones(3), 0.1))
        tagg.flush_apply(np.ones(3), 0.1)
    assert rows.tobytes() == rows_bytes
    assert trows.numpy().tobytes() == rows_bytes
    assert jax.tree.map(lambda a: a.tobytes(), params) == before
    fresh = _np_params("mlp")
    assert jax.tree.map(lambda a: a.tobytes(), fresh) == before


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


def _jax_agg(params, opt, k_max, shards=1):
    jparams = jax.tree.map(lambda a: jnp.asarray(a.copy()), params)
    return jslab.SlabAggregator(jslab.slab_codec(jparams), jparams, k_max,
                                use_pallas=False, shards=shards,
                                optimizer=JaxSlabOptimizer(opt))


def _port_agg(params, opt, k_max, shards=None):
    tparams = params_from_numpy(params)
    return tslab.SlabAggregator(tslab.slab_codec(tparams), tparams, k_max,
                                shards=shards, optimizer=SlabOptimizer(opt))


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_grow_keeps_staged_rows_like_reference(opt):
    """Rows staged before a grow survive it: the flush after growth
    tracks the JAX aggregator's grown one (allclose) and equals, bitwise,
    a port aggregator built at the larger size from the start."""
    params = _np_params("mlp")
    jagg, grown = _jax_agg(params, opt, 2), _port_agg(params, opt, 2)
    fixed = _port_agg(params, opt, 5)
    rng = np.random.default_rng(6)
    p_pad = grown.codec.padded_size
    rows = rng.normal(size=(5, p_pad)).astype(np.float32)
    for slot in range(2):
        for agg in (grown, fixed):
            agg.stage(torch.from_numpy(rows[slot].copy()), slot)
        jagg.stage(jnp.asarray(rows[slot].copy()), slot)
    for agg in (grown, jagg):
        agg.grow(5)
        agg.grow(3)                 # never shrinks
    assert grown.k_max == jagg.k_max == 5
    assert all(r.shape == (5, c) for r, c in zip(grown._staging,
                                                 grown.chunk_sizes))
    for slot in range(2, 5):
        for agg in (grown, fixed):
            agg.stage(torch.from_numpy(rows[slot].copy()), slot)
        jagg.stage(jnp.asarray(rows[slot].copy()), slot)
    w = np.asarray([1.0, 0.5, 0.25, 1.0, 0.75])
    got = grown.flush_apply(w, 0.05)
    assert torch.equal(got, fixed.flush_apply(w, 0.05))
    _assert_close(got.numpy(), np.asarray(jagg.flush_apply(w, 0.05)),
                  f"{opt} params after grow")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_sharded_flush_bitwise_equals_unsharded(opt, dtype):
    """Chunking staging along P changes no bit of the params or the
    moments (the fold is elementwise over P), and a sharded port
    aggregator tracks the JAX one sharded the same way.  Against JAX the
    weights are powers of two summing to one, so the two packages'
    orders of normalizing and folding (ROADMAP C.1) round alike and the
    comparison sees the sharding alone."""
    params = _np_params("cnn-mnist")
    tparams = params_from_numpy(params)
    codec = tslab.slab_codec(tparams, slab_dtype=dtype)
    rng = np.random.default_rng(8)
    rows = [torch.from_numpy(rng.normal(size=codec.padded_size)
                             .astype(np.float32)).to(codec.slab_dtype)
            for _ in range(3)]
    w = np.asarray([1.0, 0.7, 0.4], np.float32)
    outs = {}
    for shards in (1, 2, 3):
        agg = tslab.SlabAggregator(codec, tparams, 3, shards=shards,
                                   optimizer=SlabOptimizer(opt))
        assert agg.shards == shards
        assert sum(agg.chunk_sizes) == codec.padded_size
        assert all(c % tslab.TILE_P == 0 for c in agg.chunk_sizes)
        for _ in range(2):
            for slot, r in enumerate(rows):
                agg.stage(r, slot)
            agg.flush_apply(w, 0.1)
        outs[shards] = (agg.params_slab, agg.opt_state_host())
    for shards in (2, 3):
        assert torch.equal(outs[shards][0], outs[1][0])
        if opt != "sgd":
            for name in SlabOptimizer(opt).moment_names:
                np.testing.assert_array_equal(outs[shards][1][name],
                                              outs[1][1][name])
    jparams = jax.tree.map(jnp.asarray, params)
    jagg = jslab.SlabAggregator(jslab.slab_codec(jparams, dtype), jparams,
                                3, use_pallas=False, shards=2,
                                optimizer=JaxSlabOptimizer(opt))
    tagg = tslab.SlabAggregator(codec, tparams, 3, shards=2,
                                optimizer=SlabOptimizer(opt))
    w2 = np.asarray([0.5, 0.25, 0.25], np.float32)
    for _ in range(2):
        for slot, r in enumerate(rows):
            tagg.stage(r, slot)
            jagg.stage(jnp.asarray(r.float().numpy()).astype(
                jagg.codec.slab_dtype), slot)
        jpub = jagg.flush_apply(w2, 0.1)
        tagg.flush_apply(w2, 0.1)
    _assert_close(tagg.params_slab.float().numpy(),
                  np.asarray(jpub).astype(np.float32),
                  f"{opt} {dtype} sharded params",
                  **({} if dtype == "f32" else dict(rtol=3e-2, atol=3e-2)))


def test_default_shards_follow_the_reference_rule():
    """One device gives one shard; the reference's rule splits only a
    multi-million-element slab across several devices."""
    p_pad = tslab.slab_codec(params_from_numpy(_np_params("cnn-cifar"))
                             ).padded_size
    for size in (p_pad, 1 << 22, 1 << 24):
        assert tslab._auto_shards(size, 1) == 1
        assert tslab._auto_shards(size, jax.local_device_count()) == \
            jslab._auto_shards(size)
    assert tslab._auto_shards(1 << 22, 4) == 4
    assert tslab._auto_shards((1 << 22) - tslab.TILE_P, 4) == 1
    assert _port_agg(_np_params("mlp"), "sgd", 3).shards == 1


@pytest.mark.parametrize("opt", ["momentum", "adamw"])
def test_reset_opt_state_reloads_like_reference(opt):
    """A saved optimizer state loads into both packages' aggregators and
    the next flush agrees; a state of another optimizer is refused."""
    jagg, tagg, p_pad = _agg_pair(opt)
    rng = np.random.default_rng(9)
    state = {name: rng.normal(size=p_pad).astype(np.float32) ** 2
             for name in SlabOptimizer(opt).moment_names}
    state["count"] = 7
    jagg.reset_opt_state({k: (v.copy() if k != "count" else v)
                          for k, v in state.items()})
    tagg.reset_opt_state(state)
    assert tagg.opt_state_host()["count"] == 7
    row = rng.normal(size=p_pad).astype(np.float32)
    tagg.stage(torch.from_numpy(row.copy()), 0)
    jagg.stage(jnp.asarray(row.copy()), 0)
    _assert_close(tagg.flush_apply(np.ones(1), 0.05).numpy(),
                  np.asarray(jagg.flush_apply(np.ones(1), 0.05)),
                  f"{opt} params after reload")
    jst, tst = jagg.opt_state_host(), tagg.opt_state_host()
    assert tst["count"] == jst["count"] == 8
    for name in SlabOptimizer(opt).moment_names:
        _assert_close(tst[name], jst[name], f"{opt} moment {name}")
    with pytest.raises(ValueError, match="missing moment"):
        tagg.reset_opt_state({"count": 1})


def test_discard_wipes_staged_rows():
    _, tagg, p_pad = _agg_pair("sgd")
    buf = tslab.SlabBuffer(tagg)
    buf.add(torch.full((p_pad,), float("inf")), 0)
    buf.add(torch.ones(p_pad), 0)
    buf.discard()
    assert len(buf) == 0
    assert all(not r.any() for r in tagg._staging)
