"""The legacy tree buffer (``core/buffer.py``) and the two examples.

- the counterparts of ``tests/test_hybrid_core.py::test_buffer_*``: the
  plain mean, staleness weighting, conservation (uniform flush x K ==
  the sum);
- ``GradientBuffer``/``aggregate_flush`` against ``repro.core.buffer``
  on the same numpy inputs, and against the port's slab flush
  (``SlabAggregator``, the plain flush on the CPU), the role the
  reference gives it (``src/repro/core/buffer.py:13-19``), at rtol 1e-5
  / atol 1e-6;
- ``examples/quickstart.py`` and ``examples/threshold_functions.py``
  run short on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import buffer as jbuffer
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.buffer import GradientBuffer, aggregate_flush
from repro_torch.core.slab import SlabAggregator, SlabBuffer, slab_codec
from repro_torch.examples import quickstart, threshold_functions

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)


def _np_tree(seed, shape=(7,)):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=shape).astype(np.float32),
            "layers": ({"b": rng.normal(size=(3, 2)).astype(np.float32)},
                       {"b": rng.normal(size=(5,)).astype(np.float32)})}


def _tree(seed, shape=(7,)):
    return params_from_numpy(_np_tree(seed, shape))


def test_buffer_flush_mean():
    buf = GradientBuffer()
    trees = [_tree(i) for i in range(4)]
    for t in trees:
        buf.add(t, version=0)
    agg, n = buf.flush(current_version=0)
    assert n == 4 and len(buf) == 0
    want = torch.mean(torch.stack([t["w"] for t in trees]), 0)
    torch.testing.assert_close(agg["w"], want, rtol=1e-6, atol=0)


def test_buffer_staleness_weighting():
    buf = GradientBuffer(staleness_decay=0.5)
    buf.add(_tree(0), version=0)   # staleness 2 -> weight 0.25
    buf.add(_tree(1), version=2)   # staleness 0 -> weight 1.0
    assert buf.staleness(2) == [2, 0]
    agg, _ = buf.flush(current_version=2)
    w = np.array([0.25, 1.0])
    w = w / w.sum()
    want = w[0] * _np_tree(0)["w"] + w[1] * _np_tree(1)["w"]
    np.testing.assert_allclose(agg["w"].numpy(), want, rtol=1e-6)


@settings(max_examples=20, deadline=None)
@given(k=st.integers(1, 10), seed=st.integers(0, 999))
def test_buffer_conservation(k, seed):
    """Property: uniform flush x K == sum of gradients (conservation)."""
    buf = GradientBuffer()
    trees = [_tree(seed + i) for i in range(k)]
    for t in trees:
        buf.add(t, version=3)
    agg, n = buf.flush(current_version=3)
    total = sum(_np_tree(seed + i)["w"] for i in range(k))
    np.testing.assert_allclose(n * agg["w"].numpy(), total, rtol=1e-5,
                               atol=1e-6)


def test_buffer_one_gradient_is_itself_and_empty_flush_refused():
    buf = GradientBuffer(staleness_decay=0.3)
    t = _tree(5)
    buf.add(t, version=1)
    agg, n = buf.flush(current_version=9)
    assert agg is t and n == 1
    with pytest.raises(ValueError):
        buf.flush(current_version=9)
    buf.add(t, version=1)
    grads, versions = buf.drain()
    assert grads == [t] and versions == [1] and len(buf) == 0


@settings(max_examples=15, deadline=None)
@given(k=st.integers(1, 8), seed=st.integers(0, 999),
       decay=st.sampled_from([1.0, 0.8, 0.5]))
def test_matches_reference_buffer(k, seed, decay):
    rng = np.random.default_rng(seed)
    versions = [int(v) for v in rng.integers(0, 5, size=k)]
    now = max(versions) + int(rng.integers(0, 3))
    ours, ref = GradientBuffer(decay), jbuffer.GradientBuffer(decay)
    for i, v in enumerate(versions):
        nt = _np_tree(seed + i)
        ours.add(params_from_numpy(nt), version=v)
        ref.add({"w": jnp.asarray(nt["w"]),
                 "layers": tuple({"b": jnp.asarray(x["b"])}
                                 for x in nt["layers"])}, version=v)
    assert ours.staleness(now) == ref.staleness(now)
    agg, n = ours.flush(now)
    jagg, jn = ref.flush(now)
    assert n == jn
    got = params_to_numpy(agg)
    np.testing.assert_allclose(got["w"], np.asarray(jagg["w"]), **TOL)
    for a, b in zip(got["layers"], jagg["layers"]):
        np.testing.assert_allclose(a["b"], np.asarray(b["b"]), **TOL)
    # aggregate_flush on explicit weights
    w = rng.random(k) + 0.1
    trees = [_tree(seed + i) for i in range(k)]
    jtrees = [{"w": jnp.asarray(_np_tree(seed + i)["w"])} for i in range(k)]
    np.testing.assert_allclose(
        aggregate_flush([{"w": t["w"]} for t in trees], w)["w"].numpy(),
        np.asarray(jbuffer.aggregate_flush(jtrees, w)["w"]), **TOL)


@pytest.mark.parametrize("decay", [1.0, 0.7])
@pytest.mark.parametrize("k", [1, 3, 6])
def test_matches_the_slab_flush(k, decay):
    """The per-leaf oracle against the slab path: staged rows flushed
    with staleness weights move the params by the buffer's weighted
    mean (scale 1, SGD)."""
    params = _tree(100, shape=(33,))
    codec = slab_codec(params)
    agg_slab = SlabAggregator(codec, params, k_max=8)
    sbuf = SlabBuffer(agg_slab, staleness_decay=decay)
    gbuf = GradientBuffer(staleness_decay=decay)
    now = 4
    for i in range(k):
        g = _tree(200 + i, shape=(33,))
        sbuf.add(codec.encode(g), version=now - i % 3)
        gbuf.add(g, version=now - i % 3)
    before = agg_slab.params_tree()
    agg_slab.flush_apply(sbuf.weights(now), scale=1.0)
    after = agg_slab.params_tree()
    mean, n = gbuf.flush(now)
    assert n == k
    got = params_to_numpy({key: before[key] for key in before})
    moved = {"w": got["w"] - after["w"].numpy()}
    np.testing.assert_allclose(moved["w"], mean["w"].numpy(), **TOL)
    for a, b, m in zip(before["layers"], after["layers"], mean["layers"]):
        np.testing.assert_allclose((a["b"] - b["b"]).numpy(),
                                   m["b"].numpy(), **TOL)


def test_quickstart_runs_short_on_cpu(capsys):
    assert quickstart.main(["--device", "cpu", "--horizon", "0.5"]) == 0
    out = capsys.readouterr().out
    rows = [ln.split() for ln in out.splitlines()
            if ln.split()[:1] in (["async"], ["sync"], ["hybrid"])]
    assert [r[0] for r in rows] == ["async", "sync", "hybrid"]
    assert all(int(r[1]) > 0 for r in rows)
    # sync applies one update per 25 gradients, async one per gradient
    sync, asyn = rows[1], rows[0]
    assert int(sync[2]) < int(sync[1]) and int(asyn[1]) == int(asyn[2])


def test_threshold_functions_runs_short_on_cpu(capsys):
    assert threshold_functions.main(["--device", "cpu", "--horizon",
                                     "0.2"]) == 0
    out = capsys.readouterr().out
    for name in ("step 300 (paper)", "linear", "cosine", "exponential",
                 "decay=0.5"):
        assert name in out


def test_examples_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main(["--horizon", "0.1"])
