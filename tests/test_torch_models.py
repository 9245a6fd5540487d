"""The port's models, loss and gradient slab against the reference's, on
the reference's initial parameters carried over as numpy arrays."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.slab import slab_codec as jax_slab_codec
from repro.data import synthetic as jsyn
from repro.models import cnn as jcnn
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.slab import slab_codec
from repro_torch.data import synthetic as tsyn
from repro_torch.models import cnn as tcnn

torch.set_num_threads(2)

# arch -> (jax init, jax forward, port forward, image shape or None)
ARCHS = {
    "mlp": (lambda k: jcnn.init_mlp_clf(k), jcnn.mlp_clf_forward,
            tcnn.mlp_clf_forward, None),
    "cnn-mnist": (lambda k: jcnn.init_cnn(k, (28, 28, 1)),
                  jcnn.cnn_forward, tcnn.cnn_forward, (28, 28, 1)),
    "cnn-cifar": (lambda k: jcnn.init_cnn(k, (32, 32, 3)),
                  jcnn.cnn_forward, tcnn.cnn_forward, (32, 32, 3)),
}


def _copies(tree):
    """A JAX tree as numpy arrays that share no memory with it."""
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _batch(arch, n=8, seed=0):
    rng = np.random.default_rng(seed)
    shape = ARCHS[arch][3] or (20,)
    x = rng.normal(size=(n,) + shape).astype(np.float32)
    y = rng.integers(0, 10, size=n).astype(np.int32)
    return x, y


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_loss_accuracy_and_grad_slab(arch):
    jinit, jfwd, tfwd, _ = ARCHS[arch]
    params = _copies(jinit(jax.random.PRNGKey(0)))
    tparams = params_from_numpy(params)
    x, y = _batch(arch)
    xt, yt = torch.from_numpy(x.copy()), torch.from_numpy(y.copy())

    np.testing.assert_allclose(tfwd(tparams, xt).numpy(),
                               np.asarray(jfwd(params, x)),
                               rtol=1e-5, atol=1e-6)
    jloss = lambda p: jcnn.nll_loss(jfwd(p, x), y)  # noqa: E731
    tloss = lambda p: tcnn.nll_loss(tfwd(p, xt), yt)  # noqa: E731
    np.testing.assert_allclose(float(tloss(tparams)),
                               float(jloss(params)), rtol=1e-5, atol=1e-6)
    assert float(tcnn.accuracy(tfwd(tparams, xt), yt)) == \
        float(jcnn.accuracy(jfwd(params, x), y))

    jgrad = jax_slab_codec(params).encode(jax.grad(jloss)(params))
    tgrad = slab_codec(tparams).encode(torch.func.grad(tloss)(tparams))
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["cnn-mnist", "cnn-cifar"])
def test_conv_layout_is_nhwc_hwio(arch):
    """A one-hot input pixel and one-hot fc1 row show that the flatten
    before fc1 is in NHWC order, as in the reference."""
    jinit, jfwd, tfwd, shape = ARCHS[arch]
    params = _copies(jinit(jax.random.PRNGKey(3)))
    params["fc1_w"] = np.zeros_like(params["fc1_w"])
    params["fc1_w"][5, :] = 1.0
    x = np.zeros((1,) + shape, np.float32)
    x[0, 1, 2, 0] = 3.0
    np.testing.assert_allclose(
        tfwd(params_from_numpy(params), torch.from_numpy(x.copy())).numpy(),
        np.asarray(jfwd(params, x)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,kw", [
    ("random_classification", dict(n=500)),
    ("mnist_like", dict(n_train=64, n_test=16)),
    ("cifar10_like", dict(n_train=64, n_test=16)),
])
def test_datasets_identical(name, kw):
    for a, b in zip(getattr(tsyn, name)(seed=3, **kw),
                    getattr(jsyn, name)(seed=3, **kw)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_params_round_trip_keeps_names_shapes_dtypes():
    params = _copies(jcnn.init_cnn(jax.random.PRNGKey(0), (28, 28, 1)))
    params["fc2_b"] = np.asarray(jnp.asarray(params["fc2_b"],
                                             jnp.bfloat16))
    back = params_to_numpy(params_from_numpy(params))
    assert sorted(back) == sorted(params)
    for k in params:
        assert back[k].dtype == params[k].dtype, k
        assert back[k].shape == params[k].shape, k
        np.testing.assert_array_equal(back[k].astype(np.float32),
                                      params[k].astype(np.float32))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_port_init_has_reference_shapes_and_scale(arch):
    jparams = ARCHS[arch][0](jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    shape = ARCHS[arch][3]
    tparams = tcnn.init_cnn(gen, shape) if shape else tcnn.init_mlp_clf(gen)
    assert sorted(tparams) == sorted(jparams)
    for k, v in jparams.items():
        assert tuple(tparams[k].shape) == v.shape, k
        assert tparams[k].dtype == torch.float32
        if k.endswith("_b") or k.startswith("b"):
            assert not tparams[k].any(), k
        else:
            ratio = float(tparams[k].std()) / float(jnp.std(v))
            assert 0.8 < ratio < 1.25, (k, ratio)
