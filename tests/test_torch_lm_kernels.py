"""The port's rmsnorm and flash_attention against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions
(``repro_torch.kernels.ref``); the JAX side runs its Pallas kernels in
interpret mode and its jnp oracles, as ``tests/kernels/test_kernels.py``
does.  The cases are that file's, with S <= 256.  Inputs are made with
numpy from a seed and handed to each framework as its own copy.  The
CUDA kernels themselves are held against their plain versions in
``tests/test_torch_cuda_kernels.py``.

Tolerances: rmsnorm f32 rtol 1e-5 / atol 1e-6 (the repo's f32 rule),
bf16 3e-2 (one bf16 ulp is 2^-8 relative); attention f32 2e-4 and bf16
5e-2, those of ``tests/kernels/test_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as trms

torch.set_num_threads(2)
I = dict(interpret=True)
BF16 = "bf16"


def _pair(a, dtype="f32"):
    """One numpy array as a JAX array and a torch tensor that share no
    memory with it or with each other."""
    j = jnp.asarray(np.array(a, copy=True))
    t = torch.from_numpy(np.array(a, copy=True))
    if dtype == BF16:
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------- rmsnorm

@pytest.mark.parametrize("shape", [(256, 128), (4, 64, 512), (2, 2, 32, 256)])
@pytest.mark.parametrize("dtype", ["f32", BF16])
def test_rmsnorm_sweep(shape, dtype):
    xj, xt = _pair(_normal(0, shape), dtype)
    sj, st = _pair(_normal(1, shape[-1:]))
    got = ops.rmsnorm(xt, st)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "f32" \
        else dict(rtol=3e-2, atol=3e-2)
    for want in (jops.rmsnorm(xj, sj, **I), jref.rmsnorm_ref(xj, sj)):
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_array_equal(_np(got), _np(ref.rmsnorm_ref(xt, st)))


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_rmsnorm_matches_model_norm(eps):
    from repro.models.norms import rmsnorm as jax_model_rmsnorm
    from repro_torch.models.norms import rmsnorm as model_rmsnorm
    xj, xt = _pair(_normal(2, (8, 128)))
    sj, st = _pair(1.0 + 0.1 * _normal(3, (128,)))
    got = model_rmsnorm({"scale": st}, xt, eps)
    for want in (jax_model_rmsnorm({"scale": sj}, xj, eps),
                 jops.rmsnorm(xj, sj, eps, **I)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-6)


def test_rmsnorm_wrapper_rejects():
    x, s = torch.ones(4, 8), torch.ones(8)
    with pytest.raises(ValueError):
        trms.rmsnorm(x, torch.ones(7))
    with pytest.raises(ValueError):
        trms.rmsnorm(x, s.double())
    with pytest.raises(TypeError):
        trms.rmsnorm(x.double(), s)
    with pytest.raises(ValueError):
        trms.rmsnorm(torch.ones(8), s)
    with pytest.raises(RuntimeError, match="forward only"):
        trms.rmsnorm(x.requires_grad_(), s)


# --------------------------------------------------------- flash attention

def _qkv(seed, B, S, H, KV, d, dtype="f32"):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(B, S, n, d)).astype(np.float32)
              for n in (H, KV, KV)]
    pairs = [_pair(a, dtype) for a in arrays]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("B,S,H,KV,d", [
    (1, 128, 4, 4, 64),     # MHA
    (2, 256, 8, 2, 64),     # GQA 4:1
    (1, 256, 4, 1, 128),    # MQA
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_shapes(B, S, H, KV, d, causal):
    (qj, kj, vj), (qt, kt, vt) = _qkv(0, B, S, H, KV, d)
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    assert got.shape == qt.shape and got.dtype == qt.dtype
    for want in (jops.flash_attention(qj, kj, vj, causal=causal, **I),
                 jref.attention_ref(qj, kj, vj, causal=causal)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("dtype", ["f32", BF16])
def test_flash_dtypes(dtype):
    (qj, kj, vj), (qt, kt, vt) = _qkv(1, 1, 256, 4, 2, 64, dtype)
    got = ops.flash_attention(qt, kt, vt)
    assert got.dtype == qt.dtype
    tol = 2e-4 if dtype == "f32" else 5e-2
    for want in (jops.flash_attention(qj, kj, vj, **I),
                 jref.attention_ref(qj, kj, vj)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("window", [32, 100, 256])
@pytest.mark.parametrize("dtype", ["f32", BF16])
def test_flash_sliding_window(window, dtype):
    (qj, kj, vj), (qt, kt, vt) = _qkv(2, 1, 256, 4, 2, 64, dtype)
    got = ops.flash_attention(qt, kt, vt, causal=True, window=window)
    tol = 2e-4 if dtype == "f32" else 5e-2
    for want in (jops.flash_attention(qj, kj, vj, causal=True,
                                      window=window, **I),
                 jref.attention_ref(qj, kj, vj, causal=True,
                                    window=window)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("qb,kb", [(64, 64), (64, 128), (128, 64),
                                   (128, 128)])
def test_flash_block_size_invariance(qb, kb):
    """The port (which names no tiling) against the reference at each
    of its tile sizes: the function does not depend on the tiling."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(3, 1, 256, 2, 2, 64)
    got = ops.flash_attention(qt, kt, vt)
    want = jops.flash_attention(qj, kj, vj, q_block=qb, kv_block=kb, **I)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_flash_matches_model_rowblock():
    """The port's flash against the JAX model's rowblock path, which is
    the function the JAX model computes."""
    from repro.models.attention import rowblock_attention
    from repro.models.config import ATTN, MLP, ModelConfig
    cfg = ModelConfig(name="x", arch_type="dense", d_model=64,
                      vocab_size=10, block_pattern=((ATTN, MLP),),
                      num_groups=1, num_heads=4, num_kv_heads=2,
                      head_dim=16, d_ff=64, dtype="float32", remat="none")
    (qj, kj, vj), (qt, kt, vt) = _qkv(4, 2, 256, 4, 2, 16)
    pos = jnp.broadcast_to(jnp.arange(256), (2, 256))
    want = rowblock_attention(qj, kj, vj, pos, cfg, q_block=128)
    got = ops.flash_attention(qt, kt, vt, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("S,window", [(37, None), (37, 8), (1, None)])
def test_flash_any_sequence_length(S, window):
    """The port takes an S that no block divides (the JAX kernel does
    not); it still computes the oracle's function."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(5, 2, S, 4, 2, 16)
    got = ops.flash_attention(qt, kt, vt, causal=True, window=window)
    want = jref.attention_ref(qj, kj, vj, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_flash_plain_version_is_the_cpu_path():
    (_, _, _), (qt, kt, vt) = _qkv(6, 1, 64, 4, 2, 16)
    tflash.reset_launch_counts()
    a = ops.flash_attention(qt, kt, vt, window=16)
    b = ref.attention_ref(qt, kt, vt, window=16)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert tflash.LAUNCHES == {"flash_attention": 0}


@pytest.mark.parametrize("bad", ["rank", "kv_shape", "groups", "dtype",
                                 "window", "grad", "mixed_dtype"])
def test_flash_wrapper_rejects(bad):
    q, k, v = torch.ones(1, 8, 4, 16), torch.ones(1, 8, 2, 16), \
        torch.ones(1, 8, 2, 16)
    kw = {}
    err = ValueError
    if bad == "rank":
        q = q[0]
    elif bad == "kv_shape":
        k = v = torch.ones(1, 9, 2, 16)
    elif bad == "groups":
        k = v = torch.ones(1, 8, 3, 16)
    elif bad == "dtype":
        q, err = q.double(), TypeError
    elif bad == "window":
        kw = dict(window=0)
    elif bad == "grad":
        q, err = q.requires_grad_(), RuntimeError
    else:
        k, err = k.to(torch.bfloat16), TypeError
    with pytest.raises(err):
        ops.flash_attention(q, k, v, **kw)
