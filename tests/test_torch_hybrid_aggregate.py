"""The port's flush wrappers against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; the JAX side
runs the Pallas kernels in interpret mode and the jnp oracles, as
``tests/kernels/test_hybrid_aggregate.py`` does.  The cases are that
file's.  Each framework gets its own copy of every numpy input: JAX may
alias a numpy buffer (``jnp.asarray``) and torch does
(``torch.from_numpy``).  The CUDA kernels themselves are held against
their plain versions in ``tests/test_torch_cuda_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref as jref
from repro.optim import bias_correction as jax_bias_correction
from repro_torch.kernels import hybrid_aggregate as ha
from repro_torch.optim import bias_correction

torch.set_num_threads(2)
I = dict(interpret=True)
TILE_P = ha.TILE_P


def _pair(a):
    """One numpy array as a JAX array and a torch tensor, each on its own
    copy of the buffer."""
    return jnp.asarray(np.array(a, copy=True)), \
        torch.from_numpy(np.array(a, copy=True))


def _rows(seed, K, P, dtype=np.float32):
    g = np.random.default_rng(seed).normal(size=(K, P)).astype(np.float32)
    gj, gt = _pair(g)
    if dtype == "bf16":
        return gj.astype(jnp.bfloat16), gt.to(torch.bfloat16)
    return gj, gt


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_close(got, want, name, rtol, atol):
    """allclose, with the output's name, the share of elements out of
    tolerance and the largest error in the message."""
    a, b = _f32(got), _f32(want)
    bad = ~np.isclose(a, b, rtol=rtol, atol=atol)
    np.testing.assert_allclose(
        a, b, rtol=rtol, atol=atol,
        err_msg=f"{name}: {bad.mean():.4%} of {bad.size} elements out of "
                f"tolerance, max abs err {np.abs(a - b).max():.3e}")


def test_tile_matches_reference():
    from repro.kernels.hybrid_aggregate import TILE_P as JAX_TILE_P
    assert ha.TILE_P == JAX_TILE_P and ha.TILE_P % ha.BLOCK_P == 0


@pytest.mark.parametrize("K", [1, 2, 7, 25])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flush_shapes_dtypes(K, dtype):
    P = TILE_P * (1 if K > 2 else 2)
    gj, gt = _rows(K, K, P, dtype)
    w = np.random.default_rng(K + 1).uniform(size=K).astype(np.float32)
    w /= w.sum()
    wj, wt = _pair(w)
    got = ha.flush(gt, wt)
    assert got.dtype == gt.dtype and got.shape == (P,)
    tol = 1e-5 if dtype == "f32" else 3e-2
    for want in (ops.hybrid_flush(gj, wj, **I), jref.flush_ref(gj, wj)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol,
                                   atol=1e-6 if dtype == "f32" else tol)


@pytest.mark.parametrize("k", [1, 3, 6])
def test_flush_zero_weight_masking(k):
    """Rows past k carry weight 0 and add exactly nothing, even over
    stale junk."""
    K_max, P = 6, TILE_P
    g = np.random.default_rng(k).normal(size=(K_max, P)).astype(np.float32)
    junk = g.copy()
    junk[k:] = 1e30
    w = np.zeros(K_max, np.float32)
    w[:k] = np.random.default_rng(k + 7).uniform(size=k) + 0.1
    (junk_j, junk_t), (wj, wt) = _pair(junk), _pair(w)
    got = ha.flush(junk_t, wt)
    want = ops.hybrid_flush(junk_j, wj, **I)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-6)
    clean = ha.flush(torch.from_numpy(g[:k].copy()),
                     torch.from_numpy(w[:k].copy()))
    np.testing.assert_array_equal(_f32(got), _f32(clean))


@pytest.mark.parametrize("beta", [0.0, 0.9])
def test_flush_momentum(beta):
    K, P = 4, TILE_P
    gj, gt = _rows(0, K, P)
    w = np.full(K, 1.0 / K, np.float32)
    m = np.random.default_rng(1).normal(size=P).astype(np.float32)
    (wj, wt), (mj, m_t) = _pair(w), _pair(m)
    u, m2 = ha.flush_momentum(gt, wt, m_t, beta)
    np.testing.assert_array_equal(m_t.numpy(), m)   # CPU: input untouched
    for uw, mw in (ops.hybrid_flush_momentum(gj, wj, mj, beta, **I),
                   jref.flush_momentum_ref(gj, wj, mj, beta)):
        np.testing.assert_allclose(_f32(u), _f32(uw), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_f32(m2), _f32(mw), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("count", [1, 10])
def test_flush_adamw(wd, count):
    K, P = 4, TILE_P
    b1, b2, eps, scale = 0.9, 0.95, 1e-8, 0.01
    rng = np.random.default_rng(count)
    gj, gt = _rows(0, K, P)
    w = np.full(K, 1.0 / K, np.float32)
    p = rng.normal(size=P).astype(np.float32)
    m = (0.1 * rng.normal(size=P)).astype(np.float32)
    v = (0.01 * np.abs(rng.normal(size=P))).astype(np.float32)
    bc1, bc2 = bias_correction(count, b1, b2)
    jbc1, jbc2 = jax_bias_correction(count, b1, b2)
    np.testing.assert_allclose([float(bc1), float(bc2)],
                               [float(jbc1), float(jbc2)], rtol=1e-6)
    (wj, wt), (pj, pt), (mj, mt), (vj, vt) = map(_pair, (w, p, m, v))
    got = ha.flush_adamw(gt, wt, pt, mt, vt, bc1, bc2, scale, b1=b1, b2=b2,
                         eps=eps, weight_decay=wd)
    args = (gj, wj, pj, mj, vj, jbc1, jbc2, scale)
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=wd)
    for which, want in (("pallas", ops.hybrid_flush_adamw(*args, **kw, **I)),
                        ("oracle", jref.flush_adamw_ref(*args, **kw))):
        for g_a, w_a, name in zip(got, want, ("params", "mu", "nu")):
            _assert_close(g_a, w_a, f"{name} vs the {which}", rtol=1e-5,
                          atol=1e-6)


def test_adamw_plain_version_takes_the_correctly_rounded_sqrt():
    """The AdamW plain version's square root is the correctly rounded
    float32 one (numpy's, and the CUDA kernel's ``__fsqrt_rn``), not
    ``torch.sqrt``'s CPU path: MKL's VML sqrt, within 1 ulp, and split
    across the intra-op threads, whose first call in a process has
    returned one thread's half with errors up to 2.9e-4 (ROADMAP C.8).
    With ``torch.sqrt`` in the plain version, 6 of these 24,576 params
    differ by an ulp."""
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(8)
    P = 3 * TILE_P
    x = torch.from_numpy(rng.uniform(1e-6, 4.0, P).astype(np.float32))
    np.testing.assert_array_equal(tref.sqrt_rn(x).numpy(),
                                  np.sqrt(x.numpy()))
    g = torch.from_numpy(rng.normal(size=(2, P)).astype(np.float32))
    w = torch.tensor([0.25, 0.75])
    p, m, v = (torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=P), 0.1 * rng.normal(size=P),
        0.01 * np.abs(rng.normal(size=P))))
    bc1, bc2 = bias_correction(3, 0.9, 0.95)
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)
    got, m_new, v_new = tref.flush_adamw_ref(g, w, p, m, v, bc1, bc2, 0.01,
                                             **kw)
    den = torch.from_numpy(np.sqrt((v_new / bc2).numpy())) + 1e-8
    want = p - 0.01 * ((m_new / bc1) / den + 0.01 * p)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("bad", ["shape", "dtype", "weights", "k", "device"])
def test_wrapper_rejects(bad):
    g = torch.zeros(3, ha.BLOCK_P)
    w = torch.ones(3)
    if bad == "shape":
        g = torch.zeros(3, ha.BLOCK_P + 8)
    elif bad == "dtype":
        g = g.double()
    elif bad == "weights":
        w = torch.ones(2)
    elif bad == "k":
        g, w = torch.zeros(ha.MAX_K + 1, ha.BLOCK_P), torch.ones(ha.MAX_K + 1)
    else:
        w = w.to("meta")
    with pytest.raises((ValueError, TypeError)):
        ha.flush(g, w)


def test_cpu_path_never_counts_a_launch():
    ha.reset_launch_counts()
    ha.flush(torch.ones(2, ha.BLOCK_P), torch.ones(2))
    assert ha.LAUNCHES == {"flush": 0, "flush_momentum": 0,
                           "flush_adamw": 0}
