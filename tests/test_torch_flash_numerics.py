"""The arithmetic of the bf16 flash_attention kernel, emulated on the CPU.

``csrc/flash_attention.cu`` runs bf16 attention on the tensor cores:
scores from bf16 q and k accumulated in f32 with the scale applied after
the product, an online softmax over 128-key tiles, and the PV product
with P split into ``hi = bf16(p)`` and ``lo = bf16(p - hi)``, both
multiplied by the bf16 v tile into one f32 accumulator.  That kernel
runs only on the card; this file repeats its arithmetic in PyTorch
(test-only: nothing on the port's path uses the emulation) and holds it
against the JAX package's ``ref.attention_ref`` at the tolerance the
card's check uses for bf16 attention, rtol 1.6e-2 / atol 1e-5 (two bf16
ulps of each output).  It also shows why the split is there: one
rounding of p to bf16 breaks that tolerance on outputs that are near
zero by cancellation.  Inputs are bf16 values made with numpy from a
seed and handed to each framework as its own copy.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

torch.set_num_threads(2)

NEG_INF = -1e30
KEY_TILE = 128                      # keys per tile, as the kernel
RTOL, ATOL = 1.6e-2, 1e-5           # chip_smoke.py FLASH_TOL["bfloat16"]


def emulate(q, k, v, *, causal, window, split_p=True):
    """q (B,S,H,d), k/v (B,S,KV,d) bf16 -> (B,S,H,d) bf16, computed the
    way the kernel computes it."""
    B, S, H, d = q.shape
    G = H // k.shape[2]
    scale_log2 = torch.tensor(d ** -0.5 * math.log2(math.e),
                              dtype=torch.float32)
    pos = torch.arange(S)
    out = torch.empty(B, S, H, d, dtype=torch.bfloat16)
    for b in range(B):
        for h in range(H):
            qf = q[b, :, h].float()
            kf = k[b, :, h // G].float()
            vf = v[b, :, h // G].float()
            m = torch.full((S,), NEG_INF)
            l = torch.zeros(S)
            acc = torch.zeros(S, d)
            for k0 in range(0, S, KEY_TILE):
                keys = pos[k0:k0 + KEY_TILE]
                s = (qf @ kf[keys].T) * scale_log2
                ok = torch.ones(S, len(keys), dtype=torch.bool)
                if causal:
                    ok &= keys[None, :] <= pos[:, None]
                if window is not None:
                    ok &= keys[None, :] > pos[:, None] - window
                s = torch.where(ok, s, NEG_INF)
                m_new = torch.maximum(m, s.max(-1).values)
                alpha = torch.where(
                    m == NEG_INF, 0.0,
                    torch.exp2(torch.clamp(m - m_new, max=0.0)))
                p = torch.exp2(s - m_new[:, None])
                p = torch.where((m_new == NEG_INF)[:, None], 0.0, p)
                l = alpha * l + p.sum(-1)
                hi = p.to(torch.bfloat16).float()
                pv = hi @ vf[keys]
                if split_p:
                    pv = pv + (p - hi).to(torch.bfloat16).float() @ vf[keys]
                acc = alpha[:, None] * acc + pv
                m = m_new
            out[b, :, h] = (acc / torch.where(l == 0, 1.0, l)[:, None]
                            ).to(torch.bfloat16)
    return out


def _inputs(seed, B, S, H, KV, d):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(B, S, n, d)).astype(np.float32)
              for n in (H, KV, KV)]
    t = [torch.from_numpy(a.copy()).to(torch.bfloat16) for a in arrays]
    j = [jnp.asarray(a.copy()).astype(jnp.bfloat16) for a in arrays]
    return t, j


def _tol_used(got, want):
    """The largest |got - want| / (atol + rtol |want|): at most 1 when the
    tolerance holds."""
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    return float((np.abs(g - w) / (ATOL + RTOL * np.abs(w))).max())


@pytest.mark.parametrize("causal,window", [(True, 512), (True, None),
                                           (False, 100)])
def test_split_p_holds_the_bf16_tolerance(causal, window):
    (q, k, v), (qj, kj, vj) = _inputs(0, 1, 1024, 2, 1, 80)
    got = emulate(q, k, v, causal=causal, window=window)
    want = jref.attention_ref(qj, kj, vj, causal=causal, window=window)
    used = _tol_used(got, want)
    assert used <= 1.0, f"tol_used {used:.3f}"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL)


def test_one_rounding_of_p_breaks_the_bf16_tolerance():
    """Why the kernel splits P: the same arithmetic with p rounded once
    to bf16 misses the tolerance the split meets."""
    (q, k, v), (qj, kj, vj) = _inputs(0, 1, 1024, 2, 1, 80)
    want = jref.attention_ref(qj, kj, vj, causal=True, window=512)
    once = emulate(q, k, v, causal=True, window=512, split_p=False)
    split = emulate(q, k, v, causal=True, window=512)
    assert _tol_used(once, want) > 1.0 >= _tol_used(split, want)


def test_window_of_one_returns_v():
    """Causal with a window of 1 reaches only the key at the query's own
    position, so p = 1 (hi 1, lo 0) and the output is v there."""
    (q, k, v), _ = _inputs(1, 1, 200, 2, 2, 16)
    got = emulate(q, k, v, causal=True, window=1)
    assert torch.equal(got, v)
