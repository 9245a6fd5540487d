"""The CUDA flush kernels against their plain PyTorch versions, on the
card.

Marked ``cuda``: they skip on a host without a CUDA device.  The file
imports nothing of JAX, so it also runs where only the port is
installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.
Shapes are the main path's (K = 25 staging rows, the cnn-cifar slab).
"""
import pytest
import torch

from repro_torch.kernels import hybrid_aggregate as ha
from repro_torch.kernels import ref as tref
from repro_torch.optim import bias_correction

torch.set_num_threads(2)
TILE_P = ha.TILE_P


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flush_matches_plain(cuda, dtype):
    K, P = 25, 33 * TILE_P
    g = torch.randn(K, P, device=cuda).to(dtype)
    w = torch.rand(K, device=cuda)
    w[7:] = 0
    g[7:] = 1e30
    before = ha.LAUNCHES["flush"]
    got = ha.flush(g, w)
    again = ha.flush(g, w)
    torch.cuda.synchronize()
    assert ha.LAUNCHES["flush"] == before + 2
    assert torch.equal(got, again)
    want = tref.flush_ref(g, w)
    tol = 1e-6 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("beta", [0.0, 0.9])
def test_cuda_momentum_matches_plain(cuda, beta):
    K, P = 25, 33 * TILE_P
    g = torch.randn(K, P, device=cuda)
    w = torch.full((K,), 1.0 / K, device=cuda)
    m = torch.randn(P, device=cuda)
    want_u, want_m = tref.flush_momentum_ref(g, w, m, beta)
    u, m2 = ha.flush_momentum(g, w, m.clone(), beta)
    torch.cuda.synchronize()
    torch.testing.assert_close(m2, want_m, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(u, want_u, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("count", [1, 10])
def test_cuda_adamw_matches_plain(cuda, wd, count):
    K, P = 25, 33 * TILE_P
    g = torch.randn(K, P, device=cuda)
    w = torch.full((K,), 1.0 / K, device=cuda)
    p = torch.randn(P, device=cuda)
    m = 0.1 * torch.randn(P, device=cuda)
    v = 0.01 * torch.randn(P, device=cuda).abs()
    bc1, bc2 = bias_correction(torch.tensor(count, device=cuda), 0.9, 0.95)
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=wd)
    want = tref.flush_adamw_ref(g, w, p, m, v, bc1, bc2, 0.01, **kw)
    got = ha.flush_adamw(g, w, p.clone(), m.clone(), v.clone(), bc1, bc2,
                         0.01, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_cuda_aggregator_matches_cpu(cuda, opt):
    """The aggregator's flushes on the card (kernels) against the same
    flushes on the CPU (plain versions), and one launch per flush."""
    import numpy as np
    from repro_torch.core.slab import SlabAggregator, slab_codec
    from repro_torch.optim import SlabOptimizer
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(300, 40, generator=gen),
              "b": torch.randn(40, generator=gen)}
    aggs = {dev: SlabAggregator(
        slab_codec(params), {k: v.to(dev) for k, v in params.items()}, 5,
        optimizer=SlabOptimizer(opt, weight_decay=0.01))
        for dev in ("cpu", cuda)}
    kernel = {"sgd": "flush", "momentum": "flush_momentum",
              "adamw": "flush_adamw"}[opt]
    before = ha.LAUNCHES[kernel]
    rng = np.random.default_rng(1)
    p_pad = aggs["cpu"].codec.padded_size
    for k in (1, 3, 5, 2):
        for slot in range(k):
            row = torch.from_numpy(rng.normal(size=p_pad).astype(np.float32))
            for dev, agg in aggs.items():
                agg.stage(row.to(dev), slot)
        w = 0.5 ** rng.integers(0, 3, size=k)
        pubs = {dev: agg.flush_apply(w, 0.01 * k) for dev, agg in aggs.items()}
        torch.testing.assert_close(pubs[cuda].cpu(), pubs["cpu"], rtol=1e-5,
                                   atol=1e-6)
    torch.cuda.synchronize()
    assert ha.LAUNCHES[kernel] == before + 4
