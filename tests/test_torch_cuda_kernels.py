"""The port's CUDA kernels (the three flushes, rmsnorm and
flash_attention) against their plain PyTorch versions, on the card, and
a small cluster run on the card against the same run on the CPU.

Marked ``cuda``: they skip on a host without a CUDA device.  The file
imports nothing of JAX, so it also runs where only the port is
installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.
Shapes are the main paths': K = 25 staging rows of the cnn-cifar slab
for the flushes, h2o-danube-1.8b's widths for rmsnorm and attention.
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
@pytest.mark.parametrize("scale_on_device", [False, True])
def test_cuda_adamw_is_one_launch(cuda, scale_on_device):
    """flush_adamw launches its kernel and nothing else (bc1/bc2 reach it
    as device pointers, scale by value or as a pointer), counted by the
    profiler's device kernels, and stays bitwise equal to its plain
    version."""
    from torch.profiler import ProfilerActivity, profile
    K, P = 25, 33 * TILE_P
    g = torch.randn(K, P, device=cuda)
    w = torch.full((K,), 1.0 / K, device=cuda)
    p = torch.randn(P, device=cuda)
    m = 0.1 * torch.randn(P, device=cuda)
    v = 0.01 * torch.randn(P, device=cuda).abs()
    bc1, bc2 = bias_correction(torch.tensor(3, device=cuda), 0.9, 0.95)
    scale = torch.tensor(0.01, device=cuda) if scale_on_device else 0.01
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)
    want = tref.flush_adamw_ref(g, w, p, m, v, bc1, bc2, scale, **kw)
    args = [t.clone() for t in (p, m, v)]
    ha.flush_adamw(g, w, *[t.clone() for t in (p, m, v)], bc1, bc2,
                   scale, **kw)              # built and loaded
    torch.cuda.synchronize()
    before = ha.LAUNCHES["flush_adamw"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = ha.flush_adamw(g, w, *args, bc1, bc2, scale, **kw)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert [e.name for e in kernels if "flush_adamw" in e.name] \
        and len(kernels) == 1, [e.name for e in kernels]
    assert ha.LAUNCHES["flush_adamw"] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_cluster_sync_matches_cpu(cuda):
    """A small mlp cluster sync run on the card (flush kernels) against
    the same run on the CPU (plain versions): same updates and server
    ledger, final params within rtol 1e-5 / atol 1e-6."""
    from repro_torch.api import ExperimentSpec
    from repro_torch.cluster.trainer import ClusterTrainer
    spec = ExperimentSpec(arch="mlp", backend="cluster", mode="sync",
                          schedule=None, cluster_workers=3, batch=16,
                          wall_budget_s=20.0, max_gradients=30)
    runs = {}
    for dev in ("cpu", cuda):
        trainer = ClusterTrainer(device=dev)
        before = ha.LAUNCHES["flush"]
        res = trainer.run(spec)
        runs[str(dev)] = (res, trainer.last_params,
                          ha.LAUNCHES["flush"] - before)
    (cres, cparams, cl), (gres, gparams, gl) = runs["cpu"], runs[str(cuda)]
    assert gres.num_updates == cres.num_updates == 10
    assert cl == 0 and gl == 10 + 1          # + the server's warm-up
    keys = ("applied", "dropped", "buffered", "pending_round", "updates")
    assert {k: gres.extra["accounting"][k] for k in keys} == \
        {k: cres.extra["accounting"][k] for k in keys}
    for k in cparams:
        torch.testing.assert_close(gparams[k], cparams[k], rtol=1e-5,
                                   atol=1e-6)


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


# ------------------------------------------------ rmsnorm, flash_attention
# Shapes: h2o-danube-1.8b's (D 2560; H 32, KV 8, d 80, window 4096) at
# the serve path's row counts, and the JAX package's kernel-test cases.
# Tolerances: rmsnorm f32 rtol 1e-5 / atol 1e-6, bf16 3e-2 (one ulp);
# attention f32 2e-4, as tests/kernels/test_kernels.py, bf16 rtol 1.6e-2
# / atol 1e-5 (two bf16 ulps; see test_cuda_flash_matches_plain).

@pytest.mark.cuda
@pytest.mark.parametrize("N", [4, 128, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rmsnorm_matches_plain(cuda, N, dtype):
    from repro_torch.kernels import rmsnorm as rms
    gen = torch.Generator(device=cuda).manual_seed(N)
    x = torch.randn(N, 2560, device=cuda, generator=gen).to(dtype)
    s = 1 + 0.1 * torch.randn(2560, device=cuda, generator=gen)
    before = rms.LAUNCHES["rmsnorm"]
    got, again = rms.rmsnorm(x, s), rms.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rms.LAUNCHES["rmsnorm"] == before + 2
    assert got.dtype == dtype and torch.equal(got, again)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), tref.rmsnorm_ref(x, s).float(),
                               rtol=tol, atol=1e-6 if tol == 1e-5 else tol)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 100, 8192])
def test_cuda_rmsnorm_other_widths(cuda, D):
    """A width the 16-byte vector path does not divide, and the widest."""
    from repro_torch.kernels import rmsnorm as rms
    x = torch.randn(33, D, device=cuda)
    s = torch.rand(D, device=cuda)
    torch.testing.assert_close(rms.rmsnorm(x, s), tref.rmsnorm_ref(x, s),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [4100, 8192, 40000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rmsnorm_wide_rows(cuda, D, dtype):
    """Rows that take several warps (4100 scalar, 8192 in vectors) and a
    row too wide to hold in registers (40000, read twice): within the
    tolerances above and bitwise equal run to run."""
    from repro_torch.kernels import rmsnorm as rms
    gen = torch.Generator(device=cuda).manual_seed(D)
    x = torch.randn(5, D, device=cuda, generator=gen).to(dtype)
    s = 1 + 0.1 * torch.randn(D, device=cuda, generator=gen)
    got, again = rms.rmsnorm(x, s), rms.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else \
        dict(rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(got.float(), tref.rmsnorm_ref(x, s).float(),
                               **tol)


FLASH_CASES = [
    # B, S, H, KV, d, causal, window, dtype
    (4, 32, 32, 8, 80, True, 4096, torch.bfloat16),    # serve prompt
    (1, 8192, 32, 8, 80, True, 4096, torch.bfloat16),  # long prefill
    (1, 128, 4, 4, 64, True, None, torch.float32),     # MHA
    (2, 256, 8, 2, 64, False, None, torch.float32),    # GQA 4:1
    (1, 512, 4, 1, 128, True, None, torch.float32),    # MQA
    (1, 256, 4, 2, 64, True, 32, torch.float32),
    (1, 256, 4, 2, 64, True, 100, torch.bfloat16),
    (1, 256, 4, 2, 16, False, 256, torch.float32),
    (2, 37, 4, 2, 80, True, 8, torch.float32),         # ragged S
    # the tensor-core kernel (bf16) at every head dim it takes
    (1, 128, 4, 4, 16, True, None, torch.bfloat16),    # MHA
    (2, 256, 8, 2, 32, False, None, torch.bfloat16),   # GQA 4:1
    (1, 512, 4, 1, 128, True, None, torch.bfloat16),   # MQA
    (1, 300, 4, 2, 96, False, 256, torch.bfloat16),    # ragged, windowed
    (2, 37, 4, 2, 64, True, 8, torch.bfloat16),        # ragged S
    (2, 32, 4, 1, 80, False, None, torch.bfloat16),    # S below one tile
    (1, 5000, 4, 1, 128, True, 4096, torch.bfloat16),  # 64-key tiles
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_cuda_flash_matches_plain(cuda, case):
    from repro_torch.kernels import flash_attention as fa
    B, S, H, KV, d, causal, window, dtype = case
    gen = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn(B, S, n, d, device=cuda, generator=gen)
               .to(dtype) for n in (H, KV, KV))
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    again = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 2
    assert got.dtype == dtype and torch.equal(got, again)
    want = tref.attention_ref(q, k, v, causal=causal, window=window)
    # bf16: both sides round f32 math to bf16 once, so they differ by
    # one bf16 ulp (at most 2^-7 of the value); rtol 1.6e-2 is two
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == torch.float32 else \
        dict(rtol=1.6e-2, atol=1e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
def test_cuda_serve_path_launches(cuda):
    """A small model's forward and decode step on the card: 2L+1 rmsnorm
    launches each, L flash launches per forward and none per decode."""
    from repro_torch.configs.registry import get_config, smoke_variant
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.models import model as M
    cfg = smoke_variant(get_config("h2o-danube-1.8b"))
    L = cfg.num_layers
    with torch.inference_mode():
        params = M.init_params(torch.Generator(device=cuda).manual_seed(0),
                               cfg)
        toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda)
        r0, f0 = rms.LAUNCHES["rmsnorm"], fa.LAUNCHES["flash_attention"]
        logits, _ = M.forward(params, {"tokens": toks}, cfg)
        assert (rms.LAUNCHES["rmsnorm"] - r0,
                fa.LAUNCHES["flash_attention"] - f0) == (2 * L + 1, L)
        cache = M.init_cache(cfg, 2, 40, device=cuda)
        r0 = rms.LAUNCHES["rmsnorm"]
        for i in range(40):
            step, cache = M.decode_step(params, cache, toks[:, i:i + 1], i,
                                        cfg)
        assert rms.LAUNCHES["rmsnorm"] - r0 == 40 * (2 * L + 1)
        assert fa.LAUNCHES["flash_attention"] - f0 == L
        torch.testing.assert_close(step[:, 0], logits[:, -1], rtol=2e-3,
                                   atol=1e-3)
