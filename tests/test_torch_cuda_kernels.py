"""The port's CUDA kernels (the three flushes, rmsnorm and
flash_attention) against their plain PyTorch versions, on the card, and
small cluster runs on the card: against the same run on the CPU, and
with worker processes against worker threads.

Marked ``cuda``: they skip on a host without a CUDA device.  The file
imports nothing of JAX, so it also runs where only the port is
installed (its proc test spawns worker processes that open the card
too):
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.
Shapes are the main paths': K = 25 staging rows of the cnn-cifar slab
for the flushes, h2o-danube-1.8b's widths for rmsnorm and attention.
The training forward with remat "block" against it without, for each
mixer family (``tests/test_torch_remat.py``'s cases on the card).
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
def test_cuda_proc_sync_matches_inproc(cuda):
    """4 worker processes sharing the card against 4 worker threads, the
    same small mlp sync run: bitwise equal final params, every update
    through the flush kernel in the parent."""
    from repro_torch.api import ExperimentSpec
    from repro_torch.cluster.trainer import ClusterTrainer
    base = ExperimentSpec(arch="mlp", backend="cluster", mode="sync",
                          schedule=None, cluster_workers=4, batch=16,
                          wall_budget_s=60.0, max_gradients=40)
    finals = {}
    for transport in ("inproc", "proc"):
        trainer = ClusterTrainer(device=cuda)
        before = ha.LAUNCHES["flush"]
        res = trainer.run(base.with_(transport=transport))
        a = res.extra["accounting"]
        assert res.num_updates == 10 and a["applied"] == 40
        assert ha.LAUNCHES["flush"] - before == 10 + 1
        finals[transport] = trainer.last_params
    for k in finals["inproc"]:
        assert torch.equal(finals["inproc"][k], finals["proc"][k]), k


@pytest.mark.cuda
def test_cuda_host_sync_matches_inproc(cuda):
    """4 joined workers (``python -m repro_torch join --device cuda``, one
    process each) sharing the card with their leader, against 4 worker
    threads, the same small mlp sync run: bitwise equal final params,
    every joiner exits 0, every update through the flush kernel in the
    leader."""
    from repro_torch.api import ExperimentSpec
    from repro_torch.cluster.hostlink import spawn_join_process
    from repro_torch.cluster.trainer import ClusterTrainer
    base = ExperimentSpec(arch="mlp", backend="cluster", mode="sync",
                          schedule=None, cluster_workers=4, batch=16,
                          wall_budget_s=60.0, max_gradients=40)
    finals = {}
    for transport in ("inproc", "host"):
        spec = base.with_(transport=transport, listen="127.0.0.1:0")
        trainer = ClusterTrainer(device=cuda)
        runtime = trainer.build_runtime(spec)
        procs = [spawn_join_process(runtime.listen_address, device="cuda",
                                    reconnect_s=0)
                 for _ in range(4 if transport == "host" else 0)]
        before = ha.LAUNCHES["flush"]
        try:
            res = trainer.finish(runtime, spec)
        finally:
            codes = [p.wait(timeout=120) for p in procs]
        assert codes == [0] * len(procs), codes
        a = res.extra["accounting"]
        assert res.num_updates == 10 and a["applied"] == 40
        assert res.extra["telemetry"]["ledger_check"]["consistent"]
        assert ha.LAUNCHES["flush"] - before == 10 + 1
        finals[transport] = trainer.last_params
    for k in finals["inproc"]:
        assert torch.equal(finals["inproc"][k], finals["host"][k]), k


@pytest.mark.cuda
def test_cuda_flush_reads_a_grown_staging_buffer(cuda):
    """A 20-row aggregator grown to 25 rows on the card keeps its staged
    rows, and the flush and AdamW kernels read the new buffer: bitwise
    equal to their plain versions over all 25 rows, one launch each,
    counted at K 25."""
    from repro_torch.core.slab import SlabAggregator, slab_codec
    params = {"w": torch.randn(3 * TILE_P, device=cuda)}
    agg = SlabAggregator(slab_codec(params), params, 20)
    rows = torch.randn(25, 3 * TILE_P, device=cuda)
    for i in range(20):
        agg.stage(rows[i], i)
    agg.grow(25)
    for i in range(20, 25):
        agg.stage(rows[i], i)
    (staging,) = agg._staging
    assert staging.shape == (25, 3 * TILE_P) and torch.equal(staging, rows)
    w = torch.rand(25, device=cuda) + 0.1
    wn = w / w.sum()
    before = ha.LAUNCHES_BY_K.get(("flush", 25), 0)
    assert torch.equal(ha.flush(staging, w), tref.flush_ref(staging, w))
    assert ha.LAUNCHES_BY_K[("flush", 25)] == before + 1
    p = torch.randn(3 * TILE_P, device=cuda)
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    # the bias corrections as the aggregator passes them: device scalars
    bc1, bc2 = bias_correction(torch.tensor(3, dtype=torch.int32,
                                            device=cuda), 0.9, 0.95)
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0)
    want = tref.flush_adamw_ref(staging, wn, p, mu, nu, bc1, bc2, 0.01, **kw)
    got = ha.flush_adamw(staging, wn, p.clone(), mu.clone(), nu.clone(),
                         bc1, bc2, 0.01, **kw)
    assert ha.LAUNCHES_BY_K[("flush_adamw", 25)] >= 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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

@pytest.fixture
def cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"needs at least 2 CUDA cards to spread the chunks "
                    f"over, found {n}")
    return n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_cuda_aggregator_chunks_across_cards(cards, opt, dtype):
    """A multi-million-parameter slab's chunks spread over the host's
    cards (chunk i on cuda:{i % n}) flush bitwise as on one card."""
    import numpy as np
    from repro_torch.core.slab import SlabAggregator, slab_codec
    from repro_torch.optim import SlabOptimizer
    params = {"w": torch.randn(600 * TILE_P - 7, device="cuda:0")}
    codec = slab_codec(params, slab_dtype=dtype)
    rows = [torch.randn(codec.padded_size, device="cuda:0").to(
        codec.slab_dtype) for _ in range(3)]
    outs = []
    for devices in (None, ["cuda:0"]):
        agg = SlabAggregator(codec, params, 3, devices=devices,
                             optimizer=SlabOptimizer(opt))
        for w in ([1.0, 0.5, 0.25], [0.4, 0.4]):
            for slot, r in enumerate(rows[:len(w)]):
                agg.stage(r, slot)
            agg.flush_apply(np.asarray(w, np.float32), 0.1)
        outs.append((agg.params_slab.cpu(), agg.opt_state_host(),
                     agg.chunk_devices))
    (p_n, s_n, d_n), (p_1, s_1, d_1) = outs
    assert d_n == tuple(torch.device("cuda", i % cards)
                        for i in range(len(d_n))) and len(d_n) == cards
    assert d_1 == (torch.device("cuda", 0),)
    assert torch.equal(p_n, p_1)
    if s_1 is not None:
        for k, v in s_1.items():
            np.testing.assert_array_equal(s_n[k], v, err_msg=k)


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


# ------------------------------------------------ telemetry and serving

@pytest.mark.cuda
def test_cuda_lm_tiny_gradient_matches_cpu(cuda):
    """lm-tiny's gradient slab (the plain training forward under
    ``torch.func.grad``) on the card against the CPU, on the same
    params and batch: rtol 1e-5 / atol 1e-6 (float32 products in full
    float32 on the card)."""
    from repro_torch.api import ExperimentSpec
    from repro_torch.convert import tree_to
    from repro_torch.core.slab import slab_codec
    from repro_torch.serve.workload import lm_tiny_workload
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = ExperimentSpec(arch="lm-tiny", smoke=True)
    loss, params, data, _ = lm_tiny_workload(spec, torch.device("cpu"))
    x, y = torch.from_numpy(data[0][:32]), torch.from_numpy(data[1][:32])
    codec = slab_codec(params)
    want = codec.encode(torch.func.grad(loss)(params, x, y))
    got = codec.encode(torch.func.grad(loss)(
        tree_to(params, cuda), x.to(cuda), y.to(cuda)))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_rmsnorm_at_the_serve_clients_shape(cuda):
    """lm-tiny's decode norm: 2 rows of D 64, f32, one launch a call."""
    from repro_torch.kernels import rmsnorm as rms
    gen = torch.Generator(device=cuda).manual_seed(64)
    x = torch.randn(2, 64, device=cuda, generator=gen)
    s = 1 + 0.1 * torch.randn(64, device=cuda, generator=gen)
    before = rms.LAUNCHES["rmsnorm"]
    got = rms.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rms.LAUNCHES["rmsnorm"] == before + 1
    torch.testing.assert_close(got, tref.rmsnorm_ref(x, s), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.cuda
def test_cuda_kernels_at_lm_tiny_metric_forward_shapes(cuda):
    """lm-tiny's accuracy runs the serving forward on its 512 held-out
    sequences of 16: rmsnorm at 8192 rows of D 64 and flash_attention at
    B 512, S 16, 4 heads of 16, causal, both f32, against their plain
    versions (rmsnorm rtol 1e-5 / atol 1e-6, attention 2e-4)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    gen = torch.Generator(device=cuda).manual_seed(65)
    x = torch.randn(8192, 64, device=cuda, generator=gen)
    s = 1 + 0.1 * torch.randn(64, device=cuda, generator=gen)
    torch.testing.assert_close(rms.rmsnorm(x, s), tref.rmsnorm_ref(x, s),
                               rtol=1e-5, atol=1e-6)
    q, k, v = (torch.randn(512, 16, 4, 16, device=cuda, generator=gen)
               for _ in range(3))
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(got, tref.attention_ref(q, k, v, causal=True),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_cuda_readers_leave_a_sync_run_bitwise_unchanged(cuda):
    """A small mlp host sync run on the card (two joined workers as
    threads) with a stats reader and a serve client attached, against
    the same run with worker threads and no reader: bitwise equal final
    params; the reader saw pushes and the client params."""
    import threading

    from repro_torch.api import ExperimentSpec
    from repro_torch.cluster.hostlink import run_joined_worker
    from repro_torch.cluster.trainer import ClusterTrainer
    from repro_torch.obs.top import StatsClient
    from repro_torch.serve.client import ServeClient
    base = ExperimentSpec(arch="mlp", backend="cluster", mode="sync",
                          schedule=None, cluster_workers=2, batch=16,
                          wall_budget_s=60.0, max_gradients=20)
    plain = ClusterTrainer(device=cuda)
    plain.run(base)
    spec = base.with_(transport="host", listen="127.0.0.1:0")
    trainer = ClusterTrainer(device=cuda)
    runtime = trainer.build_runtime(spec)
    addr = runtime.listen_address
    codes = {}
    joiners = [threading.Thread(target=lambda i=i: codes.update(
        {i: run_joined_worker(addr, verbose=False, device="cuda")}),
        daemon=True) for i in range(2)]
    for t in joiners:
        t.start()
    reader = StatsClient(addr)
    client = ServeClient(addr, device=cuda)
    try:
        res = trainer.finish(runtime, spec)
    finally:
        for t in joiners:
            t.join(timeout=60)
        reader.close()
        client.close()
    assert codes == {0: 0, 1: 0}, codes
    assert res.extra["accounting"]["applied"] == 20
    assert res.extra["serving"]["clients"] == 1
    assert res.extra["serving"]["stats_clients"] == 1
    assert reader.pushes_seen + len(reader.backfill) > 0
    assert client.versions_seen
    for k in plain.last_params:
        assert torch.equal(plain.last_params[k], trainer.last_params[k]), k


# ---------------------------------------- chunk mask, MLA head dims

# B, S, H, KV, d, d_v, causal, window, chunk, dtype
FLASH_NEW_CASES = [
    # chunked-local: a chunk no tile divides, ragged S, chunk < tile
    (1, 300, 4, 2, 64, 64, True, None, 100, torch.bfloat16),
    (1, 300, 4, 2, 64, 64, True, None, 100, torch.float32),
    (2, 37, 4, 2, 64, 64, True, None, 16, torch.bfloat16),
    (2, 37, 4, 2, 64, 64, True, None, 16, torch.float32),
    (1, 200, 4, 1, 128, 128, False, None, 48, torch.bfloat16),
    (1, 200, 4, 1, 128, 128, True, 20, 48, torch.float32),
    (1, 1024, 8, 2, 128, 128, True, None, 256, torch.bfloat16),  # llama4
    # MLA: q and k 192 (80) wide, v 128 (64)
    (1, 512, 4, 4, 192, 128, True, None, None, torch.bfloat16),
    (2, 130, 4, 4, 192, 128, False, None, None, torch.float32),
    (2, 40, 4, 4, 80, 64, True, None, None, torch.bfloat16),
    (2, 40, 4, 4, 80, 64, True, None, None, torch.float32),
    (1, 300, 4, 4, 192, 128, True, None, 64, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_NEW_CASES, ids=str)
def test_cuda_flash_chunk_and_mla_head_dims(cuda, case):
    """The chunk mask and the (d, d_v) pairs other than square ones:
    bitwise equal run to run, within the f32 and bf16 tolerances of
    ``test_cuda_flash_matches_plain``."""
    from repro_torch.kernels import flash_attention as fa
    B, S, H, KV, d, dv, causal, window, chunk, dtype = case
    gen = torch.Generator(device=cuda).manual_seed(S + d)
    q, k = (torch.randn(B, S, n, d, device=cuda, generator=gen).to(dtype)
            for n in (H, KV))
    v = torch.randn(B, S, KV, dv, device=cuda, generator=gen).to(dtype)
    before = fa.LAUNCHES["flash_attention"]
    kw = dict(causal=causal, window=window, chunk=chunk)
    got = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 2
    assert got.shape == (B, S, H, dv) and torch.equal(got, again)
    want = tref.attention_ref(q, k, v, **kw)
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == torch.float32 else \
        dict(rtol=1.6e-2, atol=1e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "llama4-scout-17b-a16e",
                                  "jamba-v0.1-52b", "xlstm-350m",
                                  "hubert-xlarge", "phi-3-vision-4.2b"])
def test_cuda_smoke_arch_matches_cpu(cuda, arch):
    """Each new family's smoke variant on the card (rmsnorm and
    flash_attention kernels) against the CPU (plain versions), same
    params and batch, f32: logits within rtol 1e-4 / atol 1e-4; every
    rmsnorm norm and full-sequence attention launched a kernel."""
    import numpy as np
    from repro_torch.configs.registry import get_config, smoke_batch, \
        smoke_variant
    from repro_torch.convert import tree_to
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.models import model as M
    cfg = smoke_variant(get_config(arch))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in smoke_batch(cfg).items() if k != "labels"}
    with torch.inference_mode():
        params = M.init_params(torch.Generator().manual_seed(0), cfg)
        want, _ = M.forward(params, batch, cfg)
        r0, f0 = rms.LAUNCHES["rmsnorm"], fa.LAUNCHES["flash_attention"]
        got, _ = M.forward(tree_to(params, cuda),
                           {k: v.to(cuda) for k, v in batch.items()}, cfg)
        torch.cuda.synchronize()
    attn = sum(m in ("attn", "attn_global", "mla")
               for m, _ in cfg.block_pattern) * cfg.num_groups
    norms = 0 if cfg.norm != "rmsnorm" else 1 + sum(
        1 + (f != "none") for _, f in cfg.block_pattern) * cfg.num_groups
    assert (rms.LAUNCHES["rmsnorm"] - r0,
            fa.LAUNCHES["flash_attention"] - f0) == (norms, attn)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_meta_route_shapes_match_the_kernels(cuda):
    """Each wrapper's meta route (the dry-run's) gives the shapes and
    dtypes its kernel gives on the card, at the main paths' shapes."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    K, P = 25, 33 * TILE_P
    g = torch.randn(K, P, device=cuda)
    w = torch.full((K,), 1.0 / K, device=cuda)
    slabs = [torch.randn(P, device=cuda) for _ in range(3)]
    q = torch.randn(1, 256, 32, 80, device=cuda).bfloat16()
    kv = torch.randn(1, 256, 8, 80, device=cuda).bfloat16()
    x = torch.randn(4, 2560, device=cuda).bfloat16()
    scale = torch.ones(2560, device=cuda)
    adamw_kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0)
    cases = [
        (ha.flush, (g, w), {}),
        (ha.flush_momentum, (g, w, slabs[0], 0.9), {}),
        (ha.flush_adamw, (g, w, *slabs, 0.5, 0.3, 1e-3), adamw_kw),
        (rms.rmsnorm, (x, scale), {}),
        (fa.flash_attention, (q, kv, kv), dict(window=64)),
    ]
    for fn, args, kw in cases:
        out = fn(*[a.clone() if isinstance(a, torch.Tensor) else a
                   for a in args], **kw)
        meta = fn(*[a.to("meta") if isinstance(a, torch.Tensor) else a
                    for a in args], **kw)
        out = out if isinstance(out, tuple) else (out,)
        meta = meta if isinstance(meta, tuple) else (meta,)
        torch.cuda.synchronize()
        assert [(t.shape, t.dtype) for t in meta] == \
            [(t.shape, t.dtype) for t in out]
        assert all(t.is_meta for t in meta)


# the families of tests/test_torch_remat.py: arch, overrides, S
REMAT_FAMILIES = {
    "dense-window": ("h2o-danube-1.8b", dict(num_groups=2), 1024),
    "mla-moe": ("deepseek-v2-lite-16b", dict(num_groups=2), 1024),
    "mamba-attn": ("jamba-v0.1-52b",
                   dict(block_pattern=(("mamba", "mlp"), ("attn", "moe"))),
                   1024),
    "mlstm-slstm": ("xlstm-350m", dict(num_groups=2), 128),
}


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(REMAT_FAMILIES))
def test_cuda_remat_gradient_equals_no_remat(cuda, family):
    """The remat gradient against three without: bitwise where those
    three agree bitwise, else within their spread."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.convert import tree_leaves
    from repro_torch.core import gradient
    from repro_torch.models import model as M
    arch, kw, S = REMAT_FAMILIES[family]
    cfg = dataclasses.replace(registry.smoke_variant(
        registry.get_config(arch)), remat="block", **kw)
    params = M.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    rng = np.random.default_rng(1)
    b = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, S))
                            .astype(np.int32), device=cuda)
         for k in ("tokens", "labels")}

    def grads(c):
        g, _ = gradient.grad_and_value(
            lambda p, bb: M.loss_fn(p, bb, c), has_aux=True)(params, b)
        return tree_leaves(g)
    none = [grads(dataclasses.replace(cfg, remat="none")) for _ in range(3)]
    block = grads(cfg)
    for i, got in enumerate(block):
        runs = [g[i] for g in none]
        if all(torch.equal(runs[0], r) for r in runs[1:]):
            assert torch.equal(runs[0], got), i
        else:
            spread = max(float((a - c).abs().max()) for a in runs
                         for c in runs)
            assert float((runs[0] - got).abs().max()) <= spread, i


@pytest.mark.cuda
def test_cuda_model_axis_across_cards(cards, tmp_path):
    """h2o-danube-1.8b's smoke variant (bf16), sync, at ``--mesh-model
    2`` on two cards over NCCL (one model group: each card its heads,
    MLP columns and vocabulary rows) against the same run as one rank:
    the losses and the final params within a bf16 tolerance (the
    row-parallel sums add in another order)."""
    import json
    import os
    import subprocess
    import sys

    import numpy as np
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    run = ["-m", "repro_torch", "run", "--backend", "spmd", "--arch",
           "h2o-danube-1.8b", "--smoke", "--mode", "sync", "--steps", "3",
           "--batch", "4", "--seq", "16", "--quiet"]
    outs = {}
    for label, pre, extra in (
            ("tp", [sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc-per-node", "2"],
             ["--mesh-model", "2"]),
            ("one", [sys.executable], [])):
        out = tmp_path / f"{label}.json"
        proc = subprocess.run(
            pre + run + extra + ["--out", str(out), "--ckpt-dir",
                                 str(tmp_path / label)],
            env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        outs[label] = json.loads(out.read_text())
    assert outs["tp"]["extra"]["mesh_model"] == 2
    assert outs["tp"]["extra"]["backend"] == "nccl"
    tol = dict(rtol=1.6e-2, atol=1e-5)
    np.testing.assert_allclose(
        [h["loss"] for h in outs["tp"]["extra"]["history"]],
        [h["loss"] for h in outs["one"]["extra"]["history"]], **tol)
    with np.load(tmp_path / "tp" / "step_3.npz") as a, \
            np.load(tmp_path / "one" / "step_3.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_allclose(a[k].astype(np.float32),
                                       b[k].astype(np.float32), err_msg=k,
                                       **tol)


@pytest.mark.cuda
def test_cuda_moe_model_axis_across_cards(cards, tmp_path):
    """deepseek-v2-lite-16b's smoke variant (MLA + MoE with a shared
    expert, float32), sync, at ``--mesh-model 2`` on two cards over NCCL
    (one model group: each card its heads, its 2 of 4 experts and its
    columns of the shared expert, the router and the latent projections
    whole) against the same run as one rank: the losses, the aux values
    and the final params within the bf16 tolerance of
    ``test_cuda_model_axis_across_cards``; the routing digests equal on
    both cards."""
    import json
    import os
    import subprocess
    import sys

    import numpy as np
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    run = ["-m", "repro_torch", "run", "--backend", "spmd", "--arch",
           "deepseek-v2-lite-16b", "--smoke", "--mode", "sync", "--steps",
           "3", "--batch", "4", "--seq", "16", "--quiet"]
    outs = {}
    for label, pre, extra in (
            ("tp", [sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc-per-node", "2"],
             ["--mesh-model", "2"]),
            ("one", [sys.executable], [])):
        out = tmp_path / f"{label}.json"
        proc = subprocess.run(
            pre + run + extra + ["--out", str(out), "--ckpt-dir",
                                 str(tmp_path / label)],
            env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        outs[label] = json.loads(out.read_text())
    tp = outs["tp"]["extra"]
    assert tp["mesh_model"] == 2 and tp["backend"] == "nccl"
    assert len(set(tp["routing_digest_by_rank"])) == 1
    tol = dict(rtol=1.6e-2, atol=1e-5)
    for key in ("loss", "aux"):
        np.testing.assert_allclose(
            [h[key] for h in tp["history"]],
            [h[key] for h in outs["one"]["extra"]["history"]], err_msg=key,
            **tol)
    with np.load(tmp_path / "tp" / "step_3.npz") as a, \
            np.load(tmp_path / "one" / "step_3.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_allclose(a[k].astype(np.float32),
                                       b[k].astype(np.float32), err_msg=k,
                                       **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
def test_cuda_ssm_model_axis_across_cards(cards, tmp_path, arch):
    """jamba-v0.1-52b's smoke variant (mamba + MLP, mamba + MoE) and
    xlstm-350m's (mLSTM, sLSTM), float32, sync, at ``--mesh-model 2`` on
    two cards over NCCL (one model group: each card half the inner
    channels, its experts and heads; mamba's ``proj`` all-reduced in
    each chunk) against the same run as one rank: the losses and the
    checkpointed final params (mamba's ``w_in`` in the whole layout)
    within the bf16 tolerance of ``test_cuda_model_axis_across_cards``,
    the whole leaves' digests equal on both cards."""
    import json
    import os
    import subprocess
    import sys

    import numpy as np
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    run = ["-m", "repro_torch", "run", "--backend", "spmd", "--arch", arch,
           "--smoke", "--mode", "sync", "--steps", "3", "--batch", "4",
           "--seq", "64", "--quiet"]
    outs = {}
    for label, pre, extra in (
            ("tp", [sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc-per-node", "2"],
             ["--mesh-model", "2"]),
            ("one", [sys.executable], [])):
        out = tmp_path / f"{label}.json"
        proc = subprocess.run(
            pre + run + extra + ["--out", str(out), "--ckpt-dir",
                                 str(tmp_path / label)],
            env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        outs[label] = json.loads(out.read_text())
    tp = outs["tp"]["extra"]
    assert tp["mesh_model"] == 2 and tp["backend"] == "nccl"
    assert len(set(tp["whole_digest_by_rank"])) == 1
    tol = dict(rtol=1.6e-2, atol=1e-5)
    np.testing.assert_allclose(
        [h["loss"] for h in tp["history"]],
        [h["loss"] for h in outs["one"]["extra"]["history"]], **tol)
    with np.load(tmp_path / "tp" / "step_3.npz") as a, \
            np.load(tmp_path / "one" / "step_3.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_allclose(a[k].astype(np.float32),
                                       b[k].astype(np.float32), err_msg=k,
                                       **tol)


_SERVE_SCRIPT = """
import dataclasses, json, sys
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.launch.mesh import distributed, rank_device
from repro_torch.serve_smoke import sliced_serve
arch, out, model, batch = sys.argv[1], sys.argv[2], *map(int, sys.argv[3:])
cfg = smoke_variant(get_config(arch))
with distributed(rank_device("cuda")):
    served = sliced_serve(cfg, model, batch, 24, 8, 32)
if served is not None:
    with open(out, "w") as f:
        json.dump(served, f)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("arch,model,batch", [
    ("h2o-danube-1.8b", 2, 4), ("deepseek-v2-lite-16b", 2, 4),
    ("jamba-v0.1-52b", 2, 4), ("xlstm-350m", 2, 4),
    ("h2o-danube-1.8b", 1, 1)])
def test_cuda_sliced_serving_across_cards(cards, tmp_path, arch, model,
                                          batch):
    """The sliced serving forward (``repro_torch/serve_smoke.py``) of each
    family's smoke variant, float32, on two cards over NCCL: 4 prompts at
    model 2 (one model group), and 1 prompt at data 2 x model 1 (regime
    (b): both cards serve the row, the cache's sequence over the two):
    the prefill's last-position logits and the decode's logits fed the
    whole run's tokens within 1e-4 of the same params served whole on the
    first card, the greedy tokens equal (on both cards), each card's
    cache bytes the dry-run's, the routing equal on both cards, rmsnorm
    launched on both (and flash where the model attends)."""
    import json
    import os
    import subprocess
    import sys

    from repro_torch.configs.registry import get_config, smoke_variant
    from repro_torch.models.config import ATTN, ATTN_GLOBAL, MLA
    from repro_torch.serve_smoke import expected_cache_bytes
    cfg = smoke_variant(get_config(arch))
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    script = tmp_path / "serve.py"
    script.write_text(_SERVE_SCRIPT)
    out = tmp_path / "served.json"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(script), arch, str(out), str(model),
         str(batch)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    sv = json.loads(out.read_text())
    assert sv["max_abs_prefill"] <= 1e-4 and sv["max_abs_decode"] <= 1e-4
    assert sv["first_divergence"] is None and sv["toks_equal"]
    by = sv["by_rank"]
    want = expected_cache_bytes(cfg, batch, 32, 2, model)
    assert by["cache_bytes"] == [want, want]
    assert by["routing"][0] == by["routing"][1]
    attends = any(m in (ATTN, ATTN_GLOBAL, MLA) for m, _ in cfg.block_pattern)
    assert all(r["rmsnorm"] > 0 and (r["flash_attention"] > 0) == attends
               for r in by["launches"])
