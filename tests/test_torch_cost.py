"""The meta-device cost model (``launch/cost.py``) and the kernels' meta
routes and closed-form costs.

- matmul FLOPs are exactly ``2 m k n`` (as the reference's
  ``test_hlo_cost_matmul_property``), and a loop of n products counted
  through ``core/counting.trips`` is n times one;
- each kernel's closed form equals a brute-force count: flash's
  reachable (query, key) pairs over the mask itself, rmsnorm's and the
  flushes' bytes over the tensors they read and write;
- the recurrent mixers (mamba, mLSTM, sLSTM) counted from 2, 3 and 4
  trips and multiplied out equal a direct trace at 6 trips: FLOPs and
  bytes exactly, forward and backward, the peak within 10%;
- a kernel wrapper's meta route gives the shapes and dtypes of the CPU
  plain version's outputs, never runs the plain version, and reports its
  cost; a CUDA-less host still runs the CPU route.
"""
import dataclasses

import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.convert import tree_leaves, tree_map
from repro_torch.core import counting
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hybrid_aggregate as ha
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rms
from repro_torch.launch import cost as C
from repro_torch.launch.dryrun import meta_params
from repro_torch.models import mamba, xlstm
from repro_torch.models import model as M

torch.set_num_threads(2)


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@settings(max_examples=10, deadline=None)
@given(m=st.sampled_from([32, 64, 128]), k=st.sampled_from([32, 256]),
       n=st.sampled_from([16, 64]))
def test_matmul_flops_exact(m, k, n):
    _, r = C.analyze(lambda a, b: a @ b, meta(m, k), meta(k, n))
    assert r.cost.flops == 2 * m * k * n
    assert r.cost.hbm_bytes == 4 * (m * k + k * n + m * n)
    assert r.peak_bytes - r.held_bytes == C.alloc_bytes(4 * m * n)


def test_cost_adds_and_scales_as_the_reference():
    a = C.Cost(1.0, 2.0, 3.0, {"all-reduce": 3.0})
    a += C.Cost(10.0, 20.0, 5.0, {"all-reduce": 1.0, "all-gather": 4.0})
    assert (a.flops, a.hbm_bytes, a.collective_bytes) == (11.0, 22.0, 8.0)
    assert a.collective_by_op == {"all-reduce": 4.0, "all-gather": 4.0}
    b = a.scaled(2)
    assert (b.flops, b.collective_by_op["all-gather"]) == (22.0, 8.0)
    assert a.flops == 11.0


@pytest.mark.parametrize("n", [1, 3, 7])
def test_a_counted_loop_is_n_times_one(n):
    a, b = meta(64, 64), meta(64, 64)

    def loop(a, b, trips):
        out = a
        for _ in counting.trips(trips):
            out = out @ b
        return out
    _, one = C.analyze(loop, a, b, 1)
    _, many = C.analyze(loop, a, b, n)
    assert many.cost.flops == n * one.cost.flops
    assert many.cost.hbm_bytes == n * one.cost.hbm_bytes
    assert many.peak_bytes == one.peak_bytes
    # without an analysis the loop runs every trip
    assert list(counting.trips(n)) == list(range(n))


def brute_pairs(S, causal, window, chunk):
    return int(ref.attention_mask(S, causal, window, "cpu", chunk).sum())


@settings(max_examples=60, deadline=None)
@given(S=st.integers(0, 300), causal=st.booleans(),
       window=st.sampled_from([None, 1, 2, 7, 16, 64, 500]),
       chunk=st.sampled_from([None, 1, 3, 16, 48, 100, 256, 1000]))
def test_flash_pairs_closed_form(S, causal, window, chunk):
    assert fa.reachable_pairs(S, causal, window, chunk) == \
        brute_pairs(S, causal, window, chunk)


@settings(max_examples=20, deadline=None)
@given(B=st.integers(1, 3), S=st.integers(1, 130), KV=st.sampled_from([1, 2]),
       G=st.sampled_from([1, 2, 4]),
       dims=st.sampled_from([(16, 16), (80, 64), (192, 128)]),
       dtype=st.sampled_from([torch.float32, torch.bfloat16]),
       causal=st.booleans(), window=st.sampled_from([None, 5, 40]),
       chunk=st.sampled_from([None, 8, 33]))
def test_flash_cost_formula(B, S, KV, G, dims, dtype, causal, window, chunk):
    d, dv = dims
    H = KV * G
    q, k, v = meta(B, S, H, d, dtype=dtype), meta(B, S, KV, d, dtype=dtype), \
        meta(B, S, KV, dv, dtype=dtype)
    flops, nbytes = fa.cost(B, S, H, KV, d, dv, q.element_size(), causal,
                            window, chunk)
    assert flops == 2 * (d + dv) * B * H * brute_pairs(S, causal, window,
                                                       chunk)
    o = meta(B, S, H, dv, dtype=dtype)
    assert nbytes == sum(C._nbytes(t) for t in (q, k, v, o))


@settings(max_examples=20, deadline=None)
@given(N=st.integers(0, 4096), D=st.sampled_from([100, 2560, 8192]),
       dtype=st.sampled_from([torch.float32, torch.bfloat16]))
def test_rmsnorm_cost_formula(N, D, dtype):
    x = meta(N, D, dtype=dtype)
    flops, nbytes = rms.cost(N, D, x.element_size())
    assert flops == 4 * N * D
    assert nbytes == 2 * C._nbytes(x) + C._nbytes(meta(D))


@settings(max_examples=20, deadline=None)
@given(K=st.integers(1, 25), blocks=st.integers(1, 64),
       dtype=st.sampled_from([torch.float32, torch.bfloat16]))
def test_flush_cost_formulas(K, blocks, dtype):
    P = blocks * ha.BLOCK_P
    g, w, slab = meta(K, P, dtype=dtype), meta(K), meta(P)
    es = g.element_size()
    assert ha.cost("flush", K, P, es) == (
        2 * K * P, sum(map(C._nbytes, (g, w, meta(P, dtype=dtype)))))
    # the moment read and written
    assert ha.cost("flush_momentum", K, P, es) == (
        2 * K * P + 2 * P, sum(map(C._nbytes, (g, w, slab, slab))))
    # params, mu and nu read and written, three f32 scalars read
    assert ha.cost("flush_adamw", K, P, es) == (
        2 * K * P + 16 * P, sum(map(C._nbytes, (g, w) + (slab,) * 6)) + 12)
    with pytest.raises(ValueError):
        ha.cost("flush_nesterov", K, P, es)


# ----------------------------------------------------- recurrences

MIXERS = [("jamba-v0.1-52b", "mamba", mamba.mamba_forward,
           lambda cfg: cfg.ssm_chunk),
          ("xlstm-350m", "mlstm", xlstm.mlstm_forward,
           lambda cfg: xlstm.MLSTM_CHUNK),
          ("xlstm-350m", "slstm", xlstm.slstm_forward, lambda cfg: 1)]


def _mixer(arch, mixer):
    cfg = smoke_variant(get_config(arch))
    j = next(i for i, (m, _) in enumerate(cfg.block_pattern) if m == mixer)
    return cfg, M._index(meta_params(cfg)["groups"][j], 0)["mixer"]


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("arch,mixer,fn,unit", MIXERS,
                         ids=[m[1] for m in MIXERS])
def test_recurrence_trip_product_equals_direct_count(arch, mixer, fn, unit,
                                                     grad):
    cfg, pm = _mixer(arch, mixer)
    u = unit(cfg)
    S = 6 * u
    params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta",
                                            requires_grad=grad), pm)
    x = torch.empty((2, S, cfg.d_model), device="meta", requires_grad=grad)

    def run(counted):
        def f(params, x):
            with torch.set_grad_enabled(grad):
                y = counting.recurrence(fn, params, x, cfg, u) if counted \
                    else fn(params, x, cfg)
                if not grad:
                    return y
                return torch.autograd.grad(
                    y, [x] + tree_leaves(params), torch.empty_like(y),
                    allow_unused=True)
        return C.analyze(f, params, x)[1]
    direct, counted = run(False), run(True)
    assert counted.cost.flops == direct.cost.flops
    assert counted.cost.hbm_bytes == direct.cost.hbm_bytes
    assert counted.peak_bytes == pytest.approx(direct.peak_bytes, rel=0.10)


REMAT_MIXERS = MIXERS[:2]          # sLSTM is not checkpointed


@pytest.mark.parametrize("arch,mixer,fn,unit", REMAT_MIXERS,
                         ids=[m[1] for m in REMAT_MIXERS])
def test_recurrence_under_remat_trip_product_equals_direct_count(
        arch, mixer, fn, unit):
    """With remat each chunk is checkpointed: its forward runs again in
    the backward, and only the carries and the chunks' inputs stay saved.
    Counted from 2, 3 and 4 trips against a direct trace at 6: FLOPs and
    bytes exactly, the peak within 10%, the bytes held at the end of the
    forward to the byte, and below the no-remat count's."""
    cfg, pm = _mixer(arch, mixer)
    u = unit(cfg)
    held = {}

    def run(cfg, counted):
        params = tree_map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device="meta", requires_grad=True), pm)
        x = torch.empty((2, 6 * u, cfg.d_model), device="meta",
                        requires_grad=True)

        def f(params, x):
            y = counting.recurrence(fn, params, x, cfg, u) if counted \
                else fn(params, x, cfg)
            held[cfg.remat, counted] = counting.ACTIVE.live
            return torch.autograd.grad(y, [x] + tree_leaves(params),
                                       torch.empty_like(y),
                                       allow_unused=True)
        return C.analyze(f, params, x)[1]
    block = dataclasses.replace(cfg, remat="block")
    direct, counted = run(block, False), run(block, True)
    plain = run(dataclasses.replace(cfg, remat="none"), False)
    assert counted.cost.flops == direct.cost.flops > plain.cost.flops
    assert counted.cost.hbm_bytes == direct.cost.hbm_bytes
    assert counted.peak_bytes == pytest.approx(direct.peak_bytes, rel=0.10)
    assert held["block", True] == held["block", False] < held["none", False]


def test_recurrence_saved_bytes_are_exact():
    """What a train step's recurrence holds for the backward at the end
    of the forward: counted and direct agree to the byte."""
    cfg, pm = _mixer("xlstm-350m", "mlstm")
    params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta",
                                            requires_grad=True), pm)
    x = torch.empty((2, 6 * xlstm.MLSTM_CHUNK, cfg.d_model), device="meta",
                    requires_grad=True)
    held = []

    def f(counted):
        def g(params, x):
            y = counting.recurrence(xlstm.mlstm_forward, params, x, cfg,
                                    xlstm.MLSTM_CHUNK) if counted \
                else xlstm.mlstm_forward(params, x, cfg)
            held.append(counting.ACTIVE.live)
            return y
        return g
    C.analyze(f(False), params, x)
    C.analyze(f(True), params, x)
    assert held[0] == held[-1]


def test_recurrence_passes_through_off_meta():
    cfg, _ = _mixer("xlstm-350m", "slstm")
    calls = []
    x = torch.zeros(1, 3, cfg.d_model)
    out = counting.recurrence(lambda p, x, c: calls.append(1) or x, {}, x,
                              cfg, 1)
    assert out is x and calls == [1]


# ----------------------------------------------------- meta routes

def _cases():
    g = torch.Generator().manual_seed(0)
    K, P = 3, 2 * ha.BLOCK_P
    grads, w = torch.randn(K, P, generator=g), torch.rand(K, generator=g)
    slab = [torch.randn(P, generator=g) for _ in range(3)]
    q, k, v = (torch.randn(2, 37, h, d, generator=g).bfloat16()
               for h, d in ((4, 80), (2, 80), (2, 64)))
    x = torch.randn(5, 96, generator=g).bfloat16()
    scale = torch.rand(96, generator=g)
    return {
        "flush": (ha.flush, (grads, w), {}),
        "flush_momentum": (ha.flush_momentum, (grads, w, slab[0], 0.9), {}),
        "flush_adamw": (ha.flush_adamw, (grads, w, *slab, 0.5, 0.3, 1e-3),
                        dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0)),
        "rmsnorm": (rms.rmsnorm, (x, scale), {}),
        "flash_attention": (fa.flash_attention, (q, k, v),
                            dict(window=8, chunk=16)),
    }


def _to_meta(a):
    return a.to("meta") if isinstance(a, torch.Tensor) else a


@pytest.mark.parametrize("name", list(_cases()))
def test_meta_route_outputs_match_the_plain_versions(name, monkeypatch):
    fn, args, kw = _cases()[name]
    want = fn(*args, **kw)
    # the meta route never reaches a plain version
    for plain in ("flush_ref", "flush_momentum_ref", "flush_adamw_ref",
                  "rmsnorm_ref", "attention_ref"):
        monkeypatch.setattr(ref, plain, None)
    margs = [_to_meta(a) for a in args]
    got, report = C.analyze(lambda *a: fn(*a, **kw), *margs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.is_meta for t in got)
    kern = report.kernels[name]
    assert kern["launches"] == 1 and kern["flops"] > 0 and kern["bytes"] > 0
    assert report.cost.flops >= kern["flops"]
    # without an analysis the meta route still answers, and counts nothing
    got2 = fn(*margs, **kw)
    got2 = got2 if isinstance(got2, tuple) else (got2,)
    assert [t.shape for t in got2] == [t.shape for t in got]


def test_meta_forward_counts_every_kernel_launch():
    """The serving forward of a smoke model on meta tensors: the kernels'
    launches are the ones the card's counters see (2 L + 1 rmsnorm, L
    flash), each costed by its formula."""
    cfg = dataclasses.replace(smoke_variant(get_config("h2o-danube-1.8b")),
                              num_groups=3)
    params = meta_params(cfg)
    toks = torch.empty((2, 64), dtype=torch.int32, device="meta")
    with torch.no_grad():
        (logits, _), r = C.analyze(lambda p, t: M.forward(p, {"tokens": t},
                                                          cfg), params, toks)
    L = cfg.num_layers
    assert tuple(logits.shape) == (2, 64, cfg.vocab_size)
    assert r.kernels["rmsnorm"]["launches"] == 2 * L + 1
    assert r.kernels["flash_attention"]["launches"] == L
    hd = cfg.resolved_head_dim
    assert r.kernels["flash_attention"]["flops"] == L * fa.cost(
        2, 64, cfg.num_heads, cfg.num_kv_heads, hd, hd, 4, True,
        cfg.sliding_window)[0]


def test_cuda_tensors_take_no_meta_route():
    """The meta route is for meta tensors only: a CPU tensor runs the
    plain version, and no analysis hook is installed outside analyze."""
    assert counting.ACTIVE is None
    x = torch.randn(3, 8)
    y = rms.rmsnorm(x, torch.ones(8))
    torch.testing.assert_close(y, ref.rmsnorm_ref(x, torch.ones(8)))
