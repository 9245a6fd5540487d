#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with
``nvcc``, holds each kernel against its plain PyTorch version on the
card at the main path's shapes, times kernel, plain version and a
one-call PyTorch yardstick beside the memory-bound time, then drives the
main path — ``SimulatorTrainer`` on ``cnn-cifar`` at its published
widths, the paper's 25 workers — through async, sync and hybrid (SGD,
momentum, AdamW) and checks that every flush went through the kernels.

Output: progress lines, then the card's name and power limit as
``nvidia-smi`` gives them, one ``{"kernels": [...]}`` JSON line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed check
raises and exits non-zero; with no CUDA device it exits 1 and prints no
result.  It imports nothing of JAX and nothing of the ``repro`` package.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
K_MAX = 25                       # the paper's fleet: at most one row each
HORIZON = 2.0                    # virtual seconds per main-path run
SOURCE = "src/repro_torch/csrc/hybrid_aggregate.cu"
TPU = "src/repro/kernels/hybrid_aggregate.py"
PORTED = {   # name -> TPU kernel it replaces (file:line of the function)
    "flush": f"{TPU}:35",
    "flush_momentum": f"{TPU}:82",
    "flush_adamw": f"{TPU}:136",
}
PENDING = {
    "rmsnorm": "src/repro/kernels/rmsnorm.py:23",
    "flash_attention": "src/repro/kernels/flash_attention.py:75",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------- timing

class Timer:
    """Median device time of one call, from CUDA events around each call.

    A ``torch.cuda._sleep`` queued first keeps the card busy while the
    host enqueues every call, so host overhead between calls is not
    timed.  ``cold`` reads a 256 MB buffer before each call, which
    evicts the inputs from the 50 MB L2 and leaves no dirty lines, so a
    kernel reads its inputs from device memory."""

    def __init__(self, torch, reps: int = 50):
        self.torch = torch
        self.reps = reps
        self.scrub = torch.ones(64 << 20, dtype=torch.float32,
                                device="cuda")

    def __call__(self, fn, cold: bool) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(self.reps):
            if cold:
                self.scrub.sum()
            fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(self.reps)]
        torch.cuda._sleep(int(2e9 * (2 * host_s + 0.01)))
        for start, end in ev:
            if cold:
                self.scrub.sum()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in ev)


def bound_ms(nbytes: int, flops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# -------------------------------------------------------------- phases

def build_kernels():
    from repro_torch.kernels import _build
    t0 = time.time()
    libs = _build.build(_build.all_sources())
    log(f"[build] {len(libs)} CUDA source(s) built in "
        f"{time.time() - t0:.2f} s: {sorted(libs)}")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def compare_kernels(torch, P: int):
    """Each kernel against its plain version on the card, twice."""
    from repro_torch.kernels import hybrid_aggregate as ha
    from repro_torch.kernels import ref
    from repro_torch.optim import bias_correction

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    K = K_MAX
    g = torch.randn(K, P, device=dev, generator=gen)
    w = torch.rand(K, device=dev, generator=gen) + 0.1
    wn = w / w.sum()
    errs = {name: 0.0 for name in PORTED}

    def same_twice(fn, *clone_from):
        outs = []
        for _ in range(2):
            args = [t.clone() for t in clone_from]
            res = fn(*args)
            outs.append(tuple(r.clone() for r in
                              (res if isinstance(res, tuple) else (res,))))
        torch.cuda.synchronize()
        for a, b in zip(*outs):
            check(torch.equal(a, b), "kernel result differs run to run")
        return outs[0]

    def hold(name, got, want, rtol, atol, case):
        err = max_err(torch, got, want)
        ok = torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
        log(f"[check] {name:15s} {case:28s} max_abs_err={err:.3e} "
            f"(rtol {rtol:g}, atol {atol:g}) {'ok' if ok else 'FAIL'}")
        check(ok, f"{name} {case} disagrees with its plain version")
        return err

    (out,) = same_twice(lambda: ha.flush(g, w))
    errs["flush"] = max(errs["flush"], hold(
        "flush", out, ref.flush_ref(g, w), 1e-6, 1e-6, "f32"))
    gb = g.to(torch.bfloat16)
    (out,) = same_twice(lambda: ha.flush(gb, w))
    hold("flush", out, ref.flush_ref(gb, w), 3e-2, 3e-2, "bf16 rows")
    live = 7
    junk = g.clone()
    junk[live:] = 1e30
    wm = w.clone()
    wm[live:] = 0
    (out,) = same_twice(lambda: ha.flush(junk, wm))
    errs["flush"] = max(errs["flush"], hold(
        "flush", out, ref.flush_ref(g[:live], w[:live]), 1e-6, 1e-6,
        f"{live} live + {K - live} junk rows"))
    torch.cuda.synchronize()

    m = torch.randn(P, device=dev, generator=gen)
    for beta in (0.0, 0.9):
        upd, new_m = same_twice(
            lambda mm: ha.flush_momentum(g, wn, mm, beta), m)
        want_u, want_m = ref.flush_momentum_ref(g, wn, m, beta)
        errs["flush_momentum"] = max(
            errs["flush_momentum"],
            hold("flush_momentum", new_m, want_m, 1e-6, 1e-6,
                 f"beta={beta}"),
            hold("flush_momentum", upd, want_u, 1e-6, 1e-6,
                 f"beta={beta} update"))
    torch.cuda.synchronize()

    p = torch.randn(P, device=dev, generator=gen)
    mu = 0.1 * torch.randn(P, device=dev, generator=gen)
    nu = 0.01 * torch.randn(P, device=dev, generator=gen).abs()
    for wd in (0.0, 0.01):
        for count in (1, 10):
            bc1, bc2 = bias_correction(
                torch.tensor(count, dtype=torch.int32, device=dev), 0.9,
                0.95)
            kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=wd)
            got = same_twice(
                lambda pp, mm, vv: ha.flush_adamw(g, wn, pp, mm, vv, bc1,
                                                  bc2, 0.01, **kw),
                p, mu, nu)
            want = ref.flush_adamw_ref(g, wn, p, mu, nu, bc1, bc2, 0.01,
                                       **kw)
            for part, a, b in zip(("params", "mu", "nu"), got, want):
                errs["flush_adamw"] = max(errs["flush_adamw"], hold(
                    "flush_adamw", a, b, 1e-5, 1e-6,
                    f"wd={wd} count={count} {part}"))
    torch.cuda.synchronize()
    return errs


def time_kernels(torch, P: int):
    from repro_torch.kernels import hybrid_aggregate as ha
    from repro_torch.kernels import ref

    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    K = K_MAX
    g = torch.randn(K, P, device="cuda", generator=gen)
    w = torch.ones(K, device="cuda")
    wn = w / w.sum()
    m = torch.zeros(P, device="cuda")
    p = torch.randn(P, device="cuda", generator=gen)
    mu = torch.zeros(P, device="cuda")
    nu = torch.zeros(P, device="cuda")
    h = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0)
    bc = torch.tensor([0.1, 0.05], device="cuda")
    cases = {
        # name: (kernel, plain, library call or None, bytes, flops)
        "flush": (lambda: ha.flush(g, w), lambda: ref.flush_ref(g, w),
                  lambda: w @ g, nbytes(g, w) + P * 4, 2 * K * P),
        "flush_momentum": (
            lambda: ha.flush_momentum(g, wn, m, 0.9),
            lambda: ref.flush_momentum_ref(g, wn, m, 0.9),
            lambda: torch.addmv(m, g.t(), wn, beta=0.9),
            nbytes(g, wn, m) + P * 4, 2 * K * P + 2 * P),
        "flush_adamw": (
            lambda: ha.flush_adamw(g, wn, p, mu, nu, bc[0], bc[1], 1e-9,
                                   **h),
            lambda: ref.flush_adamw_ref(g, wn, p, mu, nu, bc[0], bc[1],
                                        1e-9, **h),
            None, nbytes(g, wn, p, mu, nu) + 12 + 3 * P * 4,
            2 * K * P + 16 * P),
    }
    out = {}
    for name, (kern, plain, lib, nb, flops) in cases.items():
        ms_cold = timer(kern, cold=True)
        ms_warm = timer(kern, cold=False)
        plain_ms = timer(plain, cold=True)
        lib_ms = timer(lib, cold=True) if lib is not None else None
        b_ms, b_by = bound_ms(nb, flops)
        out[name] = dict(ms=ms_cold, warm_ms=ms_warm, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                         bytes=nb)
        lib_s = f"{lib_ms:.4f}" if lib_ms is not None else "none"
        log(f"[time] {name:15s} kernel {ms_cold:.4f} ms cold "
            f"({ms_warm:.4f} warm in L2)  plain {plain_ms:.4f}  "
            f"library {lib_s}  bound {b_ms:.4f} ms ({nb / 1e6:.1f} MB, "
            f"{b_by})  = {100 * b_ms / ms_cold:.0f}% of bound")
    torch.cuda.synchronize()
    return out


def cross_check_small(torch):
    """The whole path on a small input: the port on the card against the
    port on the CPU (plain versions), mlp, hybrid AdamW."""
    from repro_torch.api import ExperimentSpec, SimulatorTrainer
    from repro_torch.core.simulator import WorkerPool
    spec = ExperimentSpec(arch="mlp", mode="hybrid", schedule="step:50",
                          horizon=3.0, smoke=True, optimizer="adamw",
                          pool=WorkerPool(num_workers=5))
    gpu = SimulatorTrainer(device="cuda").run(spec)
    cpu = SimulatorTrainer(device="cpu").run(spec)
    check((gpu.num_updates, gpu.num_gradients)
          == (cpu.num_updates, cpu.num_gradients),
          "cuda and cpu runs disagree on event counts")
    worst = 0.0
    for k in ("train_loss", "test_loss"):
        a, b = gpu.metrics[k], cpu.metrics[k]
        worst = max(worst, max(abs(x - y) for x, y in zip(a, b)))
        check(all(math.isclose(x, y, rel_tol=1e-4, abs_tol=1e-5)
                  for x, y in zip(a, b)), f"cuda vs cpu {k} differ")
    log(f"[small] mlp hybrid adamw: cuda == cpu on {gpu.num_updates} "
        f"updates / {gpu.num_gradients} gradients, loss max diff "
        f"{worst:.2e} (rtol 1e-4, atol 1e-5)")


def drive_main_path(torch):
    """cnn-cifar at full width through the port's own trainer."""
    from repro_torch.api import ExperimentSpec, SimulatorTrainer
    from repro_torch.core.simulator import WorkerPool
    from repro_torch.kernels import hybrid_aggregate as ha

    trainer = SimulatorTrainer(device="cuda")
    base = ExperimentSpec(arch="cnn-cifar", smoke=False, seed=0, lr=0.01,
                          batch=32, horizon=HORIZON,
                          pool=WorkerPool(num_workers=25))
    runs = [
        ("async", base.with_(mode="async", schedule=None), "flush"),
        ("sync", base.with_(mode="sync", schedule=None), "flush"),
        ("hybrid", base.with_(mode="hybrid", schedule="step:300"), "flush"),
        ("hybrid+momentum", base.with_(mode="hybrid", schedule="step:300",
                                       optimizer="momentum"),
         "flush_momentum"),
        ("hybrid+adamw", base.with_(mode="hybrid", schedule="step:300",
                                    optimizer="adamw"), "flush_adamw"),
    ]
    # the dataset upload and the first gradient's one-time set-up are
    # paid outside the timed runs
    t0 = time.time()
    trainer.run(base.with_(mode="async", schedule=None, horizon=0.2))
    torch.cuda.synchronize()
    log(f"[sim] set-up run (dataset upload, first gradients): "
        f"{time.time() - t0:.1f} s")

    ha.reset_launch_counts()
    results = []
    for label, spec, kernel in runs:
        before = dict(ha.LAUNCHES)
        res = trainer.run(spec)
        torch.cuda.synchronize()
        delta = {k: ha.LAUNCHES[k] - before[k] for k in ha.LAUNCHES}
        engine = trainer.engine(spec)
        agg = engine._agg_cache[1 if spec.mode == "async" else 25]
        check(all(t.is_cuda for t in (engine.x_tr, engine.y_tr, agg._slab,
                                      agg._staging, agg.params_slab)),
              "params, staging or data left the card")
        losses = res.metrics["train_loss"] + res.metrics["test_loss"]
        check(all(math.isfinite(x) for x in losses),
              f"{label}: non-finite loss")
        check(delta[kernel] == res.num_updates and
              sum(delta.values()) == res.num_updates,
              f"{label}: launches {delta} vs {res.num_updates} flushes")
        if label == "async":
            tl = res.metrics["train_loss"]
            check(tl[-1] < tl[0], f"async train loss did not fall: {tl}")
        avg = {k: round(v, 4) for k, v in res.averaged().items()}
        log(f"[sim] cnn-cifar {label:16s} wall {res.wall_s:.2f} s  "
            f"{res.num_gradients} grads ({res.num_gradients / res.wall_s:.0f}"
            f"/s)  {res.num_updates} flushes  {kernel} launches "
            f"{delta[kernel]}  train_loss {res.metrics['train_loss'][0]:.4f}"
            f" -> {res.metrics['train_loss'][-1]:.4f}  averaged {avg}")
        results.append(res)
    return dict(ha.LAUNCHES), results


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    build_kernels()

    from repro_torch.models.cnn import init_cnn
    from repro_torch.core.slab import slab_codec
    P = slab_codec(init_cnn(torch.Generator().manual_seed(0),
                            (32, 32, 3))).padded_size
    log(f"[shape] cnn-cifar slab P_pad={P}, K={K_MAX}")

    errs = compare_kernels(torch, P)
    times = time_kernels(torch, P)
    cross_check_small(torch)
    launches, _ = drive_main_path(torch)
    for name in PORTED:
        check(launches[name] > 0, f"{name} was never launched")

    kernels = []
    for name, tpu in PORTED.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": tpu, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "warm_ms": t["warm_ms"], "tpu_kernel": tpu, "status": "ported",
            "max_err": errs[name], "kernel_ms": t["ms"]})
    pending = [{"name": n, "tpu_kernel": tpu, "status": "pending"}
               for n, tpu in PENDING.items()]
    log(smi)
    print(json.dumps({"kernels": kernels, "pending": pending}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
