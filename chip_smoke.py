#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with
``nvcc`` (one ``nvcc`` per source, all started together), holds each
kernel against its plain PyTorch version on the card at its main path's
shapes, times kernel, plain version and a one-call PyTorch yardstick
beside the least time the card could take, then drives the port's two
main paths:

- the simulator: ``SimulatorTrainer`` on ``cnn-cifar`` at its published
  widths, the paper's 25 workers, through async, sync and hybrid (SGD,
  momentum, AdamW), checking that every flush went through the flush
  kernels;
- the cluster: ``ClusterTrainer`` (``backend="cluster"``, in-process
  transport) on ``cnn-cifar`` at its published widths with 25 worker
  threads and batch 32 — sync twice (bitwise equal), async, hybrid, and
  hybrid AdamW with a kill, a respawn, checkpoints and a mid-run
  restore — checking the exact conservation ledger and that every
  server update went through a flush kernel;
- serving: ``greedy_generate`` on h2o-danube-1.8b at its published
  widths and depth (batch 4, prompt 32, gen 16) and ``prefill_step`` on
  the 32-token prompts and on one 8192-token sequence, checking that
  every norm went through the rmsnorm kernel and every full-sequence
  attention through the flash_attention kernel.

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
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 dense tensor cores
K_MAX = 25                       # the paper's fleet: at most one row each
HORIZON = 2.0                    # virtual seconds per main-path run
CLUSTER_BUDGET_S = 4.0           # wall seconds per timed cluster run
# K grows by one every 10 updates: about 800 gradients in a 4 s run (the
# async run's rate) take K from 1 to about 12 of the 25 workers
CLUSTER_SCHEDULE = "step:10"
ARCH = "h2o-danube-1.8b"         # the serving path's model, full width
SERVE = dict(batch=4, prompt=32, gen=16)   # the reference's serve defaults
LONG_S = 8192                    # the long prefill: twice the 4096 window
# prefill (flash + rmsnorm kernels) vs decode replay (plain attention)
# logits at the prompt's last position, bf16, 24 layers: the two paths
# round differently.  tests/test_torch_lm.py holds a 24-layer bf16 model
# to the same bound on the CPU, where the two differ by 0.047-0.055
PREFILL_DECODE_ATOL = 0.25
TPU = "src/repro/kernels/hybrid_aggregate.py"
CSRC = "src/repro_torch/csrc"
PORTED = {   # name -> (CUDA source, TPU kernel it replaces: file:line)
    "flush": (f"{CSRC}/hybrid_aggregate.cu", f"{TPU}:35"),
    "flush_momentum": (f"{CSRC}/hybrid_aggregate.cu", f"{TPU}:82"),
    "flush_adamw": (f"{CSRC}/hybrid_aggregate.cu", f"{TPU}:136"),
    "rmsnorm": (f"{CSRC}/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:23"),
    "flash_attention": (f"{CSRC}/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:75"),
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


def kernel_only_ms(torch, fn, kernel: str, reps: int = 50) -> float:
    """Median device duration of the kernel named ``kernel`` over
    ``reps`` cold calls of ``fn``, from the profiler's trace: the kernel
    alone, without the gaps the CUDA events around a call also time."""
    from torch.profiler import ProfilerActivity, profile
    scrub = torch.ones(64 << 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            scrub.sum()
            fn()
        torch.cuda.synchronize()
    durations = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in e.name]
    check(len(durations) == reps, f"{kernel}: {len(durations)} kernels "
          f"in the trace of {reps} calls")
    return statistics.median(durations) / 1e3


def bound_ms(nbytes: int, flops: int, flops_per_s: float = F32_FLOPS_PER_S):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their
    type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# -------------------------------------------------------------- phases

def kernel_label(mangled: str) -> str:
    """``rmsnorm_kernel<bf16, 8, 16>``-style label from an Itanium-mangled
    kernel name: its last nested name, dtype and integer template
    arguments."""
    i = mangled.find("_ZN")
    if i < 0:
        return mangled
    i += 3
    label = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        label, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    args = mangled[i:]
    if not args.startswith("I"):
        return label
    args = args[1:args.find("Ev")]
    parts = (["bf16"] if "bfloat16" in args else
             ["f32"] if args.startswith("f") else [])
    return f"{label}<{', '.join(parts + re.findall(r'Li(\d+)E', args))}>"


def build_kernels():
    """Build every CUDA source and print each kernel's registers,
    spills and shared memory as ``nvcc -Xptxas -v`` gave them."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    t0 = time.time()
    libs = _build.build(_build.all_sources())
    log(f"[build] {len(libs)} CUDA source(s) built in "
        f"{time.time() - t0:.2f} s: {sorted(libs)}")
    for name in libs:
        kernel, spill = "?", ""
        for line in _build.build_log(name).splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                kernel = kernel_label(m.group(1))
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                log(f"[build] {name}: {kernel}: "
                    f"{line.split(':', 1)[1].strip()}; {spill}")
    lib = fa._lib()
    smem = {d: lib.flash_attention_bf16_smem_bytes(d) for d in fa.HEAD_DIMS}
    log(f"[build] flash_attention: flash_fwd_bf16_kernel dynamic shared "
        f"memory by head dim (bytes): {smem}")


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def same_twice(torch, fn, *clone_from):
    """``fn`` twice on fresh clones of ``clone_from``; the results must
    be bitwise equal.  Returns the first run's results as a tuple."""
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


def hold(torch, name, got, want, rtol, atol, case):
    """The kernel's result against its plain version's; returns the
    max abs error.  ``tol_used`` is the largest
    ``|got - want| / (atol + rtol*|want|)``: at most 1 when it holds."""
    err = max_err(torch, got, want)
    g, w = got.float(), want.float()
    used = float(((g - w).abs() / (atol + rtol * w.abs())).max()) \
        if g.numel() else 0.0
    ok = torch.allclose(g, w, rtol=rtol, atol=atol)
    log(f"[check] {name:15s} {case:34s} max_abs_err={err:.3e} "
        f"(rtol {rtol:g}, atol {atol:g}) tol_used={used:.3f} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name} {case} disagrees with its plain version")
    return err


def compare_kernels(torch, P: int):
    """Each flush kernel against its plain version on the card, twice."""
    from repro_torch.kernels import hybrid_aggregate as ha
    from repro_torch.kernels import ref
    from repro_torch.optim import bias_correction

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    K = K_MAX
    g = torch.randn(K, P, device=dev, generator=gen)
    w = torch.rand(K, device=dev, generator=gen) + 0.1
    wn = w / w.sum()
    errs = {name: 0.0 for name in ha.LAUNCHES}

    (out,) = same_twice(torch, lambda: ha.flush(g, w))
    errs["flush"] = max(errs["flush"], hold(torch, 
        "flush", out, ref.flush_ref(g, w), 1e-6, 1e-6, "f32"))
    gb = g.to(torch.bfloat16)
    (out,) = same_twice(torch, lambda: ha.flush(gb, w))
    hold(torch, "flush", out, ref.flush_ref(gb, w), 3e-2, 3e-2, "bf16 rows")
    live = 7
    junk = g.clone()
    junk[live:] = 1e30
    wm = w.clone()
    wm[live:] = 0
    (out,) = same_twice(torch, lambda: ha.flush(junk, wm))
    errs["flush"] = max(errs["flush"], hold(torch, 
        "flush", out, ref.flush_ref(g[:live], w[:live]), 1e-6, 1e-6,
        f"{live} live + {K - live} junk rows"))
    torch.cuda.synchronize()

    m = torch.randn(P, device=dev, generator=gen)
    for beta in (0.0, 0.9):
        upd, new_m = same_twice(torch, 
            lambda mm: ha.flush_momentum(g, wn, mm, beta), m)
        want_u, want_m = ref.flush_momentum_ref(g, wn, m, beta)
        errs["flush_momentum"] = max(
            errs["flush_momentum"],
            hold(torch, "flush_momentum", new_m, want_m, 1e-6, 1e-6,
                 f"beta={beta}"),
            hold(torch, "flush_momentum", upd, want_u, 1e-6, 1e-6,
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
            got = same_twice(torch, 
                lambda pp, mm, vv: ha.flush_adamw(g, wn, pp, mm, vv, bc1,
                                                  bc2, 0.01, **kw),
                p, mu, nu)
            want = ref.flush_adamw_ref(g, wn, p, mu, nu, bc1, bc2, 0.01,
                                       **kw)
            for part, a, b in zip(("params", "mu", "nu"), got, want):
                errs["flush_adamw"] = max(errs["flush_adamw"], hold(
                    torch, "flush_adamw", a, b, 1e-5, 1e-6,
                    f"wd={wd} count={count} {part}"))
    torch.cuda.synchronize()
    return errs


def time_kernels(torch, P: int):
    from repro_torch.kernels import hybrid_aggregate as ha
    from repro_torch.kernels import ref

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
    out = time_cases(torch, Timer(torch), cases)
    # the kernel alone, from the profiler, beside the wrapper call's
    # event time above; each wrapper launches its kernel and nothing else
    for name, case in cases.items():
        t = out[name]
        t["kernel_only_ms"] = kernel_only_ms(torch, case[0],
                                             f"{name}_kernel")
        log(f"[time] {name:15s} kernel alone {t['kernel_only_ms']:.6f} ms "
            f"cold (profiler) = {100 * t['bound_ms'] / t['kernel_only_ms']:.1f}"
            f"% of bound; wrapper call {t['ms']:.6f} ms (CUDA events)")
    return out


def time_cases(torch, timer, cases, plain_timer=None, peak=F32_FLOPS_PER_S):
    """Cold and warm kernel times, the plain version's and the library
    call's (cold), and the bound, for each case
    ``name: (kernel, plain, library or None, bytes, flops)``."""
    out = {}
    for name, (kern, plain, lib, nb, flops) in cases.items():
        ms_cold = timer(kern, cold=True)
        ms_warm = timer(kern, cold=False)
        plain_ms = (plain_timer or timer)(plain, cold=True)
        lib_ms = timer(lib, cold=True) if lib is not None else None
        b_ms, b_by = bound_ms(nb, flops, peak)
        out[name] = dict(ms=ms_cold, warm_ms=ms_warm, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                         bytes=nb, flops=flops)
        lib_s = f"{lib_ms:.4f}" if lib_ms is not None else "none"
        log(f"[time] {name:15s} kernel {ms_cold:.4f} ms cold "
            f"({ms_warm:.4f} warm in L2)  plain {plain_ms:.4f}  "
            f"library {lib_s}  bound {b_ms:.4f} ms ({nb / 1e6:.1f} MB, "
            f"{flops / 1e9:.3f} GFLOP, {b_by})  = "
            f"{100 * b_ms / ms_cold:.1f}% of bound")
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
                                      *agg._staging, agg.params_slab)),
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


# ------------------------------------------------------- cluster path

def check_ledger(res, label: str) -> dict:
    """The exact conservation ledger and its telemetry cross-check."""
    a = res.extra["accounting"]
    check(a["computed"] == a["applied"] + a["dropped"] + a["buffered"]
          + a["pending_round"] + a["in_flight"]
          and res.num_gradients == a["applied"]
          and res.extra["telemetry"]["ledger_check"]["consistent"],
          f"{label}: conservation ledger broken: {a}")
    return a


def drive_cluster_path(torch):
    """cnn-cifar at full width through ``ClusterTrainer`` on the card:
    25 worker threads, batch 32, the in-process transport.  Returns the
    flush kernels' launches over the counted runs."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-") as ckpt_dir:
        return cluster_runs(torch, ckpt_dir)


def cluster_runs(torch, ckpt_dir: str):
    from repro_torch.api import ExperimentSpec, FaultPlan
    from repro_torch.cluster.trainer import ClusterTrainer
    from repro_torch.kernels import hybrid_aggregate as ha
    from repro_torch.profile_sim import profiled

    trainer = ClusterTrainer(ckpt_dir=ckpt_dir, device="cuda")
    base = ExperimentSpec(arch="cnn-cifar", backend="cluster", smoke=False,
                          seed=0, lr=0.01, batch=32, cluster_workers=25,
                          wall_budget_s=CLUSTER_BUDGET_S,
                          wall_sample_every_s=1.0, transport="inproc")
    sync = base.with_(mode="sync", schedule=None, max_gradients=250,
                      wall_budget_s=60.0)
    # the dataset's upload and each worker thread's cuDNN and cuBLAS
    # handles are paid outside the counted runs
    t0 = time.time()
    trainer.run(sync.with_(max_gradients=50))
    torch.cuda.synchronize()
    log(f"[cluster] set-up run (dataset upload, 25 threads' first "
        f"gradients): {time.time() - t0:.1f} s")

    faults = FaultPlan(kill=((3, 1.0),), respawn_after_s=0.5,
                       checkpoint_every_s=1.0, restore_at_s=2.5)
    runs = [
        ("sync sgd #1", sync, "flush"),
        ("sync sgd #2", sync, "flush"),
        ("async sgd", base.with_(mode="async", schedule=None), "flush"),
        ("hybrid sgd", base.with_(mode="hybrid",
                                  schedule=CLUSTER_SCHEDULE), "flush"),
        ("hybrid adamw faults", base.with_(
            mode="hybrid", schedule=CLUSTER_SCHEDULE, optimizer="adamw",
            faults=faults), "flush_adamw"),
    ]
    ha.reset_launch_counts()
    finals, rates = [], {}
    for label, spec, kernel in runs:
        before = dict(ha.LAUNCHES)
        res, prof = profiled(lambda: trainer.run(spec), host_ops=False)
        delta = {k: ha.LAUNCHES[k] - before[k] for k in ha.LAUNCHES}
        a = check_ledger(res, label)
        # + 1: the server's warm-up flush before the clock starts
        check(delta[kernel] == res.num_updates + 1
              and sum(delta.values()) == delta[kernel],
              f"{label}: launches {delta} vs {res.num_updates} updates")
        losses = res.metrics["train_loss"] + res.metrics["test_loss"]
        check(all(math.isfinite(x) for x in losses) and len(losses) > 0,
              f"{label}: non-finite or missing losses")
        window = res.extra["serve_wall_s"]
        rates[label] = res.num_gradients / window
        events = [e["event"] for e in res.extra["events"]]
        log(f"[cluster] cnn-cifar {label:20s} {res.num_gradients} grads "
            f"in {window:.2f} s ({rates[label]:.1f} grads/s), "
            f"{res.num_updates} updates, {a['dropped']} dropped, "
            f"{a['in_flight']} in flight; ledger computed {a['computed']}"
            f" == applied {a['applied']} + dropped {a['dropped']} + "
            f"buffered {a['buffered']} + pending {a['pending_round']} + "
            f"in flight {a['in_flight']}; {kernel} launches "
            f"{delta[kernel]} = {res.num_updates} updates + 1 warm-up; "
            f"device busy {prof['device_busy_s']:.4f} s of "
            f"{prof['wall_s']:.2f} s wall, idle share "
            f"{prof['device_idle_share']:.4f}, flush kernels "
            f"{prof['device_s_by_group'].get('flush kernels', 0.0):.6f} s,"
            f" convolutions "
            f"{prof['device_s_by_group'].get('convolution', 0.0):.4f} s;"
            f" test_acc {res.final()['test_acc']:.4f}; events {events}")
        if label.startswith("sync"):
            check(res.num_updates == 10 and a["applied"] == 250,
                  f"{label}: {res.num_updates} rounds, expected 10 of 25")
            finals.append(trainer.last_params)
        if label == "hybrid adamw faults":
            for kind in ("kill", "respawn", "checkpoint", "restore"):
                check(kind in events, f"{label}: no {kind} event: {events}")
            restore_t = next(e["t"] for e in res.extra["events"]
                             if e["event"] == "restore")
            check(restore_t < window, f"{label}: no training after the "
                  "restore")
    launches = dict(ha.LAUNCHES)
    check(all(torch.equal(finals[0][k], finals[1][k]) for k in finals[0]),
          "the two sync runs' final params differ")
    log("[cluster] sync sgd #1 and #2: final params bitwise equal "
        f"({sum(t.numel() for t in finals[0].values())} params, 10 "
        "rounds of 25 gradients in worker-id order)")

    # what the device trace costs the runs above: the async run untraced
    res = trainer.run(runs[2][1])
    check_ledger(res, "async, untraced")
    untraced = res.num_gradients / res.extra["serve_wall_s"]
    log(f"[cluster] async sgd untraced: {untraced:.1f} grads/s against "
        f"{rates['async sgd']:.1f} under the device trace")
    # what cuDNN's deterministic algorithms cost: the same async run,
    # traced the same way, with the default algorithm choice
    torch.backends.cudnn.deterministic = False
    try:
        res, prof = profiled(lambda: trainer.run(runs[2][1]),
                             host_ops=False)
    finally:
        torch.backends.cudnn.deterministic = True
    check_ledger(res, "async, default cuDNN")
    free = res.num_gradients / res.extra["serve_wall_s"]
    log(f"[cluster] async sgd with cuDNN's default (non-deterministic) "
        f"algorithms: {free:.1f} grads/s against {rates['async sgd']:.1f} "
        f"deterministic; device busy {prof['device_busy_s']:.4f} s, "
        f"convolutions {prof['device_s_by_group'].get('convolution', 0):.4f}"
        f" s, idle share {prof['device_idle_share']:.4f}")
    return launches


# ------------------------------------------------------- serving path

# flash_attention cases: (label, B, S, H, KV, d, causal, window, dtype).
# The serve path's two shapes, then the JAX package's kernel-test cases
# (tests/kernels/test_kernels.py:44-119) and a ragged S in f32 (the
# CUDA-core kernel), then bf16 cases for the tensor-core kernel at every
# head dim it takes: MHA, GQA, MQA, causal and not, windows, a ragged S
# and an S below one key tile.
FLASH_CASES = [
    ("serve prompt", 4, 32, 32, 8, 80, True, 4096, "bfloat16"),
    ("long prefill", 1, LONG_S, 32, 8, 80, True, 4096, "bfloat16"),
    ("MHA causal", 1, 128, 4, 4, 64, True, None, "float32"),
    ("MHA full", 1, 128, 4, 4, 64, False, None, "float32"),
    ("GQA causal", 2, 256, 8, 2, 64, True, None, "float32"),
    ("GQA full", 2, 256, 8, 2, 64, False, None, "float32"),
    ("MQA causal", 1, 512, 4, 1, 128, True, None, "float32"),
    ("MQA full", 1, 512, 4, 1, 128, False, None, "float32"),
    ("dtype f32", 1, 256, 4, 2, 64, True, None, "float32"),
    ("dtype bf16", 1, 256, 4, 2, 64, True, None, "bfloat16"),
    ("window 32", 1, 256, 4, 2, 64, True, 32, "float32"),
    ("window 100", 1, 256, 4, 2, 64, True, 100, "float32"),
    ("window 256", 1, 256, 4, 2, 64, True, 256, "float32"),
    ("ragged S 37", 2, 37, 4, 2, 80, True, 8, "float32"),
    ("bf16 MHA causal", 1, 128, 4, 4, 16, True, None, "bfloat16"),
    ("bf16 MHA full", 1, 256, 4, 4, 32, False, None, "bfloat16"),
    ("bf16 GQA causal", 2, 256, 8, 2, 64, True, None, "bfloat16"),
    ("bf16 GQA full", 2, 256, 8, 2, 96, False, None, "bfloat16"),
    ("bf16 MQA causal", 1, 512, 4, 1, 128, True, None, "bfloat16"),
    ("bf16 MQA full", 1, 512, 4, 1, 80, False, None, "bfloat16"),
    ("bf16 window 32", 1, 256, 4, 2, 16, True, 32, "bfloat16"),
    ("bf16 window 100", 1, 256, 4, 2, 96, True, 100, "bfloat16"),
    ("bf16 window 256", 1, 300, 4, 2, 128, False, 256, "bfloat16"),
    ("bf16 window 4096", 1, 5000, 4, 1, 64, True, 4096, "bfloat16"),
    ("bf16 ragged S 37", 2, 37, 4, 2, 32, True, 8, "bfloat16"),
    ("bf16 ragged S 37 full", 1, 37, 4, 1, 128, False, None, "bfloat16"),
    ("bf16 S 32", 2, 32, 4, 1, 16, False, None, "bfloat16"),
    ("bf16 S 8192 d 128", 1, LONG_S, 8, 2, 128, True, None, "bfloat16"),
]
# rmsnorm f32 rtol 1e-5 / atol 1e-6, bf16 3e-2 (one bf16 ulp is 2^-8
# relative); attention f32 2e-4 (tests/kernels/test_kernels.py), bf16
# rtol 1.6e-2 / atol 1e-5: the kernel and the plain version each round
# f32 math to bf16 once, so they differ by one bf16 ulp (at most 2^-7 of
# the value) and the f32 difference; 1.6e-2 is two ulps.  The outputs
# scale as 1/sqrt(keys in reach), ~0.026 at S=8192 with window 4096, so
# a fixed atol of that size would hide a wrong window or a lost tile.
RMS_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (3e-2, 3e-2)}
FLASH_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (1.6e-2, 1e-5)}


def qkv(torch, seed, B, S, H, KV, d, dtype):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(B, S, n, d, device="cuda", generator=gen)
            .to(getattr(torch, dtype)) for n in (H, KV, KV)]


def compare_lm_kernels(torch, D: int):
    """rmsnorm and flash_attention against their plain versions on the
    card, each run twice (bitwise equal), at the serve path's shapes, at
    the JAX package's kernel-test cases, and (rmsnorm) at a width the
    16-byte vectors do not divide and at the registry's widest d_model."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms

    errs = {"rmsnorm": 0.0, "flash_attention": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for width in (D, 100, 8192):
        scale = 1 + 0.1 * torch.randn(width, device="cuda", generator=gen)
        for n in (4, SERVE["batch"] * SERVE["prompt"], LONG_S):
            for dtype in ("float32", "bfloat16"):
                x = torch.randn(n, width, device="cuda", generator=gen).to(
                    getattr(torch, dtype))
                (y,) = same_twice(torch, lambda: rms.rmsnorm(x, scale))
                err = hold(torch, "rmsnorm", y, ref.rmsnorm_ref(x, scale),
                           *RMS_TOL[dtype], f"N={n} D={width} {dtype}")
                if width == D:
                    errs["rmsnorm"] = max(errs["rmsnorm"], err)

    for seed, (label, B, S, H, KV, d, causal, window, dtype) in \
            enumerate(FLASH_CASES):
        q, k, v = qkv(torch, seed, B, S, H, KV, d, dtype)
        (o,) = same_twice(torch, lambda: fa.flash_attention(
            q, k, v, causal=causal, window=window))
        want = ref.attention_ref(q, k, v, causal=causal, window=window)
        errs["flash_attention"] = max(errs["flash_attention"], hold(
            torch, "flash_attention", o, want, *FLASH_TOL[dtype],
            f"{label} ({B},{S},{H},{KV},{d}) w={window}"))
        del want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return errs


def window_pairs(S: int, causal: bool, window) -> int:
    """(query, key) pairs that the masks leave reachable: the work the
    attention must do for one (batch, head)."""
    total = 0
    for i in range(S):
        hi = i + 1 if causal else S
        lo = max(0, i - window + 1) if window else 0
        total += hi - lo
    return total


def time_lm_kernels(torch, D: int):
    """rmsnorm and flash_attention at the serve path's shapes, and flash
    at every head dim it takes."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms

    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(3)
    scale = 1 + 0.1 * torch.randn(D, device="cuda", generator=gen)
    scale_bf16 = scale.to(torch.bfloat16)
    rms_cases = {}
    for n, label in ((SERVE["batch"], "decode"),
                     (SERVE["batch"] * SERVE["prompt"], "serve prefill"),
                     (LONG_S, "long prefill")):
        x = torch.randn(n, D, device="cuda", generator=gen).to(
            torch.bfloat16)
        rms_cases[f"rmsnorm {label} N={n}"] = (
            lambda x=x: rms.rmsnorm(x, scale),
            lambda x=x: ref.rmsnorm_ref(x, scale),
            lambda x=x: F.rms_norm(x, (D,), scale_bf16, 1e-5),
            2 * nbytes(x) + nbytes(scale), 4 * n * D)
    out = time_cases(torch, timer, rms_cases)

    # the serve path's two shapes, then every head dim at one mid-size
    # causal shape
    shapes = FLASH_CASES[:2] + [
        (f"bf16 d={d}", 1, 4096, 16, 4, d, True, None, "bfloat16")
        for d in fa.HEAD_DIMS]
    for seed, (label, B, S, H, KV, d, causal, window, dtype) in \
            enumerate(shapes):
        q, k, v = qkv(torch, 10 + seed, B, S, H, KV, d, dtype)
        mask = ref.attention_mask(S, causal, window, "cuda")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        flops = 4 * d * B * H * window_pairs(S, causal, window)
        case = {f"flash {label} S={S}": (
            lambda: fa.flash_attention(q, k, v, causal=causal,
                                       window=window),
            lambda: ref.attention_ref(q, k, v, causal=causal,
                                      window=window),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True),
            2 * nbytes(q) + nbytes(k, v), flops)}
        big = S >= 2048
        out.update(time_cases(
            torch, Timer(torch, reps=5) if big else timer, case,
            plain_timer=Timer(torch, reps=2) if big else None,
            peak=BF16_FLOPS_PER_S))
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()
    return out


def cross_check_serve_small(torch):
    """The serving path on a small model: the port on the card (kernels)
    against the port on the CPU (plain versions), same params and
    prompts, f32."""
    import numpy as np
    from repro_torch.configs.registry import get_config, smoke_variant
    from repro_torch.convert import tree_to
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = smoke_variant(get_config(ARCH))
    with torch.inference_mode():
        params = M.init_params(torch.Generator().manual_seed(0), cfg)
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 40)).astype(np.int32)
        res = {}
        for dev in ("cuda", "cpu"):
            p = tree_to(params, torch.device(dev))
            toks = serve.greedy_generate(cfg, p, prompts, 8)
            logits = serve.prefill_step(
                p, {"tokens": torch.as_tensor(prompts, device=dev)}, cfg)
            res[dev] = toks, logits.cpu()
    torch.cuda.synchronize()
    check(np.array_equal(res["cuda"][0], res["cpu"][0]),
          "serve smoke: cuda and cpu generate different tokens")
    diff = max_err(torch, res["cuda"][1], res["cpu"][1])
    check(torch.allclose(res["cuda"][1], res["cpu"][1], rtol=1e-4,
                         atol=1e-4), "serve smoke: prefill logits differ")
    log(f"[small] {cfg.name} ({cfg.num_layers} layers, d {cfg.d_model}, "
        f"window {cfg.sliding_window}, f32): cuda == cpu on 2x8 greedy "
        f"tokens after a 40-token prompt; prefill logits max diff "
        f"{diff:.2e} (rtol 1e-4, atol 1e-4)")


def drive_serve_path(torch):
    """h2o-danube-1.8b at its published widths and depth through the
    port's serving entry points: greedy_generate (batch 4, prompt 32,
    gen 16), then prefill_step on the same prompts and on one
    8192-token sequence.  Returns the launch counts of the two kernels
    over the whole run and the run's numbers."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = get_config(ARCH)
    L, V = cfg.num_layers, cfg.vocab_size
    B, P, G = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, V, (B, P)).astype(np.int32)
    long_toks = torch.as_tensor(rng.integers(0, V, (1, LONG_S))
                                .astype(np.int32), device=dev)

    def counts():
        return rms.LAUNCHES["rmsnorm"], fa.LAUNCHES["flash_attention"]

    def delta(before):
        return tuple(a - b for a, b in zip(counts(), before))

    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        t0 = time.time()
        params = M.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in tree_leaves(params))
        n_bytes = sum(nbytes(t) for t in tree_leaves(params))
        log(f"[serve] {cfg.name}: {L} layers, d {cfg.d_model}, "
            f"H {cfg.num_heads}/KV {cfg.num_kv_heads}, hd "
            f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {V}, window "
            f"{cfg.sliding_window}, {cfg.dtype}: {n_params / 1e9:.3f} B "
            f"params, {n_bytes / 1e9:.2f} GB, random init from seed 0 in "
            f"{time.time() - t0:.1f} s")
        # one-time set-up (cuBLAS handles, the kernels' first loads) is
        # paid outside the counted runs
        serve.greedy_generate(cfg, params, prompts[:, :2], 1)
        serve.prefill_step(params, {"tokens": long_toks[:, :64]}, cfg)
        torch.cuda.synchronize()

        rms.reset_launch_counts()
        fa.reset_launch_counts()
        before = counts()
        t0 = time.time()
        out = serve.greedy_generate(cfg, params, prompts, G)
        torch.cuda.synchronize()
        gen_s = time.time() - t0
        steps = P + G
        check(delta(before) == (steps * (2 * L + 1), 0),
              f"greedy_generate launches {delta(before)}, expected "
              f"{steps * (2 * L + 1)} rmsnorm and no flash_attention")
        check(out.shape == (B, P + G) and np.array_equal(out[:, :P], prompts)
              and int(out.min()) >= 0 and int(out.max()) < V,
              "greedy_generate returned malformed tokens")
        log(f"[serve] greedy_generate B={B} prompt={P} gen={G}: {steps} "
            f"decode steps in {gen_s:.3f} s ({B * G / gen_s:.1f} new tok/s, "
            f"{B * steps / gen_s:.1f} tok/s with the replayed prompt, "
            f"{1e3 * gen_s / steps:.2f} ms/step); rmsnorm launches "
            f"{delta(before)[0]} = {steps} x {2 * L + 1}, flash 0")

        before = counts()
        t0 = time.time()
        short = serve.prefill_step(
            params, {"tokens": torch.as_tensor(prompts, device=dev)}, cfg)
        torch.cuda.synchronize()
        short_s = time.time() - t0
        check(delta(before) == (2 * L + 1, L),
              f"prefill_step launches {delta(before)}, expected "
              f"{(2 * L + 1, L)}")
        log(f"[serve] prefill_step B={B} S={P}: {1e3 * short_s:.2f} ms "
            f"({B * P / short_s:.0f} tok/s); launches rmsnorm "
            f"{2 * L + 1}, flash {L}")

        before = counts()
        t0 = time.time()
        long_logits = serve.prefill_step(params, {"tokens": long_toks},
                                         cfg)
        torch.cuda.synchronize()
        long_s = time.time() - t0
        check(delta(before) == (2 * L + 1, L),
              f"long prefill_step launches {delta(before)}")
        check(tuple(long_logits.shape) == (1, V)
              and bool(torch.isfinite(long_logits).all()),
              "long prefill: malformed or non-finite logits")
        log(f"[serve] prefill_step B=1 S={LONG_S} (window "
            f"{cfg.sliding_window}): {long_s:.3f} s ({LONG_S / long_s:.0f} "
            f"tok/s); launches rmsnorm {2 * L + 1}, flash {L}; peak "
            f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
            f"GB")
        launches = dict(zip(("rmsnorm", "flash_attention"), counts()))

        # two code paths for the same logits: the prefill's flash and
        # rmsnorm kernels against the decode replay's plain attention
        cache = M.init_cache(cfg, B, P, device=dev)
        toks = torch.as_tensor(prompts, device=dev)
        for i in range(P):
            dec, cache = M.decode_step(params, cache, toks[:, i:i + 1], i,
                                       cfg)
        dec = dec[:, 0].float()
        short = short.float()
    diff = float((short - dec).abs().max())
    top2 = short.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * PREFILL_DECODE_ATOL
    agree = short.argmax(-1) == dec.argmax(-1)
    first = torch.as_tensor(out[:, P], device=dev) == dec.argmax(-1)
    check(bool(torch.isfinite(short).all()) and diff <= PREFILL_DECODE_ATOL,
          f"prefill vs decode replay logits differ by {diff}")
    check(bool(agree[clear].all()), "prefill and decode disagree on a "
          "top-1 token whose margin exceeds twice the tolerance")
    check(bool(first.all()), "greedy's first token is not the replay's "
          "argmax")
    log(f"[serve] prefill logits vs decode replay at position {P - 1}: "
        f"max diff {diff:.4f} (atol {PREFILL_DECODE_ATOL}), max |logit| "
        f"{float(short.abs().max()):.3f}, top-1 agree "
        f"{int(agree.sum())}/{B} ({int(clear.sum())} rows with a clear "
        f"margin)")
    return launches, dict(gen_s=gen_s, short_s=short_s, long_s=long_s,
                          n_params=n_params)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    # float32 products in full float32 on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    build_kernels()

    from repro_torch.configs.registry import get_config
    from repro_torch.models.cnn import init_cnn
    from repro_torch.core.slab import slab_codec
    P = slab_codec(init_cnn(torch.Generator().manual_seed(0),
                            (32, 32, 3))).padded_size
    log(f"[shape] cnn-cifar slab P_pad={P}, K={K_MAX}")

    errs = compare_kernels(torch, P)
    times = time_kernels(torch, P)
    cross_check_small(torch)
    launches, _ = drive_main_path(torch)
    log(f"[phase] simulator path done at {time.time() - t_start:.1f} s")
    for name, n in drive_cluster_path(torch).items():
        launches[name] += n
    log(f"[phase] cluster path done at {time.time() - t_start:.1f} s")

    D = get_config(ARCH).d_model
    errs.update(compare_lm_kernels(torch, D))
    lm_times = time_lm_kernels(torch, D)
    # each kernel's line holds its time at the shape the path launches
    # most: rmsnorm at a decode step's rows, flash at the long prefill
    for name, case in (("rmsnorm", f"rmsnorm decode N={SERVE['batch']}"),
                       ("flash_attention",
                        f"flash long prefill S={LONG_S}")):
        times[name] = dict(lm_times[case], timed_at=case)
    cross_check_serve_small(torch)
    serve_launches, _ = drive_serve_path(torch)
    launches.update(serve_launches)
    log(f"[phase] serving path done at {time.time() - t_start:.1f} s")
    for name in PORTED:
        check(launches[name] > 0, f"{name} was never launched")

    kernels = []
    for name, (source, tpu) in PORTED.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": tpu, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "warm_ms": t["warm_ms"],
            "kernel_only_ms": t.get("kernel_only_ms"), "timed_at": t.get(
                "timed_at", f"K={K_MAX} P={P} f32"), "tpu_kernel": tpu,
            "status": "ported", "max_err": errs[name], "kernel_ms": t["ms"]})
    log(smi)
    print(json.dumps({"kernels": kernels, "pending": []}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
