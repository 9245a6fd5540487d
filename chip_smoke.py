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
  kernels; then ``lm-tiny`` (4,096 sequences of 16) hybrid, its final
  params slab against the same run on the CPU;
- the cluster: ``ClusterTrainer`` (``backend="cluster"``, in-process
  transport) on ``cnn-cifar`` at its published widths with 25 worker
  threads and batch 32 — sync twice (bitwise equal), async, hybrid, and
  hybrid AdamW with a kill, a respawn, checkpoints and a mid-run
  restore — checking the exact conservation ledger and that every
  server update went through a flush kernel;
- the cluster over the wire: the same trainer on ``transport="proc"``,
  25 worker processes sharing the card over Unix sockets (sync, bitwise
  equal to the in-process sync run; hybrid AdamW with a SIGKILL, a
  respawn, checkpoints and a restore), and on ``transport="socket"``,
  25 worker threads over TCP (async, the received bytes exactly the
  frames the ledger implies), with the card's utilization as
  ``nvidia-smi`` samples it, the wire bytes, the fleet's start-up and
  the peak host and card memory;
- the cluster over hosts: ``transport="host"``, ``repro_torch join``
  processes sharing the card (sync with a ``top`` stats reader attached,
  bitwise equal to the in-process sync run; an elastic hybrid AdamW run
  that grows from 20 to 25 joiners, with its Prometheus endpoint scraped
  twice and ``top`` reading it), and the proc hybrid AdamW run traced:
  the parent's ``grad_rx``, ``flush`` and ``publish`` span seconds as
  shares of the training window;
- the serving plane: an ``lm-tiny`` host leader (hybrid AdamW,
  ``serve_every=2``) with 8 ``repro_torch join`` processes, 2 ``python -m
  repro_torch infer`` processes and one in-process ``ServeClient`` that
  greedy-decodes successive params versions through the rmsnorm kernel
  while the flush kernels update them;
- serving: ``greedy_generate`` on h2o-danube-1.8b at its published
  widths and depth (batch 4, prompt 32, gen 16) and ``prefill_step`` on
  the 32-token prompts and on one 8192-token sequence, checking that
  every norm went through the rmsnorm kernel and every full-sequence
  attention through the flash_attention kernel;
- the rest of the model stack: flash_attention with a chunk mask and
  with d_v != d, and rmsnorm at the new families' widths, against their
  plain versions and timed; ``[serve-mla-moe]``, deepseek-v2-lite-16b at
  its published widths and depth (27 MLA + MoE layers, 32.4 GB bf16)
  through ``greedy_generate`` and ``prefill_step`` (S 32 and 4096), 55
  rmsnorm and 27 flash launches a forward, the prefill against the
  plain forward and a decode replay; ``[zoo-sim]``, ``SimulatorTrainer``
  on ``zoo:xlstm`` at xlstm-350m's shape (hybrid, 16 workers, f32 slab;
  every flush a ``flush`` launch, staging and data on the card, the loss
  falling),
  then ``zoo:xlstm`` and ``zoo:transformer`` at x0.25 against the CPU
  (zoo:xlstm's gradient leaf by leaf within its one-ulp spread);
  ``[zoo-wire]``, the ported ``smoke_zoo`` (proc, bf16 slab, AdamW);
  ``[arch]``, every registry family's smoke variant against the CPU,
  one full-width group of jamba (prefill S 2048, greedy decode) and of
  llama4-scout (prefill S 16384 through the chunked kernel),
  hubert-xlarge and phi-3-vision at full width.  Each releases its
  weights before the next;
- the dry-run against the card (``[dryrun]``): state, prefill and train
  step bytes and times against the meta device's predictions, the
  train step being h2o-danube-1.8b's AdamW step at full width at S 1024
  without rematerialisation and at S 2048 and S 4096 with the config's
  remat "block", the remat gradient against the no-remat one, and
  ``torch.sqrt`` of float32 on the card against the correctly rounded
  root on every non-negative float32;
- the SPMD backend: ``torchrun`` of 4 ``python -m repro_torch run
  --backend spmd`` ranks sharing the card over gloo, xlstm-350m at its
  published width with its remat "block" (2 of its 6 block groups),
  annealed g 1 -> 2 -> 4 (7
  gradients; the g 2 and g 4 phases in the reference's FSDP layout,
  each rank's state held against the partition rules' shard bytes and
  its step peak against the dry-run's traced FSDP peak; every merge
  split along P, a ``flush`` launch on each rank at K 4, 2 and 1), then
  h2o-danube-1.8b's smoke variant on 2 ranks, the card against the CPU
  and a sync run twice (bitwise equal), and ``flush`` alone at the
  merge's shape (the full-width run starts once ``[zoo-sim]``'s 1.0 run
  has released the card, beside its small runs and ``[zoo-wire]``;
  ``[arch]`` runs before ``[zoo-sim]``);
- the model axis (``[spmd-tp]``): three runs side by side, each 4 gloo
  ranks sharing the card as data 2 x model 2, hybrid step:1 over 2
  steps of 2 x 512, SGD, at published widths: h2o-danube-1.8b
  (attention + MLP, 2 of its 24 block groups), deepseek-v2-lite-16b
  (MLA + MoE, 1 of its 27) and xlstm-350m (mLSTM + sLSTM, 1 of its 6
  groups; it starts once h2o's has ended, the other two when ``[spmd]``'s
  full run has); each rank's state
  against the partition rules' shards to the byte, one ``flush`` launch
  a rank at K 2 and at K 1 (each model column merges its own slices),
  the leaves whole on every model rank and every MoE layer's routing
  equal across each model group, the final params assembled in rank 0's
  host memory (the cut config's shapes, finite, the whole leaves the
  ranks' bit for bit); then, in the same torchrun, a sliced prefill and
  greedy decode of 4 prompts of 24 tokens and 8 new
  (``repro_torch/serve_smoke.py``) from params drawn sliced on the card
  (bf16: the launches, which count in the kernels line, and the times),
  then the same slices drawn in float32, their prefill and their decode
  fed rank 0's whole run's tokens, within 1e-3 of the same params served
  whole in float32; each rank's cache bytes the dry-run's, the routing
  equal across each model group, rmsnorm and flash launched on the
  sliced path; then the same for 1 prompt (``long_500k``'s B 1, which
  the data axis does not divide: every rank serves the row, the cache
  of 32 cut along its sequence or channels over data x model, so the
  prompt's slots cross from data position 0 to 1), every rank's tokens
  equal; then ``flush`` alone at a rank's chunk of each
  run's merge, bitwise against its plain version.  Four cards
  are ``python -m repro_torch.multicard_smoke``'s (NCCL), not this
  script's.

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
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 dense tensor cores
K_MAX = 25                       # the paper's fleet: at most one row each
HORIZON = 1.0                    # virtual seconds per main-path run
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
LM_P = 98_304                    # lm-tiny's params slab, padded
LM_TEST_SEQS, LM_SEQ = 512, 16   # ... its held-out sequences, full width
SERVE_WORKERS = 8                # [cluster-serve]: joined workers
SERVE_EVERY = 2                  # ... and its serve clients' down-sampling
INFER_PROCS, INFER_REQUESTS = 2, 4
SERVE_DECODES = 3                # params versions the in-process client reads
# the serving run ends once every client is done (a cap, never reached in
# a healthy run)
SERVE_BUDGET_S = 240.0
SERVE_MIN_S = 6.0                # ... and lasts at least this long
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


KERNEL_TRACE_TRIES = 3            # traces of kernel_only_ms before it fails


def kernel_only_ms(torch, fn, kernel: str, reps: int = 50) -> float:
    """Median device duration of the kernel named ``kernel`` over the
    last ``reps`` of ``reps + 30`` cold calls of ``fn``, from the
    profiler's raw trace: the kernel alone, without the gaps the CUDA
    events around a call also time.  The tracer can miss kernels (12 of
    60 calls once, after the long traced cluster runs; 31 of 40 once at
    the end of the script): the calls queue behind a 0.1 s device
    sleep, the first ones are spares, the trace stays open 0.2 s after
    the last kernel ends, and a trace that still holds fewer than
    ``reps`` of them is logged and taken again, up to
    ``KERNEL_TRACE_TRIES`` times."""
    from torch.profiler import ProfilerActivity, profile
    scrub = torch.ones(64 << 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    calls = reps + 30
    for attempt in range(1, KERNEL_TRACE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(int(2e8))
            for _ in range(calls):
                scrub.sum()
                fn()
            torch.cuda.synchronize()
            time.sleep(0.2)
        events = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA]
        durations = sorted((e.start_ns(), (e.end_ns() - e.start_ns()) / 1e3)
                           for e in events if kernel in e.name())
        if len(durations) >= reps:
            return statistics.median(d for _, d in durations[-reps:]) / 1e3
        starts = [e.start_ns() for e in events]
        span = ((max(starts) - min(starts)) / 1e6) if starts else 0.0
        log(f"[time] {kernel}: trace {attempt} of {KERNEL_TRACE_TRIES} "
            f"holds {len(durations)} of its {calls} launches and "
            f"{len(events)} device events of {2 * calls + 1}, over "
            f"{span:.3f} ms")
    check(False, f"{kernel}: fewer than {reps} kernels in each of "
          f"{KERNEL_TRACE_TRIES} traces of {calls} calls")


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


def storage_bytes(tree) -> int:
    """What a tree's tensors hold on the card: each storage's bytes,
    rounded up to the caching allocator's 512-byte unit.  (The
    allocator's own count can be higher by up to 1 MiB an allocation: a
    request above 1 MiB takes a whole segment when less than 1 MiB would
    be left over.)"""
    seen = {}
    for t in tree_leaves(tree):
        st = t.untyped_storage()
        seen[st.data_ptr()] = -(-st.nbytes() // 512) * 512
    return sum(seen.values())


def step_bytes(torch):
    """Start measuring a step's own device bytes; the returned function,
    called after the step (synchronized), gives its peak minus what was
    allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    return lambda: torch.cuda.max_memory_allocated() - held


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
    smem = {f"{d}/{dv}": lib.flash_attention_bf16_smem_bytes(d, dv)
            for d, dv in fa.HEAD_DIMS}
    log(f"[build] flash_attention: flash_fwd_bf16_kernel dynamic shared "
        f"memory by head dims d/d_v (bytes): {smem}")


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


def compare_kernels(torch, P: int, K: int = K_MAX):
    """Each flush kernel against its plain version on the card, twice,
    at K staging rows of a P-element slab."""
    from repro_torch.kernels import hybrid_aggregate as ha
    from repro_torch.kernels import ref
    from repro_torch.optim import bias_correction

    log(f"[check] flush kernels at K={K} P={P}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
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
        # name: (kernel, plain, library call or None, (flops, bytes))
        "flush": (lambda: ha.flush(g, w), lambda: ref.flush_ref(g, w),
                  lambda: w @ g, ha.cost("flush", K, P, 4)),
        "flush_momentum": (
            lambda: ha.flush_momentum(g, wn, m, 0.9),
            lambda: ref.flush_momentum_ref(g, wn, m, 0.9),
            lambda: torch.addmv(m, g.t(), wn, beta=0.9),
            ha.cost("flush_momentum", K, P, 4)),
        "flush_adamw": (
            lambda: ha.flush_adamw(g, wn, p, mu, nu, bc[0], bc[1], 1e-9,
                                   **h),
            lambda: ref.flush_adamw_ref(g, wn, p, mu, nu, bc[0], bc[1],
                                        1e-9, **h),
            None, ha.cost("flush_adamw", K, P, 4)),
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
    ``name: (kernel, plain, library or None, (flops, bytes))``: the work
    is the kernel module's own ``cost``, the formula the dry-run counts
    its launches by."""
    out = {}
    for name, (kern, plain, lib, (flops, nb)) in cases.items():
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
    """cnn-cifar at full width through the port's own trainer, then
    lm-tiny.  Returns every kernel's launches over the counted runs."""
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
        check(all(t.is_cuda for t in (engine.x_tr, engine.y_tr, *agg._master,
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
    launches = dict(ha.LAUNCHES)
    for name, n in drive_lm_tiny_sim(torch, trainer, base).items():
        launches[name] = launches.get(name, 0) + n
    return launches, results


def drive_lm_tiny_sim(torch, trainer, base):
    """lm-tiny at its full width (4,096 sequences of 16) through the
    simulator, hybrid, 25 workers: every flush through the flush kernel
    (by staging rows), the loss falls, and the final params slab allclose
    to the same run on the CPU (f32, rtol 1e-5 / atol 1e-6).  Workers
    differentiate the plain forward; the metrics' accuracy runs the
    serving forward, whose norms and attention are kernels on the card.
    Returns the launches of every kernel in this run."""
    from repro_torch.api import SimulatorTrainer
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hybrid_aggregate as ha
    from repro_torch.kernels import rmsnorm as rms

    spec = base.with_(arch="lm-tiny", mode="hybrid", schedule="step:300")
    ha.reset_launch_counts()
    rms.reset_launch_counts()
    fa.reset_launch_counts()
    t0 = time.time()
    res = trainer.run(spec)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ha.LAUNCHES, rmsnorm=rms.LAUNCHES["rmsnorm"],
                    flash_attention=fa.LAUNCHES["flash_attention"])
    by_k = dict(ha.LAUNCHES_BY_K)
    check(by_k == {("flush", K_MAX): res.num_updates} and res.num_updates
          == launches["flush"] > 0,
          f"lm-tiny: flush launches by K {by_k} vs {res.num_updates} "
          "flushes")
    tl = res.metrics["train_loss"]
    check(all(math.isfinite(x) for x in tl) and tl[-1] < tl[0],
          f"lm-tiny: train loss did not fall: {tl}")
    agg = trainer.engine(spec)._agg_cache[K_MAX]
    check(agg.params_slab.is_cuda and agg.codec.padded_size == LM_P,
          f"lm-tiny: slab {agg.codec.padded_size} on "
          f"{agg.params_slab.device}")
    gpu_slab = agg.params_slab.cpu()
    t1 = time.time()
    cpu_trainer = SimulatorTrainer(device="cpu")
    cres = cpu_trainer.run(spec)
    cpu_s = time.time() - t1
    cpu_slab = cpu_trainer.engine(spec)._agg_cache[K_MAX].params_slab
    check((cres.num_updates, cres.num_gradients)
          == (res.num_updates, res.num_gradients),
          "lm-tiny: cuda and cpu runs disagree on event counts")
    diff = max_err(torch, gpu_slab, cpu_slab)
    check(torch.allclose(gpu_slab, cpu_slab, rtol=1e-5, atol=1e-6),
          f"lm-tiny: cuda params slab differs from cpu's by {diff}")
    # the metrics against the CPU run's: test_loss through the plain
    # forward (f32, rtol 1e-5 / atol 1e-6), test_acc through the serving
    # forward's kernels (argmax over 8,192 tokens: at most 4 tokens may
    # flip on a near-tie, 4/8192 = 4.9e-4)
    tgt, tcpu = res.metrics["test_loss"], cres.metrics["test_loss"]
    agt, acpu = res.metrics["test_acc"], cres.metrics["test_acc"]
    acc_diff = max(abs(a - b) for a, b in zip(agt, acpu))
    check(len(tgt) == len(tcpu) and all(math.isclose(
        a, b, rel_tol=1e-5, abs_tol=1e-6) for a, b in zip(tgt, tcpu)),
          f"lm-tiny: test_loss {tgt} vs the CPU run's {tcpu}")
    check(len(agt) == len(acpu) and acc_diff <= 4 / (LM_TEST_SEQS * LM_SEQ),
          f"lm-tiny: test_acc {agt} vs the CPU run's {acpu}")
    log(f"[sim] lm-tiny  hybrid           wall {res.wall_s:.2f} s "
        f"({wall:.2f} s with the dataset's build)  {res.num_gradients} "
        f"grads  {res.num_updates} flushes  flush launches by staging "
        f"rows {by_k}  train_loss {tl[0]:.4f} -> {tl[-1]:.4f}  test_acc "
        f"{res.metrics['test_acc'][-1]:.4f}; metrics' serving forward "
        f"rmsnorm {launches['rmsnorm']} / flash "
        f"{launches['flash_attention']} launches; P={LM_P} params slab "
        f"vs the CPU run ({cpu_s:.1f} s): max diff {diff:.2e} (rtol 1e-5,"
        f" atol 1e-6); test_acc over {len(agt)} samples max diff "
        f"{acc_diff:.2e} (at most {4 / (LM_TEST_SEQS * LM_SEQ):.2e})")
    return launches


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
    flush kernels' launches over the counted runs, each run's grads/s
    and the first sync run's final params."""
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
    return launches, rates, finals[0]


# ---------------------------------------------- cluster over the wire

def tree_rss_bytes(root: int) -> int:
    """Resident memory of ``root`` and every process below it."""
    children = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        children.setdefault(ppid, []).append(int(d))
    total, todo = 0, [root]
    page = os.sysconf("SC_PAGE_SIZE")
    while todo:
        pid = todo.pop()
        todo.extend(children.get(pid, ()))
        try:
            with open(f"/proc/{pid}/statm") as f:
                total += int(f.read().split()[1]) * page
        except (OSError, ValueError, IndexError):
            pass
    return total


def host_used_bytes() -> int:
    """The host's memory in use: MemTotal - MemAvailable."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            info[key] = int(value.split()[0]) * 1024
    return info["MemTotal"] - info["MemAvailable"]


class CardMonitor:
    """Every 0.2 s while a run lasts: the card's utilization and memory
    in use as ``nvidia-smi`` samples them (it sees the kernels of every
    process on the card, where the parent's profiler sees only its own),
    the host's memory in use and the resident memory of this process and
    its children."""

    def __init__(self):
        import threading
        self.card = []      # (epoch s, utilization %, memory used MiB)
        self.host = []      # (epoch s, tree RSS bytes, host used bytes)
        self.host_before = host_used_bytes()
        self._stop = threading.Event()
        self._smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=timestamp,utilization.gpu,"
             "memory.used", "--format=csv,noheader,nounits", "-lms", "200"],
            stdout=subprocess.PIPE, text=True)
        self._threads = [threading.Thread(target=f, daemon=True)
                         for f in (self._read_smi, self._sample_host)]
        for t in self._threads:
            t.start()
        deadline = time.time() + 30
        while not self.card and time.time() < deadline:
            time.sleep(0.05)
        if not self.card:
            self.stop()
            raise AssertionError("nvidia-smi gave no sample within 30 s")
        self.card_before = self.card[-1][2]

    def _read_smi(self):
        from datetime import datetime
        for line in self._smi.stdout:
            try:
                stamp, util, mem = (x.strip() for x in line.split(","))
                t = datetime.strptime(stamp, "%Y/%m/%d %H:%M:%S.%f")
                self.card.append((t.timestamp(), float(util), float(mem)))
            except ValueError:
                continue

    def _sample_host(self):
        me = os.getpid()
        while not self._stop.wait(0.2):
            self.host.append((time.time(), tree_rss_bytes(me),
                              host_used_bytes()))

    def window(self, runtime, window: float, label: str):
        """Over the run's training window (the ``window`` seconds since
        the clock's start, ``runtime._t0``): the card's utilization
        samples; over the whole run: the card's peak memory in use, the
        process tree's peak RSS and the host's peak memory in use above
        the start."""
        t1 = time.time() - (time.monotonic() - runtime._t0 - window)
        t0 = t1 - window
        utils = [u for t, u, _ in self.card if t0 <= t <= t1]
        check(len(utils) > 0, f"{label}: no utilization sample in the "
              "training window")
        return (utils, max(m for _, _, m in self.card),
                max(r for _, r, _ in self.host),
                max(h for _, _, h in self.host) - self.host_before)

    def stop(self):
        self._stop.set()
        self._smi.terminate()
        try:
            self._smi.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._smi.kill()
            self._smi.wait()
        for t in self._threads:
            t.join(timeout=10)


def drive_wire_path(torch, P: int, inproc_rates, inproc_sync_params):
    """cnn-cifar at full width through ``ClusterTrainer`` on the wire
    transports: 25 worker processes sharing the card over Unix sockets
    (sync, then hybrid AdamW with a SIGKILL, a respawn, checkpoints and a
    restore), and 25 worker threads over TCP (async).  Returns the flush
    kernels' launches over the three runs."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip-smoke-wire-") as ckpt_dir:
        return wire_runs(torch, ckpt_dir, P, inproc_rates,
                         inproc_sync_params)


def wire_runs(torch, ckpt_dir: str, P: int, inproc_rates,
              inproc_sync_params):
    from repro_torch.api import ExperimentSpec, FaultPlan
    from repro_torch.cluster.trainer import ClusterTrainer
    from repro_torch.kernels import hybrid_aggregate as ha
    from repro_torch.profile_sim import profiled

    trainer = ClusterTrainer(ckpt_dir=ckpt_dir, device="cuda")
    base = ExperimentSpec(arch="cnn-cifar", backend="cluster", smoke=False,
                          seed=0, lr=0.01, batch=32, cluster_workers=25,
                          wall_budget_s=CLUSTER_BUDGET_S,
                          wall_sample_every_s=1.0)
    faults = FaultPlan(kill=((3, 1.0),), respawn_after_s=0.5,
                       checkpoint_every_s=1.0, restore_at_s=2.5)
    runs = [  # label, spec, kernel, the [cluster] run of the same spec
        ("proc sync sgd", base.with_(
            transport="proc", mode="sync", schedule=None,
            max_gradients=250, wall_budget_s=60.0), "flush",
         "sync sgd #1"),
        ("proc hybrid adamw faults", base.with_(
            transport="proc", mode="hybrid", schedule=CLUSTER_SCHEDULE,
            optimizer="adamw", faults=faults, wall_budget_s=6.0),
         "flush_adamw", "hybrid adamw faults"),
        ("socket async sgd", base.with_(transport="socket", mode="async",
                                        schedule=None), "flush",
         "async sgd"),
    ]
    hello, grad_frame = 5 + 14, 5 + 16 + 4 * P
    traced = "proc hybrid adamw faults"
    trace_path = os.path.join(ckpt_dir, "proc_hybrid_adamw.trace.json")
    ha.reset_launch_counts()
    rates = {}
    for label, spec, kernel, twin in runs:
        before = dict(ha.LAUNCHES)
        # [cluster-obs]: the proc hybrid AdamW run records its timeline
        trainer.trace = trace_path if label == traced else None
        runtime = trainer.build_runtime(spec)
        torch.cuda.reset_peak_memory_stats()
        monitor = CardMonitor()
        try:
            res, prof = profiled(lambda: trainer.finish(runtime, spec),
                                 host_ops=False)
        finally:
            monitor.stop()
        card0 = monitor.card_before
        delta = {k: ha.LAUNCHES[k] - before[k] for k in ha.LAUNCHES}
        a = check_ledger(res, label)
        check("torn_frames" in a, f"{label}: no torn_frames in {a}")
        check(delta[kernel] == res.num_updates + 1
              and sum(delta.values()) == delta[kernel],
              f"{label}: launches {delta} vs {res.num_updates} updates")
        losses = res.metrics["train_loss"] + res.metrics["test_loss"]
        check(all(math.isfinite(x) for x in losses) and len(losses) > 0,
              f"{label}: non-finite or missing losses")
        window = res.extra["serve_wall_s"]
        utils, card_peak, rss_peak, host_peak = monitor.window(
            runtime, window, label)
        counters = res.extra["telemetry"]["counters"]
        rx, tx = counters.get("wire.rx_bytes", 0), \
            counters.get("wire.tx_bytes", 0)
        rate = rates[label] = res.num_gradients / window
        events = [e["event"] for e in res.extra["events"]]
        ready = res.extra.get("fleet_ready_s")
        log(f"[cluster-wire] cnn-cifar {label:25s} {res.num_gradients} "
            f"grads in {window:.2f} s ({rate:.1f} grads/s; inproc "
            f"'{twin}' {inproc_rates[twin]:.1f} grads/s in [cluster]), "
            f"{res.num_updates} updates, {a['dropped']} dropped, "
            f"{a['in_flight']} in flight, torn frames {a['torn_frames']}; "
            f"ledger computed {a['computed']} == applied {a['applied']} + "
            f"dropped {a['dropped']} + buffered {a['buffered']} + pending "
            f"{a['pending_round']} + in flight {a['in_flight']}; {kernel} "
            f"launches {delta[kernel]} = {res.num_updates} updates + 1 "
            f"warm-up; parent's flush kernels "
            f"{prof['device_s_by_group'].get('flush kernels', 0.0):.6f} s "
            f"device time; card utilization (nvidia-smi, 0.2 s) mean "
            f"{statistics.mean(utils):.1f}% median "
            f"{statistics.median(utils):.1f}% over {len(utils)} samples; "
            f"wire rx {rx / window / 1e6:.1f} MB/s tx "
            f"{tx / window / 1e6:.1f} MB/s; spawn to release "
            f"{'%.2f s' % ready if ready is not None else 'n/a (threads)'};"
            f" peak card memory {card_peak:.0f} MiB (before the run "
            f"{card0:.0f}), parent "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB "
            f"allocated; peak host RSS of the process tree "
            f"{rss_peak / 2**30:.2f} GiB, host memory in use +"
            f"{host_peak / 2**30:.2f} GiB; test_acc "
            f"{res.final()['test_acc']:.4f}; events {events}")
        if spec.transport == "proc":
            # 25 contexts on the card: a child that computed on the host
            # would add none
            check(card_peak - card0 > 25 * 100,
                  f"{label}: card memory grew {card_peak} - {card0} MiB, "
                  "too little for 25 worker processes on the card")
        if label == "proc sync sgd":
            check(res.num_updates == 10 and a["applied"] == 250,
                  f"{label}: {res.num_updates} rounds, expected 10 of 25")
            final = trainer.last_params
            check(all(torch.equal(final[k], inproc_sync_params[k])
                      for k in final),
                  "proc sync final params differ from inproc sync #1's")
            log("[cluster-wire] proc sync sgd: final params bitwise equal "
                "to [cluster]'s inproc sync sgd #1")
        if label == "proc hybrid adamw faults":
            for kind in ("kill", "respawn", "checkpoint", "restore"):
                check(kind in events, f"{label}: no {kind} event: {events}")
            kill = next(e for e in res.extra["events"]
                        if e["event"] == "kill")
            check(kill["sigkill"] is True, f"{label}: kill was no SIGKILL")
            st = runtime.server.snapshot_opt_state()
            check(all(bool(torch.isfinite(torch.as_tensor(st[m])).all())
                      for m in ("mu", "nu")), f"{label}: moments not finite")
            trace_shares(res, window, rate)
        if spec.transport == "socket":
            conns = spec.cluster_workers
            check(rx == hello * conns + grad_frame * a["computed"],
                  f"{label}: wire.rx_bytes {rx} != {hello} x {conns} + "
                  f"{grad_frame} x {a['computed']}")
            log(f"[cluster-wire] socket async sgd: wire.rx_bytes {rx} = "
                f"{hello} x {conns} connections + {grad_frame} x "
                f"{a['computed']} computed")
    return dict(ha.LAUNCHES), rates


def trace_shares(res, window: float, rate: float) -> None:
    """[cluster-obs]: the traced run's Chrome trace, read back from its
    file: the parent's ``grad_rx`` (25 hub reader threads, concurrent, so
    their sum may pass 100%), ``flush`` and ``publish`` span seconds as
    shares of the training window."""
    path = res.extra["trace_path"]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    tracks = {e["args"]["name"] for e in events if e["ph"] == "M"
              and e["name"] == "thread_name"}
    spans = {}
    for e in events:
        if e["ph"] == "X":
            n, s = spans.get(e["name"], (0, 0.0))
            spans[e["name"]] = (n + 1, s + e["dur"] / 1e6)
    for name in ("grad_rx", "flush", "publish"):
        check(spans.get(name, (0, 0))[0] > 0,
              f"traced run: no {name} span in {sorted(spans)}")
    shares = {k: f"{spans[k][0]} spans {spans[k][1]:.4f} s = "
                 f"{100 * spans[k][1] / window:.2f}%"
              for k in ("grad_rx", "flush", "publish")}
    log(f"[cluster-obs] proc hybrid adamw faults traced ({rate:.1f} grads/s"
        f" with spans recorded): {len(events)} trace events on "
        f"{len(tracks)} tracks written to {os.path.basename(path)}; the "
        f"parent's span seconds over the {window:.2f} s training window: "
        f"grad_rx {shares['grad_rx']} (summed over 25 concurrent hub "
        f"readers; the bounded put, i.e. backpressure), flush "
        f"{shares['flush']} (the flush's dispatch from the host: the "
        f"kernel is enqueued, not waited for), publish {shares['publish']}")


# ------------------------------------------------ cluster over hosts

HOST_SEED, HOST_MAX = 20, 25     # the elastic run's seed fleet and ceiling
HOST_KILLED = 3                  # the seed worker whose connection is cut
# the elastic run ends once its checks can be read (a cap, never reached
# in a healthy run): 20 joiners start in 80-100 s before the clock, and
# 5 more, spawned at the first applied gradient, take about 21 s of one
# core each (python -m repro_torch.profile_spawn) on cores the 20
# training processes share
HOST_BUDGET_S = 300.0
HOST_GROW_TIMEOUT_S = 240.0


def grown_flush_check(torch, P: int):
    """The flush kernels on a staging buffer grown from 20 to 25 rows,
    as elastic admission grows it mid-run: the staged rows survive the
    resize, and ``flush`` and ``flush_adamw`` read the new buffer,
    bitwise equal to their plain versions on the same tensors."""
    from repro_torch.core.slab import SlabAggregator, slab_codec
    from repro_torch.kernels import hybrid_aggregate as ha
    from repro_torch.kernels import ref
    from repro_torch.optim import bias_correction

    gen = torch.Generator(device="cuda").manual_seed(5)
    params = {"slab": torch.randn(P, device="cuda", generator=gen)}
    agg = SlabAggregator(slab_codec(params), params, HOST_SEED)
    rows = torch.randn(HOST_MAX, P, device="cuda", generator=gen)
    for i in range(HOST_SEED):
        agg.stage(rows[i], i)
    agg.grow(HOST_MAX)
    for i in range(HOST_SEED, HOST_MAX):
        agg.stage(rows[i], i)
    (staging,) = agg._staging
    check(tuple(staging.shape) == (HOST_MAX, P)
          and torch.equal(staging, rows),
          "the grown staging buffer lost or changed a staged row")
    w = torch.rand(HOST_MAX, device="cuda", generator=gen) + 0.1
    wn = w / w.sum()
    errs = {}
    got, want = ha.flush(staging, w), ref.flush_ref(staging, w)
    check(torch.equal(got, want), "flush on the grown buffer differs from "
          "its plain version")
    check(not torch.equal(got, ref.flush_ref(staging[:HOST_SEED],
                                             w[:HOST_SEED])),
          "flush on the grown buffer ignored the new rows")
    errs["flush"] = max_err(torch, got, want)
    bc1, bc2 = bias_correction(torch.tensor(3, dtype=torch.int32,
                                            device="cuda"), 0.9, 0.95)
    p = torch.randn(P, device="cuda", generator=gen)
    mu = 0.1 * torch.randn(P, device="cuda", generator=gen)
    nu = 0.01 * torch.randn(P, device="cuda", generator=gen).abs()
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)
    want = ref.flush_adamw_ref(staging, wn, p, mu, nu, bc1, bc2, 0.01, **kw)
    got = ha.flush_adamw(staging, wn, p.clone(), mu.clone(), nu.clone(),
                         bc1, bc2, 0.01, **kw)
    for part, a, b in zip(("params", "mu", "nu"), got, want):
        check(torch.equal(a, b), f"flush_adamw {part} on the grown buffer "
              "differs from its plain version")
    errs["flush_adamw"] = max(max_err(torch, a, b) for a, b in zip(got, want))
    torch.cuda.synchronize()
    log(f"[cluster-host] staging grown {HOST_SEED} -> {HOST_MAX} rows at "
        f"P={P}: staged rows kept; flush and flush_adamw bitwise equal to "
        f"their plain versions over all {HOST_MAX} rows (max_abs_err "
        f"{errs['flush']:.1e}, {errs['flush_adamw']:.1e})")
    return errs


def drive_host_path(torch, P: int, inproc_rates, wire_rates,
                    inproc_sync_params):
    """cnn-cifar at full width through ``ClusterTrainer`` on the ``host``
    transport: a leader on 127.0.0.1 and ``python -m repro_torch join``
    processes sharing the card (sync with 25 joiners; hybrid AdamW whose
    fleet grows from 20 to 25 while it trains, with a connection cut
    and a rejoin).  Returns the flush kernels' launches over both runs."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip-smoke-host-") as ckpt_dir:
        return host_runs(torch, ckpt_dir, P, inproc_rates, wire_rates,
                         inproc_sync_params)


def wait_joiners(procs, label: str, timeout_s: float = 120.0):
    """Every joiner's exit code (a joiner still running is killed and
    reported); all must be 0."""
    codes = {}
    deadline = time.monotonic() + timeout_s
    for wid, p in procs.items():
        try:
            codes[wid] = p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            codes[wid] = "stranded"
    bad = {w: c for w, c in codes.items() if c != 0}
    check(not bad, f"{label}: joiners exited {bad}")
    return codes


def scrape(url: str):
    """One Prometheus scrape: (HTTP status, repro_grads_applied_total)."""
    import urllib.request
    with urllib.request.urlopen(url, timeout=10.0) as r:
        text = r.read().decode("utf-8")
        status = r.status
    applied = [int(line.split()[1]) for line in text.splitlines()
               if line.startswith("repro_grads_applied_total ")]
    check(len(applied) == 1, f"no repro_grads_applied_total in {text!r}")
    return status, applied[0]


class ElasticDirector:
    """What the elastic run's operator does, from a thread beside the
    leader: spawn the late joiners once the first gradient is applied,
    wait for the fleet to reach the ceiling and flush at K 25, scrape the
    leader's Prometheus endpoint, cut one seed worker's connection, wait
    for its rejoin at the next generation and a few more updates, watch
    three ``top`` rows, scrape again, then end the run."""

    def __init__(self, runtime, spawn):
        import threading
        self.runtime, self.spawn = runtime, spawn
        self.late = {}
        self.error = None
        self.marks = {}
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _poll(self, predicate, timeout_s: float, what: str) -> None:
        deadline = time.monotonic() + timeout_s
        while not predicate():
            check(time.monotonic() < deadline, f"timed out waiting: {what}")
            time.sleep(0.05)

    def _run(self):
        from repro_torch.kernels import hybrid_aggregate as ha
        rt = self.runtime
        try:
            self._poll(lambda: getattr(rt, "server", None) is not None
                       and rt.server.applied > 0, 600.0,
                       "the first applied gradient")
            t_late = time.monotonic()
            self.marks["release_to_late_spawn_s"] = t_late - rt._t0
            for wid in range(HOST_SEED, HOST_MAX):
                self.late[wid] = self.spawn(wid)
            self._poll(lambda: rt.fleet_size == HOST_MAX,
                       HOST_GROW_TIMEOUT_S, f"the fleet to grow to "
                       f"{HOST_MAX}")
            self.marks["late_spawn_to_grown_s"] = time.monotonic() - t_late
            self._poll(lambda: ha.LAUNCHES_BY_K.get(
                ("flush_adamw", HOST_MAX), 0) > 0, 60.0,
                f"a flush_adamw launch at K {HOST_MAX}")
            self.marks["scrapes"] = [scrape(rt.prom_server.url)]
            self.marks["cut"] = rt.transport.kill_worker(HOST_KILLED)
            t_cut = time.monotonic()
            self._poll(lambda: any(
                e["event"] == "member_join" and e["worker"] == HOST_KILLED
                and e["generation"] == 1 for e in list(rt.events)), 60.0,
                f"worker {HOST_KILLED} to rejoin at generation 1")
            self.marks["cut_to_rejoin_s"] = time.monotonic() - t_cut
            mark = rt.server.applied
            self._poll(lambda: rt.server.applied >= mark + 500, 60.0,
                       "500 more gradients after the rejoin")
            import io
            from repro_torch.obs.top import top_main
            out = io.StringIO()
            self.marks["top"] = (top_main(tuple(rt.listen_address),
                                          count=3, out=out),
                                 out.getvalue().splitlines())
            self.marks["scrapes"].append(scrape(rt.prom_server.url))
        except Exception as e:          # raised in the main thread
            self.error = e
        finally:
            server = getattr(rt, "server", None)
            if server is not None:
                server.done.set()       # end the run


def host_runs(torch, ckpt_dir: str, P: int, inproc_rates, wire_rates,
              inproc_sync_params):
    from repro_torch.api import ExperimentSpec, FaultPlan
    from repro_torch.cluster.hostlink import spawn_join_process
    from repro_torch.cluster.trainer import ClusterTrainer
    from repro_torch.kernels import hybrid_aggregate as ha
    from repro_torch.obs.top import StatsClient
    from repro_torch.profile_sim import profiled

    trainer = ClusterTrainer(ckpt_dir=ckpt_dir, device="cuda")
    base = ExperimentSpec(arch="cnn-cifar", backend="cluster", smoke=False,
                          seed=0, lr=0.01, batch=32, cluster_workers=25,
                          transport="host", listen="127.0.0.1:0",
                          heartbeat_s=2.0, wall_sample_every_s=1.0)
    runs = [  # label, spec, kernel, the inproc and proc runs of the mode
        ("host sync sgd", base.with_(
            mode="sync", schedule=None, max_gradients=250,
            wall_budget_s=60.0), "flush", "sync sgd #1", "proc sync sgd"),
        ("host elastic hybrid adamw", base.with_(
            mode="hybrid", schedule=CLUSTER_SCHEDULE, optimizer="adamw",
            cluster_workers=HOST_SEED, max_workers=HOST_MAX,
            wall_budget_s=HOST_BUDGET_S, wall_sample_every_s=5.0,
            faults=FaultPlan(checkpoint_every_s=2.0)),
         "flush_adamw", "hybrid adamw faults", "proc hybrid adamw faults"),
    ]
    ha.reset_launch_counts()
    for label, spec, kernel, twin, wire_twin in runs:
        elastic = spec.max_workers is not None
        before = dict(ha.LAUNCHES)
        before_k = dict(ha.LAUNCHES_BY_K)
        # [cluster-obs]: the elastic leader serves /metrics, and a
        # stats reader watches the sync run from its start
        trainer.prom_port = 0 if elastic else None
        runtime = trainer.build_runtime(spec)
        addr = runtime.listen_address
        reader = None if elastic else StatsClient(addr)

        def spawn(wid=None):
            # the seed worker whose connection is cut rejoins; no other
            # joiner outlives its session
            return spawn_join_process(
                addr, worker_id=wid, device="cuda", connect_timeout=600.0,
                reconnect_s=30.0 if elastic and wid == HOST_KILLED else 0)

        torch.cuda.reset_peak_memory_stats()
        monitor = CardMonitor()
        t_spawn = time.monotonic()
        procs = {w: spawn(w if elastic else None)
                 for w in range(spec.cluster_workers)}
        director = ElasticDirector(runtime, spawn) if elastic else None
        try:
            if director is not None:
                director.thread.start()
            res, prof = profiled(lambda: trainer.finish(runtime, spec),
                                 host_ops=False)
        finally:
            if director is not None:
                director.thread.join(timeout=120)
                procs.update(director.late)
            if reader is not None:
                reader.close()
            codes = wait_joiners(procs, label)
            monitor.stop()
        if director is not None and director.error is not None:
            raise director.error
        delta = {k: ha.LAUNCHES[k] - before[k] for k in ha.LAUNCHES}
        by_k = {kk: n - before_k.get(kk, 0)
                for kk, n in ha.LAUNCHES_BY_K.items()
                if kk[0] == kernel and n > before_k.get(kk, 0)}
        a = check_ledger(res, label)
        check("torn_frames" in a, f"{label}: no torn_frames in {a}")
        check(delta[kernel] == res.num_updates + 1
              and sum(delta.values()) == delta[kernel],
              f"{label}: launches {delta} vs {res.num_updates} updates")
        losses = res.metrics["train_loss"] + res.metrics["test_loss"]
        check(all(math.isfinite(x) for x in losses) and len(losses) > 0,
              f"{label}: non-finite or missing losses")
        window = res.extra["serve_wall_s"]
        utils, card_peak, rss_peak, host_peak = monitor.window(
            runtime, window, label)
        counters = res.extra["telemetry"]["counters"]
        rx, tx = counters.get("wire.rx_bytes", 0), \
            counters.get("wire.tx_bytes", 0)
        pings = counters.get("wire.pings", 0)
        check(pings > 0, f"{label}: the leader sent no PING")
        rate = res.num_gradients / window
        events = res.extra["events"]
        kinds = [e["event"] for e in events]
        spawn_to_release = runtime._t0 - t_spawn
        per_k = dict(sorted((k, n) for (_, k), n in by_k.items()))
        log(f"[cluster-host] cnn-cifar {label:26s} {res.num_gradients} "
            f"grads in {window:.2f} s ({rate:.1f} grads/s; inproc "
            f"'{twin}' {inproc_rates[twin]:.1f}, proc '{wire_twin}' "
            f"{wire_rates[wire_twin]:.1f} grads/s in this call), "
            f"{res.num_updates} updates, {a['dropped']} dropped, "
            f"{a['in_flight']} in flight, torn frames {a['torn_frames']}; "
            f"ledger computed {a['computed']} == applied {a['applied']} + "
            f"dropped {a['dropped']} + buffered {a['buffered']} + pending "
            f"{a['pending_round']} + in flight {a['in_flight']}; {kernel} "
            f"launches {delta[kernel]} = {res.num_updates} updates + 1 "
            f"warm-up, by staging rows K {per_k}; "
            f"parent's flush kernels "
            f"{prof['device_s_by_group'].get('flush kernels', 0.0):.6f} s "
            f"device time; card utilization (nvidia-smi, 0.2 s) mean "
            f"{statistics.mean(utils):.1f}% median "
            f"{statistics.median(utils):.1f}% over {len(utils)} samples; "
            f"wire rx {rx / window / 1e6:.1f} MB/s tx "
            f"{tx / window / 1e6:.1f} MB/s; PINGs sent {pings}; first "
            f"spawn to release {spawn_to_release:.2f} s (barrier "
            f"{res.extra['fleet_ready_s']:.2f} s); peak card memory "
            f"{card_peak:.0f} MiB (before the run {monitor.card_before:.0f})"
            f", parent {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB "
            f"allocated; peak host RSS of the process tree "
            f"{rss_peak / 2**30:.2f} GiB, host memory in use +"
            f"{host_peak / 2**30:.2f} GiB; joiner exit codes "
            f"{sorted(set(codes.values()))} x {len(codes)}; test_acc "
            f"{res.final()['test_acc']:.4f}; events {sorted(set(kinds))}")
        check(card_peak - monitor.card_before > spec.cluster_workers * 100,
              f"{label}: card memory grew {card_peak} - "
              f"{monitor.card_before} MiB, too little for the joiners")
        if not elastic:
            check(res.num_updates == 10 and a["applied"] == 250,
                  f"{label}: {res.num_updates} rounds, expected 10 of 25")
            check(kinds.count("member_join") == 25,
                  f"{label}: {kinds.count('member_join')} joins, not 25")
            final = trainer.last_params
            check(all(torch.equal(final[k], inproc_sync_params[k])
                      for k in final),
                  "host sync final params differ from inproc sync #1's")
            serving = res.extra["serving"]
            check(reader.pushes_seen >= 1 and serving["stats_clients"] == 1
                  and serving["clients"] == 0,
                  f"{label}: stats reader saw {reader.pushes_seen} pushes,"
                  f" serving {serving}")
            log("[cluster-host] host sync sgd: final params bitwise equal "
                "to [cluster]'s inproc sync sgd #1")
            log(f"[cluster-obs] host sync sgd with a stats reader attached "
                f"from the leader's bind: {reader.pushes_seen} pushes and "
                f"{len(reader.backfill)} backfilled cells received, "
                f"counted as stats client ({serving['stats_clients']}), "
                f"never a serve client; final params still bitwise equal "
                f"to inproc sync #1")
            continue
        grows = [e for e in events if e["event"] == "fleet_grow"]
        check(grows and min(e["from_workers"] for e in grows) == HOST_SEED
              and max(e["to_workers"] for e in grows) == HOST_MAX
              and runtime.fleet_size == HOST_MAX,
              f"{label}: the fleet did not grow {HOST_SEED} -> {HOST_MAX}: "
              f"{grows}")
        rejoin = [e for e in events if e["event"] == "member_join"
                  and e["worker"] == HOST_KILLED]
        check([e["generation"] for e in rejoin] == [0, 1],
              f"{label}: worker {HOST_KILLED} joined as {rejoin}")
        check(director.marks["cut"] is True,
              f"{label}: no live connection of worker {HOST_KILLED} cut")
        check("member_gone" in kinds, f"{label}: no member_gone event")
        check(kinds.count("checkpoint") >= 2,
              f"{label}: {kinds.count('checkpoint')} checkpoints")
        check(by_k.get((kernel, HOST_SEED), 0) >= 1
              and by_k.get((kernel, HOST_MAX), 0) >= 1,
              f"{label}: {kernel} launches by K {by_k}")
        check(set(a["computed_per_worker"]) ==
              {str(w) for w in range(HOST_MAX)},
              f"{label}: per-worker ledger {a['computed_per_worker']}")
        st = runtime.server.snapshot_opt_state()
        check(all(bool(torch.isfinite(torch.as_tensor(st[m])).all())
                  for m in ("mu", "nu")), f"{label}: moments not finite")
        scrapes = director.marks["scrapes"]
        top_code, top_lines = director.marks["top"]
        rows = [ln for ln in top_lines if ln.startswith("[top] v")]
        check([st for st, _ in scrapes] == [200, 200]
              and scrapes[0][1] <= scrapes[1][1],
              f"{label}: Prometheus scrapes {scrapes}")
        check(top_code == 0 and len(rows) == 3,
              f"{label}: top exited {top_code} with rows {top_lines}")
        check(any(e["event"] == "prom_listening" for e in events),
              f"{label}: no prom_listening event")
        log(f"[cluster-obs] elastic leader's /metrics scraped twice: HTTP "
            f"{scrapes[0][0]}, {scrapes[1][0]}; repro_grads_applied_total "
            f"{scrapes[0][1]} -> {scrapes[1][1]}; top_main(count=3) exit "
            f"{top_code}:")
        for line in top_lines:
            log(f"[cluster-obs]   {line}")
        log(f"[cluster-host] elastic: fleet_grow {HOST_SEED} -> {HOST_MAX} "
            f"in {len(grows)} step(s); late joiners spawned "
            f"{director.marks['release_to_late_spawn_s']:.2f} s after the "
            f"release, admitted {director.marks['late_spawn_to_grown_s']:.2f}"
            f" s later; worker {HOST_KILLED}'s connection cut, rejoined at "
            f"generation 1 after {director.marks['cut_to_rejoin_s']:.2f} s; "
            f"{kinds.count('checkpoint')} checkpoints; moments finite")
    return dict(ha.LAUNCHES)


# ------------------------------------------------ the serving plane

def serve_plane_kernel_check(torch):
    """The lm-tiny paths' kernel shapes, each against its plain version:
    the three flushes at K 8 on lm-tiny's slab; rmsnorm at a serve
    client's decode step (2 rows of D 64, f32); and the serving forward
    of the metrics' accuracy (the simulator's and the cluster leader's,
    on the 512 held-out sequences of 16): rmsnorm at 8192 rows of D 64
    and flash_attention at B 512, S 16, 4 heads of 16, causal, f32."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms
    errs = compare_kernels(torch, LM_P, K=SERVE_WORKERS)
    gen = torch.Generator(device="cuda").manual_seed(64)
    errs["rmsnorm"] = 0.0
    for n in (2, LM_TEST_SEQS * LM_SEQ):
        x = torch.randn(n, 64, device="cuda", generator=gen)
        scale = 1 + 0.1 * torch.randn(64, device="cuda", generator=gen)
        (y,) = same_twice(torch, lambda: rms.rmsnorm(x, scale))
        errs["rmsnorm"] = max(errs["rmsnorm"], hold(
            torch, "rmsnorm", y, ref.rmsnorm_ref(x, scale),
            *RMS_TOL["float32"], f"N={n} D=64 float32"))
    q, k, v = qkv(torch, 65, LM_TEST_SEQS, LM_SEQ, 4, 4, 16, "float32")
    (o,) = same_twice(torch, lambda: fa.flash_attention(q, k, v,
                                                         causal=True))
    errs["flash_attention"] = hold(
        torch, "flash_attention", o, ref.attention_ref(q, k, v, causal=True),
        *FLASH_TOL["float32"], f"lm-tiny ({LM_TEST_SEQS},{LM_SEQ},4,4,16)")
    return errs


class ServeDirector:
    """From a thread beside the lm-tiny leader: once the clock starts, an
    in-process ``ServeClient`` with ``LMAdapter`` greedy-decodes
    ``SERVE_DECODES`` successive params versions on the card, counting
    its rmsnorm launches and each request's latency; once it and every
    ``infer`` process are done, the run ends."""

    def __init__(self, runtime, spec, infers):
        import threading
        self.runtime, self.spec, self.infers = runtime, spec, infers
        self.error = None
        self.decodes = []       # (version, latency s, tokens)
        self.versions_seen = []
        self.rmsnorm = 0
        self.cut_short = True   # until the decodes end inside the run
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import rmsnorm as rms
        from repro_torch.serve.client import ServeClient
        from repro_torch.serve.workload import build_infer_adapter
        rt = self.runtime
        client = None
        try:
            client = ServeClient(rt.listen_address, device="cuda")
            adapter = build_infer_adapter(self.spec, device="cuda")
            cfg = adapter.cfg
            norms_per_step = cfg.num_groups * sum(
                len(g) for g in cfg.block_pattern) + 1
            want = norms_per_step * (adapter.prompts.shape[1]
                                     + adapter.gen_len)
            last = -1
            for i in range(SERVE_DECODES):
                msg = client.wait_params(min_version=last + 1,
                                         timeout=SERVE_BUDGET_S)
                check(msg is not None, "the serve client got no fresh "
                      f"params after version {last}")
                last = msg.version
                before = (rms.LAUNCHES["rmsnorm"],
                          fa.LAUNCHES["flash_attention"])
                t0 = time.perf_counter()
                out = adapter.run(adapter.decode(msg.params), i)
                dt = time.perf_counter() - t0
                norms = rms.LAUNCHES["rmsnorm"] - before[0]
                flash = fa.LAUNCHES["flash_attention"] - before[1]
                # one launch for each norm of each decode step (the
                # prompt is replayed a token at a time); decode attends
                # to its cache with plain attention.  The leader's metric
                # forwards run once the run has stopped, and cut_short
                # shows it stopped after these decodes: no other launch
                # of this process lands in the delta.
                check(norms == want and flash == 0,
                      f"the serve client's request {i} launched rmsnorm "
                      f"{norms} times (want {want}) and flash {flash}")
                self.rmsnorm += norms
                self.decodes.append((msg.version, dt, out["tokens"]))
            self.cut_short = rt._stop.is_set()
            for p in self.infers:
                p.wait(timeout=SERVE_BUDGET_S)
            # a training window long enough to read a rate and the
            # card's utilization from
            while time.monotonic() - rt._t0 < SERVE_MIN_S:
                time.sleep(0.05)
            self.versions_seen = list(client.versions_seen)
        except Exception as e:          # raised in the main thread
            self.error = e
        finally:
            if client is not None:
                client.close()
            server = getattr(rt, "server", None)
            if server is not None:
                server.done.set()       # end the run


def drive_serve_plane(torch):
    """The serving plane on the card: an ``lm-tiny`` host leader (hybrid
    AdamW, ``serve_every=2``) with ``SERVE_WORKERS`` ``python -m
    repro_torch join`` processes training, ``INFER_PROCS`` ``python -m
    repro_torch infer`` processes and one in-process ``ServeClient``
    decoding through the rmsnorm kernel while the flush kernels update
    the params.  Returns the kernels' launches in this run."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip-smoke-serve-") as tmp:
        return serve_plane_run(torch, tmp)


def serve_plane_run(torch, tmp: str):
    from repro_torch.api import ExperimentSpec
    from repro_torch.cluster.hostlink import spawn_join_process
    from repro_torch.cluster.trainer import ClusterTrainer
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hybrid_aggregate as ha
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.serve.client import spawn_infer_process

    spec = ExperimentSpec(
        arch="lm-tiny", backend="cluster", smoke=False, seed=0, lr=0.01,
        batch=32, cluster_workers=SERVE_WORKERS, mode="hybrid",
        schedule=CLUSTER_SCHEDULE, optimizer="adamw", transport="host",
        listen="127.0.0.1:0", heartbeat_s=2.0, serve_every=SERVE_EVERY,
        wall_budget_s=SERVE_BUDGET_S, wall_sample_every_s=5.0)
    trainer = ClusterTrainer(device="cuda")
    runtime = trainer.build_runtime(spec)
    addr = runtime.listen_address
    ha.reset_launch_counts()
    rms.reset_launch_counts()
    fa.reset_launch_counts()
    monitor = CardMonitor()
    t_spawn = time.monotonic()
    joiners = {w: spawn_join_process(addr, device="cuda",
                                     connect_timeout=600.0, reconnect_s=0)
               for w in range(SERVE_WORKERS)}
    logs = [open(os.path.join(tmp, f"infer{i}.log"), "w+")
            for i in range(INFER_PROCS)]
    infers = [spawn_infer_process(addr, requests=INFER_REQUESTS,
                                  device="cuda", connect_timeout=600.0,
                                  quiet=False, stdout=f) for f in logs]
    director = ServeDirector(runtime, spec, infers)
    director.thread.start()
    try:
        res = trainer.finish(runtime, spec)
    finally:
        director.thread.join(timeout=120)
        infer_codes = wait_joiners(dict(enumerate(infers)), "infer")
        codes = wait_joiners(joiners, "[cluster-serve] joiners")
        monitor.stop()
    if director.error is not None:
        raise director.error
    launches = dict(ha.LAUNCHES, rmsnorm=rms.LAUNCHES["rmsnorm"],
                    flash_attention=fa.LAUNCHES["flash_attention"])
    by_k = dict(ha.LAUNCHES_BY_K)
    a = check_ledger(res, "[cluster-serve]")
    check(launches["flush_adamw"] == res.num_updates + 1
          and by_k.get(("flush_adamw", SERVE_WORKERS), 0) ==
          res.num_updates + 1 and launches["flush"] ==
          launches["flush_momentum"] == 0,
          f"[cluster-serve]: launches {launches}, by K {by_k}, "
          f"{res.num_updates} updates")
    window = res.extra["serve_wall_s"]
    utils, card_peak, _, _ = monitor.window(runtime, window,
                                            "[cluster-serve]")
    serving = res.extra["serving"]
    check(serving["clients"] == INFER_PROCS + 1
          and serving["serve_every"] == SERVE_EVERY,
          f"[cluster-serve]: serving {serving}")
    skipped = sum(c["skipped_pushes"] for c in serving["per_client"])
    check(skipped > 0, f"[cluster-serve]: no push skipped: {serving}")
    # each infer process's report: request, version, latency
    infer_rows = []
    for f in logs:
        f.seek(0)
        rows = [(int(m.group(1)), float(m.group(2))) for m in (
            re.search(r"params v(\d+) ([\d.]+)ms", line) for line in f)
            if m]
        f.close()
        check(len(rows) == INFER_REQUESTS,
              f"[cluster-serve]: an infer process served {rows}")
        versions = [v for v, _ in rows]
        check(versions == sorted(versions),
              f"[cluster-serve]: infer versions went back: {versions}")
        infer_rows.append(rows)
    seen = director.versions_seen
    versions = [v for v, _, _ in director.decodes]
    check(len(versions) == SERVE_DECODES and versions == sorted(set(
        versions)) and seen == sorted(set(seen)),
          f"[cluster-serve]: in-process client decoded {versions}, saw "
          f"{seen}")
    check(all(v % SERVE_EVERY == 0 for v in seen),
          f"[cluster-serve]: a down-sampled version was pushed: {seen}")
    check(director.rmsnorm > 0 and not director.cut_short,
          "[cluster-serve]: the serve client's decode launched no rmsnorm "
          "kernel, or the run ended before its decodes did")
    rate = res.num_gradients / window
    lat = [1e3 * dt for _, dt, _ in director.decodes]
    infer_lat = [ms for rows in infer_rows for _, ms in rows]
    log(f"[cluster-serve] lm-tiny host hybrid adamw, {SERVE_WORKERS} joined "
        f"processes, serve_every {SERVE_EVERY}: {res.num_gradients} grads "
        f"in {window:.2f} s ({rate:.1f} grads/s), {res.num_updates} "
        f"updates; ledger computed {a['computed']} == applied "
        f"{a['applied']} + dropped {a['dropped']} + buffered "
        f"{a['buffered']} + pending {a['pending_round']} + in flight "
        f"{a['in_flight']}; flush_adamw launches {launches['flush_adamw']}"
        f" = {res.num_updates} updates + 1 warm-up, by staging rows K "
        f"{by_k}; first spawn to release {runtime._t0 - t_spawn:.2f} s; "
        f"card utilization (nvidia-smi, 0.2 s) mean "
        f"{statistics.mean(utils):.1f}% median "
        f"{statistics.median(utils):.1f}% over {len(utils)} samples; peak "
        f"card memory {card_peak:.0f} MiB; joiner exit codes "
        f"{sorted(set(codes.values()))} x {len(codes)}, infer exit codes "
        f"{list(infer_codes.values())}")
    log(f"[cluster-serve] serving: {serving['clients']} clients, "
        f"{skipped} pushes skipped by serve_every, per client "
        f"{[(c['pushes'], c['skipped_pushes'], c['last_version']) for c in serving['per_client']]}"
        f" (pushes, skipped, last version)")
    log(f"[cluster-serve] in-process ServeClient (LMAdapter, batch 2, prompt"
        f" 8, gen 8): versions {versions} decoded in "
        f"{', '.join(f'{x:.1f}' for x in lat)} ms; rmsnorm launches "
        f"{director.rmsnorm} ({director.rmsnorm // SERVE_DECODES} a "
        f"request); tokens {[t for _, _, t in director.decodes]}")
    log(f"[cluster-serve] infer processes: versions "
        f"{[[v for v, _ in rows] for rows in infer_rows]}, latency per "
        f"request mean {statistics.mean(infer_lat):.1f} ms median "
        f"{statistics.median(infer_lat):.1f} ms (their own clocks, "
        f"{len(infer_lat)} requests)")
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
            rms.cost(n, D, x.element_size()))
    out = time_cases(torch, timer, rms_cases)
    # the kernel alone (profiler) at the shape the path launches most
    decode = f"rmsnorm decode N={SERVE['batch']}"
    out[decode]["kernel_only_ms"] = kernel_only_ms(
        torch, rms_cases[decode][0], "rmsnorm_kernel")

    # the serve path's two shapes, then every head dim at one mid-size
    # causal shape
    shapes = FLASH_CASES[:2] + [
        (f"bf16 d={d}", 1, 4096, 16, 4, d, True, None, "bfloat16")
        for d, dv in fa.HEAD_DIMS if d == dv]
    for seed, (label, B, S, H, KV, d, causal, window, dtype) in \
            enumerate(shapes):
        q, k, v = qkv(torch, 10 + seed, B, S, H, KV, d, dtype)
        mask = ref.attention_mask(S, causal, window, "cuda")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        case = {f"flash {label} S={S}": (
            lambda: fa.flash_attention(q, k, v, causal=causal,
                                       window=window),
            lambda: ref.attention_ref(q, k, v, causal=causal,
                                      window=window),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True),
            fa.cost(B, S, H, KV, d, d, q.element_size(), causal, window))}
        big = S >= 2048
        out.update(time_cases(
            torch, Timer(torch, reps=5) if big else timer, case,
            plain_timer=Timer(torch, reps=2) if big else None,
            peak=BF16_FLOPS_PER_S))
        if label == "long prefill":
            name = f"flash {label} S={S}"
            out[name]["kernel_only_ms"] = kernel_only_ms(
                torch, case[name][0], "flash_fwd_bf16_kernel", reps=10)
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
        held0 = torch.cuda.memory_allocated()
        params = M.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
        torch.cuda.synchronize()
        param_bytes = (storage_bytes(params),
                       torch.cuda.memory_allocated() - held0)
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
        long_step = step_bytes(torch)
        t0 = time.time()
        long_logits = serve.prefill_step(params, {"tokens": long_toks},
                                         cfg)
        torch.cuda.synchronize()
        long_s = time.time() - t0
        long_step = long_step()
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
                          n_params=n_params, param_bytes=param_bytes,
                          long_step_bytes=long_step)



# ------------------------------------------ the rest of the model stack

DEEPSEEK = "deepseek-v2-lite-16b"
# deepseek's last-position logits after a 32-token prompt, 27 layers, at
# a capacity that drops no token, three ways: the prefill (flash at
# (192, 128) + rmsnorm kernels), the plain forward (the same full-sequence
# MLA through the plain attention and norm) and the decode replay
# (absorbed MLA in plain PyTorch).  In float32 the three agree to 1e-5 -
# 2e-5 on the card, so they compute one function; in bf16 each rounds in
# its own order at every layer, and over seeds 0-3 the kernels read
# 0.19-0.67 from the plain forward and the prefill 0.43-1.00 from the
# replay (PERF.md, PR 18); seeds 0-1 run here
MLA_SEEDS = (0, 1)                  # bf16
MLA_KERNEL_ATOL = 1.0
MLA_PREFILL_DECODE_ATOL = 1.5
MLA_F32_ATOL = 2e-4                 # seed 0, float32 weights (64.8 GB)
MLA_LONG_S = 4096
ZOO_SCALE = 1.0        # [zoo-sim]: xlstm-350m's published shape
ZOO_WORKERS = 16       # ... 16 x 1.76 GB snapshots + 16 staging rows
ZOO_HORIZON = 0.0625   # ... virtual seconds: 13 gradients, 11 updates
ZOO_SMALL = 0.25       # the width run on the card and on the CPU ...
ZOO_SMALL_HORIZON = 0.0625  # ... for 0.0625 virtual s: about 12 gradients
# SGD at xlstm-350m's width over 0.5 virtual s: the train loss ran away
# at the default lr 0.01, rose at 3e-4 and 1e-4 and fell at 3e-5
# (PERF.md, PR 18)
ZOO_LR = 3e-5
JAMBA = "jamba-v0.1-52b"
LLAMA4 = "llama4-scout-17b-a16e"
HUBERT = "hubert-xlarge"
PHI3V = "phi-3-vision-4.2b"
# flash_attention at the new full-sequence kinds: (label, B, S, H, KV, d,
# d_v, causal, window, chunk, dtype)
FLASH_NEW = [
    ("MLA deepseek", 1, MLA_LONG_S, 16, 16, 192, 128, True, None, None,
     "bfloat16"),
    ("chunked llama4", 1, 16384, 40, 8, 128, 128, True, None, 8192,
     "bfloat16"),
    ("bidirectional hubert", 2, 1024, 16, 16, 80, 80, False, None, None,
     "bfloat16"),
    # a rank's heads of h2o's prefill at model 2 (the sliced serving)
    ("h2o model 2", 1, LONG_S, 16, 4, 80, 80, True, 4096, None,
     "bfloat16"),
]
# smaller held cases: chunk no tile divides, chunk below a tile, ragged S,
# MLA's smoke pair, f32 on the CUDA-core kernel
FLASH_NEW_SMALL = [
    ("chunk 100 ragged", 1, 300, 4, 2, 64, 64, True, None, 100, "bfloat16"),
    ("chunk 100 ragged f32", 1, 300, 4, 2, 64, 64, True, None, 100,
     "float32"),
    ("chunk 16 S 37", 2, 37, 4, 2, 64, 64, True, None, 16, "bfloat16"),
    ("chunk 48 full", 1, 200, 4, 1, 128, 128, False, None, 48, "bfloat16"),
    ("chunk + window f32", 1, 200, 4, 1, 128, 128, True, 20, 48, "float32"),
    ("MLA 192/128 f32", 2, 130, 4, 4, 192, 128, False, None, None,
     "float32"),
    ("MLA 80/64", 2, 40, 4, 4, 80, 64, True, None, None, "bfloat16"),
    ("MLA 80/64 f32", 2, 40, 4, 4, 80, 64, True, None, None, "float32"),
]
RMS_NEW_D = (1024, 2048, 4096, 5120)
# the rows a rank normalizes in h2o's sliced decode step at data 2: 2 of
# 4 prompts, or the 1 prompt every rank serves (regime (b))
RMS_SLICED = ((2, 2560), (1, 2560))


def qkv_v(torch, seed, B, S, H, KV, d, dv, dtype):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    return [torch.randn(B, S, n, w, device="cuda", generator=gen).to(dt)
            for n, w in ((H, d), (KV, d), (KV, dv))]


def compare_new_kernel_shapes(torch):
    """flash_attention with a chunk and with d_v != d, and rmsnorm at the
    new families' widths, against their plain versions (the plain
    attention a 1024-row query block at a time above S 4096)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    errs = {"rmsnorm": 0.0, "flash_attention": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(4)
    for width in RMS_NEW_D:
        scale = 1 + 0.1 * torch.randn(width, device="cuda", generator=gen)
        for n in (4, 4096):
            for dtype in ("float32", "bfloat16"):
                x = torch.randn(n, width, device="cuda", generator=gen).to(
                    getattr(torch, dtype))
                (y,) = same_twice(torch, lambda: rms.rmsnorm(x, scale))
                errs["rmsnorm"] = max(errs["rmsnorm"], hold(
                    torch, "rmsnorm", y, ref.rmsnorm_ref(x, scale),
                    *RMS_TOL[dtype], f"N={n} D={width} {dtype}"))
    for n, width in RMS_SLICED:
        scale = 1 + 0.1 * torch.randn(width, device="cuda", generator=gen)
        for dtype in ("float32", "bfloat16"):
            x = torch.randn(n, width, device="cuda", generator=gen).to(
                getattr(torch, dtype))
            (y,) = same_twice(torch, lambda: rms.rmsnorm(x, scale))
            errs["rmsnorm"] = max(errs["rmsnorm"], hold(
                torch, "rmsnorm", y, ref.rmsnorm_ref(x, scale),
                *RMS_TOL[dtype], f"sliced decode N={n} D={width} {dtype}"))
    for seed, (label, B, S, H, KV, d, dv, causal, window, chunk, dtype) in \
            enumerate(FLASH_NEW + FLASH_NEW_SMALL):
        q, k, v = qkv_v(torch, 50 + seed, B, S, H, KV, d, dv, dtype)
        kw = dict(causal=causal, window=window, chunk=chunk)
        (o,) = same_twice(torch, lambda: fa.flash_attention(q, k, v, **kw))
        check(tuple(o.shape) == (B, S, H, dv), f"flash {label}: shape")
        want = ref.attention_ref(q, k, v, q_block=1024 if S > 4096 else None,
                                 **kw)
        errs["flash_attention"] = max(errs["flash_attention"], hold(
            torch, "flash_attention", o, want, *FLASH_TOL[dtype],
            f"{label} ({B},{S},{H},{KV},{d}/{dv}) c={chunk}"))
        del q, k, v, o, want
        torch.cuda.empty_cache()
    return errs


def time_new_kernel_shapes(torch):
    """flash_attention at the three new kinds and rmsnorm at the new
    widths: the kernel alone (profiler), CUDA-event calls, the plain
    version and the library call (masked SDPA, F.rms_norm)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for width in RMS_NEW_D:
        scale = 1 + 0.1 * torch.randn(width, device="cuda", generator=gen)
        for dtype in ("float32", "bfloat16"):
            x = torch.randn(4096, width, device="cuda", generator=gen).to(
                getattr(torch, dtype))
            lib_scale = scale.to(x.dtype)
            name = f"rmsnorm N=4096 D={width} {dtype}"
            case = {name: (
                lambda x=x, sc=scale: rms.rmsnorm(x, sc),
                lambda x=x, sc=scale: ref.rmsnorm_ref(x, sc),
                lambda x=x, w=width, ls=lib_scale: F.rms_norm(
                    x, (w,), ls, 1e-5),
                rms.cost(4096, width, x.element_size()))}
            out.update(time_cases(torch, timer, case))
            out[name]["kernel_only_ms"] = kernel_only_ms(
                torch, case[name][0], "rmsnorm_kernel")
            t = out[name]
            log(f"[time] {name}: kernel alone {t['kernel_only_ms']:.6f} ms "
                f"= {100 * t['bound_ms'] / t['kernel_only_ms']:.1f}% of "
                f"bound {t['bound_ms']:.6f} ms")
    for n, width in RMS_SLICED:
        scale = 1 + 0.1 * torch.randn(width, device="cuda", generator=gen)
        x = torch.randn(n, width, device="cuda", generator=gen).to(
            torch.bfloat16)
        name = f"rmsnorm sliced decode N={n} D={width} bfloat16"
        case = {name: (lambda x=x, sc=scale: rms.rmsnorm(x, sc),
                       lambda x=x, sc=scale: ref.rmsnorm_ref(x, sc),
                       lambda x=x, w=width, ls=scale.to(x.dtype): F.rms_norm(
                           x, (w,), ls, 1e-5),
                       rms.cost(n, width, x.element_size()))}
        out.update(time_cases(torch, timer, case))
        out[name]["kernel_only_ms"] = kernel_only_ms(torch, case[name][0],
                                                     "rmsnorm_kernel")
        t = out[name]
        log(f"[time] {name}: kernel alone {t['kernel_only_ms']:.6f} ms = "
            f"{100 * t['bound_ms'] / t['kernel_only_ms']:.1f}% of bound "
            f"{t['bound_ms']:.6f} ms; call {t['ms']:.6f} ms, warm "
            f"{t['warm_ms']:.6f} ms, plain {t['plain_ms']:.6f} ms, "
            f"F.rms_norm {t['library_ms']}")
    for seed, (label, B, S, H, KV, d, dv, causal, window, chunk, dtype) in \
            enumerate(FLASH_NEW):
        q, k, v = qkv_v(torch, 70 + seed, B, S, H, KV, d, dv, dtype)
        kw = dict(causal=causal, window=window, chunk=chunk)
        mask = ref.attention_mask(S, causal, window, "cuda", chunk)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        name = f"flash {label} S={S}"

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=KV != H)
        try:
            library()
            torch.cuda.synchronize()
        except Exception as e:      # a yardstick only: time what runs
            log(f"[time] {name}: masked SDPA does not run here "
                f"({type(e).__name__}: {str(e)[:120]}); library_ms null")
            library = None
        torch.cuda.empty_cache()
        big = S >= 2048
        case = {name: (
            lambda: fa.flash_attention(q, k, v, **kw),
            lambda: ref.attention_ref(q, k, v, q_block=1024 if S > 4096
                                      else None, **kw),
            library, fa.cost(B, S, H, KV, d, dv, q.element_size(), causal,
                             window, chunk))}
        out.update(time_cases(
            torch, Timer(torch, reps=5) if big else timer, case,
            plain_timer=Timer(torch, reps=2) if big else None,
            peak=BF16_FLOPS_PER_S))
        out[name]["kernel_only_ms"] = kernel_only_ms(
            torch, case[name][0], "flash_fwd_bf16_kernel", reps=10)
        t = out[name]
        log(f"[time] {name}: kernel alone {t['kernel_only_ms']:.6f} ms = "
            f"{100 * t['bound_ms'] / t['kernel_only_ms']:.1f}% of bound "
            f"{t['bound_ms']:.6f} ms")
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()
    return out


def _counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hybrid_aggregate as ha
    from repro_torch.kernels import rmsnorm as rms
    return rms.LAUNCHES, fa.LAUNCHES, ha.LAUNCHES


def reset_counts() -> None:
    """Every kernel's launch count to 0 (just before a counted run)."""
    from repro_torch.kernels import hybrid_aggregate as ha
    for counts in _counters():
        for name in counts:
            counts[name] = 0
    ha.LAUNCHES_BY_K.clear()


def read_counts() -> dict:
    out = {}
    for counts in _counters():
        out.update(counts)
    return out


def release(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def init_full(torch, cfg, label: str, seed: int = 0):
    from repro_torch.models import model as M
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = M.init_params(torch.Generator(device="cuda").manual_seed(seed),
                           cfg)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    gb = sum(nbytes(t) for t in tree_leaves(params)) / 1e9
    log(f"[{label}] {cfg.name}: {cfg.num_layers} layers "
        f"({cfg.num_groups} x {len(cfg.block_pattern)}), d {cfg.d_model}, "
        f"{cfg.dtype}: {n / 1e9:.3f} B params, {gb:.2f} GB, random init "
        f"from seed {seed} in {time.time() - t0:.1f} s")
    return params


def mla_paths(torch, params, cfg, prompts):
    """deepseek's last-position logits after ``prompts`` three ways, at a
    capacity factor of E (no token dropped by any): the prefill (flash
    at (192, 128) and rmsnorm kernels), the plain forward (the same
    full-sequence MLA through the plain attention and norm), the decode
    replay (absorbed MLA in plain PyTorch); and greedy's first tokens."""
    import dataclasses
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    full = dataclasses.replace(cfg, moe_capacity_factor=float(
        cfg.num_experts))
    B, P = prompts.shape
    dev = torch.device("cuda")
    toks = torch.as_tensor(prompts, device=dev)
    pre = serve.prefill_step(params, {"tokens": toks}, full).float()
    plain = M.forward(params, {"tokens": toks}, full,
                      plain=True)[0][:, -1].float()
    cache = M.init_cache(full, B, P, device=dev)
    for i in range(P):
        dec, cache = M.decode_step(params, cache, toks[:, i:i + 1], i, full)
    first = serve.greedy_generate(full, params, prompts, 1)[:, P]
    return pre, plain, dec[:, 0].float(), first


def hold_mla_paths(torch, paths, kernel_atol: float, atol: float,
                   label: str) -> dict:
    """The kernels against the plain forward, the prefill against the
    decode replay, and the h2o check's top-1 rules: a row whose prefill
    margin exceeds twice the bound agrees on top-1, and greedy's first
    token is the replay's argmax."""
    pre, plain, dec, first = paths
    kern = float((pre - plain).abs().max())
    rep = float((plain - dec).abs().max())
    diff = float((pre - dec).abs().max())
    top2 = pre.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * atol
    agree = pre.argmax(-1) == dec.argmax(-1)
    check(bool(torch.isfinite(pre).all()) and kern <= kernel_atol,
          f"deepseek {label}: prefill (kernels) vs plain forward logits "
          f"differ by {kern}")
    check(diff <= atol, f"deepseek {label}: prefill vs decode replay "
          f"logits differ by {diff}")
    check(bool(agree[clear].all()), f"deepseek {label}: prefill and decode "
          "disagree on a top-1 token whose margin exceeds twice the bound")
    check(bool((torch.as_tensor(first, device=dec.device)
                == dec.argmax(-1)).all()),
          f"deepseek {label}: greedy's first token is not the replay's "
          "argmax")
    log(f"[serve-mla-moe] {label}, capacity factor E (no drops), last-"
        f"position logits: prefill (kernels) vs plain forward {kern:.6g} "
        f"(atol {kernel_atol:g}); plain forward vs decode replay "
        f"{rep:.6g}; prefill vs decode replay {diff:.6g} (atol {atol:g}); "
        f"max |logit| {float(pre.abs().max()):.3f}; top-1 agree "
        f"{int(agree.sum())}/{len(agree)} ({int(clear.sum())} rows with a "
        f"clear margin); greedy's first tokens are the replay's argmax")
    return dict(kernels=kern, replay=rep, prefill=diff)


def drive_mla_moe_serve(torch):
    """deepseek-v2-lite-16b at its published widths and depth through the
    serving entry points: greedy_generate (batch 4, prompt 32, gen 16),
    prefill_step on the prompts and on one 4096-token sequence; every
    norm through rmsnorm, every MLA attention through flash_attention at
    (192, 128); the prefill against the plain forward and a decode
    replay."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve

    cfg = get_config(DEEPSEEK)
    L, V = cfg.num_layers, cfg.vocab_size
    B, P, G = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, V, (B, P)).astype(np.int32)
    long_toks = torch.as_tensor(rng.integers(0, V, (1, MLA_LONG_S))
                                .astype(np.int32), device=dev)
    per_fwd = (2 * L + 1, L)
    torch.cuda.reset_peak_memory_stats()
    totals = {}

    def counted(fn):
        reset_counts()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        dt = time.time() - t0
        got = read_counts()
        for k, n in got.items():
            totals[k] = totals.get(k, 0) + n
        return res, dt, (got["rmsnorm"], got["flash_attention"])

    with torch.inference_mode():
        held0 = torch.cuda.memory_allocated()
        params = init_full(torch, cfg, "serve-mla-moe")
        param_bytes = (storage_bytes(params),
                       torch.cuda.memory_allocated() - held0)
        serve.greedy_generate(cfg, params, prompts[:, :2], 1)   # set-up
        serve.prefill_step(params, {"tokens": long_toks[:, :64]}, cfg)
        torch.cuda.synchronize()
        out, gen_s, n = counted(
            lambda: serve.greedy_generate(cfg, params, prompts, G))
        steps = P + G
        check(n == (steps * per_fwd[0], 0),
              f"deepseek greedy launches {n}, expected "
              f"{steps * per_fwd[0]} rmsnorm and no flash")
        check(out.shape == (B, P + G) and np.array_equal(out[:, :P], prompts)
              and int(out.min()) >= 0 and int(out.max()) < V,
              "deepseek greedy_generate returned malformed tokens")
        log(f"[serve-mla-moe] greedy_generate B={B} prompt={P} gen={G}: "
            f"{steps} decode steps in {gen_s:.3f} s ({B * G / gen_s:.1f} "
            f"new tok/s, {1e3 * gen_s / steps:.2f} ms/step); rmsnorm "
            f"launches {n[0]} = {steps} x {per_fwd[0]}, flash 0")
        short, short_s, n = counted(lambda: serve.prefill_step(
            params, {"tokens": torch.as_tensor(prompts, device=dev)}, cfg))
        check(n == per_fwd, f"deepseek prefill launches {n}, expected "
              f"{per_fwd}")
        log(f"[serve-mla-moe] prefill_step B={B} S={P}: {1e3 * short_s:.2f} "
            f"ms ({B * P / short_s:.0f} tok/s); launches rmsnorm "
            f"{n[0]}, flash {n[1]} (at d "
            f"{cfg.resolved_head_dim + cfg.rope_head_dim} / d_v "
            f"{cfg.resolved_v_head_dim})")
        long_step = step_bytes(torch)
        long_logits, long_s, n = counted(lambda: serve.prefill_step(
            params, {"tokens": long_toks}, cfg))
        long_step = long_step()
        check(n == per_fwd and tuple(long_logits.shape) == (1, V)
              and bool(torch.isfinite(long_logits).all()),
              f"deepseek long prefill: launches {n} or logits malformed")
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"[serve-mla-moe] prefill_step B=1 S={MLA_LONG_S}: {long_s:.3f} "
            f"s ({MLA_LONG_S / long_s:.0f} tok/s); launches rmsnorm {n[0]}, "
            f"flash {n[1]}; peak device memory {peak:.2f} GB")

        # the same function three ways, at a capacity that drops no token
        # in any (a prefill routes B*P tokens per group, a decode B), at
        # two bf16 seeds, then in float32
        hold_mla_paths(torch, mla_paths(torch, params, cfg, prompts),
                       MLA_KERNEL_ATOL, MLA_PREFILL_DECODE_ATOL,
                       "bf16 seed 0")
        del params
        release(torch)
        for seed in MLA_SEEDS[1:]:
            params = init_full(torch, cfg, "serve-mla-moe", seed)
            hold_mla_paths(torch, mla_paths(torch, params, cfg, prompts),
                           MLA_KERNEL_ATOL, MLA_PREFILL_DECODE_ATOL,
                           f"bf16 seed {seed}")
            del params
            release(torch)
        f32 = dataclasses.replace(cfg, dtype="float32")
        params = init_full(torch, f32, "serve-mla-moe")
        hold_mla_paths(torch, mla_paths(torch, params, f32, prompts),
                       MLA_F32_ATOL, MLA_F32_ATOL, "float32 seed 0")
    del params
    release(torch)
    return totals, dict(gen_s=gen_s, short_s=short_s, long_s=long_s,
                        peak_gb=peak, param_bytes=param_bytes,
                        long_step_bytes=long_step)


def _slab(trainer, spec):
    (agg,) = trainer.engine(spec)._agg_cache.values()
    return agg


def xlstm_gradient_leaves(torch, sp) -> dict:
    """One zoo:xlstm gradient (batch 32) on the card against the CPU's,
    each leaf within twice the largest move of that leaf of the CPU's
    gradient when every param moves one ulp up or down at random (four
    draws), as tests/test_torch_zoo.py holds the port against the
    reference: a leaf computed at lower precision would leave its own
    spread even where another leaf's is wide."""
    from repro_torch.convert import tree_to
    from repro_torch.core.slab import slab_codec
    from repro_torch.models.model import _map
    from repro_torch.models.zoo import zoo_workload
    loss, params, data, _ = zoo_workload(sp, torch.device("cpu"))
    x, y = (torch.as_tensor(a[:32]) for a in data[:2])
    codec = slab_codec(params)

    def grad(p, dev):
        g = torch.func.grad(loss)(tree_to(p, dev), x.to(dev), y.to(dev))
        return codec.encode(g).cpu()

    def moved(seed):
        gen = torch.Generator().manual_seed(seed)

        def ulp(t):     # one ulp up or down (a half-ulp step, rounded)
            sign = torch.randint(0, 2, t.shape, generator=gen) * 2 - 1
            return (t.double() * (1 + sign * 2.0 ** -24)).to(t.dtype)
        return dict(_map(ulp, {k: v for k, v in params.items()
                               if k != "groups"}),
                    groups=tuple(_map(ulp, g) for g in params["groups"]))

    def leaf_max(slab):
        return torch.stack([slab[o:o + n].abs().max() for o, n in
                            zip(codec.offsets, codec.sizes)])

    want = grad(params, "cpu")
    got = grad(params, "cuda")
    diff = leaf_max(got - want)
    spread = torch.stack([leaf_max(grad(moved(s), "cpu") - want)
                          for s in range(4)]).max(0).values
    ratio = diff / (2 * spread + 1e-6)
    i = int(ratio.argmax())
    worst = "/".join(str(k) for k in codec.paths[i])
    check(bool(torch.isfinite(got).all()) and bool((ratio <= 1).all()),
          f"zoo:xlstm gradient cuda vs cpu leaf {worst}: {float(diff[i]):.3e}"
          f" exceeds twice its CPU one-ulp spread {float(spread[i]):.3e}")
    return dict(leaves=len(codec.sizes), ratio=float(ratio[i]), worst=worst,
                diff=float(diff[i]), spread=float(spread[i]),
                max_diff=float(diff.max()), max_spread=float(spread.max()))


def drive_zoo_sim(torch, after_big=None):
    """SimulatorTrainer on zoo:xlstm at zoo_scale 1.0 (xlstm-350m's
    shape, f32 slab), hybrid step:10, then zoo:xlstm and zoo:transformer
    at 0.25 on the card and on the CPU.  ``after_big()`` runs once the
    1.0 run has released the card."""
    from repro_torch.api import ExperimentSpec, SimulatorTrainer
    from repro_torch.core.simulator import WorkerPool
    from repro_torch.kernels import hybrid_aggregate as ha
    from repro_torch.models.zoo import zoo_config

    def spec(arch, scale, horizon=ZOO_HORIZON):
        return ExperimentSpec(
            arch=arch, zoo_scale=scale, mode="hybrid", schedule="step:10",
            batch=32, lr=ZOO_LR, horizon=horizon, sample_every=horizon / 2,
            smoke=True, pool=WorkerPool(num_workers=ZOO_WORKERS))

    totals = {}
    big = spec("zoo:xlstm", ZOO_SCALE)
    trainer = SimulatorTrainer(device="cuda")
    engine = trainer.engine(big)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    res = trainer.run(big)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    for k, n in counts.items():
        totals[k] = totals.get(k, 0) + n
    agg = _slab(trainer, big)
    P = agg.params_slab.numel()
    staging = sum(r.numel() * r.element_size() for r in agg._staging)
    losses = res.metrics["train_loss"]
    check(counts["flush"] == res.num_updates > 0,
          f"zoo:xlstm flush launches {counts['flush']} != updates "
          f"{res.num_updates}")
    check(all(r.device.type == "cuda" and r.shape[0] == ZOO_WORKERS
              for r in agg._staging) and engine.x_tr.device.type == "cuda",
          "zoo:xlstm staging or data left the card")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"zoo:xlstm train loss not finite or not falling: {losses}")
    zc = zoo_config("xlstm", ZOO_SCALE)
    log(f"[zoo-sim] zoo:xlstm x{ZOO_SCALE:g} ({zc.num_layers} layers, d "
        f"{zc.d_model}, {zc.num_heads} heads, vocab {zc.vocab_size}, f32; "
        f"P_pad {P:,}) hybrid step:10, lr {ZOO_LR:g}, {ZOO_WORKERS} workers, "
        f"batch 32, seq 32, {ZOO_HORIZON} virtual s: {res.num_gradients} "
        f"gradients, {res.num_updates} updates = {counts['flush']} flush "
        f"launches ({dict(sorted((k, n) for (name, k), n in ha.LAUNCHES_BY_K.items() if name == 'flush'))} by K) "
        f"in {wall:.2f} s ({res.num_gradients / wall:.2f} grads/s); "
        f"staging {ZOO_WORKERS} x {P:,} f32 = {staging / 1e9:.2f} GB on "
        f"the card; train loss {losses[0]:.4f} -> {losses[-1]:.4f}; rmsnorm "
        f"launches {counts['rmsnorm']} (accuracy forwards); peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del trainer, engine, agg, res
    release(torch)
    if after_big is not None:
        after_big()

    # the same short run at 0.25 on the card and on the CPU
    from repro_torch.convert import tree_to
    from repro_torch.models.zoo import zoo_workload
    for arch in ("zoo:xlstm", "zoo:transformer"):
        sp = spec(arch, ZOO_SMALL, ZOO_SMALL_HORIZON)
        slabs, runs = {}, {}
        for dev in ("cuda", "cpu"):
            tr = SimulatorTrainer(device=dev)
            reset_counts()
            t0 = time.time()
            runs[dev] = tr.run(sp)
            wall = time.time() - t0
            if dev == "cuda":
                torch.cuda.synchronize()
                wall = time.time() - t0
                counts = read_counts()
                for k, n in counts.items():
                    totals[k] = totals.get(k, 0) + n
                check(counts["flush"] == runs[dev].num_updates,
                      f"{arch} x{ZOO_SMALL}: flush launches != updates")
                if arch == "zoo:transformer":
                    check(counts["flash_attention"] > 0,
                          "zoo:transformer accuracy forward launched no "
                          "flash_attention")
            slabs[dev] = _slab(tr, sp).params_slab.cpu()
            log(f"[zoo-sim] {arch} x{ZOO_SMALL} on {dev}: "
                f"{runs[dev].num_gradients} gradients, "
                f"{runs[dev].num_updates} updates in {wall:.2f} s "
                f"({runs[dev].num_gradients / wall:.2f} grads/s)")
        check((runs["cuda"].num_gradients, runs["cuda"].num_updates) ==
              (runs["cpu"].num_gradients, runs["cpu"].num_updates),
              f"{arch}: cuda and cpu runs disagree on event counts")
        check(runs["cuda"].num_updates > 0, f"{arch}: no update to compare "
              "(the horizon is too short)")
        diff = float((slabs["cuda"] - slabs["cpu"]).abs().max())
        strict = torch.allclose(slabs["cuda"], slabs["cpu"], rtol=1e-5,
                                atol=1e-6)
        if arch == "zoo:transformer":
            check(strict, f"{arch}: params slab cuda vs cpu {diff:.3e} "
                  "(rtol 1e-5, atol 1e-6)")
            log(f"[zoo-sim] {arch} x{ZOO_SMALL}: params slab cuda vs cpu "
                f"max diff {diff:.3e} (rtol 1e-5, atol 1e-6: held); "
                f"flash_attention and rmsnorm in its accuracy forwards")
            continue
        # zoo:xlstm's gradient is ill-conditioned (ROADMAP C.28): over the
        # run's updates the card's and the CPU's params drift apart as
        # far as from params one ulp apart, so the run's slab is shown,
        # and one gradient is held leaf by leaf
        check(math.isfinite(diff), f"{arch}: params slab not finite")
        g = xlstm_gradient_leaves(torch, sp)
        log(f"[zoo-sim] {arch} x{ZOO_SMALL}: params slab cuda vs cpu max "
            f"diff {diff:.3e} (rtol 1e-5 / atol 1e-6: "
            f"{'held' if strict else 'not held: ill-conditioned, C.28'}); "
            f"one gradient (batch 32) cuda vs cpu, leaf by leaf within "
            f"twice that leaf's CPU one-ulp spread: {g['leaves']} leaves "
            f"held, worst ratio {g['ratio']:.3f} at {g['worst']} "
            f"({g['diff']:.3e} against spread {g['spread']:.3e}); over the "
            f"slab {g['max_diff']:.3e} against {g['max_spread']:.3e}")
    release(torch)
    return totals


def drive_zoo_wire(torch):
    """The ported smoke_zoo on the card: zoo:transformer x0.125, proc, 2
    worker processes, bf16 slab, AdamW, with its five gates."""
    from repro_torch.cluster.trainer import ClusterTrainer
    from repro_torch.examples import smoke_zoo
    from repro_torch.models.zoo import init_zoo_params, num_params, \
        zoo_config
    p = num_params(init_zoo_params(zoo_config("transformer",
                                              smoke_zoo.SCALE), 0))
    trainer = ClusterTrainer(device="cuda")
    reset_counts()
    t0 = time.time()
    res = trainer.run(smoke_zoo.spec())
    wall = time.time() - t0
    counts = read_counts()
    fails = smoke_zoo.gates(res, p)
    check(not fails, f"smoke_zoo gates: {fails}")
    check(counts["flush_adamw"] > 0, "zoo-wire: no flush_adamw launch")
    a = res.extra["accounting"]
    rx = res.extra["telemetry"]["counters"]["wire.rx_bytes"]
    log(f"[zoo-wire] zoo:transformer x{smoke_zoo.SCALE} ({p:,} params) proc "
        f"x2, bf16 slab, AdamW: {a['applied']} applied of {a['computed']} "
        f"computed, ledger exact; rx {rx / a['computed']:.0f} B/grad = "
        f"{rx / a['computed'] / (4 * p):.3f} of the f32 slab; flush_adamw "
        f"launches {counts['flush_adamw']}; {wall:.1f} s with the fleet's "
        f"start-up")
    release(torch)
    return counts


def _forward_counted(torch, params, batch, cfg):
    from repro_torch.models import model as M
    reset_counts()
    t0 = time.time()
    logits, _ = M.forward(params, batch, cfg)
    torch.cuda.synchronize()
    c = read_counts()
    return logits, time.time() - t0, c


def _expected(cfg):
    """(rmsnorm, flash_attention) launches of one serving forward."""
    attn = sum(m in ("attn", "attn_global", "mla")
               for m, _ in cfg.block_pattern) * cfg.num_groups
    norms = 0 if cfg.norm != "rmsnorm" else 1 + sum(
        1 + (f != "none") for _, f in cfg.block_pattern) * cfg.num_groups
    return norms, attn


def drive_arch(torch):
    """Every registry family on the card: each smoke variant against the
    CPU and its decode against its forward; then jamba and llama4 at full
    width (one group each, what one card holds), hubert-xlarge and
    phi-3-vision at full width."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.registry import ARCH_NAMES, get_config, \
        smoke_batch, smoke_variant
    from repro_torch.convert import tree_to
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    totals = {}

    def add(c):
        for k, n in c.items():
            totals[k] = totals.get(k, 0) + n

    dev = torch.device("cuda")
    with torch.inference_mode():
        for arch in ARCH_NAMES:
            cfg = dataclasses.replace(smoke_variant(get_config(arch)),
                                      moe_capacity_factor=8.0)
            batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                     for k, v in smoke_batch(cfg).items() if k != "labels"}
            params = M.init_params(torch.Generator().manual_seed(0), cfg)
            want, _ = M.forward(params, batch, cfg)
            p = tree_to(params, dev)
            got, _, c = _forward_counted(
                torch, p, {k: v.to(dev) for k, v in batch.items()}, cfg)
            add(c)
            check((c["rmsnorm"], c["flash_attention"]) == _expected(cfg),
                  f"{arch} smoke: launches {c}")
            diff = max_err(torch, got.cpu(), want)
            check(torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4),
                  f"{arch} smoke: cuda vs cpu logits {diff:.3e}")
            msg = (f"[arch] {cfg.name}: cuda (kernels) vs cpu (plain) "
                   f"logits {diff:.2e} (rtol 1e-4, atol 1e-4)")
            if cfg.has_decode:
                S = 24
                toks = torch.as_tensor(np.random.default_rng(1).integers(
                    0, cfg.vocab_size, (2, S)).astype(np.int32), device=dev)
                tcfg = dataclasses.replace(cfg, frontend=None)
                full, _ = M.forward(p, {"tokens": toks}, tcfg)
                cache = M.init_cache(cfg, 2, S, device=dev)
                outs = []
                for i in range(S):
                    lg, cache = M.decode_step(p, cache, toks[:, i:i + 1], i,
                                              cfg)
                    outs.append(lg[:, 0])
                dec = torch.stack(outs, 1)
                d2 = max_err(torch, dec, full)
                check(torch.allclose(dec, full, rtol=2e-3, atol=1e-3),
                      f"{arch} smoke: decode vs forward {d2:.3e}")
                msg += f"; {S} decode steps vs forward {d2:.2e} (2e-3/1e-3)"
            log(msg)
        del params, p
        release(torch)

        # jamba, one group of 8 at full width: 7 mamba, 1 attention, 4 MoE
        cfg = dataclasses.replace(get_config(JAMBA), num_groups=1)
        params = init_full(torch, cfg, "arch")
        toks = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (1, 2048)).astype(np.int32), device=dev)
        logits, dt, c = _forward_counted(torch, params, {"tokens": toks},
                                         cfg)
        add(c)
        check((c["rmsnorm"], c["flash_attention"]) == _expected(cfg)
              and bool(torch.isfinite(logits[:, -1]).all()),
              f"jamba prefill: launches {c} or logits not finite")
        log(f"[arch] {cfg.name} one group prefill B=1 S=2048: {dt:.3f} s "
            f"({2048 / dt:.0f} tok/s); rmsnorm {c['rmsnorm']}, flash "
            f"{c['flash_attention']}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del logits
        prompts = np.random.default_rng(3).integers(
            0, cfg.vocab_size, (SERVE["batch"], SERVE["prompt"])
        ).astype(np.int32)
        reset_counts()
        t0 = time.time()
        out = serve.greedy_generate(cfg, params, prompts, SERVE["gen"])
        torch.cuda.synchronize()
        dt = time.time() - t0
        c = read_counts()
        add(c)
        steps = SERVE["prompt"] + SERVE["gen"]
        check(c["rmsnorm"] == steps * _expected(cfg)[0]
              and c["flash_attention"] == 0 and out.shape ==
              (SERVE["batch"], steps) and int(out.max()) < cfg.vocab_size,
              f"jamba greedy: launches {c} or tokens malformed")
        log(f"[arch] {cfg.name} one group greedy_generate B="
            f"{SERVE['batch']} prompt={SERVE['prompt']} gen={SERVE['gen']}: "
            f"{dt:.3f} s ({1e3 * dt / steps:.2f} ms/step, "
            f"{SERVE['batch'] * SERVE['gen'] / dt:.1f} new tok/s); rmsnorm "
            f"{c['rmsnorm']}")
        del params, toks
        release(torch)

        # llama4-scout, one group at full width: 3 chunked + 1 global
        cfg = dataclasses.replace(get_config(LLAMA4), num_groups=1)
        params = init_full(torch, cfg, "arch")
        S = 16384
        toks = torch.as_tensor(np.random.default_rng(4).integers(
            0, cfg.vocab_size, (1, S)).astype(np.int32), device=dev)
        reset_counts()
        t0 = time.time()
        last = serve.prefill_step(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
        dt = time.time() - t0
        c = read_counts()
        add(c)
        check((c["rmsnorm"], c["flash_attention"]) == _expected(cfg)
              and bool(torch.isfinite(last).all()),
              f"llama4 prefill: launches {c} or logits not finite")
        log(f"[arch] {cfg.name} one group (3 chunked + 1 global layer, "
            f"chunk {cfg.attn_chunk}) prefill B=1 S={S}: {dt:.3f} s "
            f"({S / dt:.0f} tok/s); rmsnorm {c['rmsnorm']}, flash "
            f"{c['flash_attention']}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del params, toks, last
        release(torch)

        # hubert-xlarge at full width: bidirectional encoder, layernorm
        cfg = get_config(HUBERT)
        params = init_full(torch, cfg, "arch")
        feats = torch.randn((2, 1024, cfg.frontend_dim), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(5))
        logits, dt, c = _forward_counted(torch, params, {"features": feats},
                                         cfg)
        add(c)
        check((c["rmsnorm"], c["flash_attention"]) == _expected(cfg)
              and tuple(logits.shape) == (2, 1024, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"hubert forward: launches {c} or logits malformed")
        log(f"[arch] {cfg.name} ({cfg.num_layers} layers, d {cfg.d_model}, "
            f"bidirectional, layernorm) forward B=2 S=1024: {dt:.3f} s "
            f"({2048 / dt:.0f} frames/s); flash {c['flash_attention']} "
            f"non-causal at d 80")
        del params, feats, logits
        release(torch)

        # phi-3-vision at full width: a prefill after its 576 image tokens
        cfg = get_config(PHI3V)
        params = init_full(torch, cfg, "arch")
        n_img, n_txt = cfg.num_image_tokens, 64
        batch = {"tokens": torch.as_tensor(np.random.default_rng(6).integers(
                     0, cfg.vocab_size, (1, n_txt)).astype(np.int32),
                     device=dev),
                 "image_embeds": torch.randn(
                     (1, n_img, cfg.frontend_dim), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(7))}
        reset_counts()
        t0 = time.time()
        last = serve.prefill_step(params, batch, cfg)
        torch.cuda.synchronize()
        dt = time.time() - t0
        c = read_counts()
        add(c)
        check((c["rmsnorm"], c["flash_attention"]) == _expected(cfg)
              and bool(torch.isfinite(last).all()),
              f"phi-3-vision prefill: launches {c} or logits not finite")
        log(f"[arch] {cfg.name} prefill B=1, {n_img} image + {n_txt} text "
            f"tokens: {dt:.3f} s; rmsnorm {c['rmsnorm']}, flash "
            f"{c['flash_attention']} at d 96")
        del params, batch, last
    release(torch)
    return totals


# --------------------------------------------------------- [spmd]

SPMD_RANKS = 4                   # one rank per data-axis position
# the SPMD driver's default arch at its published width (--no-smoke: the
# spec's default is the smoke variant, and the published config's remat
# is "block"): g 1 -> 2 -> 4, one step each, so 4 + 2 + 1 = 7 gradients
SPMD_BATCH, SPMD_SEQ, SPMD_LR = 32, 64, 3e-5
SPMD_RUN = ["--arch", "xlstm-350m", "--no-smoke", "--mode", "hybrid",
            "--schedule",
            "step:1", "--steps", "3", "--batch", str(SPMD_BATCH), "--seq",
            str(SPMD_SEQ), "--lr", str(SPMD_LR), "--optimizer", "sgd",
            "--log-every", "1"]
SPMD_GROUPS = [1, 2, 4]
# [spmd]'s run at 2 of xlstm-350m's 6 block groups, its widths unchanged:
# the [spmd-tp] runs start once it has been read, after the zoo phases,
# and at all 6 groups its ~111 s outlasted them
SPMD_DEPTH = 2
SPMD_CHILD = "--spmd-child"
SPMD_SMALL = ["--arch", "h2o-danube-1.8b", "--smoke", "--schedule",
              "step:2", "--steps", "4", "--batch", "4", "--seq", "16",
              "--log-every", "1"]
SPMD_TOL = (1e-5, 1e-6)         # card vs CPU, float32


def spmd_launch(nproc: int, args, device: str, out: str,
                ckpt_dir=None) -> subprocess.Popen:
    """``torchrun --standalone`` (a free rendezvous port) of ``python -m
    repro_torch run --backend spmd``; only rank 0 writes ``out``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), "-m", "repro_torch", "run",
           "--backend", "spmd", *args, "--device", device, "--quiet",
           "--out", out]
    if ckpt_dir:
        cmd += ["--ckpt-dir", ckpt_dir]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def stop(proc) -> None:
    """End ``proc`` (a torchrun, which passes SIGTERM on to its ranks)
    if it is still running."""
    if proc is None or proc.poll() is not None:
        return
    proc.terminate()
    try:
        proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()


def spmd_result(proc: subprocess.Popen, out: str, label: str,
                timeout: float = 600.0) -> dict:
    try:
        text, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        text, _ = proc.communicate()
        raise AssertionError(f"[spmd] {label}: no end in {timeout} s:\n"
                             + text[-3000:])
    check(proc.returncode == 0, f"[spmd] {label}: torchrun exited "
          f"{proc.returncode} (a rank failed):\n{text[-3000:]}")
    with open(out) as f:
        return json.load(f)


def spmd_npz(path: str) -> dict:
    import numpy as np
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def spmd_config():
    """``[spmd]``'s config: xlstm-350m at ``SPMD_DEPTH`` of its groups."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config("xlstm-350m"),
                               num_groups=SPMD_DEPTH)


def spmd_child(out: str) -> int:
    """A rank of ``[spmd]``'s full-width run (started by torchrun):
    ``python -m repro_torch run --backend spmd`` with ``SPMD_RUN`` on
    xlstm-350m cut to ``SPMD_DEPTH`` groups."""
    from repro_torch.api.cli import main as cli
    from repro_torch.multicard_smoke import at_depth
    at_depth("xlstm-350m", SPMD_DEPTH)
    return cli(["run", "--backend", "spmd", *SPMD_RUN, "--device", "cuda",
                "--quiet", "--out", out])


def start_spmd(tmp: str) -> dict:
    """Start ``[spmd]``'s full-width run (:func:`drive_spmd` reads it):
    its torchrun of ``SPMD_CHILD`` ranks, where it writes and when it
    started."""
    out = os.path.join(tmp, "full.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(SPMD_RANKS), os.path.abspath(__file__),
           SPMD_CHILD, out]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return {"proc": subprocess.Popen(cmd, cwd=ROOT, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
            "out": out, "t0": time.time()}


def drive_spmd(torch, tmp: str, full: dict):
    """The SPMD backend: xlstm-350m at full width, 4 ranks sharing the
    card over gloo, g annealed 1 -> 2 -> 4 with every merge through the
    flush kernel (``full``, from :func:`start_spmd`, started beside
    ``[zoo-sim]``'s small runs and ``[zoo-wire]``: nothing times them,
    and they fit the card together); then h2o-danube-1.8b's smoke variant
    on 2 ranks, the card against the CPU and a sync run twice, while
    ``[spmd-tp]``'s runs (:func:`spmd_tp_check`) run beside them
    (started once the full run has ended, the ``TP_AFTER`` runs once the
    run each names has: see there); then ``flush`` alone at every
    merge's shape.  The card's memory in use is sampled all along
    (``nvidia-smi``).  Returns the flush launches of the full run and of
    ``[spmd-tp]`` (their rank 0's, read through ``RunResult.extra``),
    ``[spmd-tp]``'s sliced serving's rmsnorm and flash launches (every
    rank's) and the merges' times."""
    tp = {}
    monitor = CardMonitor()
    try:
        launches = spmd_runs(torch, tmp, full, lambda: tp.update(
            (label, spmd_tp_launch(label, tmp)) for label in TP_RUNS
            if label not in TP_AFTER))
        for label, after in TP_AFTER.items():
            tp_wait(tp[after])
            tp[label] = spmd_tp_launch(label, tmp)
        tp_launches = {"flush": 0, "rmsnorm": 0, "flash_attention": 0}
        for run in tp.values():
            flush, served = spmd_tp_check(run)
            tp_launches["flush"] += flush
            for name, n in served.items():
                tp_launches[name] += n
    finally:
        for run in tp.values():
            stop(run["proc"])
        monitor.stop()
    peak = max(m for _, _, m in monitor.card)
    log(f"[spmd-tp] the card's memory in use while [spmd] and [spmd-tp] "
        f"ran: {monitor.card_before:.0f} MiB at the start, peak {peak:.0f} "
        f"MiB ({len(monitor.card)} nvidia-smi samples)")
    times = spmd_merge_flush(torch)
    times.update(spmd_tp_merge_flush(torch))
    return launches, tp_launches, times


def spmd_runs(torch, tmp: str, full: dict, after_full=None) -> dict:
    import numpy as np
    res = spmd_result(full["proc"], full["out"], "xlstm-350m")
    wall = time.time() - full["t0"]
    hist, extra = res["extra"]["history"], res["extra"]
    groups = [h["group_size"] for h in hist]
    reps = [h["replicas"] for h in hist]
    check(groups == SPMD_GROUPS and reps == [SPMD_RANKS // g for g in
                                             SPMD_GROUPS],
          f"[spmd] group sizes {groups}, replicas {reps}")
    want = (sum(SPMD_RANKS // g for g in SPMD_GROUPS), len(SPMD_GROUPS))
    check((res["num_gradients"], res["num_updates"]) == want,
          f"[spmd] {res['num_gradients']} gradients, {res['num_updates']} "
          f"updates, expected {want}")
    flush_by_k = extra["launches_by_k"].get("flush", {})
    check(flush_by_k.get("4", 0) >= 1 and flush_by_k.get("2", 0) >= 1,
          f"[spmd] flush launches by K {flush_by_k}: none at K 4 or K 2")
    # the merges are split along P: every rank flushes its own chunk
    check(all(r == {"1": 1, "2": 1, "4": 1}
              for r in extra["flush_launches_by_rank"]),
          f"[spmd] flush launches by rank {extra['flush_launches_by_rank']}")
    check([m["K"] for m in extra["merges"]] == [4, 2, 1],
          f"[spmd] merges {extra['merges']}")
    losses = [h["loss"] for h in hist]
    check(all(math.isfinite(x) for x in losses), f"[spmd] losses {losses}")
    check(all((h["divergence"] > 0) == (h["replicas"] > 1)
              and math.isfinite(h["divergence"]) for h in hist),
          f"[spmd] divergence {[h['divergence'] for h in hist]}")
    check(extra["backend"] == "gloo" and extra["world_size"] == SPMD_RANKS,
          f"[spmd] backend {extra['backend']}, world {extra['world_size']}")
    # the published config's remat: block groups and mLSTM chunks
    # checkpointed (sLSTM is not, as in the reference)
    check(extra["remat"] == "block", f"[spmd] remat {extra['remat']}")
    steps, tokens = res["num_updates"], hist[-1]["tokens"]
    log(f"[spmd] xlstm-350m full width, remat {extra['remat']}, "
        f"{SPMD_RANKS} ranks on "
        f"{extra['device_name']}, backend {extra['backend']}: g "
        f"{groups}, R {reps}; {res['num_gradients']} gradients, "
        f"{steps} updates; flush launches by K {flush_by_k} on rank 0, "
        f"by rank {extra['flush_launches_by_rank']}; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; divergence "
        f"{[float('%.4g' % h['divergence']) for h in hist]}")
    peaks = [round(b / 2**30, 2) for b in extra["peak_memory_bytes"]]
    log(f"[spmd] wall {res['wall_s']:.2f} s in rank 0's trainer "
        f"({steps / res['wall_s']:.3f} steps/s, "
        f"{tokens / res['wall_s']:.1f} tokens/s), {wall:.2f} s with "
        f"torchrun and start-up; step wall by step "
        f"{[h['wall_s'] for h in hist]}; peak card memory by rank "
        f"(allocator) {peaks} GiB; seconds in collectives by rank "
        f"{[round(x, 2) for x in extra['collective_s']]}")
    # the divergence of a logged step moves each replica's P-chunks to
    # their ranks (each group gathers its replica, then one all-to-all;
    # a diagnostic the reference takes inside its step); each kind's
    # seconds include the waits for the other ranks
    by_kind = extra["collective_s_by_kind"]
    div0 = by_kind[0]["divergence"]
    log(f"[spmd] seconds in collectives by kind and rank: " + "; ".join(
        f"{kind} {[round(r[kind], 2) for r in by_kind]}"
        for kind in ("gradient", "gather", "divergence", "merge")) +
        f"; without rank 0's {div0:.2f} s of divergence gathers "
        f"{steps / (res['wall_s'] - div0):.3f} steps/s, "
        f"{tokens / (res['wall_s'] - div0):.1f} tokens/s")

    if after_full is not None:
        after_full()
    spmd_fsdp_check(extra["layout"])

    # smoke width: the card against the CPU, and a sync run twice
    runs = {
        "cuda": ("cuda", ["--mode", "hybrid"]),
        "cpu": ("cpu", ["--mode", "hybrid"]),
        "sync-a": ("cuda", ["--mode", "sync"]),
        "sync-b": ("cuda", ["--mode", "sync"]),
    }
    procs = {}
    for label, (dev, mode) in runs.items():
        procs[label] = spmd_launch(
            2, SPMD_SMALL + mode, dev, os.path.join(tmp, f"{label}.json"),
            ckpt_dir=os.path.join(tmp, label))
    small = {label: spmd_result(p, os.path.join(tmp, f"{label}.json"),
                                f"h2o smoke {label}")
             for label, p in procs.items()}
    final = {label: spmd_npz(os.path.join(tmp, label, "step_4.npz"))
             for label in runs}
    rtol, atol = SPMD_TOL
    worst = 0.0
    for k, want in final["cpu"].items():
        got = final["cuda"][k]
        worst = max(worst, float(np.abs(got - want).max()))
        check(np.allclose(got, want, rtol=rtol, atol=atol),
              f"[spmd] h2o smoke hybrid: {k} on the card vs the CPU")
    for a, b in zip(small["cuda"]["extra"]["history"],
                    small["cpu"]["extra"]["history"]):
        check(math.isclose(a["loss"], b["loss"], rel_tol=rtol,
                           abs_tol=atol), f"[spmd] losses {a} vs {b}")
    check(all(final["sync-a"][k].tobytes() == final["sync-b"][k].tobytes()
              for k in final["sync-a"]),
          "[spmd] h2o smoke sync: two runs on the card differ")
    log(f"[spmd] h2o-danube-1.8b smoke f32 hybrid step:2, 2 ranks: final "
        f"params on the card vs the CPU max abs diff {worst:.3e} (rtol "
        f"{rtol:g}, atol {atol:g}), merges by K "
        f"{[m['K'] for m in small['cuda']['extra']['merges']]}; sync run "
        f"twice on the card: final params bitwise equal")
    return flush_by_k


def spmd_fsdp_check(layout) -> None:
    """The g 2 and g 4 phases run the FSDP layout (parallel/fsdp.py):
    each rank's state is the partition rules' shard bytes to the byte,
    and each rank's step peak is the dry-run's traced FSDP peak at
    [spmd]'s own shape (a rank's 8 rows of 64, SGD) within 10% or
    256 MiB, the [dryrun] rule."""
    from repro_torch.configs.registry import InputShape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.optim.optimizers import sgd
    check([(p["g"], p["fsdp"]) for p in layout] ==
          [(g, g > 1) for g in SPMD_GROUPS], f"[spmd] layout {layout}")
    shape = InputShape("spmd", SPMD_SEQ, SPMD_BATCH, "train")
    for p in layout[1:]:
        pred = dryrun.fsdp_layout(spmd_config(), shape,
                                  SPMD_RANKS, hybrid_rep=SPMD_RANKS // p["g"],
                                  optimizer=sgd(SPMD_LR))
        state, peak = pred["state_bytes_total"], pred["peak_bytes"]
        check(all(b == state for b in p["state_bytes"]),
              f"[spmd] g {p['g']}: state bytes by rank {p['state_bytes']}, "
              f"the partition rules' {state}")
        tol = max(DRYRUN_RTOL * peak, DRYRUN_SLACK)
        check(all(abs(b - peak) <= tol for b in p["step_peak_bytes"]),
              f"[spmd] g {p['g']}: step peaks by rank "
              f"{p['step_peak_bytes']}, predicted {peak} within {tol:.0f}")
        log(f"[spmd] FSDP g {p['g']}: state {state} B a rank = the "
            f"partition rules' shard bytes; held before the first step "
            f"by rank {p['held_bytes']} B; step peak by rank "
            f"{p['step_peak_bytes']} B against the dry-run's traced "
            f"{peak} B (ratios "
            f"{[round(b / peak, 6) for b in p['step_peak_bytes']]}); "
            f"predicted collectives a step "
            f"{ {k: int(v) for k, v in pred['collective_bytes_per_device'].items()} } B")


def spmd_merge_flush(torch) -> dict:
    """``flush`` alone at the merge's shape: K 4 replicas of one rank's
    P-chunk of the full run's f32 slab (the merges are split along P over
    the 4 ranks)."""
    from repro_torch.core.slab import shard_chunks, slab_codec
    from repro_torch.launch import dryrun
    P = slab_codec(dryrun.meta_params(spmd_config())).padded_size
    return merge_flush(torch, SPMD_RANKS, shard_chunks(P, SPMD_RANKS)[0],
                       "the merge's shape")


def merge_flush(torch, K: int, P: int, what: str,
                bitwise: bool = False) -> dict:
    """``flush`` alone at a merge's shape, K rows of a P-chunk, against
    its plain version (``bitwise``: equal to it bit for bit) and timed
    with its bound and ``w @ g``."""
    from repro_torch.kernels import hybrid_aggregate as ha
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(2)
    g = torch.randn(K, P, device="cuda", generator=gen)
    w = torch.ones(K, device="cuda")
    got, want = same_twice(torch, lambda: ha.flush(g, w))[0], \
        ref.flush_ref(g, w)
    err = hold(torch, "flush", got, want, 1e-6, 1e-6, f"merge K={K} P={P}")
    check(not bitwise or torch.equal(got, want),
          f"flush at {what}: not bitwise equal to its plain version")
    del got, want
    case = f"flush merge chunk K={K} P={P} f32"
    row = time_cases(torch, Timer(torch, reps=10), {
        case: (lambda: ha.flush(g, w), lambda: ref.flush_ref(g, w),
               lambda: w @ g, ha.cost("flush", K, P, 4))})[case]
    row["kernel_only_ms"] = kernel_only_ms(torch, lambda: ha.flush(g, w),
                                           "flush_kernel", reps=10)
    row["max_abs_err"] = err
    log(f"[time] flush at {what} (K {K}, P {P:,}): kernel alone "
        f"{row['kernel_only_ms']:.6f} ms cold (profiler) = "
        f"{100 * row['bound_ms'] / row['kernel_only_ms']:.1f}% of bound "
        f"{row['bound_ms']:.6f} ms; wrapper call {row['ms']:.6f} ms; w @ g "
        f"{row['library_ms']:.6f} ms")
    del g
    release(torch)
    return {case: row}


# --------------------------------------------------------- [spmd-tp]

# [spmd-tp]: the model axis (parallel/tensor.py) on the one card: 4 gloo
# ranks as {data 2, model 2}, hybrid step:1 (g 1 -> 2, R 2 -> 1), 2 steps
# of 2 rows of 512, SGD, at published widths and reduced depth (a
# torchrun of this script's TP_CHILD, run_training on the registry's
# config cut in that process), the final params assembled in rank 0's
# host memory: h2o-danube-1.8b (attention + MLP), deepseek-v2-lite-16b
# (MLA + MoE) and xlstm-350m (mLSTM + sLSTM), side by side
TP_MODEL = 2
TP_BATCH, TP_SEQ, TP_LR = 2, 512, 1e-5
TP_RUNS = {"h2o": ("h2o-danube-1.8b", 2),        # 2 of its 24 groups
           "deepseek": ("deepseek-v2-lite-16b", 1),   # 1 of its 27
           "xlstm": ("xlstm-350m", 1)}                # 1 of its 6
# the [spmd-tp] runs that start once another has ended, the others when
# [spmd]'s full run has: deepseek's ran out of the card's memory beside
# the full run and beside xlstm's at 6 groups; beside the full run,
# xlstm's at 2 groups took the card to 72.4 of its 81.6 GB before
# [zoo-sim]'s and [zoo-wire]'s share (PERF.md); its ranks peak at 1.65
# GB each, h2o's, which it replaces, at 2.08.  xlstm's run follows h2o's
# on the phase's longest chain, and the sliced serving added to each run
# lengthened it: xlstm went from 2 of its groups to 1 to make the room,
# its width unchanged
TP_AFTER = {"xlstm": "h2o"}
TP_CHILD = "--spmd-tp-child"
# after its training, each [spmd-tp] run serves sliced in the same
# torchrun (repro_torch/serve_smoke.py): 4 prompts of 24 tokens, 8 new,
# a cache of 32 (M 2 divides it), the params drawn sliced from seed 0 on
# the card, against rank 0's whole run of the same params
TP_SERVE = dict(batch=4, prompt=24, gen=8, max_seq=32)
# then 1 prompt, which the 2 data positions do not divide (regime (b))
TP_SERVE_B = dict(TP_SERVE, batch=1)


def tp_config(arch: str, groups: int):
    import dataclasses
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(arch), num_groups=groups)


def spmd_tp_child(out: str, arch: str, groups: int) -> int:
    """A rank of a ``[spmd-tp]`` run (started by torchrun); rank 0 writes
    what it assembled of the final params beside ``out``, then, after
    the sliced serving (``TP_SERVE``) in the same process group, its
    figures."""
    from repro_torch.api.spec import ExperimentSpec
    from repro_torch.launch.mesh import distributed, rank_device
    from repro_torch.launch.train import run_training
    from repro_torch.multicard_smoke import at_depth, final_summary
    from repro_torch.serve_smoke import sliced_serve
    spec = ExperimentSpec(
        arch=arch, backend="spmd", mode="hybrid", schedule="step:1",
        steps=2, batch=TP_BATCH, seq=TP_SEQ, lr=TP_LR, optimizer="sgd",
        smoke=False, log_every=1, mesh_model=TP_MODEL)
    at_depth(arch, groups)
    t0 = time.time()
    with distributed(rank_device("cuda")):
        final, _, _ = run_training(spec, out_json=out, verbose=False,
                                   device="cuda")
        if final is not None:
            with open(out + ".final.json", "w") as f:
                json.dump(final_summary(final, TP_MODEL, time.time() - t0),
                          f)
        del final
        for tag, shape in (("serve", TP_SERVE), ("serve-b", TP_SERVE_B)):
            served = sliced_serve(tp_config(arch, groups), TP_MODEL,
                                  shape["batch"], shape["prompt"],
                                  shape["gen"], shape["max_seq"])
            if served is not None:
                with open(f"{out}.{tag}.json", "w") as f:
                    json.dump(served, f)
    return 0


def spmd_tp_launch(label: str, tmp: str) -> dict:
    """Start ``[spmd-tp]``'s ``label`` run: 4 ranks of this script's
    ``TP_CHILD`` under ``torchrun --standalone``."""
    arch, groups = TP_RUNS[label]
    out = os.path.join(tmp, f"tp-{label}.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(SPMD_RANKS), os.path.abspath(__file__),
           TP_CHILD, out, arch, str(groups)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return {"proc": subprocess.Popen(cmd, cwd=ROOT, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
            "out": out, "t0": time.time(), "label": label}


def tp_wait(run: dict, timeout: float = 600.0) -> str:
    """Wait for a ``[spmd-tp]`` run's torchrun to end and keep its
    output (read once)."""
    if "text" not in run:
        try:
            run["text"], _ = run["proc"].communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            run["proc"].kill()
            run["text"], _ = run["proc"].communicate()
            raise AssertionError(f"[spmd-tp] {run['label']}: no end in "
                                 f"{timeout} s:\n" + run["text"][-3000:])
        run["t_end"] = time.time()
    return run["text"]


def spmd_tp_check(run: dict) -> int:
    """The model axis: a torchrun of 4 ranks sharing the card over gloo
    at model 2 (``run``, from :func:`spmd_tp_launch`).  Each rank's state
    against the partition rules' shards over {data g, model 2} to the
    byte (its step peak against the dry-run's traced tensor-parallel
    step, read), one ``flush`` a rank at K 2 and at K 1 (each model
    column merges its own slices), divergence > 0 exactly while R > 1,
    the leaves whole on every model rank (and, with an MoE, every MoE
    layer's routing) equal across each model group at the end, and the
    final params rank 0 assembled in its host memory of the cut
    config's shapes, finite, their whole leaves the ranks' bit for bit.
    Then its sliced serving (:func:`tp_serve_check`).  Returns the run's
    flush launches (rank 0's) and its sliced serving's rmsnorm and
    flash launches (all ranks')."""
    from repro_torch.configs.registry import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.multicard_smoke import check_final
    from repro_torch.optim.optimizers import sgd
    label = run["label"]
    arch, groups = TP_RUNS[label]
    tag = f"[spmd-tp] {label}"
    data = SPMD_RANKS // TP_MODEL
    text = tp_wait(run)
    check(run["proc"].returncode == 0, f"{tag}: torchrun exited "
          f"{run['proc'].returncode} (a rank failed):\n{text[-3000:]}")
    with open(run["out"]) as f:
        res = json.load(f)
    wall = run["t_end"] - run["t0"]
    st, hist = res["stats"], res["history"]
    check(st["backend"] == "gloo" and st["world_size"] == SPMD_RANKS
          and st["mesh_model"] == TP_MODEL,
          f"{tag}: backend {st['backend']}, world {st['world_size']}, "
          f"mesh_model {st.get('mesh_model')}")
    check([(h["group_size"], h["replicas"]) for h in hist] ==
          [(1, 2), (2, 1)], f"{tag}: history {hist}")
    check([m["K"] for m in st["merges"]] == [2, 1],
          f"{tag}: merges {st['merges']}")
    check(all(r == {"1": 1, "2": 1} for r in st["flush_launches_by_rank"]),
          f"{tag}: flush launches by rank {st['flush_launches_by_rank']}")
    check(all((h["divergence"] > 0) == (h["replicas"] > 1)
              and math.isfinite(h["divergence"])
              and math.isfinite(h["loss"]) for h in hist),
          f"{tag}: history {hist}")
    keys = ["whole_digest_by_rank"] + (
        ["routing_digest_by_rank"] if "routing_digest_by_rank" in st else [])
    check(label != "deepseek" or len(keys) == 2, f"{tag}: no routing digest")
    for key in keys:
        d = st[key]
        check(all(d[r] == d[r - r % TP_MODEL] for r in range(SPMD_RANKS)),
              f"{tag}: {key} {d}")
    cfg = tp_config(arch, groups)
    with open(run["out"] + ".final.json") as f:
        res["final"] = json.load(f)
    check_final(tag, res, cfg, TP_MODEL)
    shape = InputShape("spmd-tp", TP_SEQ, TP_BATCH, "train")
    for p in st["layout"]:
        pred = dryrun.fsdp_layout(cfg, shape, SPMD_RANKS,
                                  hybrid_rep=data // p["g"],
                                  optimizer=sgd(TP_LR), model=TP_MODEL)
        state, peak = pred["state_bytes_total"], pred["peak_bytes"]
        check(p["model"] == TP_MODEL and all(
            b == state for b in p["state_bytes"]),
            f"{tag} g {p['g']}: state bytes by rank {p['state_bytes']}, "
            f"the partition rules' {state} over {pred['mesh']}")
        log(f"{tag} g {p['g']} x model {p['model']} (FSDP {p['fsdp']}): "
            f"state {state} B a rank = the partition rules' shard bytes "
            f"over {pred['mesh']}; step peak by rank {p['step_peak_bytes']} "
            f"B against the dry-run's traced {peak} B (ratios "
            f"{[round(b / peak, 6) for b in p['step_peak_bytes']]}; read, "
            f"not held); predicted collectives a step "
            f"{ {k: int(v) for k, v in pred['collective_bytes_per_device'].items()} } B")
    flush_by_k = st["launches_by_k"].get("flush", {})
    by_kind = st["collective_s_by_kind"]
    log(f"{tag}: {arch} full width, {groups} of "
        f"{published_groups(arch)} groups, "
        f"remat {st['remat']}, {SPMD_RANKS} ranks on {st['device_name']} "
        f"as data {data} x model {TP_MODEL}, backend {st['backend']}: g "
        f"{[h['group_size'] for h in hist]}, merges K "
        f"{[m['K'] for m in st['merges']]}, flush launches by rank "
        f"{st['flush_launches_by_rank']}; losses "
        f"{[round(h['loss'], 6) for h in hist]}"
        + (f"; aux {[round(h['aux'], 6) for h in hist]}"
           if "aux" in hist[0] else "")
        + f"; divergence {[float('%.6g' % h['divergence']) for h in hist]};"
        f" digests equal across each model group ("
        + ", ".join(f"{k} {st[k]}" for k in keys) + "); last logged step "
        f"at {hist[-1]['wall_s']:.2f} s in rank 0's trainer; final params "
        f"assembled in rank 0's host memory ({len(res['final']['leaves'])} "
        f"leaves of the config's shapes, finite, whole leaves' digest "
        f"{res['final']['whole_digest']} = the ranks') by "
        f"{res['final']['seconds']:.2f} s into rank 0's run (the params "
        f"drawn, each rank's model slices taken leaf by leaf on the host, "
        f"and moved to the card in {st['draw_s']:.2f} s of it); its "
        f"torchrun ended {wall:.2f} s after its start (beside other runs);"
        f" peak GiB "
        f"by rank "
        f"{[round(b / 2**30, 2) for b in st['peak_memory_bytes']]}; "
        f"collective s by kind: " + "; ".join(
            f"{k} {[round(r[k], 2) for r in by_kind]}" for k in by_kind[0]))
    return sum(flush_by_k.values()), tp_serve_check(run, cfg)


def tp_serve_check(run: dict, cfg) -> dict:
    """A ``[spmd-tp]`` run's sliced serving (``repro_torch/serve_smoke.py``,
    ``TP_SERVE``), held by ``serve_smoke.check_served``: the float32
    logits within ``F32_TOL`` of rank 0's float32 whole run's, each
    rank's cache bytes the dry-run's to the byte, the MoE's routing
    digests equal across each model group, rmsnorm and flash launched on
    the sliced path; then the same of ``TP_SERVE_B``'s one row, every
    rank's tokens and routing equal.  Returns the sliced runs' launches,
    summed over the ranks."""
    from repro_torch.serve_smoke import check_served, summary
    launches = {"rmsnorm": 0, "flash_attention": 0}
    for name in ("serve", "serve-b"):
        tag = f"[spmd-tp] {run['label']} {name}"
        with open(f"{run['out']}.{name}.json") as f:
            sv = json.load(f)
        want = check_served(tag, sv, cfg, SPMD_RANKS, TP_MODEL)
        log(f"{tag}: {summary(sv, want)}")
        for k in launches:
            launches[k] += sum(r[k] for r in sv["by_rank"]["launches"])
    return launches


def published_groups(arch: str) -> int:
    from repro_torch.configs.registry import get_config
    return get_config(arch).num_groups


def spmd_tp_merge_flush(torch) -> dict:
    """``flush`` alone at each ``[spmd-tp]`` run's K 2 merge: K 2 rows of
    one rank's P-chunk of its model column's slab (the model slices of
    the run's config, split over the column's 2 data positions), bitwise
    against its plain version."""
    from repro_torch.core.slab import shard_chunks, slab_codec
    from repro_torch.launch import dryrun
    from repro_torch.parallel.fsdp import shard_tree
    from repro_torch.parallel.tensor import model_dims
    data = SPMD_RANKS // TP_MODEL
    out = {}
    for label, (arch, groups) in TP_RUNS.items():
        params = dryrun.meta_params(tp_config(arch, groups))
        sliced = shard_tree(params, 0, TP_MODEL,
                            model_dims(params, TP_MODEL))
        P = shard_chunks(slab_codec(sliced).padded_size, data)[0]
        out.update(merge_flush(torch, data, P,
                               f"the model axis' merge ({label})",
                               bitwise=True))
    return out


# ------------------------------------------------------------- dry-run

# [dryrun]: h2o-danube-1.8b's AdamW train step at full width, B 1, at
# three points, each held against its own meta-device prediction: S 1024
# without rematerialisation (what fitted the card before remat), S 2048
# and S 4096 (train_4k's length) with the config's remat "block" (each
# block group, each 512-row query block of the attention checkpointed)
DRYRUN_POINTS = ((1024, "none"), (2048, "block"), (4096, "block"))
DRYRUN_COMPARE_S = 1024           # remat against no remat, gradients
DRYRUN_COMPARE_RUNS = 3           # no-remat gradients: the run-to-run spread
DRYRUN_RTOL = 0.10                # a step's own bytes: within 10% ...
DRYRUN_SLACK = 256 << 20          # ... or 256 MiB, the larger


DRYRUN_CHILD = "--dryrun-train-step"


def _h2o_train_state(torch, dev):
    """h2o-danube-1.8b's params (seed 0) and AdamW state on ``dev``, and
    a batch maker: ``batch(S)`` gives B 1 tokens and labels of length S
    (one generator, seed 0)."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    h2o = get_config(ARCH)
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), h2o)
    opt = adamw(3e-4)
    rng = np.random.default_rng(0)

    def batch(S):
        return {k: torch.as_tensor(rng.integers(0, h2o.vocab_size, (1, S))
                                   .astype(np.int32), device=dev)
                for k in ("tokens", "labels")}
    return h2o, params, opt, opt.init(params), batch


def remat_gradient_check(torch, params, h2o, b) -> dict:
    """The gradient of one batch with remat "block" against the one
    without, leaf by leaf: bitwise where ``DRYRUN_COMPARE_RUNS`` runs
    without remat are bitwise equal to each other, else within their
    spread (the largest difference between two of them)."""
    import dataclasses
    from repro_torch.core import gradient
    from repro_torch.models import model as M

    def grads(cfg):
        g, _ = gradient.grad_and_value(
            lambda p, bb: M.loss_fn(p, bb, cfg), has_aux=True)(params, b)
        torch.cuda.synchronize()
        return tree_leaves(g)

    none = [grads(dataclasses.replace(h2o, remat="none"))
            for _ in range(DRYRUN_COMPARE_RUNS)]
    block = grads(dataclasses.replace(h2o, remat="block"))

    def diff(a, c):
        return float((a.float() - c.float()).abs().max())
    leaves, spread_leaves, bad = len(block), [], []
    for i, got in enumerate(block):
        runs = [g[i] for g in none]
        steady = all(torch.equal(runs[0], r) for r in runs[1:])
        d = diff(runs[0], got)
        if steady:
            if not torch.equal(runs[0], got):
                bad.append((i, "bitwise", 0.0, d))
            continue
        spread = max(diff(a, c) for j, a in enumerate(runs)
                     for c in runs[j + 1:])
        spread_leaves.append((i, spread, d))
        if d > spread:
            bad.append((i, "spread", spread, d))
    return dict(leaves=leaves, spread_leaves=spread_leaves, bad=bad)


def remat_step_seconds(torch, params, opt, opt_state, h2o, b, warm_b):
    """What remat costs a step: the same AdamW step on batch ``b`` with
    remat "none" and "block", in turns (none, block, block, none, each
    warmed on ``warm_b`` first); the fastest of each side's two."""
    import dataclasses
    from repro_torch.launch.steps import make_train_step
    steps = {r: make_train_step(dataclasses.replace(h2o, remat=r), opt)
             for r in ("none", "block")}
    for step in steps.values():
        step(params, opt_state, warm_b)
    times = {"none": [], "block": []}
    for r in ("none", "block", "block", "none"):
        torch.cuda.synchronize()
        t0 = time.time()
        out = steps[r](params, opt_state, b)
        torch.cuda.synchronize()
        times[r].append(time.time() - t0)
        del out
    return {r: min(t) for r, t in times.items()}


def dryrun_train_step(torch) -> dict:
    """h2o-danube-1.8b's AdamW train step (B 1) through
    ``make_train_step`` on the card at each of ``DRYRUN_POINTS``, after a
    warm-up step at S 64: its params' and moments' storage bytes, its own
    bytes (peak above what was allocated before it) and seconds, and the
    own bytes of its gradient alone; at ``DRYRUN_COMPARE_S`` the remat
    gradient against the no-remat one (:func:`remat_gradient_check`) and
    the step's seconds with and without remat
    (:func:`remat_step_seconds`)."""
    import dataclasses
    from repro_torch.core import gradient
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    h2o, params, opt, opt_state, batch = _h2o_train_state(
        torch, torch.device("cuda"))
    out = dict(params=storage_bytes(params),
               opt_state=storage_bytes(opt_state), points=[])
    for S, remat in DRYRUN_POINTS:
        cfg = dataclasses.replace(h2o, remat=remat)
        train_step = make_train_step(cfg, opt)
        warm = train_step(params, opt_state, batch(64))   # not timed
        torch.cuda.synchronize()
        del warm
        b = batch(S)
        measured = step_bytes(torch)
        t0 = time.time()
        new_params, _, loss, _ = train_step(params, opt_state, b)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        step = measured()
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(t).all()) for t in tree_leaves(new_params))
        del new_params, loss
        measured = step_bytes(torch)
        g = gradient.grad_and_value(
            lambda p, bb: M.loss_fn(p, bb, cfg), has_aux=True)(params, b)
        torch.cuda.synchronize()
        grad_step = measured()
        del g
        point = dict(S=S, remat=remat, step=step, seconds=seconds,
                     grad_step=grad_step, finite=finite)
        if S == DRYRUN_COMPARE_S:
            point["compare"] = remat_gradient_check(torch, params, h2o, b)
            point["remat_cost"] = remat_step_seconds(
                torch, params, opt, opt_state, h2o, b, batch(64))
        out["points"].append(point)
        del b
        torch.cuda.empty_cache()
    return out


def c38_reading(torch, report) -> dict:
    """ROADMAP C.38: the S 1024 no-remat step taken once more in this
    process (after every earlier phase), under the allocator's memory
    history, as a logged reading, not a check.  When it reads above the
    prediction by more than ``DRYRUN_SLACK`` the history goes to
    ``chiprun_out/c38_snapshot.pickle``."""
    import dataclasses
    from repro_torch.launch.steps import make_train_step
    h2o, params, opt, opt_state, batch = _h2o_train_state(
        torch, torch.device("cuda"))
    S, remat = DRYRUN_POINTS[0]
    train_step = make_train_step(dataclasses.replace(h2o, remat=remat),
                                 opt)
    warm = train_step(params, opt_state, batch(64))
    torch.cuda.synchronize()
    del warm
    b = batch(S)
    torch.cuda.memory._record_memory_history(max_entries=100000)
    measured = step_bytes(torch)
    out = train_step(params, opt_state, b)
    torch.cuda.synchronize()
    got = measured()
    excess = got - report.step_bytes
    dump = None
    if excess > DRYRUN_SLACK:
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        dump = os.path.join(ROOT, "chiprun_out", "c38_snapshot.pickle")
        torch.cuda.memory._dump_snapshot(dump)
    torch.cuda.memory._record_memory_history(enabled=None)
    del out, params, opt_state, b
    release(torch)
    return dict(step=got, excess=excess, snapshot=dump)


def drive_dryrun(torch, serve_read: dict, mla_read: dict) -> dict:
    """The meta-device dry-run (``launch/dryrun.py``) against the card:
    state bytes (params, KV cache, AdamW moments) exactly, each step's
    own bytes (its peak above what was allocated before it) within 10%
    or 256 MiB, and each step's time at or above the dry-run's bound.
    The prefills are ``[serve]``'s (h2o-danube-1.8b, B 1, S 8192) and
    ``[serve-mla-moe]``'s (deepseek-v2-lite-16b, S 4096).  The train
    steps (``DRYRUN_POINTS``) run in a child process of their own
    (:func:`dryrun_train_step`), their gradients' own bytes held too: in
    this process, after the other phases, one call of five read 10.4 GB
    above the step's 33.8 GB that every fresh process reads (ROADMAP
    C.38), which :func:`c38_reading` keeps reading.  Before them the
    square-root sweep (``repro_torch/sqrt_sweep.py``) shows ``torch.sqrt``
    of CUDA float32 correctly rounded, which ``sqrt_rn`` relies on."""
    import dataclasses
    from repro_torch import sqrt_sweep
    from repro_torch.configs.registry import InputShape, get_config
    from repro_torch.launch import cost as C
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import H100_MEMORY_BYTES, card_memory_bytes
    from repro_torch.models import model as M

    t_phase = time.time()
    card = card_memory_bytes("cuda")
    log(f"[dryrun] card memory {card} B (torch.cuda.get_device_properties);"
        f" the dry-run's constant on the meta device {H100_MEMORY_BYTES} B")
    h2o, ds = get_config(ARCH), get_config(DEEPSEEK)
    t0 = time.time()
    pre_h2o, info_h2o = dryrun.analyze_step(
        h2o, InputShape("prefill", LONG_S, 1, "prefill"))
    pre_ds, info_ds = dryrun.analyze_step(
        ds, InputShape("prefill", MLA_LONG_S, 1, "prefill"))
    train = {}
    for S, remat in DRYRUN_POINTS:
        train[S, remat] = dryrun.analyze_step(
            dataclasses.replace(h2o, remat=remat),
            InputShape("train", S, 1, "train"))
    log(f"[dryrun] predictions on the meta device in {time.time() - t0:.1f}"
        " s; train B=1: " + "; ".join(
            f"S={S} remat {remat}: peak {r.peak_bytes} B "
            f"({'fits' if r.peak_bytes <= card else 'does not fit'} in "
            f"{card} B), step bytes {r.step_bytes}, gradient bytes "
            f"{r.phases['start']['peak'] - r.held_bytes}"
            for (S, remat), (r, _) in train.items()))
    out = {}

    def state(label, measured, meta_tree, allocator=None):
        want = C.tree_bytes(meta_tree)
        check(measured == want, f"[dryrun] {label}: {measured} B on the card,"
              f" {want} B predicted")
        extra = "" if allocator is None else \
            f" (the allocator's count rose {allocator} B)"
        log(f"[dryrun] state {label}: {measured} B = predicted{extra}")
        out[f"state {label}"] = measured

    def step(label, measured, report, seconds, dtype):
        want = report.step_bytes
        check(abs(measured - want) <= max(DRYRUN_RTOL * want, DRYRUN_SLACK),
              f"[dryrun] {label}: step bytes {measured} on the card, {want} "
              "predicted")
        bound = dryrun.bound_seconds(report.cost.flops,
                                     report.cost.hbm_bytes, dtype)
        check(seconds >= bound, f"[dryrun] {label}: {seconds} s is under "
              f"the dry-run's bound {bound} s")
        log(f"[dryrun] {label}: step bytes {measured} on the card / {want} "
            f"predicted = {measured / want:.6f}; {seconds:.6f} s against "
            f"the bound {bound:.6f} s ({report.cost.flops:.6e} FLOP, "
            f"{report.cost.hbm_bytes:.6e} B) = {100 * bound / seconds:.1f}% "
            f"of bound; kernels {report.kernels}")
        out[label] = dict(ratio=measured / want, seconds=seconds,
                          bound_s=bound, share=bound / seconds)

    state("h2o params", serve_read["param_bytes"][0], info_h2o["params"],
          serve_read["param_bytes"][1])
    step(f"h2o prefill B=1 S={LONG_S}", serve_read["long_step_bytes"],
         pre_h2o, serve_read["long_s"], torch.bfloat16)
    state("deepseek params", mla_read["param_bytes"][0], info_ds["params"],
          mla_read["param_bytes"][1])
    step(f"deepseek prefill B=1 S={MLA_LONG_S}", mla_read["long_step_bytes"],
         pre_ds, mla_read["long_s"], torch.bfloat16)

    dev = torch.device("cuda")
    B, P, G = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    cache = M.init_cache(h2o, B, P + G, device=dev)
    state(f"h2o KV cache B={B} S={P + G}", storage_bytes(cache),
          M.init_cache(h2o, B, P + G, device="meta"))
    del cache
    release(torch)          # the child needs the cached blocks back

    t0 = time.time()
    sweep = sqrt_sweep.sweep(torch.device("cuda"))
    check(sweep["mismatches"] == 0, f"[dryrun] torch.sqrt of CUDA float32 "
          f"is not the correctly rounded root: {sweep}")
    log(f"[dryrun] sqrt sweep: torch.sqrt of CUDA float32 against the "
        f"float64 root rounded once over {sweep['compared']} values "
        f"({sweep['range']}): {sweep['mismatches']} mismatches in "
        f"{time.time() - t0:.2f} s; kernels/ref.py::sqrt_rn takes the "
        "float32 root on the card")

    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           DRYRUN_CHILD], capture_output=True, text=True,
                          timeout=400)
    check(proc.returncode == 0, f"[dryrun] the train steps' process exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    info_tr = train[DRYRUN_POINTS[0]][1]
    state("h2o train params", child["params"], info_tr["params"])
    state("h2o AdamW state", child["opt_state"], info_tr["opt_state"])
    for pt in child["points"]:
        S, remat = pt["S"], pt["remat"]
        report = train[S, remat][0]
        check(pt["finite"], f"[dryrun] the train step at S={S} remat "
              f"{remat} gave a non-finite loss or params")
        step(f"h2o train step B=1 S={S} remat {remat} AdamW (own process)",
             pt["step"], report, pt["seconds"], torch.bfloat16)
        want = report.phases["start"]["peak"] - report.held_bytes
        got = pt["grad_step"]
        check(abs(got - want) <= max(DRYRUN_RTOL * want, DRYRUN_SLACK),
              f"[dryrun] S={S} remat {remat}: gradient bytes {got} on the "
              f"card, {want} predicted")
        log(f"[dryrun] S={S} remat {remat}: gradient bytes {got} on the "
            f"card / {want} predicted = {got / want:.6f}")
        out[f"gradient S={S} remat {remat}"] = got / want
        if "compare" in pt:
            cmp = pt["compare"]
            check(not cmp["bad"], f"[dryrun] S={S}: the remat gradient "
                  f"differs from the no-remat one (leaf, kind, spread, "
                  f"diff): {cmp['bad']}")
            log(f"[dryrun] S={S}: gradient with remat block against "
                f"{DRYRUN_COMPARE_RUNS} without, {cmp['leaves']} leaves: "
                f"{cmp['leaves'] - len(cmp['spread_leaves'])} bitwise equal"
                f" (each steady run to run without remat); leaves that "
                f"vary run to run (leaf, spread, remat diff): "
                f"{cmp['spread_leaves']}")
        if "remat_cost" in pt:
            t = pt["remat_cost"]
            log(f"[dryrun] S={S}: the AdamW step with remat block "
                f"{t['block']:.6f} s, without {t['none']:.6f} s (fastest "
                f"of two each, in turns) = {t['block'] / t['none']:.3f}x")

    c38 = c38_reading(torch, train[DRYRUN_POINTS[0]][0])
    log(f"[dryrun] C.38 reading (not a check): S={DRYRUN_POINTS[0][0]} "
        f"remat {DRYRUN_POINTS[0][1]} step in this process under the "
        f"memory history: {c38['step']} B, {c38['excess']} B above the "
        f"prediction; snapshot {c38['snapshot']}")
    out["phase_s"] = time.time() - t_phase
    log(f"[dryrun] phase {out['phase_s']:.1f} s")
    return out


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def main() -> int:
    import torch
    if sys.argv[1:] == [DRYRUN_CHILD]:        # drive_dryrun's child
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(dryrun_train_step(torch)), flush=True)
        return 0
    if sys.argv[1:2] == [SPMD_CHILD]:         # a [spmd] rank
        return spmd_child(sys.argv[2])
    if sys.argv[1:2] == [TP_CHILD]:           # a [spmd-tp] rank
        torch.backends.cuda.matmul.allow_tf32 = False
        out, arch, groups = sys.argv[2:]
        return spmd_tp_child(out, arch, int(groups))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    # float32 products in full float32 on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    # the image sets are drawn once, in this process, and mapped by every
    # worker process of the cluster phases' fleets, which would each draw
    # the whole set to keep their shard (repro_torch/data/synthetic.py)
    from repro_torch.data.synthetic import CACHE_ENV
    data_dir = tempfile.mkdtemp(prefix="chip-smoke-data-")
    os.environ[CACHE_ENV] = data_dir
    try:
        return _main(torch, t_start)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


def _main(torch, t_start: float) -> int:
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
    cluster_launches, rates, sync_params = drive_cluster_path(torch)
    for name, n in cluster_launches.items():
        launches[name] += n
    log(f"[phase] cluster path done at {time.time() - t_start:.1f} s")
    wire_launches, wire_rates = drive_wire_path(torch, P, rates,
                                                sync_params)
    for name, n in wire_launches.items():
        launches[name] += n
    log(f"[phase] cluster-wire path done at {time.time() - t_start:.1f} s")
    for name, err in grown_flush_check(torch, P).items():
        errs[name] = max(errs[name], err)
    for name, n in drive_host_path(torch, P, rates, wire_rates,
                                   sync_params).items():
        launches[name] += n
    log(f"[phase] cluster-host path done at {time.time() - t_start:.1f} s")
    for name, err in serve_plane_kernel_check(torch).items():
        errs[name] = max(errs.get(name, 0.0), err)
    for name, n in drive_serve_plane(torch).items():
        launches[name] += n
    log(f"[phase] cluster-serve path done at {time.time() - t_start:.1f} s")

    D = get_config(ARCH).d_model
    for name, err in compare_lm_kernels(torch, D).items():
        errs[name] = max(errs.get(name, 0.0), err)
    lm_times = time_lm_kernels(torch, D)
    # each kernel's line holds its time at the shape the path launches
    # most: rmsnorm at a decode step's rows, flash at the long prefill
    for name, case in (("rmsnorm", f"rmsnorm decode N={SERVE['batch']}"),
                       ("flash_attention",
                        f"flash long prefill S={LONG_S}")):
        times[name] = dict(lm_times[case], timed_at=case)
        t = times[name]
        log(f"[time] {name:15s} kernel alone {t['kernel_only_ms']:.6f} ms "
            f"cold (profiler) at {case} = "
            f"{100 * t['bound_ms'] / t['kernel_only_ms']:.1f}% of bound; "
            f"wrapper call {t['ms']:.6f} ms (CUDA events)")
    cross_check_serve_small(torch)
    serve_launches, serve_read = drive_serve_path(torch)
    for name, n in serve_launches.items():
        launches[name] += n
    log(f"[phase] serving path done at {time.time() - t_start:.1f} s")

    for name, err in compare_new_kernel_shapes(torch).items():
        errs[name] = max(errs[name], err)
    new_times = time_new_kernel_shapes(torch)
    log(f"[phase] new kernel shapes done at {time.time() - t_start:.1f} s")
    mla_launches, mla_read = drive_mla_moe_serve(torch)
    for name, n in mla_launches.items():
        launches[name] += n
    log(f"[phase] serve-mla-moe done at {time.time() - t_start:.1f} s")
    drive_dryrun(torch, serve_read, mla_read)
    log(f"[phase] dryrun done at {time.time() - t_start:.1f} s")
    tmp = tempfile.mkdtemp(prefix="chip-smoke-spmd-")
    full = {}
    try:
        # [spmd]'s full run starts once [zoo-sim]'s big run is over
        for phase, drive in (
                ("arch", lambda: drive_arch(torch)),
                ("zoo-sim", lambda: drive_zoo_sim(
                    torch, lambda: full.update(start_spmd(tmp)))),
                ("zoo-wire", lambda: drive_zoo_wire(torch))):
            for name, n in drive().items():
                launches[name] += n
            log(f"[phase] {phase} done at {time.time() - t_start:.1f} s")
        reset_counts()
        spmd_launches, tp_launches, merge_times = drive_spmd(torch, tmp,
                                                             full)
    finally:
        stop(full.get("proc"))
        shutil.rmtree(tmp, ignore_errors=True)
    launches["flush"] += sum(spmd_launches.values())
    for name, n in tp_launches.items():
        launches[name] += n
    log(f"[phase] spmd and spmd-tp done at {time.time() - t_start:.1f} s")
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
            "status": "ported", "max_err": errs[name], "kernel_ms": t["ms"],
            "also_timed": {
                case: {k: v for k, v in row.items()
                       if k in ("ms", "warm_ms", "kernel_only_ms",
                                "plain_ms", "library_ms", "bound_ms",
                                "bound_by")}
                for case, row in new_times.items()
                if case.startswith(name.split("_")[0])}})
    flush_row = next(k for k in kernels if k["name"] == "flush")
    flush_row["also_timed"].update(merge_times)
    log(smi)
    print(json.dumps({"kernels": kernels, "pending": []}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
