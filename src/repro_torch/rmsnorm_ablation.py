"""Which parts of the rmsnorm kernel's design buy its time, on the card.

    python -m repro_torch.rmsnorm_ablation [--rows 4 128 8192] [--reps 50]

Builds ``csrc/rmsnorm.cu`` as it is and five variants of it, each
undoing one design choice by an edit of the source text:

- ``read_twice``: every row streamed, x read again for the scaling pass
  (the rows keep their warps);
- ``serial_loads``: each load summed before the next is issued;
- ``scalar_scale``: ``scale`` read as single floats instead of float4;
- ``warp_per_row``: one warp a row even when the launch has few warps;
- ``block_barrier``: 8 warps a row at every N, their sums met in shared
  memory after a ``__syncthreads``.

Each is timed cold (a 256 MB read before every launch evicts the L2) on
bf16 rows of h2o-danube-1.8b's width (2560) at each ``--rows``, in two
interleaved rounds, beside ``F.rms_norm``; the median of ``--reps``
launches timed with CUDA events.  Prints one line per row count and the
card's name and power limit.  Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

D = 2560
_HOISTED = """#pragma unroll
      for (int i = 0; i < VPL; ++i)
        if (first + i * stride < nv) held[i] = xr[first + i * stride];
#pragma unroll
      for (int i = 0; i < VPL; ++i)
        if (first + i * stride < nv) ss = sum_squares<T, W>(held[i], ss);"""
_SERIAL = """#pragma unroll
      for (int i = 0; i < VPL; ++i)
        if (first + i * stride < nv) {
          held[i] = xr[first + i * stride];
          ss = sum_squares<T, W>(held[i], ss);
        }"""
_SPREAD = "constexpr long long kSpreadWarps = 2048;"
_SWITCH = "  switch (per_lane <= 2 ? per_lane"
EDITS = {
    "final": [],
    "read_twice": [(_SWITCH, "  if (N > 0) return start<T, W, 0>(x, scale, "
                             "y, N, D, eps, wpr, stream);\n" + _SWITCH)],
    "serial_loads": [(_HOISTED, _SERIAL)],
    "scalar_scale": [("    to_f32(*reinterpret_cast<const float4*>(s), out);",
                      "    for (int e = 0; e < 4; ++e) out[e] = s[e];")],
    "warp_per_row": [(_SPREAD, "constexpr long long kSpreadWarps = 0;")],
    "block_barrier": [(_SPREAD, "constexpr long long kSpreadWarps = 1LL << 40;")],
}


def build_variants() -> Dict[str, ctypes.CDLL]:
    src = (_build.CSRC / "rmsnorm.cu").read_text()
    out = _build.BUILD_DIR / "rmsnorm_ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: csrc/rmsnorm.cu no longer "
                                   f"holds the text it edits")
            text = text.replace(old, new)
        cu, so = out / f"{name}.cu", out / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.rmsnorm_bf16.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        libs[name] = lib
    return libs


def cold_ms(fn, scrub: torch.Tensor, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(1e8))      # the card waits while the host enqueues
    for start, end in ev:
        scrub.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.rmsnorm_ablation",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[4, 128, 8192])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rmsnorm_ablation needs a CUDA device", file=sys.stderr)
        return 1
    libs = build_variants()
    scrub = torch.ones(64 << 20, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = 1 + 0.1 * torch.randn(D, device="cuda", generator=gen)
    for n in args.rows:
        x = torch.randn(n, D, device="cuda", generator=gen).bfloat16()
        y = torch.empty_like(x)
        want = F.rms_norm(x.float(), (D,), scale, 1e-5)
        times: Dict[str, List[float]] = {}
        for _ in range(2):
            for name, lib in libs.items():
                def run(lib=lib):
                    err = lib.rmsnorm_bf16(x.data_ptr(), scale.data_ptr(),
                                           y.data_ptr(), n, D, 1e-5, stream)
                    if err:
                        raise RuntimeError(f"{name}: launch failed ({err})")
                times.setdefault(name, []).append(
                    cold_ms(run, scrub, args.reps))
                if not torch.allclose(y.float(), want, rtol=3e-2, atol=3e-2):
                    raise AssertionError(f"variant {name} is wrong at N={n}")
            times.setdefault("F.rms_norm", []).append(cold_ms(
                lambda: F.rms_norm(x, (D,), scale.bfloat16(), 1e-5), scrub,
                args.reps))
        print(f"N={n} D={D} bf16, ms cold (two rounds): " + "  ".join(
            f"{k} {a:.4f}/{b:.4f}" for k, (a, b) in times.items()),
            flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
