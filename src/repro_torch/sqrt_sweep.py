"""Sweep every non-negative float32 through two square roots and compare
them bit for bit: ``torch.sqrt`` of the float32 tensor, and the root
taken in float64 and rounded once (the correctly rounded float32 root,
what ``kernels/ref.py::sqrt_rn`` takes on the CPU).

The bit patterns ``0x00000000``-``0x7f800000`` (zero, the subnormals,
the normals, +inf) and one quiet NaN are made on the device in chunks
and compared there.  On a CUDA device the result decides whether
``sqrt_rn`` may take the float32 root on CUDA tensors (ROADMAP C.43).

  python -m repro_torch.sqrt_sweep            # on the card, ~1 s

It prints one JSON line: the values compared, the mismatches, the first
mismatch's bits and both roots' bits, and the seconds it took.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Optional

import torch

LAST = 0x7f800000           # +inf: every non-negative float32 below it
QUIET_NAN = 0x7fc00000
CHUNK = 1 << 27


def float64_root(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).float()


def sweep(device, stop: int = LAST + 1, chunk: int = CHUNK,
          candidate: Callable = torch.sqrt,
          reference: Callable = float64_root) -> dict:
    """Compare ``candidate`` with ``reference`` on the float32 bit
    patterns ``[0, stop)`` and on a quiet NaN.  Two NaNs agree whatever
    their payloads."""
    t0 = time.time()
    n = mismatches = 0
    first: Optional[dict] = None

    def compare(bits: torch.Tensor):
        nonlocal n, mismatches, first
        x = bits.view(torch.float32)
        a, b = candidate(x), reference(x)
        ai, bi = a.view(torch.int32), b.view(torch.int32)
        bad = (ai != bi) & ~(torch.isnan(a) & torch.isnan(b))
        k = int(bad.sum())
        n += bits.numel()
        if k and first is None:
            i = int(torch.nonzero(bad)[0, 0])
            first = {"x_bits": f"{int(bits[i]) & 0xffffffff:#010x}",
                     "candidate_bits": f"{int(ai[i]) & 0xffffffff:#010x}",
                     "reference_bits": f"{int(bi[i]) & 0xffffffff:#010x}"}
        mismatches += k

    for lo in range(0, stop, chunk):
        hi = min(stop, lo + chunk)
        compare(torch.arange(lo, hi, dtype=torch.int64,
                             device=device).to(torch.int32))
    compare(torch.tensor([QUIET_NAN], dtype=torch.int32, device=device))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return {"device": str(device), "compared": n, "mismatches": mismatches,
            "first_mismatch": first, "seconds": time.time() - t0,
            "range": f"0x00000000-{stop - 1:#010x} and a quiet NaN"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.sqrt_sweep")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 1
    res = sweep(torch.device(args.device))
    if torch.device(args.device).type == "cuda":
        res["device_name"] = torch.cuda.get_device_name(args.device)
    print(json.dumps(res), flush=True)
    return 0 if res["mismatches"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
