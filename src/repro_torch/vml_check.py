"""How often a process's first thread-split CPU cos comes back inexact
(ROADMAP C.8).

    python -m repro_torch.vml_check [--procs 360] [--jobs 5] [--threads 2]
        [--way cos32 cos64 polar]

For each ``--way`` it starts ``--procs`` fresh Python processes,
``--jobs`` at a time.  Each sets ``--threads`` intra-op threads and
takes, as its first such call, the cosine and sine of rope's 4096
float32 angles (S 512, head dim 16; more than one of VML's 2048-element
chunks) one way:

- ``cos32``: ``torch.cos``/``torch.sin`` of the float32 angles;
- ``cos64``: the same of the angles in float64, rounded once;
- ``polar``: ``torch.polar`` in float64, rounded once (what
  ``models/rope.py`` does).

A process is inexact when any value differs from the correctly rounded
float32 one (numpy's float64 cos/sin, rounded once).  Prints one line
per way: processes run, processes inexact, and the most values one
process got wrong.  CPU only; it uses no card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

WAYS = ("cos32", "cos64", "polar")

_CHILD = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(int(sys.argv[2]))
way = sys.argv[1]
inv = 1.0 / (10000.0 ** (torch.arange(0, 8, dtype=torch.float32) / 8))
ang = torch.arange(512, dtype=torch.float32)[:, None] * inv
if way == "cos32":
    c, s = torch.cos(ang), torch.sin(ang)
elif way == "cos64":
    c, s = torch.cos(ang.double()).float(), torch.sin(ang.double()).float()
else:
    z = torch.polar(torch.ones_like(ang, dtype=torch.float64), ang.double())
    c, s = z.real.float(), z.imag.float()
a = ang.numpy().astype(np.float64)
bad = int((c.numpy() != np.cos(a).astype(np.float32)).sum()
          + (s.numpy() != np.sin(a).astype(np.float32)).sum())
print(bad)
"""


def _one(way: str, threads: int) -> int:
    out = subprocess.run([sys.executable, "-c", _CHILD, way, str(threads)],
                         check=True, capture_output=True, text=True)
    return int(out.stdout.split()[-1])


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.vml_check",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=360)
    ap.add_argument("--jobs", type=int, default=5)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--way", nargs="+", choices=WAYS, default=list(WAYS))
    args = ap.parse_args(argv)
    with ThreadPoolExecutor(args.jobs) as pool:
        for way in args.way:
            bad = list(pool.map(lambda _: _one(way, args.threads),
                                range(args.procs)))
            print(f"{way}: {args.procs} processes, "
                  f"{sum(b > 0 for b in bad)} inexact, "
                  f"most values wrong in one process {max(bad)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
