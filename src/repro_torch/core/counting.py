"""What a cost analysis on the ``meta`` device sees of the port's kernel
launches and Python loops.

``launch/cost.py::analyze`` sets :data:`ACTIVE` while it traces a step
on meta tensors.  Without it every hook is a pass-through: ``trips(n)``
is ``range(n)`` and ``recurrence`` calls the mixer.  The hooks never
look at a CUDA or CPU tensor's values, and the kernels' CUDA path calls
none of them.

- :func:`kernel`: a kernel wrapper's meta route reports the work its
  kernel would do (the kernel module's closed-form ``cost``).
- :func:`trips`: a loop of ``n`` identical, independent iterations (the
  train step's micro-batches) is traced once and its cost counted ``n``
  times, as the reference's ``hlo_cost`` multiplies a while body by its
  trip count.
- :func:`recurrence`: a recurrent mixer (mamba, mLSTM, sLSTM) runs a
  Python loop over positions or chunks; the analysis counts it from
  three trip counts of its own code and multiplies (``launch/cost.py``),
  its tensor-parallel collectives (a chunk's all-reduce among them) too;
- :func:`phase`: a step names the phase it enters (the train step's
  optimizer update), and the analysis keeps each phase's peak.
"""
from __future__ import annotations

ACTIVE = None       # the running launch.cost analysis, if any


def kernel(name: str, flops: int, nbytes: int) -> None:
    if ACTIVE is not None:
        ACTIVE.kernel(name, flops, nbytes)


def phase(name: str) -> None:
    if ACTIVE is not None:
        ACTIVE.phase(name)


def trips(n: int):
    return range(n) if ACTIVE is None else ACTIVE.trips(n)


def recurrence(fn, params, x, cfg, unit: int, tp=None):
    """``fn(params, x, cfg)``, or ``fn(params, x, cfg, tp)`` under a
    tensor-parallel context ``tp``: a recurrent mixer's full-sequence
    forward, whose loop takes one trip every ``unit`` positions of x
    (B, S, D)."""
    if ACTIVE is None or not x.is_meta:
        return fn(params, x, cfg) if tp is None else fn(params, x, cfg, tp)
    return ACTIVE.recurrence(fn, params, x, cfg, unit, tp)
