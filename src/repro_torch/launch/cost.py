"""Cost analysis of a step on the ``meta`` device: the counterpart of the
reference's ``launch/hlo_cost.py``.

:func:`analyze` runs ``fn`` on meta tensors (shapes and dtypes, no
memory, no arithmetic) under a dispatch mode that sees every aten op the
port issues, and counts per executed step:

* ``flops``: PyTorch's own formulas (``torch.utils.flop_counter``'s
  registry, the table ``FlopCounterMode`` reads: ``mm``, ``bmm``,
  ``addmm``, convolutions, ...), plus each kernel's closed-form
  ``cost`` reported by its wrapper's meta route;
* ``hbm_bytes``: at op granularity, the bytes of every tensor operand
  and result of every aten op that is not a view or an allocation.
  Eager PyTorch fuses nothing, so this is the port's traffic model, as
  fusion granularity is XLA's in the reference; a kernel counts its
  inputs read once and outputs written once;
* the peak of live bytes: every storage an op creates is live until
  Python drops its last reference (a ``weakref.finalize`` on the
  storage), each rounded up to the 512 bytes the CUDA caching allocator
  hands out, so the numbers compare with
  ``torch.cuda.max_memory_allocated``.  What the inputs hold when the
  analysis starts is ``held_bytes``.

Loops are counted as the reference's ``hlo_cost`` multiplies a while
body by its trip count (``core/counting.py``):

* ``trips(n)`` (the train step's micro-batches) runs its body once and
  counts it ``n`` times; the live bytes of one iteration are those of
  every iteration, so the peak is taken as traced;
* ``recurrence`` (mamba, mLSTM, sLSTM: a Python loop over positions or
  chunks, which would issue millions of ops at S 32768) is measured by
  running the mixer's own code alone at three trip counts, forward and, when
  a gradient is taken, backward, and extrapolated to the sequence's
  trips: FLOPs, bytes and the bytes it saves for the backward are
  polynomials of degree at most 2 in the trip count (the backward of a
  per-trip slice writes a whole-sequence gradient), and its transient
  peaks grow by the same amount each trip once the largest is reached.  In the
  traced step a stand-in (:class:`_Recurrence`) allocates its output,
  the saved bytes until its backward, and its transient peaks, and
  counts the extrapolated work.  Collective bytes come from the layout
  (``launch/dryrun.py``), counted from the collectives' calls; a
  tensor-parallel mixer's collectives (its input's and output's, and a
  collective inside each trip, such as mamba's ``proj`` all-reduce and
  its recompute under remat) are measured with it at the three trip
  counts, extrapolated alike, and added to the step's counting
  collectives (``comm.bytes``) when the stand-in runs forward and
  backward.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.convert import tree_leaves, tree_map
from repro_torch.core import counting

ALLOC_ROUND = 512           # the CUDA caching allocator's block unit
aten = torch.ops.aten
# ops that allocate or relabel without moving data
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.new_empty,
               aten.empty_strided, aten.new_empty_strided, aten.detach,
               aten.alias, aten.lift_fresh, aten.lift_fresh_copy}


# binary pointwise ops whose meta result this module makes itself when
# every tensor operand is laid out row-major: PyTorch computes a meta
# pointwise result in Python (torch._refs), about 0.1 ms an op, and they
# are most of a step's ops
_POINTWISE = {aten.add.Tensor, aten.sub.Tensor, aten.mul.Tensor,
              aten.div.Tensor, aten.maximum.default, aten.minimum.default}


def _row_major(t: torch.Tensor) -> bool:
    """Strides fall from dim to dim over the dims that are neither of
    size 1 nor broadcast (a contiguous tensor, or a slice or expansion
    of one): an eager pointwise result of such operands is contiguous."""
    last = None
    for n, st in zip(t.shape, t.stride()):
        if n == 1 or st == 0:
            continue
        if last is not None and st > last:
            return False
        last = st
    return True


def _pointwise_meta(func, args, kwargs):
    """The result of a binary pointwise op on row-major meta operands
    (broadcast shape, promoted dtype, contiguous), or None."""
    if func not in _POINTWISE or len(args) != 2 or \
            set(kwargs) - {"alpha"}:
        return None
    ts = [t for t in args if isinstance(t, torch.Tensor)]
    if not all(t.is_meta and _row_major(t) for t in ts):
        return None
    dtype = torch.result_type(*args)
    if func is aten.div.Tensor and not dtype.is_floating_point:
        return None
    shape = torch.broadcast_shapes(*(t.shape for t in ts))
    return torch.empty(shape, dtype=dtype, device="meta")


def alloc_bytes(nbytes: int) -> int:
    """What the CUDA caching allocator takes for a request of ``nbytes``."""
    return -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


@dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_op: Dict[str, float] = field(default_factory=dict)

    def __iadd__(self, o: "Cost"):
        self.flops += o.flops
        self.hbm_bytes += o.hbm_bytes
        self.collective_bytes += o.collective_bytes
        for k, v in o.collective_by_op.items():
            self.collective_by_op[k] = self.collective_by_op.get(k, 0) + v
        return self

    def scaled(self, n: float) -> "Cost":
        return Cost(self.flops * n, self.hbm_bytes * n,
                    self.collective_bytes * n,
                    {k: v * n for k, v in self.collective_by_op.items()})


@dataclass
class Report:
    """One analyzed call: its executed cost, what its inputs held when it
    began, the peak of live bytes (inputs included), each kernel's
    launches, FLOPs and bytes, the aten ops traced, and the peak of each
    phase the call named (``core/counting.phase``; the first is
    ``"start"``) with the live bytes it began at."""
    cost: Cost
    held_bytes: int
    peak_bytes: int
    kernels: Dict[str, Dict[str, float]]
    ops: int
    phases: Dict[str, Dict[str, int]] = field(default_factory=dict)

    @property
    def step_bytes(self) -> int:
        """The step's own bytes: the peak above what its inputs held."""
        return self.peak_bytes - self.held_bytes


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _tensors(o)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _traffic(t: torch.Tensor) -> int:
    """The bytes an op moves for a tensor operand or result: a broadcast
    (stride-0) dim is read once, not once per index."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n if t.numel() else 0


class Analysis(TorchDispatchMode):
    """The dispatch mode of one :func:`analyze` pass."""

    def __init__(self, models: Dict):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.ops = 0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, weakref.finalize] = {}
        self.models = models        # recurrence models, shared across passes
        self.missing: set = set()
        self.phases: Dict[str, Dict[str, int]] = {}
        self._phase = self.phase("start")

    # ------------------------------------------------------------ memory
    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        nb = alloc_bytes(st.nbytes())
        self.live += nb
        self.peak = max(self.peak, self.live)
        self._phase["peak"] = max(self._phase["peak"], self.live)
        self._storages[key] = weakref.finalize(st, self._free, key, nb)

    def _free(self, key: int, nb: int) -> None:
        self.live -= nb
        self._storages.pop(key, None)

    def hold(self, *trees) -> int:
        for t in _tensors(list(trees)):
            self.track(t)
        return self.live

    def phase(self, name: str) -> Dict[str, int]:
        self._phase = self.phases[name] = {"begin": self.live,
                                           "peak": self.live}
        return self._phase

    def close(self) -> None:
        for f in list(self._storages.values()):
            f.detach()
        self._storages.clear()

    # ------------------------------------------------------------ counts
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = _pointwise_meta(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        outs = _tensors(out)
        if not (func.is_view or packet in _NO_TRAFFIC):
            self.hbm_bytes += sum(map(_traffic, _tensors(args)
                                      + _tensors(kwargs) + outs))
        for t in outs:
            self.track(t)
        return out

    def kernel(self, name: str, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.hbm_bytes += nbytes
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0,
                                           "bytes": 0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def _snapshot(self):
        return (self.flops, self.hbm_bytes, self.ops,
                {k: dict(v) for k, v in self.kernels.items()})

    def _add_scaled_since(self, snap, extra: float) -> None:
        """Count what ran since ``snap`` ``extra`` more times."""
        flops, nbytes, ops, kernels = snap
        self.flops += extra * (self.flops - flops)
        self.hbm_bytes += extra * (self.hbm_bytes - nbytes)
        self.ops += int(extra * (self.ops - ops))
        for name, k in self.kernels.items():
            before = kernels.get(name, {"launches": 0, "flops": 0,
                                        "bytes": 0})
            for f in k:
                k[f] += extra * (k[f] - before[f])

    # ------------------------------------------------------------- loops
    def trips(self, n: int):
        snap = self._snapshot()
        if n > 0:
            yield 0
        self._add_scaled_since(snap, n - 1)

    def recurrence(self, fn, params, x, cfg, unit: int, tp=None):
        S = x.shape[1]
        if S % unit or S // unit <= _TRIPS[-1]:
            return fn(params, x, cfg, tp)
        leaves = tree_leaves(params)
        grad = torch.is_grad_enabled() and (
            x.requires_grad or any(t.requires_grad for t in leaves))
        spec = _RecurrenceSpec(
            fn, tuple(x.shape[:1]) + (unit,) + tuple(x.shape[2:]), x.dtype,
            tree_map(lambda t: _Leaf(tuple(t.shape), t.dtype), params),
            cfg, grad, 1 if tp is None else tp.M, tp)
        model = self.models.get(spec)
        if model is None:
            # measured between passes, outside any transform
            self.missing.add(spec)
            model = _RecurrenceModel.zero(len(leaves))
        comm = None if tp is None else getattr(tp.comm, "bytes", None)
        return _Recurrence.apply(x, model.at(S // unit), model.has_grad,
                                 self, comm, *leaves)[0]


@dataclass(frozen=True)
class _Leaf:
    shape: Tuple[int, ...]
    dtype: torch.dtype

    def meta(self, requires_grad: bool) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device="meta",
                           requires_grad=requires_grad)


@dataclass(frozen=True)
class _RecurrenceSpec:
    fn: Any
    x_unit_shape: Tuple[int, ...]     # (B, unit, D)
    dtype: torch.dtype
    params: Any                       # a tree of _Leaf
    cfg: Any
    grad: bool
    model: int = 1                    # the tensor-parallel M
    # the tensor-parallel context the mixer is measured with (its
    # collectives counted in ``tp.comm.bytes``); the measured counts
    # serve any context of the same M
    tp: Any = field(default=None, compare=False)

    def __hash__(self):
        return hash((self.fn, self.x_unit_shape, self.dtype, self.cfg,
                     self.grad, self.model,
                     tuple(tree_leaves(self.params))))


# counts that add up over trips: a polynomial of degree <= 2 in the trip
# count (the backward of a slice taken once a trip writes a gradient of
# the whole sequence, so its bytes grow with trips x sequence)
_SUMS = ("fwd_flops", "fwd_bytes", "saved", "bwd_flops", "bwd_bytes",
         "ops")
# transient peaks above the live bytes around them: affine once the
# largest of them is the one that grows fastest, taken from the last two
_PEAKS = ("fwd_extra", "bwd_extra")
# the trip counts a mixer is measured at: from 2, where every per-trip
# slice is a proper part of the sequence (at one trip a slice, or a
# concatenation of one piece, is special)
_TRIPS = (2, 3, 4)


@dataclass
class _RecurrenceModel:
    """One mixer's counts at the ``_TRIPS`` trip counts; :meth:`at`
    extrapolates."""
    counts: Tuple[Dict[str, float], ...]
    has_grad: Tuple[bool, ...]        # which param leaves get a gradient

    @classmethod
    def zero(cls, n_leaves: int):
        return cls((dict.fromkeys(_SUMS + _PEAKS, 0),) * 3,
                   (True,) * n_leaves)

    def at(self, n: int) -> Dict[str, float]:
        v2, v3, v4 = self.counts
        m = n - _TRIPS[0]
        # the sums, and the collective bytes by direction and kind
        # ("fwd <kind>", "bwd <kind>")
        out = {f: v2[f] + m * (v3[f] - v2[f])
               + m * (m - 1) // 2 * (v4[f] - 2 * v3[f] + v2[f])
               for f in v2 if f not in _PEAKS}
        out.update({f: max(0, v4[f] + (n - _TRIPS[2]) * (v4[f] - v3[f]))
                    for f in _PEAKS})
        return out


def _measure(spec: _RecurrenceSpec) -> _RecurrenceModel:
    """The mixer's own code at three trip counts, alone, on meta
    tensors."""
    out = []
    B, unit, D = spec.x_unit_shape
    for n in _TRIPS:
        a = Analysis({})
        params = tree_map(lambda leaf: leaf.meta(spec.grad), spec.params)
        x = torch.empty((B, n * unit, D), dtype=spec.dtype, device="meta",
                        requires_grad=spec.grad)
        leaves = tree_leaves(params)
        L0 = a.hold(params, x)
        a.peak = L0
        coll = _CollectiveMarks(spec.tp)
        with a, torch.set_grad_enabled(spec.grad):
            y = spec.fn(params, x, spec.cfg, spec.tp)
            L1, Pf = a.live, a.peak
            coll.mark("fwd")
            v = {"fwd_flops": a.flops, "fwd_bytes": a.hbm_bytes,
                 "saved": L1 - L0 - alloc_bytes(_nbytes(y)),
                 "fwd_extra": Pf - L1, "bwd_flops": 0, "bwd_bytes": 0,
                 "bwd_extra": 0}
            has_grad = (True,) * len(leaves)
            if spec.grad:
                gy = torch.empty_like(y)
                B0 = a.peak = a.live
                f0, b0 = a.flops, a.hbm_bytes
                grads = torch.autograd.grad(y, [x] + leaves, gy,
                                            allow_unused=True)
                G = sum(alloc_bytes(_nbytes(g)) for g in grads
                        if g is not None)
                v.update(bwd_flops=a.flops - f0, bwd_bytes=a.hbm_bytes - b0,
                         bwd_extra=a.peak - B0 - G)
                has_grad = tuple(g is not None for g in grads[1:])
                del grads, gy
                coll.mark("bwd")
            v["ops"] = a.ops
            v.update(coll.counts)
        del y
        a.close()
        out.append(v)
    return _RecurrenceModel(tuple(out), has_grad)


class _CollectiveMarks:
    """The collective bytes a measured mixer's tensor-parallel context
    counts (``tp.comm.bytes``, by kind), split at each :meth:`mark` into
    ``"<label> <kind>"`` entries of :attr:`counts`."""

    def __init__(self, tp):
        self.bytes = None if tp is None else getattr(tp.comm, "bytes", None)
        self.last = dict(self.bytes or {})
        self.counts: Dict[str, float] = {}

    def mark(self, label: str) -> None:
        if self.bytes is None:
            return
        for kind, n in self.bytes.items():
            self.counts[f"{label} {kind}"] = n - self.last.get(kind, 0.0)
        self.last = dict(self.bytes)


def _count_collectives(comm, model, label: str) -> None:
    """Add the extrapolated ``"<label> <kind>"`` bytes of ``model`` to
    the step's counting collectives ``comm`` (a dict by kind)."""
    if comm is None:
        return
    for key, n in model.items():
        if key.startswith(label + " "):
            kind = key[len(label) + 1:]
            comm[kind] = comm.get(kind, 0.0) + n


class _Recurrence(torch.autograd.Function):
    """A recurrent mixer's stand-in in a traced step: its output, the
    bytes it saves for the backward (held until then), its transient
    peaks, and its extrapolated work; gradients of x and of the used
    param leaves in the backward."""

    @staticmethod
    def forward(x, model, has_grad, analysis, comm, *leaves):
        _count_collectives(comm, model, "fwd")
        analysis.flops += model["fwd_flops"]
        analysis.hbm_bytes += model["fwd_bytes"]
        analysis.ops += int(model["ops"])
        y = x.new_empty(x.shape)
        saved = x.new_empty((int(model["saved"]),), dtype=torch.uint8)
        extra = int(model["fwd_extra"])
        if extra > 0:       # a transient: freed as soon as it is made
            x.new_empty((extra,), dtype=torch.uint8)
        return y, saved

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, model, has_grad, analysis, comm, *leaves = inputs
        ctx.model, ctx.has_grad, ctx.analysis = model, has_grad, analysis
        ctx.comm = comm
        ctx.shapes = [(t.shape, t.dtype) for t in [x] + leaves]
        ctx.save_for_backward(output[1])
        ctx.mark_non_differentiable(output[1])
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, gy, _):
        model, analysis = ctx.model, ctx.analysis
        _count_collectives(ctx.comm, model, "bwd")
        analysis.flops += model["bwd_flops"]
        analysis.hbm_bytes += model["bwd_bytes"]
        dev = torch.device("meta")
        used = (True,) + ctx.has_grad
        grads = [torch.empty(s, dtype=d, device=dev) if u else None
                 for (s, d), u in zip(ctx.shapes, used)]
        extra = int(model["bwd_extra"])
        if extra > 0:
            torch.empty((extra,), dtype=torch.uint8, device=dev)
        return (grads[0], None, None, None, None, *grads[1:])


_MODELS: Dict[_RecurrenceSpec, _RecurrenceModel] = {}


def analyze(fn, *args, **kwargs) -> Tuple[Any, Report]:
    """Run ``fn(*args, **kwargs)`` on meta tensors and count its cost.
    Returns ``(fn's result, Report)``.  A recurrence met for the first
    time is measured after the pass, and the pass runs again."""
    while True:
        a = Analysis(_MODELS)
        held = a.hold(args, kwargs)
        a.peak = held
        a.phase("start")
        prev, counting.ACTIVE = counting.ACTIVE, a
        try:
            with a:
                out = fn(*args, **kwargs)
        finally:
            counting.ACTIVE = prev
        report = Report(Cost(a.flops, a.hbm_bytes), held, a.peak,
                        a.kernels, a.ops, a.phases)
        a.close()
        if not a.missing:
            return out, report
        del out
        for spec in a.missing:
            _MODELS[spec] = _measure(spec)


def tree_bytes(tree) -> int:
    """Bytes of a tree's tensors, each rounded as the allocator would."""
    return sum(alloc_bytes(_nbytes(t)) for t in _tensors(tree))

