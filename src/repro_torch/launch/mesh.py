"""The rank layout of the SPMD backend: the counterpart of the mesh.

The reference lays a TPU mesh out as ``(rep, data, model)``
(``src/repro/launch/train.py:54-60 build_hybrid_mesh``), ``model``
varying fastest.  Here one rank of a ``torch.distributed`` job is one
device of that mesh: with W ranks, ``mesh_model`` M and R replica
groups of g data positions each (R g M = W), rank ``r*g*M + d*M + k``
is position (rep r, data d, model k):

  * replica group r holds ranks ``[r*g*M, (r+1)*g*M)``
    (:func:`replica_groups`), the order of the reference's reshape;
  * the data column of a rank is the g ranks of its replica group with
    its model index k (:func:`data_column`): the FSDP axis;
  * the model group of a rank is the M consecutive ranks of its data
    position (:func:`model_group`): the tensor-parallel axis;
  * a rank computes on ``cuda:{LOCAL_RANK % device_count}``, or on the
    CPU when the caller asks (:func:`rank_device`);
  * the collective backend follows from that layout
    (:func:`collective_backend`): gloo when ranks share a card or run on
    the CPU (NCCL refuses two ranks on one device), NCCL only when every
    rank has a card of its own.  Nothing tries one and falls back on the
    other.

:class:`Collectives` is every collective the train driver uses.  The
reference's v5e constants and production meshes have no counterpart:
device memory is read from the card (``min_group_size``).
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
import warnings
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.convert import Device, resolve_device

log = logging.getLogger("repro_torch.launch.mesh")

# elements per staged piece of a collective (128 MB of float32): the
# pinned host buffer a rank keeps, and well below gloo's 2 GiB messages
STAGE_ELEMS = 1 << 25

# timed NCCL calls whose CUDA events a rank holds before it reads the
# older half of them
EVENTS_HELD = 4096


def world() -> Tuple[int, int]:
    """``(rank, world_size)``: ``(0, 1)`` when no process group is
    initialised, as on a one-device host."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def replica_groups(world_size: int, R: int) -> List[List[int]]:
    """The ranks of each of R replica groups: group r is
    ``[r*n, (r+1)*n)`` with n = world_size / R (g data positions times
    the model width)."""
    if R < 1 or world_size % R:
        raise ValueError(f"{R} replica groups do not split "
                         f"{world_size} ranks")
    n = world_size // R
    return [list(range(r * n, (r + 1) * n)) for r in range(R)]


def data_column(rank: int, g: int, model: int = 1) -> List[int]:
    """The ranks of ``rank``'s replica group (g data positions of
    ``model`` ranks) that share its model index: the same (r, k), over
    d."""
    base = rank - rank % (g * model)
    return [base + d * model + rank % model for d in range(g)]


def model_group(rank: int, model: int) -> List[int]:
    """The ``model`` ranks of ``rank``'s data position: the same (r, d),
    over k."""
    base = rank - rank % model
    return list(range(base, base + model))


def rank_device(device: Device = None,
                local_rank: Optional[int] = None) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` unless
    the caller names a card or asks for the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def local_world_size() -> int:
    """Ranks on this host, as ``torchrun`` describes them."""
    return int(os.environ.get("LOCAL_WORLD_SIZE",
                              os.environ.get("WORLD_SIZE", "1")))


def collective_backend(device: torch.device, local_ranks: int,
                       device_count: int) -> str:
    """``"nccl"`` when every rank on this host has a card of its own,
    else ``"gloo"`` (the CPU, or ranks sharing a card)."""
    if device.type == "cuda" and local_ranks <= device_count:
        return "nccl"
    return "gloo"


def describe_layout(device: torch.device, backend: str) -> str:
    rank, W = world()
    where = str(device)
    if device.type == "cuda":
        n = torch.cuda.device_count()
        where = (f"{device} ({local_world_size()} ranks on this host share "
                 f"{n} card{'s' if n > 1 else ''})")
    return f"world {W}, backend {backend}, rank 0 on {where}" \
        if rank == 0 else f"rank {rank} on {where}"


@contextlib.contextmanager
def distributed(device: torch.device) -> Iterator[Optional[str]]:
    """Join the job ``torchrun`` describes in the environment
    (``WORLD_SIZE`` > 1) for the ``with`` block, and leave it after.
    Yields the collective backend, or None for a single process.  A
    process group that is already initialised is used as it is."""
    if dist.is_initialized():
        yield dist.get_backend()
        return
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        yield None
        return
    count = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = collective_backend(device, local_world_size(), count)
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend, init_method="env://", **kw)
    log.info("%s", describe_layout(device, backend))
    try:
        yield backend
    finally:
        dist.destroy_process_group()


class Collectives:
    """The collectives of one rank, each on one flat tensor.

    gloo aborts a rank that sends or receives a CUDA tensor (ROADMAP
    C.31), so with gloo every collective on a CUDA tensor is staged
    through host memory: an all-reduce, in place, through a pinned host
    buffer in pieces of :data:`STAGE_ELEMS` (:meth:`_staged`); a gather,
    a scatter or an all-to-all, whose output is another tensor, through
    host copies made for the call (:meth:`_staged_pair`).  Compute never
    leaves the card; only the bytes that cross ranks pass through the
    host.  NCCL
    takes the CUDA tensors as they are.  With one rank every collective
    is the identity.

    With ``model`` M > 1 a rank sits on two axes: the FSDP collectives
    (``all_reduce_sum_``, ``all_gather_``, ``reduce_scatter_``) run over
    its data column within the replica group, the tensor-parallel ones
    (``model_all_reduce_``, ``model_all_gather_``,
    ``model_reduce_scatter_``) over its model group, the serving's
    ``replica_all_reduce_`` and ``replica_all_gather_`` over its replica
    group of g data positions (a batch the data axis does not divide,
    ``parallel/tensor.py::Spread``),
    and the merges' ``all_to_all_`` over its model column: the W/M ranks
    with its model index, where ``position`` is its place and
    ``positions`` their count.  Every rank creates the model groups, then
    the columns, in the same order, and the data columns and the replica
    group of a group size the first time it is asked for.  Under NCCL a
    model group stays on one host.

    ``seconds`` adds up the time spent in the collectives, waits
    for the other ranks included, and ``seconds_by`` splits it by the
    label of :meth:`timing` around each call.  Under gloo it is the
    host's clock around the call.  NCCL's collectives return before
    their work is done, so under NCCL each call is timed by two CUDA
    events recorded on the card's current stream, before the call and
    after it (the stream waits for the collective there): the seconds
    are the collective's own on the device, the compute queued before it
    not counted, and nothing synchronizes the card.  The events are read
    when ``seconds`` or ``seconds_by`` is, or once
    :data:`EVENTS_HELD` are waiting."""

    def __init__(self, device: torch.device, model: int = 1):
        self.device = device
        self.rank, self.world = world()
        self.backend = dist.get_backend() if self.world > 1 else None
        self.model = int(model)
        if self.model < 1 or self.world % self.model:
            raise ValueError(f"mesh_model={self.model} must divide the "
                             f"world size ({self.world})")
        if self.backend == "nccl" and local_world_size() % self.model:
            raise ValueError(f"mesh_model={self.model}: a model group must "
                             f"stay on one host ({local_world_size()} "
                             "ranks here)")
        self.k = self.rank % self.model
        self.position = self.rank // self.model
        self.positions = self.world // self.model
        self._seconds = 0.0
        self._by: Dict[str, float] = {}
        self._events: List[Tuple[str, object, object]] = []
        self._kind = "other"
        self._handles: Dict[Tuple[int, ...], object] = {}
        self._groups: Dict[int, object] = {}
        self._replicas: Dict[int, object] = {}
        self._pinned: Dict[torch.dtype, torch.Tensor] = {}
        M, W = self.model, self.world
        self._model = self._create(
            [model_group(p * M, M) for p in range(W // M)])
        self._column = self._create(
            [data_column(k, W // M, M) for k in range(M)])

    def _create(self, groups: Sequence[Sequence[int]]):
        """Create each group in order (every rank creates every one) and
        return the handle of the one holding this rank: None for the
        whole world or for a group of one."""
        mine = None
        for ranks in groups:
            ranks = tuple(ranks)
            if len(ranks) in (1, self.world):
                handle = None
            elif ranks in self._handles:
                handle = self._handles[ranks]
            else:
                handle = self._handles[ranks] = dist.new_group(list(ranks))
            if self.rank in ranks:
                mine = handle
        return mine

    def group(self, g: int):
        """This rank's data column within its replica group of ``g``
        data positions (None for the whole world)."""
        if g not in self._groups:
            M = self.model
            self._groups[g] = self._create(
                [data_column(base + k, g, M)
                 for base in range(0, self.world, g * M) for k in range(M)])
        return self._groups[g]

    def replica(self, g: int):
        """This rank's replica group of ``g`` data positions x M model
        ranks (None for the whole world), created the first time it is
        asked for, as :meth:`group` creates the columns."""
        if g not in self._replicas:
            self._replicas[g] = self._create(replica_groups(
                self.world, self.world // (g * self.model)))
        return self._replicas[g]

    @contextlib.contextmanager
    def timing(self, kind: str) -> Iterator[None]:
        """Count the collectives inside the block under ``kind``."""
        outer, self._kind = self._kind, kind
        try:
            yield
        finally:
            self._kind = outer

    @property
    def seconds(self) -> float:
        self._settle(len(self._events))
        return self._seconds

    @property
    def seconds_by(self) -> Dict[str, float]:
        self._settle(len(self._events))
        return dict(self._by)

    def _add(self, kind: str, dt: float) -> None:
        self._seconds += dt
        self._by[kind] = self._by.get(kind, 0.0) + dt

    def _settle(self, n: int) -> None:
        """Add the first ``n`` timed NCCL calls' event times (waits for
        their end events)."""
        for kind, start, end in self._events[:n]:
            end.synchronize()
            self._add(kind, start.elapsed_time(end) / 1e3)
        del self._events[:n]

    @contextlib.contextmanager
    def _clock(self, t: torch.Tensor) -> Iterator[None]:
        """Add the block's seconds to ``seconds`` and to the current
        kind: the host's clock, or under NCCL the device's, from CUDA
        events on ``t``'s card's current stream."""
        if self.backend == "nccl" and t.device.type == "cuda":
            stream = torch.cuda.current_stream(t.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            yield
            end.record(stream)
            self._events.append((self._kind, start, end))
            if len(self._events) >= EVENTS_HELD:
                self._settle(EVENTS_HELD // 2)
            return
        t0 = time.perf_counter()
        yield
        self._add(self._kind, time.perf_counter() - t0)

    def _staged(self, t: torch.Tensor, op) -> None:
        """``op(piece)`` on every piece of flat ``t``, in place.  With
        gloo and a CUDA tensor each piece goes through the pinned host
        buffer, copied in and back."""
        with self._clock(t):
            self._pieces(t, op)

    def _staged_pair(self, out: torch.Tensor, inp: torch.Tensor,
                     op) -> None:
        """``op(out, inp)`` for a collective that reads ``inp`` and
        writes ``out`` (flat, of other sizes).  With gloo and CUDA
        tensors both go through host copies made for the call."""
        with self._clock(out):
            if self.backend != "gloo" or out.device.type != "cuda":
                op(out, inp)
                return
            host_out = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
            op(host_out, inp.cpu())
            out.copy_(host_out)

    def _pieces(self, t: torch.Tensor, op) -> None:
        if self.backend != "gloo" or t.device.type != "cuda":
            op(t)
            return
        buf = self._pinned.get(t.dtype)
        if buf is None:
            buf = self._pinned[t.dtype] = torch.empty(
                (STAGE_ELEMS,), dtype=t.dtype, pin_memory=True)
        flat = t.view(-1)
        for lo in range(0, flat.numel(), STAGE_ELEMS):
            piece = flat[lo:lo + STAGE_ELEMS]
            host = buf[:piece.numel()]
            host.copy_(piece)
            op(host)
            piece.copy_(host)

    def all_reduce_sum_(self, t: torch.Tensor, g: int) -> None:
        """Sum ``t`` in place over this rank's data column of g."""
        if g == 1:
            return
        grp = self.group(g)
        self._staged(t, lambda x: dist.all_reduce(x, group=grp))

    def all_gather_(self, out: torch.Tensor, t: torch.Tensor,
                    g: int) -> None:
        """``out`` (flat, g times ``t``'s size) <- the flat ``t`` of each
        rank of this rank's data column of g, in rank order."""
        if g == 1:
            out.copy_(t)
            return
        self._gather(out, t, self.group(g))

    def reduce_scatter_(self, out: torch.Tensor, t: torch.Tensor,
                        g: int) -> None:
        """``out`` <- this rank's 1/g of flat ``t`` summed over its
        data column of g (the column's d-th rank takes the d-th
        slice)."""
        if g == 1:
            out.copy_(t)
            return
        grp = self.group(g)
        self._staged_pair(out, t, lambda o, i: _quiet(
            dist.reduce_scatter_tensor, o, i, group=grp))

    def model_all_reduce_(self, t: torch.Tensor) -> None:
        """Sum flat ``t`` in place over this rank's model group."""
        if self.model > 1:
            grp = self._model
            self._staged(t, lambda x: dist.all_reduce(x, group=grp))

    def model_all_gather_(self, out: torch.Tensor, t: torch.Tensor
                          ) -> None:
        """``out`` (flat, M times ``t``'s size) <- the flat ``t`` of each
        rank of this rank's model group, in rank order."""
        if self.model == 1:
            out.copy_(t)
            return
        self._gather(out, t, self._model)

    def model_reduce_scatter_(self, out: torch.Tensor, t: torch.Tensor
                              ) -> None:
        """``out`` <- this rank's 1/M of flat ``t`` summed over its model
        group (model index k takes the k-th slice)."""
        if self.model == 1:
            out.copy_(t)
            return
        grp = self._model
        self._staged_pair(out, t, lambda o, i: _quiet(
            dist.reduce_scatter_tensor, o, i, group=grp))

    def replica_all_reduce_(self, t: torch.Tensor, g: int) -> None:
        """Sum flat ``t`` in place over this rank's replica group of g
        data positions."""
        if g * self.model > 1:
            grp = self.replica(g)
            self._staged(t, lambda x: dist.all_reduce(x, group=grp))

    def replica_all_gather_(self, out: torch.Tensor, t: torch.Tensor,
                            g: int) -> None:
        """``out`` (flat, g M times ``t``'s size) <- the flat ``t`` of
        each rank of this rank's replica group of g data positions, in
        rank order (position d, model index k at d M + k)."""
        if g * self.model == 1:
            out.copy_(t)
            return
        self._gather(out, t, self.replica(g))

    def _gather(self, out, t, grp) -> None:
        self._staged_pair(out, t, lambda o, i: _quiet(
            dist.all_gather_into_tensor, o, i, group=grp))

    def all_to_all_(self, out: torch.Tensor, t: torch.Tensor,
                    out_splits: Sequence[int],
                    in_splits: Sequence[int]) -> None:
        """Over this rank's model column (the whole world when M is 1):
        position j gets ``in_splits[j]`` elements of flat ``t``
        (consecutive slices, in position order), and ``out`` is what
        each position sent this one, ``out_splits[j]`` from position
        j."""
        if self.positions == 1:
            out.copy_(t)
            return
        grp = self._column
        self._staged_pair(out, t, lambda o, i: dist.all_to_all_single(
            o, i, list(out_splits), list(in_splits), group=grp))

    def sum_world(self, t: torch.Tensor) -> torch.Tensor:
        """A small tensor summed over the world in float64 (one
        all-reduce: on the card under NCCL, on the host under gloo),
        returned on the host."""
        x = t.detach().to(torch.float64)
        if self.world == 1:
            return x.cpu()
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        x = x.to(dev)
        with self._clock(x):
            dist.all_reduce(x)
        return x.cpu()

    def gather_host(self, values: Sequence[float]) -> List[List[float]]:
        """Every rank's ``values`` (same length on each), by rank."""
        if self.world == 1:
            return [list(values)]
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        mine = torch.tensor(list(values), dtype=torch.float64, device=dev)
        out = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(out, mine)
        return [o.cpu().tolist() for o in out]

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()


def _quiet(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` without the ``FutureWarning`` some torch
    versions give for the ``*_tensor`` collectives' names (the names
    every version the port runs on has)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kwargs)
