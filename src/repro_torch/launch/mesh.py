"""The rank layout of the SPMD backend: the counterpart of the mesh.

The reference factors a TPU mesh's data axis into ``(rep, data)``.  Here
one rank of a ``torch.distributed`` job is one position on the data
axis, and the world size W is the axis (times ``mesh_model``, which is 1
in this port):

  * replica group r of size g holds ranks ``[r*g, (r+1)*g)``
    (:func:`replica_groups`), the order of the reference's reshape;
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
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.convert import Device, resolve_device

log = logging.getLogger("repro_torch.launch.mesh")

# elements per staged piece of a collective (128 MB of float32): the
# pinned host buffer a rank keeps, and well below gloo's 2 GiB messages
STAGE_ELEMS = 1 << 25


def world() -> Tuple[int, int]:
    """``(rank, world_size)``: ``(0, 1)`` when no process group is
    initialised, as on a one-device host."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def replica_groups(world_size: int, R: int) -> List[List[int]]:
    """The ranks of each of R replica groups: group r is
    ``[r*g, (r+1)*g)`` with g = world_size / R."""
    if R < 1 or world_size % R:
        raise ValueError(f"{R} replica groups do not split "
                         f"{world_size} ranks")
    g = world_size // R
    return [list(range(r * g, (r + 1) * g)) for r in range(R)]


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
    C.31), so with gloo every collective on a CUDA tensor, one path for
    all of them, is staged through a pinned host buffer in pieces of
    :data:`STAGE_ELEMS` (:meth:`_staged`).  Compute never leaves the
    card; only the bytes that cross ranks pass through the host.  NCCL
    takes the CUDA tensors as they are.  With one rank every collective
    is the identity.  ``seconds`` adds up the host time spent in them,
    waits for the other ranks included (NCCL's are asynchronous), and
    ``seconds_by`` splits it by the label of :meth:`timing` around each
    call."""

    def __init__(self, device: torch.device):
        self.device = device
        self.rank, self.world = world()
        self.backend = dist.get_backend() if self.world > 1 else None
        self.seconds = 0.0
        self.seconds_by: Dict[str, float] = {}
        self._kind = "other"
        self._groups: Dict[int, object] = {}
        self._pinned: Dict[torch.dtype, torch.Tensor] = {}

    def group(self, g: int):
        """This rank's replica group of size ``g`` (None for the whole
        world).  Every rank creates every group of a size, in order, the
        first time the size is asked for."""
        if g == self.world:
            return None
        if g not in self._groups:
            mine = None
            for ranks in replica_groups(self.world, self.world // g):
                handle = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = handle
            self._groups[g] = mine
        return self._groups[g]

    @contextlib.contextmanager
    def timing(self, kind: str) -> Iterator[None]:
        """Count the collectives inside the block under ``kind``."""
        outer, self._kind = self._kind, kind
        try:
            yield
        finally:
            self._kind = outer

    def _staged(self, t: torch.Tensor, op, read: bool = True,
                write: bool = True) -> None:
        """``op(piece)`` on every piece of flat ``t``.  With gloo and a
        CUDA tensor each piece goes through the pinned host buffer:
        copied in when ``op`` reads it, back when ``op`` writes it."""
        t0 = time.perf_counter()
        self._pieces(t, op, read, write)
        dt = time.perf_counter() - t0
        self.seconds += dt
        self.seconds_by[self._kind] = self.seconds_by.get(self._kind,
                                                          0.0) + dt

    def _pieces(self, t: torch.Tensor, op, read: bool, write: bool) -> None:
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
            if read:
                host.copy_(piece)
            op(host)
            if write:
                piece.copy_(host)

    def all_reduce_sum_(self, t: torch.Tensor, g: int) -> None:
        """Sum ``t`` in place over this rank's replica group of size g."""
        if g == 1:
            return
        grp = self.group(g)
        self._staged(t, lambda x: dist.all_reduce(x, group=grp))

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> None:
        if self.world > 1:
            self._staged(t, lambda x: dist.broadcast(x, src),
                         read=self.rank == src, write=self.rank != src)

    def send(self, t: torch.Tensor, dst: int) -> None:
        self._staged(t, lambda x: dist.send(x, dst), write=False)

    def recv_(self, t: torch.Tensor, src: int) -> None:
        self._staged(t, lambda x: dist.recv(x, src), read=False)

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
