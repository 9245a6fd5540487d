"""Flat gradient/parameter slabs — the aggregation format.

A *slab* is one contiguous ``(P_pad,)`` tensor holding every leaf of a
parameter tree: leaves in the reference's ``jax.tree`` flatten order
(dict keys sorted, nested dicts depth first), each raveled C-order,
concatenated, and zero-padded so ``P_pad`` is a multiple of
:data:`~repro_torch.kernels.hybrid_aggregate.TILE_P`.  The layout and the
per-leaf dtype rules are those of ``src/repro/core/slab.py``, so the two
packages' slabs of the same parameters are equal byte for byte.

The server stages incoming slabs into a preallocated ``(K_max, P_pad)``
buffer and applies every flush through one kernel
(:mod:`repro_torch.kernels.hybrid_aggregate`), whatever the number of
gradients K it aggregates: rows past the live count carry weight 0.

PyTorch has no buffer donation.  Instead (enforced by
:class:`SlabAggregator`):

* the master params slab, the staging buffer and the moment slabs are
  updated **in place** and never escape the aggregator;
* everything handed to callers — the published params slab, decoded
  trees — is a **fresh** tensor on every flush that aliases no buffer
  the aggregator writes again, so a caller may hold it across later
  flushes (the simulator's event heap holds old parameter snapshots).

``shards > 1`` splits the staging buffer, the master slab and the
moments along P into tile-aligned chunks, each flushed by its own kernel
launch, and places chunk i on the i-th of the host's cards, round robin,
as the reference spreads its chunks over a host's devices; the fold is
elementwise along P, so a sharded flush is bitwise equal to the
unsharded one.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.convert import to_device
from repro_torch.kernels.hybrid_aggregate import (TILE_P, flush,
                                                  flush_adamw,
                                                  flush_momentum)
from repro_torch.optim.optimizers import bias_correction
from repro_torch.optim.slab_form import SlabOptimizer

# declared aggregation dtypes: spec/CLI name -> torch dtype
SLAB_DTYPES: Dict[str, torch.dtype] = {"f32": torch.float32,
                                       "bf16": torch.bfloat16}
_ALIASES = {"float32": "f32", "bfloat16": "bf16"}

Path = Tuple[str, ...]


def resolve_slab_dtype(name) -> torch.dtype:
    """``"f32"``/``"bf16"`` (or ``"float32"``/``"bfloat16"``, or the
    torch dtype itself) -> the torch slab dtype."""
    if isinstance(name, torch.dtype) and name in SLAB_DTYPES.values():
        return name
    key = _ALIASES.get(str(name).replace("torch.", ""), name)
    if key in SLAB_DTYPES:
        return SLAB_DTYPES[key]
    raise ValueError(f"slab_dtype must be one of "
                     f"{sorted(SLAB_DTYPES)}, got {name!r}")


def _flatten(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs in ``jax.tree`` order: dict keys sorted, tuple
    and list items in order, depth first.  A dict key is a path element
    as it is; a sequence position is an ``int`` (the model stack's
    ``params["groups"]`` is a tuple of dicts)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, prefix + (i,)))
        return out
    return [(prefix, tree)]


def _unflatten(paths: Tuple[Path, ...], leaves) -> Any:
    if paths == ((),):
        return leaves[0]
    root: Dict[Any, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return _sequences(root)


def _sequences(node: Any) -> Any:
    """Nested dicts back to the tree: a node keyed by ``int`` positions
    is a tuple."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return tuple(_sequences(node[i]) for i in range(len(node)))
    return {k: _sequences(v) for k, v in node.items()}


def _keystr(path: Path) -> str:
    """The reference's ``jax.tree_util.keystr`` form, e.g. ``['a']['b']``."""
    return "".join(f"[{k!r}]" for k in path)


class SlabCodec:
    """Tree ⇄ slab codec for one (paths, shapes, dtypes, slab_dtype).

    ``encode`` casts each leaf to the declared aggregation dtype and
    pads; ``decode`` restores every leaf's original dtype and returns
    fresh tensors (never views into the slab).  Both run on whatever
    device their input is on.
    """

    def __init__(self, paths: Tuple[Path, ...],
                 shapes: Tuple[Tuple[int, ...], ...],
                 dtypes: Tuple[torch.dtype, ...], slab_dtype="f32"):
        for path, dt in zip(paths, dtypes):
            name = _keystr(path) or "leaf[0]"
            if not dt.is_floating_point:
                raise TypeError(
                    f"slab codec requires floating leaves, got {dt} "
                    f"at {name} (the slab is a floating array; integer "
                    "leaves would round-trip lossily)")
            if dt.itemsize > 4:
                raise TypeError(
                    f"slab codec requires leaves <= 32-bit, got {dt} "
                    f"at {name} (wider floats would be silently "
                    "quantized on the round trip)")
        self.paths = paths
        self.shapes = shapes
        self.dtypes = dtypes
        self.slab_dtype = resolve_slab_dtype(slab_dtype)
        self.slab_dtype_name = "f32" if self.slab_dtype == torch.float32 \
            else "bf16"
        self.sizes = tuple(int(np.prod(s, dtype=np.int64)) for s in shapes)
        self.offsets = tuple(int(o) for o in
                             np.cumsum((0,) + self.sizes)[:-1])
        self.size = int(sum(self.sizes))            # live elements P
        if self.size == 0:
            raise ValueError("empty tree has no slab")
        self.padded_size = -(-self.size // TILE_P) * TILE_P

    def _encode_as(self, tree, dtype: torch.dtype) -> torch.Tensor:
        leaves = [leaf for _, leaf in _flatten(tree)]
        out = torch.zeros((self.padded_size,), dtype=dtype,
                          device=leaves[0].device)
        for off, n, leaf in zip(self.offsets, self.sizes, leaves):
            out[off:off + n].copy_(leaf.reshape(-1))
        return out

    def encode(self, tree) -> torch.Tensor:
        """tree -> (P_pad,) slab in the aggregation dtype (fresh)."""
        return self._encode_as(tree, self.slab_dtype)

    def encode_master(self, tree) -> torch.Tensor:
        """tree -> (P_pad,) **float32** slab — the aggregator's master
        params form, whatever ``slab_dtype`` is."""
        return self._encode_as(tree, torch.float32)

    def items(self, tree) -> List[Tuple[Path, Any]]:
        """``(path, leaf)`` pairs of ``tree`` in the slab's order."""
        return _flatten(tree)

    def tree(self, leaves: Sequence[Any]) -> Any:
        """The tree of ``leaves`` given in the slab's order."""
        return _unflatten(self.paths, list(leaves))

    def decode(self, slab: torch.Tensor) -> Any:
        """(P_pad,) slab -> tree of fresh tensors with the template's
        shapes and original per-leaf dtypes."""
        leaves = [slab[off:off + n].reshape(shape).to(dtype, copy=True)
                  for off, n, shape, dtype in zip(self.offsets, self.sizes,
                                                  self.shapes, self.dtypes)]
        return _unflatten(self.paths, leaves)

    def decode_host(self, slab: torch.Tensor) -> Any:
        """:meth:`decode` into fresh CPU tensors (one device-to-host
        copy of the slab; it waits for the work queued before it)."""
        return self.decode(slab.cpu())

    def __repr__(self):
        return (f"SlabCodec(leaves={len(self.sizes)}, P={self.size}, "
                f"padded={self.padded_size}, "
                f"dtype={self.slab_dtype_name})")


_CODEC_CACHE: Dict[Tuple, SlabCodec] = {}


def slab_codec(tree, slab_dtype="f32") -> SlabCodec:
    """The cached codec for ``tree``'s structure (key paths + leaf shapes
    + dtypes) at the given aggregation dtype."""
    flat = _flatten(tree)
    paths = tuple(p for p, _ in flat)
    shapes = tuple(tuple(leaf.shape) for _, leaf in flat)
    dtypes = tuple(leaf.dtype for _, leaf in flat)
    sdt = resolve_slab_dtype(slab_dtype)
    key = (paths, shapes, dtypes, sdt)
    codec = _CODEC_CACHE.get(key)
    if codec is None:
        codec = _CODEC_CACHE[key] = SlabCodec(paths, shapes, dtypes, sdt)
    return codec


_SHARD_AUTO_MIN = 1 << 22     # elements: auto-shard only for multi-
#                               million-parameter slabs


def _auto_shards(padded_size: int, num_devices: int) -> int:
    """The reference's default shard count: 1 unless the slab is
    multi-million-parameter and there are several devices to spread the
    chunks across."""
    if num_devices <= 1 or padded_size < _SHARD_AUTO_MIN:
        return 1
    return min(num_devices, padded_size // TILE_P)


def shard_chunks(padded_size: int, shards: int) -> Tuple[int, ...]:
    """Split ``padded_size`` (a TILE_P multiple) into ``shards``
    tile-aligned chunk lengths (descending by at most one tile)."""
    tiles = padded_size // TILE_P
    shards = max(1, min(int(shards), tiles))
    base, extra = divmod(tiles, shards)
    return tuple((base + (1 if i < extra else 0)) * TILE_P
                 for i in range(shards))


class SlabAggregator:
    """Master params slab + ``(K_max, P_pad)`` staging buffer + the flush.

    The flush computes, for the first ``k`` staged rows ``g_i`` with
    weights ``w_i`` (zero-padded to ``K_max``)::

        params <- params - scale * (Σ_i w_i · g_i) / (Σ_i w_i)

    in place, and publishes a fresh copy of the new params that is safe
    to hand to workers.  One kernel serves every ``1 <= k <= K_max``
    through zero-weight masking of the unused rows; on a CPU device the
    kernels' plain versions run instead.

    Staging rows and the published slab are in the codec's
    ``slab_dtype``; the master params slab, the moments and the
    reduction are always float32 (bf16 rows are upcast before the flush,
    as in the reference).

    With ``optimizer=SlabOptimizer("momentum"|"adamw")`` the update runs
    in the fused ``flush_momentum``/``flush_adamw`` kernels on f32
    moment slabs, with AdamW's bias correction driven by an int32 update
    count kept on the device.  No flush reads a device value on the
    host.

    ``shards`` splits staging, the master slab and the moments along P
    into :func:`shard_chunks` chunks, one flush launch each, chunk i on
    ``devices[i % len(devices)]``.  ``devices`` defaults to every card
    of the host when the params are on a card, else the params' device;
    ``shards=None`` takes the reference's rule: 1 unless the slab is
    multi-million-parameter and there are several devices.  Each device
    gets its own copy of the flush's weights and of AdamW's bias
    corrections, copied from the aggregator's device, so the copies are
    equal; the update count stays there.  The published slab is
    assembled on the aggregator's device.  With one chunk nothing is
    split: the master slab is one tensor on the aggregator's device.
    """

    def __init__(self, codec: SlabCodec, params, k_max: int, *,
                 shards: Optional[int] = None,
                 optimizer: Optional[SlabOptimizer] = None,
                 devices: Optional[Sequence[Any]] = None):
        if k_max < 1:
            raise ValueError(f"k_max must be >= 1, got {k_max}")
        self.codec = codec
        self.k_max = int(k_max)
        self.opt = optimizer or SlabOptimizer("sgd")
        slab = codec.encode_master(params)
        self.device = slab.device
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())] \
                if self.device.type == "cuda" else [self.device]
        devices = [torch.device(d) for d in devices]
        if shards is None:
            shards = _auto_shards(codec.padded_size, len(devices))
        self.chunk_sizes = shard_chunks(codec.padded_size, shards)
        self.shards = len(self.chunk_sizes)
        self.chunk_offsets = tuple(int(o) for o in
                                   np.cumsum((0,) + self.chunk_sizes)[:-1])
        self.chunk_devices = (self.device,) if self.shards == 1 else tuple(
            devices[i % len(devices)] for i in range(self.shards))
        self._master = self._split(slab)
        del slab
        self._staging = [torch.zeros((self.k_max, n), dtype=codec.slab_dtype,
                                     device=d)
                         for n, d in zip(self.chunk_sizes,
                                         self.chunk_devices)]
        self._pub = codec.encode(params)
        self._zero_row = torch.zeros((codec.padded_size,),
                                     dtype=codec.slab_dtype,
                                     device=self.device)
        self._init_opt_state()

    def _split(self, full: torch.Tensor) -> List[torch.Tensor]:
        """A whole f32 slab as the chunks' tensors on their devices (the
        slab itself when there is one chunk)."""
        if self.shards == 1:
            return [full]
        return [full[off:off + n].to(d, copy=True) for off, n, d in zip(
            self.chunk_offsets, self.chunk_sizes, self.chunk_devices)]

    def _zeros(self) -> List[torch.Tensor]:
        return [torch.zeros((n,), dtype=torch.float32, device=d)
                for n, d in zip(self.chunk_sizes, self.chunk_devices)]

    def _init_opt_state(self) -> None:
        """Zero the f32 moment slabs and the int32 update count."""
        self._count = torch.zeros((), dtype=torch.int32, device=self.device)
        self._moments: Dict[str, List[torch.Tensor]] = {
            name: self._zeros() for name in self.opt.moment_names}

    def _assemble(self, chunks: List[torch.Tensor]) -> torch.Tensor:
        """The whole slab of per-chunk tensors, on the aggregator's
        device (a fresh tensor)."""
        if self.shards == 1:
            return chunks[0].clone()
        return torch.cat([c.to(self.device) for c in chunks])

    def _published(self) -> torch.Tensor:
        """A fresh copy of the master slab in the slab dtype."""
        if self.shards == 1 and self.codec.slab_dtype != torch.float32:
            return self._master[0].to(self.codec.slab_dtype)
        full = self._assemble(self._master)
        return full if self.codec.slab_dtype == torch.float32 \
            else full.to(self.codec.slab_dtype)

    def _chunks(self):
        """(staging rows in f32 or bf16, chunk index) per chunk."""
        for i, rows in enumerate(self._staging):
            yield (rows if rows.dtype == torch.float32 else rows.float()), i

    def _on_devices(self, t: torch.Tensor) -> Dict[torch.device, Any]:
        """``t`` (made on the aggregator's device) copied to each chunk's
        device."""
        return {d: t if d == t.device else t.to(d)
                for d in set(self.chunk_devices)}

    # ------------------------------------------------------------- API
    def stage(self, slab: torch.Tensor, slot: int) -> None:
        """Write one gradient slab into staging row ``slot`` (in place)."""
        if not 0 <= slot < self.k_max:
            raise IndexError(f"slot {slot} outside 0..{self.k_max - 1}")
        for rows, off, n in zip(self._staging, self.chunk_offsets,
                                self.chunk_sizes):
            rows[slot].copy_(slab[off:off + n])

    def flush_apply(self, weights, scale: float) -> torch.Tensor:
        """Aggregate the first ``len(weights)`` staged rows and apply the
        update.  Returns the freshly published params slab."""
        k = len(weights)
        if not 1 <= k <= self.k_max:
            raise ValueError(f"{k} weights for a buffer of {self.k_max}")
        wfull = np.zeros((self.k_max,), np.float32)
        wfull[:k] = np.asarray(weights, np.float32)
        w = to_device(wfull, self.device)
        devs = self.chunk_devices
        master = self._master
        if self.opt.name == "sgd":
            ws = self._on_devices(w)
            wsum = self._on_devices(w.sum())
            for rows, i in self._chunks():
                agg = flush(rows, ws[devs[i]])
                master[i].sub_(agg.div_(wsum[devs[i]]).mul_(scale))
        elif self.opt.name == "momentum":
            wn = self._on_devices(w / w.sum())
            mu = self._moments["mu"]
            for rows, i in self._chunks():
                _, new_mu = flush_momentum(rows, wn[devs[i]], mu[i],
                                           self.opt.beta1)
                _write(mu[i], new_mu)
                master[i].sub_(mu[i] * scale)
            self._count += 1
        else:
            wn = self._on_devices(w / w.sum())
            c = self._count + 1
            bc = [self._on_devices(b) for b in
                  bias_correction(c, self.opt.beta1, self.opt.beta2)]
            mu, nu = self._moments["mu"], self._moments["nu"]
            for rows, i in self._chunks():
                d = devs[i]
                new = flush_adamw(
                    rows, wn[d], master[i], mu[i], nu[i], bc[0][d], bc[1][d],
                    scale, b1=self.opt.beta1, b2=self.opt.beta2,
                    eps=self.opt.eps, weight_decay=self.opt.weight_decay)
                for dst, src in zip((master[i], mu[i], nu[i]), new):
                    _write(dst, src)
            self._count = c
        self._pub = self._published()
        return self._pub

    @property
    def params_slab(self) -> torch.Tensor:
        """The published params slab (safe to ship / hold)."""
        return self._pub

    def params_tree(self):
        """Decode the published params into a fresh tree."""
        return self.codec.decode(self._pub)

    def reset_params(self, params) -> None:
        """Replace the live params (checkpoint restore)."""
        self._master = self._split(
            self.codec.encode_master(params).to(self.device))
        self._pub = self.codec.encode(params).to(self.device)

    def reset_opt_state(self, state: Optional[Dict[str, Any]] = None
                        ) -> None:
        """Resync the optimizer state (checkpoint restore): ``None``
        zeros the moments and the update count; a dict in the
        :meth:`opt_state_host` form (f32 ``(P_pad,)`` arrays by moment
        name plus an int ``count``) reloads them."""
        if state is None:
            self._init_opt_state()
            return
        missing = [n for n in self.opt.moment_names if n not in state]
        if missing:
            raise ValueError(
                f"optimizer state is missing moment slab(s) {missing} "
                f"for {self.opt.name!r}: the checkpoint was written by "
                "a run with a different optimizer")
        moments = {}
        for name in self.opt.moment_names:
            full = np.asarray(state[name], np.float32)
            if full.shape != (self.codec.padded_size,):
                raise ValueError(f"moment {name!r} has shape {full.shape},"
                                 f" the slab ({self.codec.padded_size},)")
            moments[name] = self._split(to_device(full, self.device))
        self._moments = moments
        self._count = torch.tensor(int(state["count"]), dtype=torch.int32,
                                   device=self.device)

    def opt_state_host(self) -> Optional[Dict[str, Any]]:
        """Host copies of the moment slabs + the int update count, or
        ``None`` for plain SGD.  The copy waits for every flush queued
        before it; the owner holds its lock so that none is queued
        while it runs."""
        if self.opt.name == "sgd":
            return None
        out: Dict[str, Any] = {
            name: torch.cat([c.cpu() for c in m]).numpy()
            for name, m in self._moments.items()}
        out["count"] = int(self._count)
        return out

    def wipe_staging(self) -> None:
        """Zero every staging row: zero-weight masking neutralizes finite
        leftovers, but a non-finite row would poison later flushes
        (``0 · inf = nan``)."""
        for rows in self._staging:
            rows.zero_()

    def warmup(self) -> None:
        """Run one flush before training starts, so the kernels are built
        and loaded before the clock does.  Scale 0 over a zero row leaves
        the params bitwise unchanged, and the still-zero moments too;
        the update count it ticks is rewound to 0, as in the reference."""
        self.stage(self._zero_row, 0)
        self.flush_apply(np.ones((1,), np.float32), 0.0)
        if self.opt.name != "sgd":
            self._count = torch.zeros((), dtype=torch.int32,
                                      device=self.device)

    def grow(self, k_max: int) -> None:
        """Resize the staging buffer to ``k_max`` rows (elastic fleet
        admission).  Staged rows are kept — a hybrid buffer holds rows
        between flushes — and the new rows are zero, which zero-weight
        masking keeps inert.  It never shrinks: a departed worker's row
        just keeps weight 0."""
        k_max = int(k_max)
        if k_max <= self.k_max:
            return
        grown = []
        for old in self._staging:
            rows = torch.zeros((k_max, old.shape[1]), dtype=old.dtype,
                               device=old.device)
            rows[:self.k_max].copy_(old)
            grown.append(rows)
        self._staging = grown
        self.k_max = k_max


def _write(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Land a kernel's result in ``dst``: on the card the kernels update
    their inputs in place, on the CPU the plain versions return new
    tensors."""
    if src.data_ptr() != dst.data_ptr():
        dst.copy_(src)


class SlabBuffer:
    """Slab-backed gradient buffer: gradient slabs are staged into the
    aggregator as they arrive (row = arrival order); only the parameter
    versions they were computed against are tracked on the host, for
    the staleness weights."""

    def __init__(self, aggregator: SlabAggregator,
                 staleness_decay: float = 1.0):
        self.agg = aggregator
        self.staleness_decay = float(staleness_decay)
        self._versions: List[int] = []

    def __len__(self) -> int:
        return len(self._versions)

    def add(self, slab: torch.Tensor, version: int) -> None:
        self.agg.stage(slab, len(self._versions))
        self._versions.append(int(version))

    def weights(self, current_version: int) -> np.ndarray:
        """Staleness weights ``decay^max(0, now - v_i)``."""
        stale = np.maximum(0.0, current_version
                           - np.asarray(self._versions, np.float64))
        return self.staleness_decay ** stale

    def clear(self) -> None:
        """Forget rows that a flush just consumed (zero weights mask
        them on the next flush)."""
        self._versions = []

    def discard(self) -> None:
        """Drop staged rows unconsumed (checkpoint restore).  The rows
        are wiped, not just masked: a discarded gradient may be
        non-finite, and ``0 · inf = nan`` would defeat the masking."""
        self.agg.wipe_staging()
        self._versions = []
