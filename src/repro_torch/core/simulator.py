"""Event-driven parameter-server simulator — the paper-faithful layer.

A port of ``src/repro/core/simulator.py``: N workers with heterogeneous
speeds, delays sampled from N(mean, σ) on a fraction of the workers, one
parameter server, and three aggregation policies:

  * ``async``  — every arriving gradient is applied immediately,
  * ``sync``   — the server waits for all workers each round,
  * ``hybrid`` — the Smooth Switch algorithm: gradients accumulate in a
                 buffer; once |buffer| >= K(t) they are flushed as one
                 aggregated update, with K(t) a monotone threshold schedule.

Time is *virtual* (an event heap); the gradients are real, computed on
the device with ``torch.func.grad``.  Every flush goes through
:class:`repro_torch.core.slab.SlabAggregator`, whose kernels run on the
card.  All randomness comes from one ``np.random.default_rng(seed)``
drawn in the reference's order, so event timing, and with it
``num_updates`` and ``num_gradients``, replays the reference exactly.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import resolve_device, to_device, tree_to
from repro_torch.core.schedule import ThresholdSchedule, constant_schedule
from repro_torch.core.slab import SlabAggregator, SlabBuffer, slab_codec
from repro_torch.optim.slab_form import SlabOptimizer


@dataclasses.dataclass(frozen=True)
class WorkerPool:
    """Static timing model for the worker fleet."""
    num_workers: int = 25
    base_compute: float = 0.05          # seconds per gradient (virtual)
    speed_jitter: float = 0.2           # worker speed ~ U[1-j, 1+j]
    delay_fraction: float = 0.5         # fraction of workers with delays
    delay_mean: float = 0.0             # N(mean, std) extra per gradient
    delay_std: float = 0.25
    comm_delay: float = 0.002           # fixed network latency each way
    # parameter-server service times: async pays `apply` per gradient,
    # the hybrid buffer once per flush
    ps_ingest_time: float = 0.0002      # per-gradient enqueue cost
    ps_apply_time: float = 0.002        # per parameter-update apply cost

    def build(self, rng: np.random.Generator):
        speeds = self.base_compute * rng.uniform(
            1 - self.speed_jitter, 1 + self.speed_jitter, self.num_workers)
        delayed = np.zeros(self.num_workers, bool)
        k = int(round(self.delay_fraction * self.num_workers))
        delayed[rng.permutation(self.num_workers)[:k]] = True
        return speeds, delayed

    def grad_time(self, w: int, speeds, delayed, rng) -> float:
        t = speeds[w]
        if delayed[w]:
            t += max(0.0, rng.normal(self.delay_mean, self.delay_std))
        return t + 2 * self.comm_delay


@dataclasses.dataclass
class SimResult:
    times: np.ndarray            # metric sample times
    train_loss: np.ndarray
    test_loss: np.ndarray
    test_acc: np.ndarray
    num_updates: int
    num_gradients: int
    mode: str

    def averaged(self) -> Dict[str, float]:
        """Paper-style 'averaged over the entire training interval'."""
        return {
            "train_loss": float(np.mean(self.train_loss)),
            "test_loss": float(np.mean(self.test_loss)),
            "test_acc": float(np.mean(self.test_acc)),
        }


def _data_to(data, device: torch.device):
    """(x_train, y_train, x_test, y_test) as tensors on ``device``;
    labels become int64, PyTorch's index type."""
    out = []
    for i, a in enumerate(data):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.ascontiguousarray(a))
        out.append(t.to(device=device,
                        dtype=torch.int64 if i % 2 else None))
    return tuple(out)


class PSTrainer:
    """Runs one simulated training for a given aggregation policy."""

    def __init__(self, loss_fn: Callable, init_params, data,
                 lr: float = 0.01, batch_size: int = 32,
                 pool: WorkerPool = WorkerPool(), seed: int = 0,
                 staleness_decay: float = 1.0, flush_mode: str = "sum",
                 accuracy_fn: Optional[Callable] = None,
                 optimizer: Optional[SlabOptimizer] = None,
                 device=None):
        """data = (x_train, y_train, x_test, y_test), arrays or tensors,
        moved to ``device`` once; loss_fn(params, x, y) -> scalar nll.
        ``device`` defaults to ``cuda`` and raises if there is none.

        flush_mode: "sum" applies every buffered gradient at full lr
        (K=1 ≡ async exactly); "mean" averages the buffer.

        accuracy_fn(params, x, y) -> scalar; when None the test-accuracy
        series is all zeros.
        """
        if flush_mode not in ("sum", "mean"):
            raise ValueError(f"flush_mode must be sum or mean, got "
                             f"{flush_mode!r}")
        self.device = resolve_device(device)
        self.flush_mode = flush_mode
        self.loss_fn = loss_fn
        self.init_params = tree_to(init_params, self.device)
        self.x_tr, self.y_tr, self.x_te, self.y_te = _data_to(data,
                                                              self.device)
        self.lr = lr
        self.batch = batch_size
        self.pool = pool
        self.seed = seed
        self.staleness_decay = staleness_decay
        # each simulated worker's gradient is flattened once into a slab
        self._codec = slab_codec(self.init_params)
        grad_fn = torch.func.grad(loss_fn)
        self._grad = lambda p, x, y: self._codec.encode(grad_fn(p, x, y))
        self.accuracy_fn = accuracy_fn
        self.optimizer = optimizer or SlabOptimizer("sgd")
        # aggregators are reused across simulate() calls, one per
        # staging width
        self._agg_cache: Dict[int, SlabAggregator] = {}

    # ------------------------------------------------------------------
    def _sample_batch(self, rng: np.random.Generator, shard_idx):
        idx = to_device(rng.choice(shard_idx, size=self.batch,
                                   replace=True), self.device)
        return self.x_tr[idx], self.y_tr[idx]

    @torch.no_grad()
    def _metrics(self, params):
        tr = float(self.loss_fn(params, self.x_tr[:2048], self.y_tr[:2048]))
        te = float(self.loss_fn(params, self.x_te, self.y_te))
        acc = float(self.accuracy_fn(params, self.x_te, self.y_te)) \
            if self.accuracy_fn else 0.0
        return tr, te, acc

    def _shards(self):
        n = self.x_tr.shape[0]
        w = self.pool.num_workers
        return [np.arange(i, n, w) for i in range(w)]

    # ------------------------------------------------------------------
    def simulate(self, mode: str, horizon: float = 20.0,
                 schedule: Optional[ThresholdSchedule] = None,
                 sample_every: float = 0.5) -> SimResult:
        if mode not in ("sync", "async", "hybrid"):
            raise ValueError(f"mode must be sync, async or hybrid, got "
                             f"{mode!r}")
        rng = np.random.default_rng(self.seed)
        speeds, delayed = self.pool.build(rng)
        shards = self._shards()
        params = self.init_params
        W = self.pool.num_workers

        if mode == "async":
            schedule = constant_schedule(W, 1)
        elif mode == "sync":
            schedule = constant_schedule(W, W)
        if schedule is None:
            raise ValueError("hybrid mode needs a schedule")

        # async pins K(t) ≡ 1, so its staging buffer needs a single row;
        # sync/hybrid flushes aggregate at most one gradient per worker —
        # or up to the schedule's own ceiling
        k_max = 1 if mode == "async" else max(W, schedule.num_workers)
        agg = self._agg_cache.get(k_max)
        if agg is None:
            agg = self._agg_cache[k_max] = SlabAggregator(
                self._codec, params, k_max, optimizer=self.optimizer)
        else:
            # reused buffers, fresh state: re-seed the params, wipe rows
            # a previous run may have left staged, zero the optimizer
            agg.reset_params(params)
            agg.wipe_staging()
            agg.reset_opt_state()
        buffer = SlabBuffer(agg, self.staleness_decay)
        version = 0            # number of parameter updates applied
        n_grads = 0
        sample_t = [t for t in np.arange(0.0, horizon + 1e-9, sample_every)]
        samples: List[Tuple[float, float, float]] = []
        next_sample = 0

        def record_until(now):
            nonlocal next_sample
            while next_sample < len(sample_t) and sample_t[next_sample] <= now:
                samples.append(self._metrics(params))
                next_sample += 1

        if mode == "sync":
            now = 0.0
            while now < horizon:
                arrivals = [now + self.pool.grad_time(w, speeds, delayed, rng)
                            for w in range(W)]
                round_end = max(arrivals)
                record_until(min(round_end, horizon))
                if round_end >= horizon:
                    break
                for w in range(W):     # staged in worker order (slot = w)
                    x, y = self._sample_batch(rng, shards[w])
                    agg.stage(self._grad(params, x, y), w)
                    n_grads += 1
                agg.flush_apply(np.ones(W), self.lr)   # round mean
                params = agg.params_tree()
                version += 1
                now = round_end
            record_until(horizon)
        else:
            # async / hybrid share the event loop; async is K(t) ≡ 1.
            # Each heap entry carries the parameter snapshot the worker
            # read when it was dispatched: params_tree() returns fresh
            # tensors that no later flush writes, so the snapshot is a
            # reference, not a copy, and staleness is physical.  The PS
            # is a serial resource: each arriving gradient costs
            # `ps_ingest_time` and each flush `ps_apply_time`.
            counter = 0  # tie-breaker (params trees are not orderable)
            server_free = 0.0
            heap: List[Tuple[float, int, int, int, Any]] = []
            for w in range(W):
                heapq.heappush(
                    heap, (self.pool.grad_time(w, speeds, delayed, rng),
                           counter, w, version, params))
                counter += 1
            while heap and heap[0][0] < horizon:
                now, _, w, v_read, params_read = heapq.heappop(heap)
                record_until(now)
                x, y = self._sample_batch(rng, shards[w])
                grad_slab = self._grad(params_read, x, y)
                n_grads += 1
                done = max(now, server_free) + self.pool.ps_ingest_time
                buffer.add(grad_slab, v_read)
                if len(buffer) >= schedule(version):
                    weights = buffer.weights(version)
                    k = len(buffer)
                    buffer.clear()
                    # "sum" applies every buffered gradient at full lr
                    # (K=1 ≡ async exactly); "mean" averages the buffer
                    scale = self.lr * k if self.flush_mode == "sum" \
                        else self.lr
                    agg.flush_apply(weights, scale)
                    params = agg.params_tree()
                    version += 1
                    done += self.pool.ps_apply_time
                server_free = done
                heapq.heappush(
                    heap, (done + self.pool.grad_time(w, speeds, delayed,
                                                      rng),
                           counter, w, version, params))
                counter += 1
            record_until(horizon)

        arr = np.asarray(samples) if samples else np.zeros((0, 3))
        return SimResult(
            times=np.asarray(sample_t[:len(samples)]),
            train_loss=arr[:, 0], test_loss=arr[:, 1], test_acc=arr[:, 2],
            num_updates=version, num_gradients=n_grads, mode=mode)
