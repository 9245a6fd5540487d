"""The simulator trainer: ExperimentSpec -> PS simulator -> RunResult.

:class:`SimulatorTrainer` runs ``backend="sim"``, the paper-faithful
event-driven parameter-server simulator.  ``spec.arch`` names a
registered workload (``mlp``, ``cnn-mnist``, ``cnn-cifar``; extend via
:func:`register_sim_workload`), or pass a prepared ``(loss_fn,
init_params, data, accuracy_fn)`` to the constructor.  Mirrors
``src/repro/api/trainers.py``.  ``backend="cluster"`` is
:class:`repro_torch.cluster.trainer.ClusterTrainer`, loaded on first
use; the SPMD trainer comes with a later slice of the port.

Everything runs on ``device``: ``cuda`` unless the caller asks for
another, and an error when CUDA is asked for and missing.  On CUDA the
trainer turns TF32 off for cuDNN convolutions and matrix products, so
the f32 models compute in full f32 like the reference.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.api.result import RunResult
from repro_torch.api.schedules import parse_schedule
from repro_torch.api.spec import ExperimentSpec
from repro_torch.convert import Device, resolve_device

# name -> builder(spec, device) -> (loss_fn, init_params, data, accuracy_fn)
SIM_WORKLOADS: Dict[str, Callable[[ExperimentSpec, torch.device],
                                  Tuple]] = {}


def register_sim_workload(name: str, builder: Callable,
                          overwrite: bool = False) -> None:
    """Register a simulator workload under ``name`` (= ``spec.arch``)."""
    if name in SIM_WORKLOADS and not overwrite:
        raise ValueError(f"sim workload {name!r} already registered")
    SIM_WORKLOADS[name] = builder


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _mlp_workload(spec: ExperimentSpec, device: torch.device):
    from repro_torch.data.synthetic import random_classification
    from repro_torch.models.cnn import (accuracy, init_mlp_clf,
                                        mlp_clf_forward, nll_loss)
    n = 2_000 if spec.smoke else 10_000
    data = random_classification(seed=spec.seed, n=n)
    params = init_mlp_clf(_generator(spec.seed), device=device)
    loss = lambda p, x, y: nll_loss(mlp_clf_forward(p, x), y)  # noqa: E731
    acc = lambda p, x, y: accuracy(mlp_clf_forward(p, x), y)   # noqa: E731
    return loss, params, data, acc


def _cnn_workload(dataset_name: str, image_shape):
    def build(spec: ExperimentSpec, device: torch.device):
        from repro_torch.data import synthetic
        from repro_torch.models.cnn import (accuracy, cnn_forward,
                                            init_cnn, nll_loss)
        dataset = getattr(synthetic, dataset_name)
        if spec.smoke:
            data = dataset(seed=spec.seed, n_train=2_000, n_test=500)
        else:
            data = dataset(seed=spec.seed)
        params = init_cnn(_generator(spec.seed), image_shape, device=device)
        loss = lambda p, x, y: nll_loss(cnn_forward(p, x), y)  # noqa: E731
        acc = lambda p, x, y: accuracy(cnn_forward(p, x), y)   # noqa: E731
        return loss, params, data, acc
    return build


register_sim_workload("mlp", _mlp_workload)
register_sim_workload("cnn-mnist", _cnn_workload("mnist_like", (28, 28, 1)))
register_sim_workload("cnn-cifar", _cnn_workload("cifar10_like",
                                                 (32, 32, 3)))


def _full_f32(device: torch.device) -> None:
    """cuDNN runs f32 convolutions in TF32 by default; the reference is
    f32 throughout."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


class SimulatorTrainer:
    """Adapter: ExperimentSpec -> event-driven PS simulator -> RunResult.

    With no workload arguments the workload is built from ``spec.arch``
    via :data:`SIM_WORKLOADS`; pass a prepared workload to pin the
    model/data/initialization across several runs.  ``device`` defaults
    to ``cuda`` and raises when there is none.  On CUDA it sets
    ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` to False."""

    def __init__(self, loss_fn: Optional[Callable] = None,
                 init_params: Any = None, data: Any = None,
                 accuracy_fn: Optional[Callable] = None,
                 device: Device = None):
        self.device = resolve_device(device)
        _full_f32(self.device)
        self._workload = None
        if loss_fn is not None:
            self._workload = (loss_fn, init_params, data, accuracy_fn)
        # one workload build / PSTrainer per distinct key, so several
        # modes off one trainer share the dataset and the aggregators
        self._workload_cache: Tuple[Optional[tuple], Optional[tuple]] \
            = (None, None)
        self._engine_cache: Tuple[Optional[tuple], Any] = (None, None)

    def _build(self, spec: ExperimentSpec):
        if self._workload is not None:
            return self._workload
        key = (spec.arch, spec.seed, spec.smoke)
        cached_key, cached = self._workload_cache
        if cached_key == key:
            return cached
        builder = SIM_WORKLOADS.get(spec.arch)
        if builder is None:
            known = ", ".join(sorted(SIM_WORKLOADS))
            raise ValueError(f"unknown sim workload {spec.arch!r} "
                             f"(known: {known}; register new ones via "
                             f"repro_torch.api.register_sim_workload)")
        workload = builder(spec, self.device)
        self._workload_cache = (key, workload)
        return workload

    def engine(self, spec: ExperimentSpec):
        """The :class:`~repro_torch.core.simulator.PSTrainer` for
        ``spec``, cached across runs that share its settings."""
        from repro_torch.core.simulator import PSTrainer

        workload = self._build(spec)
        key = (id(workload), spec.lr, spec.batch, spec.pool, spec.seed,
               spec.staleness_decay, spec.flush_mode, spec.optimizer,
               spec.beta1, spec.beta2, spec.weight_decay)
        cached_key, cached = self._engine_cache
        if cached_key == key:
            return cached
        loss_fn, init_params, data, accuracy_fn = workload
        trainer = PSTrainer(
            loss_fn, init_params, data, lr=spec.lr, batch_size=spec.batch,
            pool=spec.pool, seed=spec.seed,
            staleness_decay=spec.staleness_decay,
            flush_mode=spec.flush_mode, accuracy_fn=accuracy_fn,
            optimizer=spec.slab_optimizer(), device=self.device)
        self._engine_cache = (key, trainer)
        return trainer

    def run(self, spec: ExperimentSpec) -> RunResult:
        trainer = self.engine(spec)
        schedule = None
        if spec.mode == "hybrid":
            schedule = parse_schedule(spec.schedule, spec.pool.num_workers)
        t0 = time.time()
        sim = trainer.simulate(spec.mode, horizon=spec.horizon,
                               schedule=schedule,
                               sample_every=spec.sample_every)
        wall_s = time.time() - t0
        name = torch.cuda.get_device_name(self.device) \
            if self.device.type == "cuda" else "cpu"
        return RunResult.from_sim(sim, spec=spec, wall_s=wall_s,
                                  extra={"device": str(self.device),
                                         "device_name": name})


def _cluster_trainer(device: Device = None):
    from repro_torch.cluster.trainer import ClusterTrainer
    return ClusterTrainer(device=device)


TRAINERS: Dict[str, Callable[..., Any]] = {
    "sim": SimulatorTrainer,
    "cluster": _cluster_trainer,
}


def get_trainer(backend: str, device: Device = None):
    try:
        factory = TRAINERS[backend]
    except KeyError:
        raise NotImplementedError(
            f"backend {backend!r} is not ported to repro_torch yet "
            f"(ported: {', '.join(sorted(TRAINERS))})") from None
    return factory(device=device)


def run(spec: ExperimentSpec, device: Device = None) -> RunResult:
    """One spec in, one RunResult out — dispatches on ``spec.backend``."""
    return get_trainer(spec.backend, device).run(spec)
