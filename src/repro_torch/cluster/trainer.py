"""Adapter: ExperimentSpec -> wall-clock cluster runtime -> RunResult.

``backend="cluster"`` in :mod:`repro_torch.api`, a port of
``src/repro/cluster/trainer.py``.  ``spec.arch`` names the simulator's
workloads (``mlp``, ``cnn-mnist``, ``cnn-cifar``, or one added with
``register_sim_workload``): one spec re-targets the simulator and the
real concurrent cluster.  ``spec.transport`` must be ``inproc`` (worker
threads and a queue); the wire transports come with ROADMAP A10.

The reported ``num_gradients`` is the server's applied-gradient counter,
exactly; ``extra["accounting"]`` carries the conservation ledger
(computed == applied + dropped + buffered + pending + in-flight),
``extra["events"]`` the fault/checkpoint timeline and
``extra["telemetry"]`` the bus's summary with its ``ledger_check``.

On CUDA the trainer turns TF32 off (as the simulator's does) and makes
cuDNN pick deterministic convolution algorithms
(``torch.backends.cudnn.deterministic = True``, ``benchmark = False``),
so a sync run under ``max_gradients`` repeats bit for bit.
"""
from __future__ import annotations

import tempfile
import time
from typing import Any, Optional, Tuple

import torch

from repro_torch.api.result import RunResult
from repro_torch.api.schedules import parse_schedule
from repro_torch.api.spec import ExperimentSpec
from repro_torch.cluster.runtime import ClusterRuntime, check_ported
from repro_torch.convert import Device, resolve_device
from repro_torch.core.simulator import data_to

# the cluster backend has no serving plane in process: its report has
# the reference's keys, empty
_NO_SERVING = {"clients": 0, "rejected_peers": 0, "serve_every": 1,
               "stats_clients": 0, "per_client": []}


class ClusterTrainer:
    """Trainer for ``backend="cluster"``.

    ``ckpt_dir`` hosts the fault plan's checkpoint cadence and mid-run
    restore; when the plan needs one and none was given, a temporary
    directory is made (logged as an event) so a checkpointing spec runs
    from its JSON alone.  ``resume_from`` starts the server from a saved
    checkpoint (K(t) continues from the restored step).  The trained
    parameters of the last run are kept on ``self.last_params`` (CPU
    tensors).  ``device`` defaults to ``cuda`` and raises when there is
    none.  The workload and its data are built and moved to the device
    once per ``(arch, seed, smoke)``."""

    def __init__(self, ckpt_dir: Optional[str] = None,
                 resume_from: Optional[str] = None, verbose: bool = False,
                 trace: Optional[str] = None,
                 prom_port: Optional[int] = None, device: Device = None):
        check_ported("inproc", trace, prom_port)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        self.ckpt_dir = ckpt_dir
        self.resume_from = resume_from
        self.verbose = verbose
        self.last_params = None
        self._workload: Tuple[Optional[tuple], Any] = (None, None)

    def _build(self, spec: ExperimentSpec):
        from repro_torch.api.trainers import SIM_WORKLOADS

        key = (spec.arch, spec.seed, spec.smoke)
        if self._workload[0] == key:
            return self._workload[1]
        builder = SIM_WORKLOADS.get(spec.arch)
        if builder is None:
            known = ", ".join(sorted(SIM_WORKLOADS))
            raise ValueError(f"unknown cluster workload {spec.arch!r} "
                             f"(known: {known}; register new ones via "
                             f"repro_torch.api.register_sim_workload)")
        loss_fn, init_params, data, accuracy_fn = builder(spec, self.device)
        workload = (loss_fn, init_params, data_to(data, self.device),
                    accuracy_fn)
        self._workload = (key, workload)
        return workload

    def build_runtime(self, spec: ExperimentSpec) -> ClusterRuntime:
        """Construct (but do not run) the runtime for ``spec``."""
        check_ported(spec.transport)
        loss_fn, init_params, data, accuracy_fn = self._build(spec)
        schedule = None
        if spec.mode == "hybrid":
            schedule = parse_schedule(spec.schedule, spec.cluster_workers)
        ckpt_dir = self.ckpt_dir
        if ckpt_dir is None and (spec.faults.checkpoint_every_s > 0
                                 or spec.faults.restore_at_s > 0):
            ckpt_dir = tempfile.mkdtemp(prefix="repro-cluster-ckpt-")
        runtime = ClusterRuntime(
            loss_fn, init_params, data, mode=spec.mode, lr=spec.lr,
            batch=spec.batch, num_workers=spec.cluster_workers,
            wall_budget_s=spec.wall_budget_s,
            sample_every_s=spec.wall_sample_every_s, schedule=schedule,
            flush_mode=spec.flush_mode,
            staleness_decay=spec.staleness_decay,
            max_gradients=spec.max_gradients, seed=spec.seed,
            faults=spec.faults, accuracy_fn=accuracy_fn,
            transport_kind=spec.transport, slab_dtype=spec.slab_dtype,
            optimizer=spec.slab_optimizer(), ckpt_dir=ckpt_dir,
            resume_from=self.resume_from, verbose=self.verbose,
            device=self.device)
        if ckpt_dir is not None and self.ckpt_dir is None:
            runtime.events.append({"t": 0.0,
                                   "event": "ckpt_dir_provisioned",
                                   "path": ckpt_dir})
        return runtime

    def finish(self, runtime: ClusterRuntime,
               spec: ExperimentSpec) -> RunResult:
        """Run a runtime built by :meth:`build_runtime` and adapt the
        result."""
        t0 = time.time()
        cres = runtime.run()
        self.last_params = cres.final_params
        result = RunResult.from_cluster(cres, spec=spec,
                                        wall_s=time.time() - t0)
        name = torch.cuda.get_device_name(self.device) \
            if self.device.type == "cuda" else "cpu"
        result.extra.update(serving=dict(_NO_SERVING),
                            telemetry=cres.telemetry,
                            device=str(self.device), device_name=name)
        return result

    def run(self, spec: ExperimentSpec) -> RunResult:
        return self.finish(self.build_runtime(spec), spec)
