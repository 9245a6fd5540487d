"""Adapter: ExperimentSpec -> wall-clock cluster runtime -> RunResult.

``backend="cluster"`` in :mod:`repro_torch.api`, a port of
``src/repro/cluster/trainer.py``.  ``spec.arch`` names the simulator's
workloads (``mlp``, ``cnn-mnist``, ``cnn-cifar``, or one added with
``register_sim_workload``): one spec re-targets the simulator and the
real concurrent cluster.  ``spec.transport`` is ``inproc`` (worker
threads and a queue), ``socket`` (worker threads over TCP), ``proc``
(worker processes over Unix sockets, computing on the same device) or
``host`` (the leader binds ``spec.listen`` and admits workers started
with ``python -m repro_torch join``, up to ``spec.max_workers``).

The reported ``num_gradients`` is the server's applied-gradient counter,
exactly; ``extra["accounting"]`` carries the conservation ledger
(computed == applied + dropped + buffered + pending + in-flight),
``extra["events"]`` the fault/checkpoint/membership timeline,
``extra["telemetry"]`` the bus's summary with its ``ledger_check``,
``extra["serving"]`` the serving plane's report (the serve and stats
clients a ``host`` leader admitted), on ``proc`` and ``host``
``extra["fleet_ready_s"]`` the seconds from the barrier's start to its
release, on ``host`` ``extra["listen"]`` the resolved ``HOST:PORT``,
and with ``trace=`` ``extra["trace_path"]``, the Chrome trace written
after the run.

On CUDA the trainer turns TF32 off (as the simulator's does) and makes
cuDNN pick deterministic convolution algorithms
(``torch.backends.cudnn.deterministic = True``, ``benchmark = False``),
so a sync run under ``max_gradients`` repeats bit for bit; ``proc``
children copy these switches from the parent, and joiners on the card
set the same ones.
"""
from __future__ import annotations

import tempfile
import time
from typing import Any, Optional, Tuple

import torch

from repro_torch.api.result import RunResult
from repro_torch.api.schedules import parse_schedule
from repro_torch.api.spec import ExperimentSpec
from repro_torch.cluster.mptransport import (CUDA_DETERMINISTIC,
                                             set_torch_flags)
from repro_torch.cluster.runtime import PROC_READY_TIMEOUT_S, ClusterRuntime
from repro_torch.convert import Device, resolve_device
from repro_torch.core.simulator import data_to


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
    once per ``(arch, seed, smoke, zoo_scale)``.  ``join_secret`` makes a ``host``
    leader challenge every JOIN, ``trace`` is the Chrome trace's output
    path and ``prom_port`` the Prometheus endpoint's port (0 picks a
    free one): invocation settings, like the checkpoint directory, never
    spec fields, so they never travel in WELCOME."""

    def __init__(self, ckpt_dir: Optional[str] = None,
                 resume_from: Optional[str] = None, verbose: bool = False,
                 trace: Optional[str] = None,
                 prom_port: Optional[int] = None,
                 join_secret: Optional[str] = None, device: Device = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_torch_flags(CUDA_DETERMINISTIC)
        self.ckpt_dir = ckpt_dir
        self.resume_from = resume_from
        self.verbose = verbose
        self.join_secret = join_secret
        self.trace = trace
        self.prom_port = prom_port
        self.last_params = None
        self._workload: Tuple[Optional[tuple], Any] = (None, None)

    def _build(self, spec: ExperimentSpec):
        from repro_torch.api.trainers import SIM_WORKLOADS

        key = (spec.arch, spec.seed, spec.smoke, spec.zoo_scale)
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
            transport_kind=spec.transport,
            # worker processes and joining hosts rebuild the workload
            # from the spec
            spec_dict=spec.to_dict()
            if spec.transport in ("proc", "host") else None,
            listen=spec.listen, heartbeat_s=spec.heartbeat_s,
            serve_every=spec.serve_every,
            max_workers=spec.max_workers, join_secret=self.join_secret,
            slab_dtype=spec.slab_dtype,
            optimizer=spec.slab_optimizer(),
            # joined hosts are started by hand, perhaps on other
            # machines: the reference gives them ten minutes
            proc_ready_timeout_s=600.0 if spec.transport == "host"
            else PROC_READY_TIMEOUT_S,
            ckpt_dir=ckpt_dir,
            resume_from=self.resume_from, verbose=self.verbose,
            trace=self.trace, prom_port=self.prom_port, device=self.device)
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
        result.extra.update(serving=cres.serving, telemetry=cres.telemetry,
                            device=str(self.device), device_name=name)
        if cres.fleet_ready_s is not None:
            result.extra["fleet_ready_s"] = cres.fleet_ready_s
        if runtime.listen_address is not None:
            bind_host, bind_port = runtime.listen_address
            result.extra["listen"] = f"{bind_host}:{bind_port}"
        if runtime.trace_path:
            from repro_torch.obs import write_chrome_trace
            n = write_chrome_trace(runtime.obs, runtime.trace_path)
            result.extra["trace_path"] = runtime.trace_path
            if self.verbose:
                print(f"[cluster] wrote {n} trace events to "
                      f"{runtime.trace_path}", flush=True)
        return result

    def run(self, spec: ExperimentSpec) -> RunResult:
        return self.finish(self.build_runtime(spec), spec)
