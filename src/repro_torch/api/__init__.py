"""Experiment layer of the port: one spec, one trainer, one CLI.

    from repro_torch.api import ExperimentSpec, run

    spec = ExperimentSpec(arch="cnn-cifar", smoke=False, mode="hybrid",
                          schedule="step:300", horizon=2.0)
    result = run(spec)                  # on cuda; run(spec, "cpu") on a CPU
    print(result.averaged())

A ``backend="spmd"`` spec runs one rank per process: launch it under
``torchrun --nproc-per-node N`` (:mod:`repro_torch.launch.train`).
A ``backend="cluster"`` spec with ``transport="host"`` makes this
process the multi-host leader: it binds ``spec.listen`` and waits for
``python -m repro_torch join HOST:PORT`` workers
(:mod:`repro_torch.cluster.hostlink`).
"""
from repro_torch.api.result import RunResult
from repro_torch.api.schedules import (SCHEDULE_FAMILIES, ScheduleFamily,
                                       parse_schedule, register_schedule,
                                       schedule_help)
from repro_torch.api.spec import (BACKENDS, FLUSH_MODES, MODES, TRANSPORTS,
                                  ExperimentSpec, FaultPlan)
from repro_torch.api.trainers import (SIM_WORKLOADS, TRAINERS,
                                      SimulatorTrainer, SpmdTrainer,
                                      get_trainer, register_sim_workload,
                                      run)

__all__ = [
    "BACKENDS", "MODES", "FLUSH_MODES", "TRANSPORTS", "ExperimentSpec",
    "FaultPlan", "RunResult", "SCHEDULE_FAMILIES", "ScheduleFamily",
    "parse_schedule", "register_schedule", "schedule_help",
    "SimulatorTrainer", "SpmdTrainer", "TRAINERS", "SIM_WORKLOADS",
    "get_trainer", "register_sim_workload", "run",
]
