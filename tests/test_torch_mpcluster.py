"""The port's cluster backend on its wire transports, on the CPU
(``spec.transport = "socket" | "proc"``): the cases of
``tests/test_mpcluster.py`` on mlp with 2 workers, and a socket sync
run against the JAX package's ``ClusterTrainer``.

  * the spec round trip, and proc's need for the spec dict;
  * ``socket`` (worker threads over TCP slab frames): the exact ledger
    with the wire bytes it implies, a mid-run restore resyncing over the
    broadcast, and parity with the JAX package;
  * ``proc`` (worker processes over Unix sockets): SIGKILL and respawn
    with an exact ledger and torn frames counted, the sync barrier
    moving through a kill, AdamW through SIGKILL and restore with finite
    moments, final params bitwise equal to ``inproc``'s, and a child
    that cannot open its device failing the barrier.

Each proc run spawns 2 children that import torch and warm a gradient
before the clock starts (seconds each); budgets are a few seconds.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as JaxSpec
from repro.api.trainers import SIM_WORKLOADS as JAX_SIM_WORKLOADS
from repro.cluster.trainer import ClusterTrainer as JaxClusterTrainer
from repro_torch.api import ExperimentSpec, FaultPlan
from repro_torch.api.trainers import register_sim_workload
from repro_torch.checkpoint import latest_step, load_opt_state
from repro_torch.cluster.mptransport import ProcTransport, ProcWorkerConfig
from repro_torch.cluster.runtime import ClusterRuntime
from repro_torch.cluster.trainer import ClusterTrainer
from repro_torch.convert import params_from_numpy

torch.set_num_threads(2)
CPU = "cpu"
# the mlp's slab: 8192 f32 elements.  A HELLO is 5 + 14 bytes on the
# wire, a GRAD 5 + 16 + 4 * 8192
HELLO_BYTES, GRAD_BYTES = 19, 21 + 4 * 8192


def _spec(**kw):
    base = dict(arch="mlp", backend="cluster", mode="hybrid",
                schedule="step:40", cluster_workers=2, wall_budget_s=1.5,
                wall_sample_every_s=0.5, batch=16, smoke=True)
    base.update(kw)
    return ExperimentSpec(**base)


def _run(spec, **trainer_kw):
    return ClusterTrainer(device=CPU, **trainer_kw).run(spec)


def _check_conservation(res):
    a = res.extra["accounting"]
    assert a["computed"] == (a["applied"] + a["dropped"] + a["buffered"]
                             + a["pending_round"] + a["in_flight"]), a
    assert res.num_gradients == a["applied"]
    assert a["computed"] == sum(a["computed_per_worker"].values())
    assert res.extra["telemetry"]["ledger_check"]["consistent"]
    assert a["torn_frames"] >= 0
    return a


def _events(res):
    return [e["event"] for e in res.extra["events"]]


# ---------------------------------------------------------------- spec

def test_spec_transport_field_round_trip():
    spec = _spec(transport="proc")
    assert ExperimentSpec.from_json(spec.to_json()) == spec
    assert JaxSpec.from_json(spec.to_json()).transport == "proc"
    with pytest.raises(ValueError, match="transport"):
        _spec(transport="carrier-pigeon")


def test_proc_runtime_requires_spec_dict():
    """A proc runtime cannot spawn children without the spec they
    rebuild the workload from: it fails at construction."""
    with pytest.raises(ValueError, match="spec_dict"):
        ClusterRuntime(lambda p, x, y: 0.0, None, (None,) * 4,
                       mode="async", transport_kind="proc", device=CPU)


# ------------------------------------------------- socket (threads/TCP)

def test_socket_transport_run_completes_with_exact_ledger():
    """Every gradient crosses TCP: the ledger is exact, and the hub's
    received bytes are exactly one HELLO per connection and one GRAD
    frame per computed gradient."""
    res = _run(_spec(transport="socket"))
    assert res.backend == "cluster" and res.grid_unit == "wall_s"
    a = _check_conservation(res)
    assert a["applied"] > 0 and res.num_updates > 0
    assert a["torn_frames"] == 0
    counters = res.extra["telemetry"]["counters"]
    assert counters["wire.rx_bytes"] == \
        2 * HELLO_BYTES + GRAD_BYTES * a["computed"]
    assert counters["wire.tx_bytes"] > 0
    assert res.extra["serving"]["clients"] == 0


def test_socket_transport_sync_restore_resyncs(tmp_path):
    """A mid-run restore rolls the version backwards over the socket
    broadcast; sync workers resync and the ledger stays exact."""
    spec = _spec(mode="sync", schedule=None, transport="socket",
                 wall_budget_s=2.0,
                 faults=FaultPlan(checkpoint_every_s=0.4,
                                  restore_at_s=1.0))
    res = _run(spec, ckpt_dir=str(tmp_path))
    a = _check_conservation(res)
    kinds = _events(res)
    assert "restore" in kinds and "checkpoint" in kinds
    assert a["applied"] > 0


def _reference_mlp(jspec):
    """The JAX workload's initial params and data, registered in the
    port under a name of its own (the socket transport's workers are
    threads of this process, so they see the registration)."""
    loss, params, data, acc = JAX_SIM_WORKLOADS["mlp"](jspec)
    np_params = jax.tree.map(lambda a: np.array(a, copy=True), params)
    np_data = tuple(np.array(a, copy=True) for a in data)

    def build(spec, device):
        from repro_torch.models.cnn import (accuracy, mlp_clf_forward,
                                            nll_loss)
        return (lambda p, x, y: nll_loss(mlp_clf_forward(p, x), y),
                params_from_numpy(np_params, device), np_data,
                lambda p, x, y: accuracy(mlp_clf_forward(p, x), y))

    register_sim_workload("mlp-jax-init-wire", build, overwrite=True)


def test_socket_sync_run_matches_reference_cluster_trainer():
    """mlp, 2 workers, sync, 20 gradients: the port over TCP from the
    JAX package's initial params ends allclose (rtol 1e-5, atol 1e-6) to
    the JAX ClusterTrainer in process, with the same server ledger."""
    fields = dict(arch="mlp", backend="cluster", mode="sync",
                  schedule=None, cluster_workers=2, wall_budget_s=5.0,
                  wall_sample_every_s=2.5, batch=16, smoke=True,
                  max_gradients=20)
    jspec = JaxSpec(**fields)
    _reference_mlp(jspec)
    jtrainer = JaxClusterTrainer()
    jres = jtrainer.run(jspec)
    trainer = ClusterTrainer(device=CPU)
    res = trainer.run(ExperimentSpec(**{**fields,
                                        "arch": "mlp-jax-init-wire",
                                        "transport": "socket"}))
    _check_conservation(res)
    keys = ("applied", "dropped", "buffered", "pending_round", "updates")
    assert res.num_updates == jres.num_updates == 10
    assert {k: res.extra["accounting"][k] for k in keys} == \
        {k: jres.extra["accounting"][k] for k in keys}
    for key, want in jtrainer.last_params.items():
        np.testing.assert_allclose(trainer.last_params[key].numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-6,
                                   err_msg=key)


# ------------------------------------------------------ proc (processes)

def test_proc_kill_respawn_exact_ledger():
    """A 2-process hybrid run: worker 1 is SIGKILLed mid-run and
    respawned (a fresh process and stream generation); the ledger holds
    to the gradient, with any frame the SIGKILL tore discarded and
    counted."""
    res = _run(_spec(transport="proc", wall_budget_s=3.0,
                     wall_sample_every_s=1.0,
                     faults=FaultPlan(kill=((1, 0.8),),
                                      respawn_after_s=0.4)))
    a = _check_conservation(res)
    assert res.num_gradients == a["applied"] > 0
    kinds = _events(res)
    assert kinds.count("kill") == 1 and kinds.count("respawn") == 1
    kill = next(e for e in res.extra["events"] if e["event"] == "kill")
    assert kill["sigkill"] is True
    assert a["computed_per_worker"]["1"] > 0
    assert res.extra["fleet_ready_s"] > 0


def test_proc_sync_kill_respawn_barrier_keeps_moving():
    """Sync over processes through a SIGKILL: membership follows the
    connection (register on HELLO, deregister when it dies), so rounds
    keep completing with the survivor while the respawn starts up."""
    res = _run(_spec(mode="sync", schedule=None, transport="proc",
                     wall_budget_s=3.0, wall_sample_every_s=1.0,
                     faults=FaultPlan(kill=((1, 0.8),),
                                      respawn_after_s=0.4)))
    a = _check_conservation(res)
    kinds = _events(res)
    assert kinds.count("kill") == 1 and kinds.count("respawn") == 1
    assert a["applied"] > 0 and res.num_updates > 0


def test_proc_adamw_sigkill_restore_finite_moments(tmp_path):
    """AdamW over worker processes takes a SIGKILL and respawn,
    checkpoints on a cadence and restores mid-run: the ledger holds, the
    moments come out finite f32, and the update count persists in the
    checkpoints and advances after the restore."""
    spec = _spec(transport="proc", optimizer="adamw", weight_decay=0.01,
                 wall_budget_s=3.0, wall_sample_every_s=1.0,
                 faults=FaultPlan(kill=((1, 0.8),), respawn_after_s=0.4,
                                  checkpoint_every_s=0.5,
                                  restore_at_s=1.6))
    trainer = ClusterTrainer(ckpt_dir=str(tmp_path), device=CPU)
    runtime = trainer.build_runtime(spec)
    res = trainer.finish(runtime, spec)
    a = _check_conservation(res)
    kinds = _events(res)
    assert "checkpoint" in kinds and "restore" in kinds
    assert kinds.count("kill") == 1 and kinds.count("respawn") == 1
    st = runtime.server.snapshot_opt_state()
    for name in ("mu", "nu"):
        assert st[name].dtype == np.float32
        assert np.isfinite(st[name]).all(), name
    assert st["count"] > 0
    step = latest_step(str(tmp_path))
    on_disk = load_opt_state(str(tmp_path / f"step_{step}"))
    assert on_disk["count"] > 0
    assert np.isfinite(on_disk["mu"]).all() and \
        np.isfinite(on_disk["nu"]).all()
    tel = res.extra["telemetry"]
    assert tel["counters"]["optimizer_steps"] == a["updates"]


def test_proc_bitwise_parity_with_inproc():
    """The same sync spec under a gradient budget with worker threads
    and with worker processes: bitwise equal final params.  Moving the
    workers out of the address space changes the physics, nothing
    else: f32 frames are bitwise, rounds fold in worker-id order, the
    children split their CPU work as the parent does."""
    base = dict(mode="sync", schedule=None, wall_budget_s=30.0,
                wall_sample_every_s=10.0, max_gradients=12)
    finals = {}
    for transport in ("inproc", "proc"):
        trainer = ClusterTrainer(device=CPU)
        res = trainer.run(_spec(transport=transport, **base))
        a = res.extra["accounting"]
        assert a["applied"] == 12 and res.num_updates == 6
        finals[transport] = trainer.last_params
    for key in finals["inproc"]:
        assert torch.equal(finals["inproc"][key], finals["proc"][key]), key


def test_proc_child_without_its_device_fails_the_barrier():
    """A child told to compute on a card it cannot open exits non-zero
    (it never falls back to the CPU), and the hub reports it as dead."""
    hub = ProcTransport(4, device=CPU)
    try:
        cfg = ProcWorkerConfig(spec=_spec(transport="proc").to_dict(),
                               worker_id=0, generation=0, num_workers=1,
                               mode="async", straggle_s=0.0, seed=0,
                               batch=16, device="cuda")
        if torch.cuda.is_available():
            cfg = dataclasses.replace(cfg, device="cuda:99")
        p = hub.spawn_worker(cfg)
        p.join(120)
        assert not p.is_alive() and p.exitcode == 2
        dead = hub.dead_workers()
        assert len(dead) == 1 and "exited with code 2" in dead[0]
        assert hub.live_workers() == set()
    finally:
        hub.close()
