"""The port's wall-clock cluster backend (``repro_torch.cluster``) on the
CPU: the cases of ``tests/test_cluster.py`` (transport semantics,
FaultPlan and spec round trips, the three policies, stragglers,
kill/respawn, checkpoint/restore, the exact ledger, determinism, the
CLI), the parameter server's cases from ``tests/test_slab.py`` and
``tests/test_transport.py``, and parity with the JAX package's
``ClusterTrainer`` from the same initial params.

Every run is bounded by ``max_gradients`` and a wall budget of at most
2 s; the point is real concurrency and exact accounting, not
convergence.
"""
import json
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as JaxSpec
from repro.api.trainers import SIM_WORKLOADS as JAX_SIM_WORKLOADS
from repro.cluster.trainer import ClusterTrainer as JaxClusterTrainer
from repro_torch.api import ExperimentSpec, FaultPlan, RunResult
from repro_torch.api.trainers import register_sim_workload
from repro_torch.checkpoint import (load_opt_state, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.cluster.faults import parse_fault_pairs
from repro_torch.cluster.runtime import ClusterRuntime
from repro_torch.cluster.server import ParameterServer
from repro_torch.cluster.trainer import ClusterTrainer
from repro_torch.cluster.transport import (GradientMsg, InProcTransport,
                                           ParamsMsg)
from repro_torch.convert import params_from_numpy
from repro_torch.core.schedule import constant_schedule, step_schedule
from repro_torch.optim import SlabOptimizer

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def _cluster_spec(**kw):
    base = dict(arch="mlp", backend="cluster", mode="hybrid",
                schedule="step:40", cluster_workers=3, wall_budget_s=1.2,
                wall_sample_every_s=0.4, batch=16, smoke=True,
                max_gradients=2000)
    base.update(kw)
    return ExperimentSpec(**base)


def _run(spec, **trainer_kw):
    return ClusterTrainer(device=CPU, **trainer_kw).run(spec)


def _check_conservation(res):
    """computed == applied + dropped + buffered + pending_round +
    in_flight, to the gradient; num_gradients is the server's applied
    counter, and the telemetry's cross-check agrees."""
    a = res.extra["accounting"]
    assert a["computed"] == (a["applied"] + a["dropped"] + a["buffered"]
                             + a["pending_round"] + a["in_flight"]), a
    assert res.num_gradients == a["applied"]
    assert a["computed"] == sum(a["computed_per_worker"].values())
    assert res.extra["telemetry"]["ledger_check"]["consistent"]
    return a


# ------------------------------------------------------------ FaultPlan

def test_fault_plan_validation():
    plan = FaultPlan(stragglers=((0, 0.1),), kill=((1, 2.0),),
                     respawn_after_s=0.5)
    assert plan.straggle_s(0) == 0.1 and plan.straggle_s(2) == 0.0
    assert plan.kill_events() == [(2.0, 1)]
    assert not plan.empty and FaultPlan().empty
    assert FaultPlan(stragglers=[[0, 0.1]]) == FaultPlan(
        stragglers=((0, 0.1),))
    with pytest.raises(ValueError, match="stragglers"):
        FaultPlan(stragglers=((-1, 0.1),))
    with pytest.raises(ValueError, match="respawn_after_s"):
        FaultPlan(respawn_after_s=-1.0)


def test_parse_fault_pairs():
    assert parse_fault_pairs("0:0.2, 3:0.5") == ((0, 0.2), (3, 0.5))
    with pytest.raises(ValueError, match="WORKER:SECONDS"):
        parse_fault_pairs("3")
    with pytest.raises(ValueError):
        parse_fault_pairs("a:b")


def test_cluster_spec_json_round_trip():
    spec = _cluster_spec(
        max_gradients=100,
        faults=FaultPlan(stragglers=((0, 0.05),), kill=((1, 0.5),),
                         respawn_after_s=0.25, checkpoint_every_s=0.5))
    back = ExperimentSpec.from_json(spec.to_json())
    assert back == spec
    assert isinstance(back.faults, FaultPlan)
    assert back.faults.kill == ((1, 0.5),)
    # the reference's cluster spec JSON loads in the port and back
    ref = JaxSpec.from_json(spec.to_json())
    assert ExperimentSpec.from_json(ref.to_json()) == spec
    with pytest.raises(ValueError, match="cluster_workers"):
        _cluster_spec(cluster_workers=0)
    with pytest.raises(ValueError, match="max_gradients"):
        _cluster_spec(max_gradients=-1)


# ------------------------------------------------------------ transport

def test_inproc_transport_semantics():
    t = InProcTransport(grad_capacity=2)
    assert t.fetch_params(timeout=0) is None          # nothing published
    t.publish_params(ParamsMsg(3, {"w": 1}))
    assert t.fetch_params(min_version=2, timeout=0).version == 3
    assert t.fetch_params(min_version=4, timeout=0.01) is None  # barrier
    assert t.send_gradient(GradientMsg(0, "g0", 3, 1))
    assert t.send_gradient(GradientMsg(1, "g1", 3, 1))
    assert not t.send_gradient(GradientMsg(2, "g2", 3, 1),
                               timeout=0.01)          # backpressure
    assert t.pending_gradients() == 2
    assert t.recv_gradient(timeout=0).worker_id == 0  # FIFO
    assert t.recv_gradient(timeout=0).worker_id == 1
    assert t.recv_gradient(timeout=0) is None


def test_inproc_timeout_none_blocks_both_sides():
    """``None`` blocks on both sides, ``<= 0`` polls."""
    t = InProcTransport(grad_capacity=1)
    assert t.send_gradient(GradientMsg(0, "g0", 0, 1))
    done = []
    th = threading.Thread(
        target=lambda: done.append(
            t.send_gradient(GradientMsg(0, "g1", 0, 2))),  # timeout=None
        daemon=True)
    th.start()
    th.join(0.2)
    assert th.is_alive(), "send_gradient(timeout=None) must block"
    assert t.recv_gradient(timeout=0).seq == 1     # make room
    th.join(2.0)
    assert not th.is_alive() and done == [True]
    out = []
    th = threading.Thread(target=lambda: out.append(t.recv_gradient()),
                          daemon=True)
    th.start()
    th.join(0.2)
    assert not th.is_alive() and out[0].seq == 2   # g1 was waiting
    th = threading.Thread(target=lambda: out.append(t.recv_gradient()),
                          daemon=True)
    th.start()
    th.join(0.2)
    assert th.is_alive(), "recv_gradient(timeout=None) must block"
    t.send_gradient(GradientMsg(0, "g2", 0, 3))
    th.join(2.0)
    assert not th.is_alive() and out[1].seq == 3
    assert t.recv_gradient(timeout=0) is None
    assert t.recv_gradient(timeout=-1) is None


def test_server_death_never_strands_workers(monkeypatch):
    """If the server dies mid-run, shutdown still reaches every worker's
    stop event: none is left in the bounded-send retry loop."""
    def boom(self, msg):
        raise RuntimeError("server died mid-ingest")

    monkeypatch.setattr(ParameterServer, "ingest", boom)
    with pytest.raises(RuntimeError, match="server died mid-ingest"):
        _run(_cluster_spec(wall_budget_s=2.0))
    deadline = time.time() + 5.0
    while time.time() < deadline:
        alive = [t.name for t in threading.enumerate()
                 if t.name.startswith("worker-") and t.is_alive()]
        if not alive:
            break
        time.sleep(0.05)
    assert not alive, f"workers outlived the dead server: {alive}"


# ------------------------------------------------- the three policies

@pytest.mark.parametrize("mode,schedule", [
    ("async", None), ("sync", None), ("hybrid", "step:40"),
])
def test_cluster_policies_produce_wall_clock_runresult(mode, schedule):
    res = _run(_cluster_spec(mode=mode, schedule=schedule))
    assert res.backend == "cluster" and res.grid_unit == "wall_s"
    assert set(res.metrics) == {"train_loss", "test_loss", "test_acc"}
    assert len(res.grid) >= 2
    assert res.grid == tuple(sorted(res.grid))
    for series in res.metrics.values():
        assert len(series) == len(res.grid)
    assert res.num_updates > 0 and res.num_gradients > 0
    avg = res.averaged()
    assert set(avg) == set(res.metrics)
    assert all(np.isfinite(v) for v in avg.values())
    assert res.schedule == (schedule if mode == "hybrid" else None)
    _check_conservation(res)
    assert res.extra["serving"]["clients"] == 0
    assert res.extra["device"] == "cpu"
    assert RunResult.from_json(res.to_json()) == res


def test_cluster_hybrid_more_grads_than_updates():
    """Once K(t) > 1 the hybrid folds several gradients per update."""
    res = _run(_cluster_spec(schedule="step:10"))
    assert res.num_gradients > res.num_updates > 0
    _check_conservation(res)


def test_unknown_cluster_workload():
    with pytest.raises(ValueError, match="unknown cluster workload"):
        _run(_cluster_spec(arch="resnet"))


def _scrape(url: str):
    import urllib.request
    with urllib.request.urlopen(url, timeout=5.0) as r:
        return r.status, r.read().decode("utf-8")


def _applied_total(text: str) -> int:
    (line,) = [ln for ln in text.splitlines()
               if ln.startswith("repro_grads_applied_total ")]
    return int(line.split()[1])


@pytest.mark.parametrize("transport", ["host"])
def test_wire_transports_refused_naming_a10(transport, tmp_path):
    """The host transport runs (tests/test_torch_hostlink.py); what it
    refuses is the reference's: a respawn (the leader does not own the
    remote machine) and, off host, an elastic ceiling.  The trace and
    Prometheus exports run: ``trace=`` writes the Chrome trace, and
    ``prom_port=0`` serves ``/metrics`` while the run lasts."""
    with pytest.raises(ValueError, match="cannot respawn"):
        _run(_cluster_spec(transport=transport,
                           faults=FaultPlan(kill=((1, 0.5),),
                                            respawn_after_s=0.2)))
    with pytest.raises(ValueError, match="max_workers"):
        ClusterRuntime(lambda p, x, y: 0.0, None, (None,) * 4,
                       mode="async", max_workers=4, device=CPU)
    trace = tmp_path / "t.json"
    trainer = ClusterTrainer(device=CPU, trace=str(trace), prom_port=0)
    spec = _cluster_spec(wall_budget_s=2.0, max_gradients=None)
    runtime = trainer.build_runtime(spec)
    box = {}
    th = threading.Thread(
        target=lambda: box.update(res=trainer.finish(runtime, spec)),
        daemon=True)
    th.start()
    deadline = time.monotonic() + 10.0
    while runtime.prom_server is None:
        assert time.monotonic() < deadline, "no Prometheus endpoint"
        time.sleep(0.02)
    scrapes = [_scrape(runtime.prom_server.url) for _ in range(2)]
    th.join(timeout=30.0)
    assert not th.is_alive()
    assert [status for status, _ in scrapes] == [200, 200]
    first, second = (_applied_total(text) for _, text in scrapes)
    assert 0 <= first <= second
    res = box["res"]
    _check_conservation(res)
    assert res.extra["trace_path"] == str(trace)
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"flush", "publish", "grad_compute"} <= names


# ------------------------------------------------------ fault injection

def test_cluster_straggler_slows_one_worker():
    res = _run(_cluster_spec(
        mode="async", schedule=None,
        faults=FaultPlan(stragglers=((0, 0.2),))))
    a = _check_conservation(res)
    per = a["computed_per_worker"]
    straggler, healthy = per["0"], max(per["1"], per["2"])
    assert straggler < healthy / 3, per


def test_cluster_hybrid_kill_and_respawn_completes():
    res = _run(_cluster_spec(
        wall_budget_s=2.0,
        faults=FaultPlan(kill=((1, 0.6),), respawn_after_s=0.3)))
    a = _check_conservation(res)
    assert res.num_gradients == a["applied"] > 0
    kinds = [e["event"] for e in res.extra["events"]]
    assert kinds.count("kill") == 1 and kinds.count("respawn") == 1
    assert a["computed_per_worker"]["1"] > 0


def test_cluster_sync_mid_run_restore_keeps_accounting(tmp_path):
    """A mid-run restore rolls the version back; sync workers resync to
    the restored round, and every gradient stays accounted."""
    spec = _cluster_spec(
        mode="sync", schedule=None, wall_budget_s=2.0,
        faults=FaultPlan(checkpoint_every_s=0.4, restore_at_s=1.0))
    res = _run(spec, ckpt_dir=str(tmp_path))
    a = _check_conservation(res)
    kinds = [e["event"] for e in res.extra["events"]]
    assert "restore" in kinds and "checkpoint" in kinds
    restore_t = next(e["t"] for e in res.extra["events"]
                     if e["event"] == "restore")
    assert restore_t < res.wall_s
    assert a["applied"] > 0


def test_cluster_adamw_restore_reloads_moments(tmp_path):
    """AdamW moments and count ride the checkpoint through a mid-run
    restore, and the run's ledger stays exact."""
    spec = _cluster_spec(
        optimizer="adamw", wall_budget_s=1.6,
        faults=FaultPlan(checkpoint_every_s=0.3, restore_at_s=0.8))
    res = _run(spec, ckpt_dir=str(tmp_path))
    _check_conservation(res)
    kinds = [e["event"] for e in res.extra["events"]]
    assert "restore" in kinds
    step = next(e["step"] for e in res.extra["events"]
                if e["event"] == "restore")
    st = load_opt_state(str(tmp_path / f"step_{step}"))
    assert st is not None and st["count"] == step > 0
    assert np.isfinite(st["mu"]).all() and np.isfinite(st["nu"]).all()


def test_cluster_fault_worker_ids_validated():
    with pytest.raises(ValueError, match="worker ids"):
        _run(_cluster_spec(faults=FaultPlan(kill=((7, 0.5),))))
    with pytest.raises(ValueError, match="worker ids"):
        _run(_cluster_spec(faults=FaultPlan(stragglers=((3, 0.1),))))


def test_cluster_overlapping_kills_fire_on_time():
    res = _run(_cluster_spec(
        wall_budget_s=2.0,
        faults=FaultPlan(kill=((0, 0.4), (1, 0.6)),
                         respawn_after_s=0.5)))
    _check_conservation(res)
    events = [(e["event"], e.get("worker")) for e in res.extra["events"]]
    assert events == [("kill", 0), ("kill", 1),
                      ("respawn", 0), ("respawn", 1)], events


def test_cluster_checkpoint_plan_requires_ckpt_dir():
    with pytest.raises(ValueError, match="ckpt_dir"):
        ClusterRuntime(lambda p, x, y: 0.0, None, (None,) * 4,
                       mode="async",
                       faults=FaultPlan(checkpoint_every_s=0.5))
    res = _run(_cluster_spec(faults=FaultPlan(checkpoint_every_s=0.4)))
    kinds = [e["event"] for e in res.extra["events"]]
    assert "ckpt_dir_provisioned" in kinds and "checkpoint" in kinds
    _check_conservation(res)


def test_cluster_sync_survives_worker_kill_without_respawn():
    res = _run(_cluster_spec(
        mode="sync", schedule=None, wall_budget_s=1.6,
        faults=FaultPlan(kill=((2, 0.4),))))
    _check_conservation(res)
    assert [e["event"] for e in res.extra["events"]] == ["kill"]
    assert res.num_updates > 0


# ------------------------------------------------- determinism guards

def test_cluster_async_accounting_deterministic():
    spec = _cluster_spec(mode="async", schedule=None, max_gradients=40,
                         wall_budget_s=2.0)
    first, second = _run(spec), _run(spec)
    for res in (first, second):
        a = _check_conservation(res)
        assert res.num_gradients == 40 == a["applied"]
    assert first.num_updates == second.num_updates


def test_cluster_sync_bitwise_reproducible():
    """Per-worker batch streams are deterministic, rounds aggregate in
    worker-id order, and the gradient budget pins the round count."""
    spec = _cluster_spec(mode="sync", schedule=None, max_gradients=30,
                         wall_budget_s=2.0)
    finals = []
    for _ in range(2):
        trainer = ClusterTrainer(device=CPU)
        res = trainer.run(spec)
        assert res.num_updates == 10      # 10 rounds of 3 workers
        finals.append(trainer.last_params)
    for key in finals[0]:
        assert torch.equal(finals[0][key], finals[1][key]), key


# ------------------------------------------------ parity with the JAX one

def _reference_mlp(jspec):
    """The JAX workload's initial params and data, registered in the
    port under a name of its own."""
    loss, params, data, acc = JAX_SIM_WORKLOADS["mlp"](jspec)
    np_params = jax.tree.map(lambda a: np.array(a, copy=True), params)
    np_data = tuple(np.array(a, copy=True) for a in data)

    def build(spec, device):
        from repro_torch.models.cnn import (accuracy, mlp_clf_forward,
                                            nll_loss)
        return (lambda p, x, y: nll_loss(mlp_clf_forward(p, x), y),
                params_from_numpy(np_params, device), np_data,
                lambda p, x, y: accuracy(mlp_clf_forward(p, x), y))

    register_sim_workload("mlp-jax-init", build, overwrite=True)


def test_sync_run_matches_reference_cluster_trainer():
    """mlp, 3 workers, sync, 30 gradients on the CPU, from the JAX
    package's initial params: the port's final params are allclose to
    the JAX ClusterTrainer's (rtol 1e-5, atol 1e-6) with the same
    updates and server ledger, and two port runs are bitwise equal."""
    fields = dict(arch="mlp", backend="cluster", mode="sync",
                  schedule=None, cluster_workers=3, wall_budget_s=2.0,
                  wall_sample_every_s=0.5, batch=16, smoke=True,
                  max_gradients=30)
    jspec = JaxSpec(**fields)
    _reference_mlp(jspec)
    jtrainer = JaxClusterTrainer()
    jres = jtrainer.run(jspec)
    spec = ExperimentSpec(**{**fields, "arch": "mlp-jax-init"})
    finals, results = [], []
    for _ in range(2):
        trainer = ClusterTrainer(device=CPU)
        results.append(trainer.run(spec))
        finals.append(trainer.last_params)
    server_keys = ("applied", "dropped", "buffered", "pending_round",
                   "updates")
    for res in results:
        _check_conservation(res)
        assert res.num_updates == jres.num_updates == 10
        assert {k: res.extra["accounting"][k] for k in server_keys} == \
            {k: jres.extra["accounting"][k] for k in server_keys}
    for key, want in jtrainer.last_params.items():
        np.testing.assert_allclose(finals[0][key].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
        assert torch.equal(finals[0][key], finals[1][key]), key


# --------------------------------------------- the server, without threads

def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"b": torch.from_numpy(scale * rng.normal(size=(5,))
                                  .astype(np.float32)),
            "w": torch.from_numpy(scale * rng.normal(size=(7, 3))
                                  .astype(np.float32))}


class _CellTransport:
    """Minimal transport stub: remembers the published params."""

    def __init__(self):
        self.published = []

    def publish_params(self, msg: ParamsMsg):
        self.published.append(msg)


def _server(mode="hybrid", num_workers=3, schedule=None, **kw):
    params = _tree(0)
    if mode in ("async", "hybrid") and schedule is None:
        schedule = constant_schedule(num_workers,
                                     1 if mode == "async" else 2)
    return params, ParameterServer(
        params, lr=0.05, mode=mode, transport=_CellTransport(),
        num_workers=num_workers, schedule=schedule, **kw)


def test_snapshot_survives_continued_flushes():
    params, server = _server(mode="async", num_workers=2)
    codec = server.codec
    grads = [codec.encode(_tree(i + 1, 0.01)) for i in range(4)]
    for i in range(3):
        server.ingest(GradientMsg(0, grads[i], server.version, i))
    version, snap, applied = server.snapshot()
    held = {k: v.clone() for k, v in snap.items()}
    for i in range(40):
        server.ingest(GradientMsg(0, grads[i % 4], server.version, i))
    for k in held:
        assert torch.equal(snap[k], held[k]), k
    _, now, _ = server.snapshot()
    assert any(not torch.equal(held[k], now[k]) for k in held)
    assert version == 3 and applied == 3


def test_restore_wipes_nonfinite_staged_gradients():
    """Diverged gradients in the buffer when a restore discards them must
    not poison later flushes (0 · inf = nan), so discard wipes."""
    schedule = step_schedule(3, 1)       # K(v) = 1 + v
    params, server = _server(mode="hybrid", num_workers=3,
                             schedule=schedule)
    codec = server.codec
    g = _tree(2, 0.01)
    for i in range(3):
        server.ingest(GradientMsg(i, codec.encode(g), server.version, i))
    assert server.version == 2 and len(server.buffer) == 0
    bad = {k: torch.full_like(v, float("inf")) for k, v in g.items()}
    for i in range(2):
        server.ingest(GradientMsg(i, codec.encode(bad), server.version,
                                  3 + i))
    assert len(server.buffer) == 2
    server.restore(params, step=0)
    assert server.dropped == 2
    server.ingest(GradientMsg(0, codec.encode(g), server.version, 5))
    _, got, _ = server.snapshot()
    for name in params:
        want = params[name] - server.lr * g[name]
        assert torch.isfinite(got[name]).all(), name
        torch.testing.assert_close(got[name], want, rtol=1e-6, atol=1e-7)


def test_hybrid_schedule_larger_than_fleet_does_not_overflow_staging():
    schedule = step_schedule(5, 1)         # K(t) can demand up to 5
    params, server = _server(mode="hybrid", num_workers=2,
                             schedule=schedule)
    codec = server.codec
    for i in range(20):
        server.ingest(GradientMsg(i % 2, codec.encode(_tree(i, 0.01)),
                                  server.version, i))
    assert server.applied == 20 and len(server.buffer) == 0
    assert server.agg.k_max == 5


def test_async_flushes_every_gradient_regardless_of_schedule():
    params, server = _server(mode="async", num_workers=3,
                             schedule=step_schedule(3, 1))
    codec = server.codec
    for i in range(6):
        server.ingest(GradientMsg(i % 3, codec.encode(_tree(i, 0.01)),
                                  server.version, i))
    assert server.applied == server.version == 6
    assert server.agg.k_max == 1


def test_moments_stay_f32_under_bf16_slab():
    opt = SlabOptimizer("adamw", beta1=0.9, beta2=0.95)
    params, server = _server(mode="async", num_workers=2,
                             slab_dtype="bf16", optimizer=opt)
    codec = server.codec
    assert server.agg.params_slab.dtype == torch.bfloat16
    for i in range(4):
        server.ingest(GradientMsg(i % 2, codec.encode(_tree(i, 0.01)),
                                  server.version, i))
    assert all(c.dtype == torch.float32
               for m in server.agg._moments.values() for c in m)
    st = server.agg.opt_state_host()
    for name in opt.moment_names:
        assert st[name].dtype == np.float32 and np.isfinite(st[name]).all()
    assert st["count"] == 4


def test_opt_state_checkpoint_round_trip_resumes_bitwise(tmp_path):
    """Checkpoint mid-run with adamw, restore into a fresh server and
    continue: bitwise the uninterrupted trajectory."""
    opt = SlabOptimizer("adamw", beta1=0.9, beta2=0.95, weight_decay=0.01)
    params, server_a = _server(mode="async", num_workers=2, optimizer=opt)
    codec = server_a.codec
    grads = [codec.encode(_tree(50 + i, 0.01)) for i in range(6)]
    for i in range(3):
        server_a.ingest(GradientMsg(i % 2, grads[i], server_a.version, i))
    version, snap, _, opt_state = server_a.snapshot_for_checkpoint()
    assert opt_state["count"] == 3
    path = str(tmp_path / f"step_{version}")
    save_checkpoint(path, snap, version, opt_state=opt_state)
    _, server_b = _server(mode="async", num_workers=2, optimizer=opt)
    r_params, r_step = restore_checkpoint(path, like=params)
    r_opt = load_opt_state(path)
    assert r_opt is not None and r_opt["count"] == 3
    server_b.restore(r_params, r_step, opt_state=r_opt)
    for i in range(3, 6):
        for s in (server_a, server_b):
            s.ingest(GradientMsg(i % 2, grads[i], s.version, i))
    _, got_a, _ = server_a.snapshot()
    _, got_b, _ = server_b.snapshot()
    for name in params:
        assert torch.equal(got_a[name], got_b[name]), name
    st_a, st_b = server_a.agg.opt_state_host(), server_b.agg.opt_state_host()
    assert st_a["count"] == st_b["count"] == 6
    for mname in opt.moment_names:
        np.testing.assert_array_equal(st_a[mname], st_b[mname])


def test_old_checkpoint_without_opt_state_restores_zero_moments(tmp_path):
    opt = SlabOptimizer("momentum", beta1=0.9)
    params, server = _server(mode="async", num_workers=2, optimizer=opt)
    codec = server.codec
    for i in range(3):
        server.ingest(GradientMsg(i % 2, codec.encode(_tree(i, 0.01)),
                                  server.version, i))
    path = str(tmp_path / "step_0")
    save_checkpoint(path, params, 0)
    assert load_opt_state(path) is None
    server.restore(params, 0, opt_state=load_opt_state(path))
    st = server.agg.opt_state_host()
    assert st["count"] == 0 and not np.any(st["mu"])


def _churn_server(mode, num_workers, schedule=None):
    params = {"b": torch.zeros(4), "w": torch.arange(8, dtype=torch.float32)}
    return ParameterServer(params, lr=0.05, mode=mode,
                           transport=InProcTransport(grad_capacity=16),
                           num_workers=num_workers, schedule=schedule)


def _grad(server, fill):
    return server.codec.encode({"b": torch.full((4,), fill),
                                "w": torch.full((8,), 2.0 * fill)})


def test_sync_round_completes_after_mid_round_worker_death():
    server = _churn_server("sync", 3)
    for w in range(3):
        server.register(w)
    server.ingest(GradientMsg(0, _grad(server, 0.1), 0, 1))
    server.ingest(GradientMsg(1, _grad(server, 0.2), 0, 1))
    assert server.version == 0
    server.deregister(2)
    assert server.version == 1
    acct = server.accounting()
    assert acct["applied"] == 2 and acct["pending_round"] == 0
    assert acct["dropped"] == 0


def test_sync_grow_mid_round_bitwise_and_ledger_exact():
    """A fleet seeded at 2 that grows to 4 mid-round gives bitwise the
    params of a fleet of 4 from the start; a stale replay after a
    shrink is dropped and accounted."""
    fixed, grown = _churn_server("sync", 4), _churn_server("sync", 2)
    g = [_grad(fixed, 0.1 * (w + 1)) for w in range(4)]
    for w in range(4):
        fixed.register(w)
    for w in range(2):
        grown.register(w)
    grown.ingest(GradientMsg(0, g[0], 0, 1))
    grown.grow_fleet(4)
    grown.register(2)
    grown.register(3)
    assert grown.version == 0
    for w in range(1, 4):
        grown.ingest(GradientMsg(w, g[w], 0, 1))
    for w in range(4):
        fixed.ingest(GradientMsg(w, g[w], 0, 1))
    assert fixed.version == 1 and grown.version == 1
    assert torch.equal(grown.agg.params_slab, fixed.agg.params_slab)
    grown.deregister(3)
    grown.ingest(GradientMsg(3, g[3], 0, 2))        # stale replay
    grown.register(3)
    for w in range(4):
        grown.ingest(GradientMsg(w, g[w], 1, 2))
    assert grown.version == 2
    acct = grown.accounting()
    assert 4 + 1 + 4 == (acct["applied"] + acct["dropped"]
                         + acct["buffered"] + acct["pending_round"])
    assert acct["applied"] == 8 and acct["dropped"] == 1


def test_hybrid_grow_mid_buffer_preserves_staged_rows():
    fixed = _churn_server("hybrid", 4, constant_schedule(4, 3))
    grown = _churn_server("hybrid", 2, constant_schedule(2, 2))
    g = [_grad(fixed, 0.3 * (w + 1)) for w in range(3)]
    grown.ingest(GradientMsg(0, g[0], 0, 1))
    assert grown.version == 0 and len(grown.buffer) == 1
    grown.grow_fleet(4, constant_schedule(4, 3))
    grown.ingest(GradientMsg(1, g[1], 0, 1))
    grown.ingest(GradientMsg(2, g[2], 0, 1))
    for w in range(3):
        fixed.ingest(GradientMsg(w, g[w], 0, 1))
    assert fixed.version == 1 and grown.version == 1
    assert torch.equal(grown.agg.params_slab, fixed.agg.params_slab)
    acct = grown.accounting()
    assert acct["applied"] == 3 and acct["buffered"] == 0


# ----------------------------------------------------------------- CLI

def test_cli_cluster_run_with_faults(tmp_path):
    out = str(tmp_path / "res.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch", "run", "--backend", "cluster",
         "--transport", "inproc", "--arch", "mlp", "--device", "cpu",
         "--cluster-workers", "3", "--wall-budget", "1.5",
         "--wall-sample-every", "0.5", "--max-gradients", "2000",
         "--mode", "hybrid", "--schedule", "step:40", "--straggler",
         "0:0.1", "--quiet", "--out", out],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    res = RunResult.from_json(open(out).read())
    assert res.backend == "cluster" and res.grid_unit == "wall_s"
    assert res.spec["faults"]["stragglers"] == [[0, 0.1]]
    _check_conservation(res)
    summary = json.loads(p.stdout)
    assert summary["num_gradients"] == res.num_gradients


def test_cli_cluster_wire_transport_refused(monkeypatch, capsys):
    """What the CLI refuses on the host transport, readably and with
    exit 2: a respawn, an elastic ceiling off host, and ``serve
    --listen`` with another transport."""
    from repro_torch.api.cli import main
    assert main(["run", "--backend", "cluster", "--transport", "host",
                 "--kill", "1:1", "--respawn-after", "0.5",
                 "--device", "cpu", "--quiet"]) == 2
    assert "cannot respawn" in capsys.readouterr().err
    assert main(["run", "--backend", "cluster", "--transport", "proc",
                 "--max-workers", "4", "--device", "cpu",
                 "--quiet"]) == 2
    assert "max_workers" in capsys.readouterr().err
    assert main(["serve", "--listen", "127.0.0.1:0", "--transport",
                 "proc", "--device", "cpu"]) == 2
    assert "--listen" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["run", "--backend", "cluster", "--quiet"])


def test_threads_share_the_gradient_function():
    """torch.func.grad from many threads at once gives each thread the
    gradient a single thread computes (the workers share one grad_fn)."""
    from repro_torch.models.cnn import init_mlp_clf, mlp_clf_forward, \
        nll_loss
    params = init_mlp_clf(torch.Generator().manual_seed(0))
    grad_fn = torch.func.grad(
        lambda p, x, y: nll_loss(mlp_clf_forward(p, x), y))
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.normal(size=(16, 20)).astype(np.float32))
          for _ in range(8)]
    ys = [torch.from_numpy(rng.integers(0, 10, 16)) for _ in range(8)]
    want = [grad_fn(params, x, y) for x, y in zip(xs, ys)]
    got = [None] * 8
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(i):
            for _ in range(20):
                got[i] = grad_fn(params, xs[i], ys[i])
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    for w, g in zip(want, got):
        for k in w:
            assert torch.equal(w[k], g[k]), k


@pytest.mark.parametrize("generation", [0, 1])
def test_shard_batches_match_reference(generation):
    """The same (seed, worker_id, generation) draws the same batches in
    both packages, and the runtime's device gather takes the same rows."""
    from repro.data.pipeline import shard_iterator as jax_shard_iterator
    from repro_torch.data.pipeline import (shard_indices, shard_iterator,
                                           worker_shards)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(101, 3)).astype(np.float32)
    y = rng.integers(0, 10, 101)
    for wid in range(4):
        ref = jax_shard_iterator(x, y, wid, 4, 8, seed=5,
                                 generation=generation)
        ours = shard_iterator(x, y, wid, 4, 8, seed=5,
                              generation=generation)
        idx = shard_indices(101, wid, 4, 8, seed=5, generation=generation)
        for _ in range(3):
            (rx, ry), (tx, ty), take = next(ref), next(ours), next(idx)
            np.testing.assert_array_equal(tx, rx)
            np.testing.assert_array_equal(ty, ry)
            np.testing.assert_array_equal(x[take], rx)
            assert set(take) <= set(worker_shards(101, 4)[wid])
