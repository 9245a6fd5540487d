"""The port's SPMD backend against the reference's.

The pieces (``token_stream``, ``merge_replicas_slab``, ``make_train_step``,
the rank layout) are held on the same inputs in one process.  The
driver runs under ``torchrun --standalone`` (a free rendezvous port)
with gloo ranks on the CPU, one intra-op thread each, against the
reference's ``run_training`` in a child process with as many forced host
devices.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as JaxSpec
from repro.checkpoint import save_checkpoint as ref_save_checkpoint
from repro.configs.registry import get_config as ref_get_config
from repro.configs.registry import smoke_variant as ref_smoke_variant
from repro.core import spmd_hybrid as ref
from repro.data.synthetic import token_stream as ref_token_stream
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import model as RM
from repro.optim import sgd as ref_sgd
from repro_torch.api import ExperimentSpec, SpmdTrainer
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import spmd_hybrid as port
from repro_torch.data.pipeline import rank_rows, shard_batch
from repro_torch.data.synthetic import token_stream
from repro_torch.launch.mesh import (Collectives, collective_backend,
                                     replica_groups)
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import run_training
from repro_torch.optim.optimizers import sgd

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
RTOL, ATOL = 1e-5, 1e-6
TIMEOUT = 300


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu", **extra)
    return env


def _torchrun(nproc: int, *args) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(nproc), *args]


def _finish(proc: subprocess.Popen, what: str) -> str:
    out, _ = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, f"{what} exited {proc.returncode}:\n" \
        + out[-4000:]
    return out


def _start(cmd, env) -> subprocess.Popen:
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ------------------------------------------------------------- the pieces

@pytest.mark.parametrize("seed,vocab,batch,seq", [(0, 512, 4, 16),
                                                  (3, 50304, 8, 33)])
def test_token_stream_equals_reference(seed, vocab, batch, seq):
    ours, theirs = token_stream(seed, vocab, batch, seq), \
        ref_token_stream(seed, vocab, batch, seq)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes()


@pytest.mark.parametrize("world,R", [(2, 2), (2, 1), (4, 4), (4, 2),
                                     (4, 1), (8, 2)])
def test_rank_rows_are_the_reference_mesh_positions(world, R):
    """Rank k takes the rows ``_shard_batch_R`` places on mesh position
    (rep k // g, data k % g), and group r holds ranks [r*g, (r+1)*g)."""
    g = world // R
    assert replica_groups(world, R) == \
        np.arange(world).reshape(R, g).tolist()
    x = np.arange(world * 3 * 5).reshape(world * 3, 5)
    placed = x.reshape(R, x.shape[0] // R, 5).reshape(R, g, 3, 5)
    for k in range(world):
        np.testing.assert_array_equal(x[rank_rows(x.shape[0], k, world)],
                                      placed[k // g, k % g])
        got = shard_batch({"tokens": x}, k, world, torch.device("cpu"))
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      placed[k // g, k % g])
    with pytest.raises(ValueError, match="replica groups"):
        replica_groups(world, 3)


def test_collective_backend_follows_the_layout():
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert collective_backend(cpu, 2, 0) == "gloo"
    assert collective_backend(card, 4, 1) == "gloo"   # four ranks, a card
    assert collective_backend(card, 4, 4) == "nccl"   # a card each
    assert collective_backend(card, 1, 1) == "nccl"


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_merge_replicas_slab_matches_reference(alpha):
    rng = np.random.default_rng(int(alpha * 10))
    R = 4
    tree = {"a": rng.normal(size=(R, 33, 7)).astype(np.float32),
            "b": {"c": rng.normal(size=(R, 129)).astype(np.float32)},
            "d": rng.normal(size=(R,)).astype(np.float32)}
    theirs = ref.merge_replicas_slab(jax.tree.map(jnp.asarray, tree),
                                     alpha=alpha, use_pallas=False)
    ours = port.merge_replicas_slab(params_from_numpy(tree), alpha=alpha)
    for (path, got), (_, want) in zip(
            _flat(params_to_numpy(ours)),
            _flat(jax.tree.map(np.asarray, theirs))):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=path)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                       f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _flat(v, f"{prefix}/{i}")]
    return [(prefix, np.asarray(tree))]


def test_make_train_step_microbatch_matches_reference():
    """Two micro-batches of h2o-danube-1.8b's smoke variant, summed in
    float32, then an SGD step: loss and params as the reference's."""
    rcfg = ref_smoke_variant(ref_get_config("h2o-danube-1.8b"))
    cfg = smoke_variant(get_config("h2o-danube-1.8b"))
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    batch = next(ref_token_stream(0, rcfg.vocab_size, 4, 16))
    ref_step = jax.jit(ref_make_train_step(rcfg, ref_sgd(0.1),
                                           microbatch=2))
    opt = ref_sgd(0.1)
    p_ref, _, l_ref = ref_step(params, opt.init(params), batch)
    ours = make_train_step(cfg, sgd(0.1), microbatch=2)
    p0 = params_from_numpy(jax.tree.map(np.asarray, params))
    p1, _, loss, _ = ours(p0, sgd(0.1).init(p0),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(l_ref), rtol=RTOL)
    for (path, got), (_, want) in zip(
            _flat(params_to_numpy(p1)),
            _flat(jax.tree.map(np.asarray, p_ref))):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=path)


def test_spmd_trainer_without_a_process_group_keeps_one_replica():
    spec = ExperimentSpec(backend="spmd", arch="xlstm-350m", smoke=True,
                          mode="hybrid", schedule="step:1", steps=3,
                          batch=2, seq=8, log_every=1)
    res = SpmdTrainer(device="cpu", verbose=False).run(spec)
    assert res.backend == "spmd" and res.grid == (0.0, 1.0, 2.0)
    assert set(res.metrics["replicas"]) == {1.0}
    assert set(res.metrics["group_size"]) == {1.0}
    assert set(res.metrics["divergence"]) == {0.0}
    assert (res.num_updates, res.num_gradients) == (3, 3)
    assert res.extra["world_size"] == 1
    assert res.extra["collective_s"] == [0.0]
    assert [m["K"] for m in res.extra["merges"]] == [1]
    assert all(np.isfinite(res.metrics["loss"]))


def test_collective_seconds_split_by_kind():
    """``Collectives.timing`` files each staged collective's host seconds
    under its label; the total stays their sum."""
    comm = Collectives(torch.device("cpu"))
    t = torch.zeros(4)
    with comm.timing("merge"):
        comm._staged(t, lambda x: time.sleep(0.01))
        with comm.timing("gradient"):
            comm._staged(t, lambda x: time.sleep(0.01))
    comm._staged(t, lambda x: None)
    assert set(comm.seconds_by) == {"merge", "gradient", "other"}
    assert comm.seconds_by["merge"] >= 0.01
    assert comm.seconds_by["gradient"] >= 0.01
    assert comm.seconds == pytest.approx(sum(comm.seconds_by.values()))


def test_mesh_model_is_refused_naming_the_roadmap_item():
    # a frontend has no tensor-parallel form (every other family has)
    spec = ExperimentSpec(backend="spmd", arch="hubert-xlarge", smoke=True,
                          mesh_model=2, steps=1, batch=2, seq=8)
    with pytest.raises(ValueError, match="mesh_model=2.*A16"):
        run_training(spec, verbose=False, device="cpu")


# -------------------------------------------------------- the driver, W=2

_REF_SCRIPT = """
    import json, sys
    import numpy as np
    from repro.api import ExperimentSpec
    from repro.checkpoint import save_checkpoint
    from repro.launch.train import run_training
    spec = ExperimentSpec.from_json(open(sys.argv[1]).read())
    params, history, stats = run_training(spec, verbose=False)
    save_checkpoint(sys.argv[2], params, spec.steps)
    with open(sys.argv[2] + ".run.json", "w") as f:
        json.dump({"history": history, "stats": stats}, f)
"""

_PORT_SCRIPT = """
    import json, sys
    import torch
    from repro_torch.api.spec import ExperimentSpec
    from repro_torch.checkpoint.ckpt import (restore_checkpoint,
                                             save_checkpoint)
    from repro_torch.configs.registry import get_config, smoke_variant
    from repro_torch.convert import params_to_numpy
    from repro_torch.launch.train import run_training
    from repro_torch.models import model as M
    spec = ExperimentSpec.from_json(open(sys.argv[1]).read())
    like = M.init_params(torch.Generator().manual_seed(0),
                         smoke_variant(get_config(spec.arch)))
    init, _ = restore_checkpoint(sys.argv[2], like)
    params, history, stats = run_training(spec, verbose=False,
                                          device="cpu",
                                          params=params_to_numpy(init))
    if params is not None:
        save_checkpoint(sys.argv[3], params, spec.steps)
        with open(sys.argv[3] + ".run.json", "w") as f:
            json.dump({"history": history, "stats": stats}, f)
"""


def test_run_training_matches_reference_on_two_ranks(tmp_path):
    """h2o-danube-1.8b smoke, float32, hybrid step:2 over 6 steps: the
    port's two gloo ranks against the reference on two forced host
    devices, from the reference's initial params.  History, counters and
    final params within rtol 1e-5 / atol 1e-6."""
    fields = dict(arch="h2o-danube-1.8b", backend="spmd", mode="hybrid",
                  schedule="step:2", steps=6, batch=4, seq=16, smoke=True,
                  log_every=1)
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(JaxSpec(**fields).to_json())
    rcfg = ref_smoke_variant(ref_get_config(fields["arch"]))
    init = jax.tree.map(np.asarray,
                        RM.init_params(jax.random.PRNGKey(0), rcfg))
    ref_save_checkpoint(str(tmp_path / "init"), init, 0)
    for name, body in (("ref.py", _REF_SCRIPT), ("port.py", _PORT_SCRIPT)):
        (tmp_path / name).write_text(textwrap.dedent(body))
    theirs = _start([sys.executable, str(tmp_path / "ref.py"),
                     str(spec_path), str(tmp_path / "ref_final")],
                    _env(XLA_FLAGS="--xla_force_host_platform_device_count"
                                   "=2"))
    ours = _start(_torchrun(2, str(tmp_path / "port.py"), str(spec_path),
                            str(tmp_path / "init"),
                            str(tmp_path / "port_final")), _env())
    _finish(ours, "the port's torchrun")
    _finish(theirs, "the reference's run_training")
    ref_run = json.loads((tmp_path / "ref_final.run.json").read_text())
    port_run = json.loads((tmp_path / "port_final.run.json").read_text())
    for k in ("num_updates", "num_gradients"):
        assert port_run["stats"][k] == ref_run["stats"][k]
    assert port_run["stats"]["num_gradients"] == 2 * 2 + 4 * 1
    assert port_run["stats"]["backend"] == "gloo"
    assert len(port_run["stats"]["collective_s"]) == 2
    assert [m["K"] for m in port_run["stats"]["merges"]] == [2, 1]
    hr, hp = ref_run["history"], port_run["history"]
    assert [(h["step"], h["group_size"], h["replicas"]) for h in hp] == \
        [(h["step"], h["group_size"], h["replicas"]) for h in hr] == \
        [(0, 1, 2), (1, 1, 2), (2, 2, 1), (3, 2, 1), (4, 2, 1), (5, 2, 1)]
    for key in ("loss", "divergence"):
        np.testing.assert_allclose([h[key] for h in hp],
                                   [h[key] for h in hr], rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    assert hp[0]["divergence"] > 0 and hp[-1]["divergence"] == 0.0
    got, want = _npz(tmp_path / "port_final.npz"), \
        _npz(tmp_path / "ref_final.npz")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_train_driver_hybrid_end_to_end(tmp_path):
    """``python -m repro_torch.launch.train`` anneals g 1 -> 2 over two
    ranks (the reference's ``test_train_driver_hybrid_end_to_end``)."""
    out = tmp_path / "h.json"
    _finish(_start(_torchrun(
        2, "-m", "repro_torch.launch.train", "--arch", "xlstm-350m",
        "--smoke", "--steps", "8", "--mode", "hybrid", "--schedule",
        "step:4", "--batch", "4", "--seq", "32",
        "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
        "--out-json", str(out)), _env()),
        "launch.train")
    run = json.loads(out.read_text())
    gs = [h["group_size"] for h in run["history"]]
    assert gs[0] == 1 and gs[-1] == 2
    assert all(np.isfinite(h["loss"]) for h in run["history"])
    assert run["stats"]["num_gradients"] == 4 * 2 + 4 * 1
    # one merge per phase end: the checkpoint's, reused by the switch
    # and by the final merge (alpha 1)
    assert [(m["step"], m["K"], m["kind"])
            for m in run["stats"]["merges"]] == \
        [(4, 2, "checkpoint"), (8, 1, "checkpoint")]
    assert sorted(f for f in os.listdir(tmp_path / "ck")
                  if f.endswith(".npz")) == ["step_4.npz", "step_8.npz"]
    by_kind = run["stats"]["collective_s_by_kind"]
    assert len(by_kind) == 2 and all(
        set(k) == {"gradient", "gather", "divergence", "merge"} and
        sum(k.values()) <= s + 1e-9
        for k, s in zip(by_kind, run["stats"]["collective_s"]))
    # rank 0 took part in the divergence of steps 0-3, and in steps 4-7
    # gathered its FSDP shards and reduce-scattered the gradient (g = 2)
    assert by_kind[0]["divergence"] > 0 and by_kind[0]["gradient"] > 0
    assert by_kind[0]["gather"] > 0
    assert [(p["g"], p["fsdp"]) for p in run["stats"]["layout"]] == \
        [(1, False), (2, True)]


def test_sync_run_repeats_bitwise_through_the_cli(tmp_path):
    """Two sync runs of ``python -m repro_torch run --backend spmd`` on
    two ranks write byte-equal final checkpoints; only rank 0 writes
    ``--out``."""
    procs = []
    for run in ("a", "b"):
        procs.append(_start(_torchrun(
            2, "-m", "repro_torch", "run", "--backend", "spmd", "--arch",
            "h2o-danube-1.8b", "--smoke", "--mode", "sync", "--steps", "3",
            "--batch", "4", "--seq", "16", "--log-every", "1", "--device",
            "cpu", "--quiet", "--ckpt-dir", str(tmp_path / run), "--out",
            str(tmp_path / f"{run}.json")), _env()))
    for p in procs:
        _finish(p, "repro_torch run --backend spmd")
    a, b = _npz(tmp_path / "a" / "step_3.npz"), \
        _npz(tmp_path / "b" / "step_3.npz")
    assert sorted(a) == sorted(b)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    res = json.loads((tmp_path / "a.json").read_text())
    assert res["backend"] == "spmd" and res["extra"]["world_size"] == 2
    assert res["metrics"]["replicas"] == [1.0, 1.0, 1.0]
    assert (res["num_updates"], res["num_gradients"]) == (3, 3)
