"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's: the cases of ``tests/test_checkpoint.py``, a checkpoint
written by either package restoring in the other (params, the
``__opt__/`` moments and the update count), the write-then-rename
commit, and an AdamW run resumed in one package from the other's
checkpoint tracking the uninterrupted run."""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.core import slab as jslab
from repro.models.cnn import init_mlp_clf
from repro.optim import SlabOptimizer as JaxSlabOptimizer
from repro_torch import checkpoint as tckpt
from repro_torch.api import ExperimentSpec, FaultPlan, parse_schedule
from repro_torch.cluster.trainer import ClusterTrainer
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import slab as tslab
from repro_torch.optim import SlabOptimizer

torch.set_num_threads(2)


def _tree():
    return {
        "dense": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                  "b": torch.ones(4)},
        "embed": torch.tensor([[1, 2], [3, 4]], dtype=torch.int32),
        "scale": torch.tensor([0.5, -2.0], dtype=torch.bfloat16),
        "stack": [torch.zeros(2, 2), torch.full((3,), 7.0)],
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_ckpt_round_trip_structure_and_dtypes(tmp_path):
    tree = _tree()
    path = str(tmp_path / "step_5")
    tckpt.save_checkpoint(path, tree, step=5, extra={"note": "hi"})
    like = {"dense": {"w": torch.zeros(3, 4), "b": torch.zeros(4)},
            "embed": torch.zeros(2, 2, dtype=torch.int32),
            "scale": torch.zeros(2, dtype=torch.bfloat16),
            "stack": [torch.zeros(2, 2), torch.zeros(3)]}
    back, step = tckpt.restore_checkpoint(path, like)
    assert step == 5
    assert isinstance(back["stack"], list) and set(back) == set(tree)
    for a, b in zip(_leaves(tree), _leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_ckpt_restore_shape_mismatch_caught(tmp_path):
    path = str(tmp_path / "step_0")
    tckpt.save_checkpoint(path, {"w": torch.zeros(2, 2)}, step=0)
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(path, {"w": torch.zeros(3, 3)})


def test_latest_step(tmp_path):
    d = str(tmp_path)
    assert tckpt.latest_step(d) is None
    for s in (3, 11, 7):
        tckpt.save_checkpoint(os.path.join(d, f"step_{s}"),
                              {"w": torch.zeros(2)}, step=s)
    assert tckpt.latest_step(d) == 11
    assert tckpt.latest_step(str(tmp_path / "missing")) is None
    # the JAX package finds the same latest step in the port's files
    assert jckpt.latest_step(d) == 11


def test_write_leaves_no_partial_file(tmp_path):
    """Both files land under their final names by rename, the sidecar
    (the commit marker) last; nothing temporary is left behind."""
    path = str(tmp_path / "step_4")
    state = {"mu": np.ones(8, np.float32), "nu": np.zeros(8, np.float32),
             "count": 4}
    tckpt.save_checkpoint(path, {"w": torch.ones(3)}, step=4,
                          opt_state=state)
    assert sorted(os.listdir(tmp_path)) == ["step_4.json", "step_4.npz"]
    assert os.stat(path + ".json").st_mtime_ns >= \
        os.stat(path + ".npz").st_mtime_ns


def test_reserved_opt_prefix_refused(tmp_path):
    with pytest.raises(ValueError, match="__opt__"):
        tckpt.save_checkpoint(str(tmp_path / "s"),
                              {"__opt__": {"mu": torch.zeros(2)}}, step=0)


def _mlp_with_state(opt, flushes=3):
    """The JAX mlp init and the opt state a JAX aggregator reaches after
    a few flushes, as numpy."""
    params = jax.tree.map(lambda a: np.array(a, copy=True),
                          init_mlp_clf(jax.random.PRNGKey(0)))
    jparams = jax.tree.map(jnp.asarray, params)
    agg = jslab.SlabAggregator(jslab.slab_codec(jparams), jparams, 2,
                               use_pallas=False,
                               optimizer=JaxSlabOptimizer(opt))
    rng = np.random.default_rng(0)
    p_pad = agg.codec.padded_size
    for _ in range(flushes):
        for slot in range(2):
            agg.stage(jnp.asarray(rng.normal(size=p_pad)
                                  .astype(np.float32)), slot)
        agg.flush_apply(np.ones(2), 0.01)
    return params, agg.opt_state_host()


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, opt):
    params, state = _mlp_with_state(opt)
    path = str(tmp_path / "step_3")
    jckpt.save_checkpoint(path, jax.tree.map(jnp.asarray, params), 3,
                          opt_state=state)
    like = params_from_numpy(jax.tree.map(np.zeros_like, params))
    back, step = tckpt.restore_checkpoint(path, like)
    assert step == 3
    for k, v in params.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    got = tckpt.load_opt_state(path)
    if state is None:
        assert got is None
        return
    assert got["count"] == state["count"] == 3
    for name in SlabOptimizer(opt).moment_names:
        np.testing.assert_array_equal(got[name], state[name])


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_port_checkpoint_restores_in_jax(tmp_path, opt):
    params, state = _mlp_with_state(opt)
    tree = params_from_numpy(params)
    tree["extra"] = [torch.tensor([1.5, -2.0], dtype=torch.bfloat16),
                     torch.arange(3, dtype=torch.int32)]
    path = str(tmp_path / "step_9")
    tckpt.save_checkpoint(path, tree, 9, opt_state=state)
    like = jax.tree.map(jnp.zeros_like, params)
    like["extra"] = [jnp.zeros(2, jnp.bfloat16), jnp.zeros(3, jnp.int32)]
    back, step = jckpt.restore_checkpoint(path, like)
    assert step == 9
    want = params_to_numpy(tree)
    for k in params:
        np.testing.assert_array_equal(np.asarray(back[k]), want[k])
    assert back["extra"][0].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back["extra"][0]).astype(np.float32),
        want["extra"][0].astype(ml_dtypes.bfloat16).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(back["extra"][1]),
                                  np.arange(3))
    got = jckpt.load_opt_state(path)
    if state is None:
        assert got is None
        return
    assert got["count"] == 3
    for name in SlabOptimizer(opt).moment_names:
        np.testing.assert_array_equal(got[name], state[name])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_adamw_resumes_across_packages(tmp_path, writer):
    """AdamW params, moments and count saved by one package and loaded
    into the other's aggregator continue the run: the next flushes in
    both packages stay allclose (rtol 1e-5, atol 1e-6), count 3 -> 5."""
    params, state = _mlp_with_state("adamw")
    path = str(tmp_path / "step_3")
    if writer == "jax":
        jckpt.save_checkpoint(path, jax.tree.map(jnp.asarray, params), 3,
                              opt_state=state)
    else:
        tckpt.save_checkpoint(path, params_from_numpy(params), 3,
                              opt_state=state)
    jparams, _ = jckpt.restore_checkpoint(
        path, jax.tree.map(jnp.zeros_like, params))
    tparams, _ = tckpt.restore_checkpoint(
        path, params_from_numpy(jax.tree.map(np.zeros_like, params)))
    jagg = jslab.SlabAggregator(jslab.slab_codec(jparams), jparams, 2,
                                use_pallas=False,
                                optimizer=JaxSlabOptimizer("adamw"))
    tagg = tslab.SlabAggregator(tslab.slab_codec(tparams), tparams, 2,
                                optimizer=SlabOptimizer("adamw"))
    jagg.reset_opt_state(jckpt.load_opt_state(path))
    tagg.reset_opt_state(tckpt.load_opt_state(path))
    rng = np.random.default_rng(1)
    for _ in range(2):
        for slot in range(2):
            row = rng.normal(size=tagg.codec.padded_size).astype(np.float32)
            jagg.stage(jnp.asarray(row.copy()), slot)
            tagg.stage(torch.from_numpy(row.copy()), slot)
        np.testing.assert_allclose(
            tagg.flush_apply(np.ones(2), 0.01).numpy(),
            np.asarray(jagg.flush_apply(np.ones(2), 0.01)),
            rtol=1e-5, atol=1e-6)
    jst, tst = jagg.opt_state_host(), tagg.opt_state_host()
    assert jst["count"] == tst["count"] == 5
    for name in ("mu", "nu"):
        np.testing.assert_allclose(tst[name], jst[name], rtol=1e-5,
                                   atol=1e-6)


def test_cluster_resume_continues_mid_schedule(tmp_path):
    """Restoring a checkpoint into a cluster run resumes K(t) from the
    restored step: the server's version starts at the checkpoint step,
    so the threshold picks up mid-anneal instead of re-opening at 1."""
    d = str(tmp_path)
    spec = ExperimentSpec(
        arch="mlp", backend="cluster", mode="hybrid", schedule="step:10",
        cluster_workers=3, wall_budget_s=1.5, wall_sample_every_s=0.5,
        batch=16, max_gradients=3000,
        faults=FaultPlan(checkpoint_every_s=0.4))
    first = ClusterTrainer(ckpt_dir=d, device="cpu").run(spec)
    step = tckpt.latest_step(d)
    assert step is not None and step > 10, \
        f"first run too short to cross a schedule step ({step})"
    assert any(e["event"] == "checkpoint" for e in first.extra["events"])
    resumed = ClusterTrainer(
        resume_from=os.path.join(d, f"step_{step}"), device="cpu").run(
            spec.with_(faults=FaultPlan(), wall_budget_s=1.0))
    assert resumed.extra["start_version"] == step
    assert parse_schedule(spec.schedule, spec.cluster_workers)(step) > 1
    assert resumed.num_updates > 0
    assert resumed.extra["accounting"]["updates"] == resumed.num_updates
