"""The slice as a whole: the port's PSTrainer against the reference's.

Both packages get the same numpy data and the reference's initial
parameters.  Event timing depends only on the seeded numpy generator,
so the update and gradient counts must be exactly equal; losses and the
final params agree to allclose, since the two frameworks sum gradients
in different orders.  The reference's own simulator properties
(``tests/test_hybrid_core.py``) are then run on the port alone.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.schedule import step_schedule as jstep
from repro.core.simulator import PSTrainer as JaxPSTrainer
from repro.core.simulator import WorkerPool as JaxWorkerPool
from repro.data.synthetic import mnist_like, random_classification
from repro.models import cnn as jcnn
from repro.optim import SlabOptimizer as JaxSlabOptimizer
from repro_torch.convert import params_from_numpy
from repro_torch.core.schedule import constant_schedule, step_schedule
from repro_torch.core.simulator import PSTrainer, WorkerPool
from repro_torch.models import cnn as tcnn
from repro_torch.optim import SlabOptimizer

torch.set_num_threads(2)

CASES = [("async", None, "sgd"), ("sync", None, "sgd"),
         ("hybrid", 50, "sgd"), ("hybrid", 50, "momentum"),
         ("hybrid", 50, "adamw")]


def _mlp():
    data = random_classification(seed=0, n=2000)
    params = jax.tree.map(np.asarray,
                          jcnn.init_mlp_clf(jax.random.PRNGKey(0)))
    jloss = lambda p, x, y: jcnn.nll_loss(jcnn.mlp_clf_forward(p, x), y)  # noqa: E731,E501
    tloss = lambda p, x, y: tcnn.nll_loss(tcnn.mlp_clf_forward(p, x), y)  # noqa: E731,E501
    return data, params, jloss, tloss


def _cnn_mnist():
    data = mnist_like(seed=0, n_train=2_000, n_test=500)
    params = jax.tree.map(np.asarray,
                          jcnn.init_cnn(jax.random.PRNGKey(0), (28, 28, 1)))
    jloss = lambda p, x, y: jcnn.nll_loss(jcnn.cnn_forward(p, x), y)  # noqa: E731,E501
    tloss = lambda p, x, y: tcnn.nll_loss(tcnn.cnn_forward(p, x), y)  # noqa: E731,E501
    return data, params, jloss, tloss


@pytest.fixture(scope="module")
def mlp():
    return _mlp()


def _pair(workload, workers, batch, optimizer):
    data, params, jloss, tloss = workload
    jtr = JaxPSTrainer(jloss, params, data, lr=0.01, batch_size=batch,
                       pool=JaxWorkerPool(num_workers=workers), seed=0,
                       optimizer=JaxSlabOptimizer(optimizer))
    ttr = PSTrainer(tloss, params_from_numpy(params), data, lr=0.01,
                    batch_size=batch, pool=WorkerPool(num_workers=workers),
                    seed=0, optimizer=SlabOptimizer(optimizer),
                    device="cpu")
    return jtr, ttr


def _compare(jtr, ttr, mode, step, workers, horizon):
    jsched = jstep(workers, step) if step else None
    tsched = step_schedule(workers, step) if step else None
    jr = jtr.simulate(mode, horizon=horizon, schedule=jsched)
    tr = ttr.simulate(mode, horizon=horizon, schedule=tsched)
    assert (tr.num_updates, tr.num_gradients) == \
        (jr.num_updates, jr.num_gradients)
    assert tr.num_updates > 0
    np.testing.assert_array_equal(tr.times, jr.times)
    for name in ("train_loss", "test_loss", "test_acc"):
        np.testing.assert_allclose(getattr(tr, name), getattr(jr, name),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    # the final params slab, as each aggregator published it
    k_max = 1 if mode == "async" else workers
    np.testing.assert_allclose(
        ttr._agg_cache[k_max].params_slab.numpy(),
        np.asarray(jtr._agg_cache[k_max].params_slab),
        rtol=1e-4, atol=1e-5)
    return tr


@pytest.mark.parametrize("mode,step,optimizer", CASES)
def test_mlp_matches_reference(mlp, mode, step, optimizer):
    jtr, ttr = _pair(mlp, workers=5, batch=16, optimizer=optimizer)
    _compare(jtr, ttr, mode, step, workers=5, horizon=3.0)


@pytest.mark.parametrize("mode,step", [("async", None), ("sync", None),
                                       ("hybrid", 20)])
def test_cnn_mnist_smoke_matches_reference(mode, step):
    jtr, ttr = _pair(_cnn_mnist(), workers=3, batch=16, optimizer="sgd")
    _compare(jtr, ttr, mode, step, workers=3, horizon=1.0)


def test_aggregator_cache_resets_between_runs(mlp):
    """A second simulate() on the same trainer starts from the initial
    params, empty staging and zero optimizer state."""
    _, ttr = _pair(mlp, workers=5, batch=16, optimizer="adamw")
    first = ttr.simulate("hybrid", horizon=1.0,
                         schedule=step_schedule(5, 20))
    second = ttr.simulate("hybrid", horizon=1.0,
                          schedule=step_schedule(5, 20))
    np.testing.assert_array_equal(first.train_loss, second.train_loss)
    assert first.num_updates == second.num_updates


# the reference's simulator properties, on the port alone

@pytest.fixture(scope="module")
def port_setup():
    data, params, _, tloss = _mlp()
    return tloss, params_from_numpy(params), data, WorkerPool(
        num_workers=5, base_compute=0.05)


def _run(port_setup, mode, schedule=None, seed=0):
    loss, params, data, pool = port_setup
    tr = PSTrainer(loss, params, data, lr=0.01, batch_size=16, pool=pool,
                   seed=seed, device="cpu")
    return tr.simulate(mode, horizon=3.0, schedule=schedule)


def test_hybrid_k1_equals_async(port_setup):
    r_async = _run(port_setup, "async")
    r_hyb = _run(port_setup, "hybrid", schedule=constant_schedule(5, 1))
    np.testing.assert_array_equal(r_hyb.train_loss, r_async.train_loss)
    assert r_hyb.num_updates == r_async.num_updates


def test_hybrid_kw_matches_sync_update_count(port_setup):
    r = _run(port_setup, "hybrid", schedule=constant_schedule(5, 5))
    assert r.num_gradients >= 5 * r.num_updates


def test_sync_slower_than_async(port_setup):
    r_sync = _run(port_setup, "sync")
    r_async = _run(port_setup, "async")
    assert r_sync.num_updates < r_async.num_updates / 2


@pytest.mark.parametrize("mode,step", [("async", None), ("sync", None),
                                       ("hybrid", 100)])
def test_all_modes_learn(port_setup, mode, step):
    sched = step_schedule(5, step) if step else None
    r = _run(port_setup, mode, schedule=sched)
    assert r.train_loss[-1] < r.train_loss[0], mode


def test_simulator_deterministic(port_setup):
    r1 = _run(port_setup, "hybrid", schedule=step_schedule(5, 50), seed=7)
    r2 = _run(port_setup, "hybrid", schedule=step_schedule(5, 50), seed=7)
    np.testing.assert_array_equal(r1.train_loss, r2.train_loss)
    assert r1.num_updates == r2.num_updates
