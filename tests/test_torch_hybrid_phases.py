"""The port's SPMD phase machinery and replica algebra against the
reference's (``src/repro/core/spmd_hybrid.py``): the counterparts of
``tests/test_hybrid_phases.py`` and of the two replica tests of
``tests/test_spmd.py``, on the same inputs in one process."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import spmd_hybrid as ref
from repro.core.schedule import linear_schedule as ref_linear
from repro.core.schedule import step_schedule as ref_step
from repro.optim import sgd as ref_sgd
from repro_torch.core import spmd_hybrid as port
from repro_torch.core.schedule import linear_schedule, step_schedule
from repro_torch.optim.optimizers import sgd

torch.set_num_threads(2)


def _same_phases(ours, theirs):
    assert [(p.t_start, p.group_size, p.num_replicas) for p in ours] == \
        [(p.t_start, p.group_size, p.num_replicas) for p in theirs]


@settings(max_examples=30, deadline=None)
@given(step=st.integers(1, 500), horizon=st.integers(1, 3000),
       axis=st.sampled_from([2, 4, 8, 16, 32]))
def test_build_phases_invariants(step, horizon, axis):
    phases = port.build_phases(step_schedule(axis, step), horizon, axis)
    _same_phases(phases, ref.build_phases(ref_step(axis, step), horizon,
                                          axis))
    assert phases[0].t_start == 0
    sizes = [p.group_size for p in phases]
    starts = [p.t_start for p in phases]
    assert sizes == sorted(sizes) and starts == sorted(starts)
    for p in phases:
        assert axis % p.group_size == 0
        assert p.num_replicas * p.group_size == axis
        assert 1 <= p.group_size <= axis


@settings(max_examples=20, deadline=None)
@given(axis=st.sampled_from([4, 8, 16]), horizon=st.integers(10, 500))
def test_build_phases_reaches_sync(axis, horizon):
    phases = port.build_phases(linear_schedule(axis, horizon), horizon + 1,
                               axis)
    _same_phases(phases, ref.build_phases(ref_linear(axis, horizon),
                                          horizon + 1, axis))
    assert phases[-1].group_size == axis and phases[-1].num_replicas == 1


@pytest.mark.parametrize("g_min", [1, 2, 4, 8])
def test_build_phases_respects_g_min(g_min):
    phases = port.build_phases(step_schedule(16, 10), 200, 16, g_min=g_min)
    _same_phases(phases, ref.build_phases(ref_step(16, 10), 200, 16,
                                          g_min=g_min))
    assert all(p.group_size >= g_min for p in phases)


@pytest.mark.parametrize("param_b,opt_b,model_axis,hbm", [
    (int(100e9 * 2), int(100e9 * 8), 16, 16 * 2 ** 30),
    (int(0.35e9 * 2), int(0.35e9 * 8), 16, 16 * 2 ** 30),
    (int(0.44e9 * 4), int(0.44e9 * 8), 1, 80 * 10 ** 9),
    (int(110e9 * 2), int(110e9 * 8), 1, 80 * 10 ** 9),
])
def test_min_group_size_law(param_b, opt_b, model_axis, hbm):
    """The memory law at the reference's TPU sizes and at an 80 GB card;
    with no size given and no card it is a readable error."""
    got = port.min_group_size(param_b, opt_b, model_axis, hbm_per_chip=hbm)
    assert got == ref.min_group_size(param_b, opt_b, model_axis,
                                     hbm_per_chip=hbm)
    with pytest.raises(ValueError, match="hbm_per_chip"):
        port.min_group_size(param_b, opt_b, model_axis, device="cpu")


@pytest.mark.parametrize("R_old,R_new", [(4, 2), (4, 1), (2, 4), (1, 2),
                                         (2, 2)])
def test_reshard_replicas_merge_down_averages(R_old, R_new):
    w = np.random.default_rng(R_old * 10 + R_new).normal(
        size=(R_old, 3, 2)).astype(np.float32)
    theirs = ref.reshard_replicas({"w": jnp.asarray(w)}, R_new)
    ours = port.reshard_replicas({"w": torch.from_numpy(w)}, R_new)
    np.testing.assert_allclose(ours["w"].numpy(), np.asarray(theirs["w"]),
                               rtol=1e-6, atol=0)
    if (R_old, R_new) == (4, 2):
        out = port.reshard_replicas(
            {"w": torch.arange(8.0).reshape(4, 2)}, 2)
        np.testing.assert_allclose(out["w"].numpy(),
                                   [[1.0, 2.0], [5.0, 6.0]])


# ----------------------------------------------------- the replica step

def _ref_loss(p, b):
    return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2), {}


def _port_loss(p, b):
    return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2), {}


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_hybrid_r1_matches_plain_dp():
    """Group size = full axis (R = 1) is plain data parallelism, and the
    port's loss sequence is the reference's on its inputs."""
    params = {"w": jax.random.normal(jax.random.PRNGKey(0), (8, 4))}
    batch = {"x": jax.random.normal(jax.random.PRNGKey(1), (16, 8)),
             "y": jax.random.normal(jax.random.PRNGKey(2), (16, 4))}
    r_opt = ref_sgd(0.1)
    r_step = jax.jit(ref.make_replica_step(_ref_loss, r_opt.update))
    pR = ref.replicate_params(params, 1)
    sR = jax.vmap(r_opt.init)(pR)
    bR = jax.tree.map(lambda x: x[None], batch)
    theirs = []
    for _ in range(3):
        pR, sR, m = r_step(pR, sR, bR)
        theirs.append(float(m["loss"]))

    opt = sgd(0.1)
    step = port.make_replica_step(_port_loss, opt.update)
    p1 = _t(params)
    s1 = opt.init(p1)
    plain = []
    for _ in range(3):
        grads, (loss, _) = torch.func.grad_and_value(
            _port_loss, has_aux=True)(p1, _t(batch))
        upd, s1 = opt.update(grads, s1, p1)
        p1 = {"w": p1["w"] + upd["w"]}
        plain.append(float(loss))
    qR = port.replicate_params(_t(params), 1)
    tR = torch.func.vmap(opt.init)(qR)
    cR = {k: v[None] for k, v in _t(batch).items()}
    ours = []
    for _ in range(3):
        qR, tR, m = step(qR, tR, cR)
        ours.append(float(m["loss"]))
        assert int(m["replicas"]) == 1 and float(m["divergence"]) == 0.0
    np.testing.assert_allclose(plain, ours, rtol=1e-6)
    np.testing.assert_allclose(ours, theirs, rtol=1e-6)


def test_hybrid_replicas_diverge_and_merge():
    params = {"w": jax.random.normal(jax.random.PRNGKey(0), (8, 4))}
    R = 2
    bR = {"x": jax.random.normal(jax.random.PRNGKey(1), (R, 8, 8)),
          "y": jax.random.normal(jax.random.PRNGKey(2), (R, 8, 4))}
    r_opt = ref_sgd(0.05)
    r_step = jax.jit(ref.make_replica_step(_ref_loss, r_opt.update))
    pR = ref.replicate_params(params, R)
    sR = jax.vmap(r_opt.init)(pR)
    opt = sgd(0.05)
    step = port.make_replica_step(_port_loss, opt.update)
    qR = port.replicate_params(_t(params), R)
    tR = torch.func.vmap(opt.init)(qR)
    assert float(port.replica_divergence(qR)) == 0.0
    for _ in range(3):
        pR, sR, m_ref = r_step(pR, sR, bR)
        qR, tR, m = step(qR, tR, _t(bR))
    assert float(m["divergence"]) > 0.0
    np.testing.assert_allclose(float(m["divergence"]),
                               float(m_ref["divergence"]), rtol=1e-5)
    np.testing.assert_allclose(m["loss_per_replica"].numpy(),
                               np.asarray(m_ref["loss_per_replica"]),
                               rtol=1e-5)
    np.testing.assert_allclose(qR["w"].numpy(), np.asarray(pR["w"]),
                               rtol=1e-5, atol=1e-6)
    merged = port.merge_replicas(qR)
    np.testing.assert_allclose(merged["w"][0].numpy(),
                               merged["w"][1].numpy(), rtol=1e-6)
    np.testing.assert_allclose(merged["w"][0].numpy(),
                               np.mean(qR["w"].numpy(), axis=0), rtol=1e-5)
    np.testing.assert_allclose(
        merged["w"].numpy(),
        np.asarray(ref.merge_replicas(jax.device_get(pR))["w"]),
        rtol=1e-5, atol=1e-6)
    up = port.reshard_replicas(merged, 2)
    np.testing.assert_allclose(up["w"][0].numpy(), up["w"][1].numpy())
