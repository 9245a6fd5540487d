"""The FSDP layout within a replica group (``parallel/fsdp.py``), the
P-split merges of the SPMD driver and the aggregator's chunks across
devices, against the unsharded forms and the reference.

The layout is held in one process (shard, gather, the partition rules'
shard shapes); the gather Function on two gloo ranks under ``torchrun
--standalone`` (a free rendezvous port), with and without remat; the
driver on four gloo ranks against the reference's ``run_training`` on
four forced host devices.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as JaxSpec
from repro.checkpoint import save_checkpoint as ref_save_checkpoint
from repro.configs.registry import get_config as ref_get_config
from repro.configs.registry import smoke_variant as ref_smoke_variant
from repro.models import model as RM
from repro_torch.configs.registry import ARCH_NAMES, get_config, smoke_variant
from repro_torch.core import slab as tslab
from repro_torch.core import spmd_hybrid as port
from repro_torch.launch.cost import tree_bytes
from repro_torch.launch.train import _Chunks
from repro_torch.models import model as M
from repro_torch.optim import SlabOptimizer
from repro_torch.optim.optimizers import adamw
from repro_torch.parallel.fsdp import leaf_dims, shard_tree
from repro_torch.parallel.partition import (map_with_path,
                                            opt_state_shardings,
                                            param_shardings)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
RTOL, ATOL = 1e-5, 1e-6
TIMEOUT = 300


def _env(**extra):
    return dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
                JAX_PLATFORMS="cpu", **extra)


def _start(cmd, env) -> subprocess.Popen:
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(proc: subprocess.Popen, what: str) -> str:
    out, _ = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, f"{what} exited {proc.returncode}:\n" \
        + out[-4000:]
    return out


def _torchrun(nproc: int, *args) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(nproc), *args]


def _leaves(tree):
    out = []
    map_with_path(lambda p, t: out.append((p, t)), tree)
    return out


# ------------------------------------------------------------ the layout

@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_shard_then_gather_round_trips(arch, g):
    """Every leaf of the smoke variant: the g ranks' shards laid side by
    side along the leaf's dim are the leaf, bit for bit; each shard has
    the partition rules' shard shape; the state a rank holds (params and
    AdamW state built on the shards) is the rules' shard bytes."""
    cfg = smoke_variant(get_config(arch))
    params = M.init_params(torch.Generator().manual_seed(1), cfg)
    dims = leaf_dims(params, g)
    shards = [shard_tree(params, k, g, dims) for k in range(g)]
    shapes = port.replica_param_shardings(params, g)
    assert any(d is not None for d in dims.values())
    for (path, leaf), want, *parts in zip(
            _leaves(params), _shapes(shapes),
            *(_leaves(s) for s in shards)):
        parts = [t for _, t in parts]
        d = dims[path]
        assert tuple(parts[0].shape) == tuple(want), path
        whole = parts[0] if d is None else torch.cat(parts, dim=d)
        assert whole.dtype == leaf.dtype and torch.equal(whole, leaf), path
        if d is not None:
            assert all(p.is_contiguous() for p in parts), path
    opt_state = adamw(1e-3).init(shards[0])
    mesh = {"data": g, "model": 1}
    want = sum(_shard_bytes(s, t) for s, (_, t) in zip(
        _shapes(param_shardings(params, mesh)), _leaves(params)))
    assert tree_bytes(shards[0]) == want
    full_opt = adamw(1e-3).init(params)
    opt_shapes = opt_state_shardings(full_opt, params, mesh)
    want_opt = sum(_shard_bytes(s, t) for k in ("mu", "nu")
                   for s, (_, t) in zip(_shapes(opt_shapes[k]),
                                        _leaves(full_opt[k])))
    assert tree_bytes({k: opt_state[k] for k in ("mu", "nu")}) == want_opt


def _shapes(tree):
    """The leaves of a tree of shape tuples, in ``map_with_path``'s
    order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _shapes(v)]
    if isinstance(tree, (tuple, list)) and tree and \
            not isinstance(tree[0], int):
        return [x for v in tree for x in _shapes(v)]
    return [tuple(tree)]


def _shard_bytes(shape, leaf) -> int:
    n = int(np.prod(shape, dtype=np.int64)) * leaf.element_size()
    return -(-n // 512) * 512


# --------------------------------------------------- the gather Function

_GATHER_SCRIPT = """
    import sys
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config, smoke_variant
    from repro_torch.core import gradient
    from repro_torch.data.synthetic import token_stream
    from repro_torch.launch.mesh import Collectives
    from repro_torch.models import model as M
    from repro_torch.parallel.fsdp import GroupShards
    from repro_torch.parallel.partition import map_with_path
    torch.use_deterministic_algorithms(True)
    remat = sys.argv[1]
    dist.init_process_group("gloo")
    rank, g = dist.get_rank(), dist.get_world_size()
    cfg = smoke_variant(get_config("h2o-danube-1.8b"))
    cfg = type(cfg)(**{**cfg.__dict__, "remat": remat})
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    batch = next(token_stream(rank, cfg.vocab_size, 2, 1040))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = lambda p, gather=None: M.loss_fn(p, batch, cfg, gather=gather)
    # unsharded: this rank's loss and gradient; the gradient summed
    want_g, (want_l, _) = gradient.grad_and_value(loss, has_aux=True)(
        params)
    comm = Collectives(torch.device("cpu"))
    sharding = GroupShards(params, g, rank, comm)
    got_g, (got_l, _) = gradient.grad_and_value(
        lambda p: loss(p, sharding.gather), has_aux=True)(
        sharding.shard(params))
    assert torch.equal(got_l, want_l), (float(got_l), float(want_l))
    summed = []
    map_with_path(lambda p, t: summed.append((p, t)), want_g)
    got = []
    map_with_path(lambda p, t: got.append((p, t)), got_g)
    sharded = 0
    for (path, w), (_, s) in zip(summed, got):
        d = sharding.dims[path]
        if d is None:       # a whole leaf: this rank's own gradient
            assert torch.equal(s, w), path
            continue
        sharded += 1
        w = w.clone()
        dist.all_reduce(w)
        n = w.shape[d] // g
        assert torch.equal(s, w.narrow(d, rank * n, n)), path
    assert sharded > 0
    assert comm.seconds_by["gather"] > 0 and comm.seconds_by["gradient"] > 0
    with open(f"{sys.argv[2]}/ok{rank}", "w") as f:
        f.write(f"{float(got_l)} {sharded}")
    dist.destroy_process_group()
"""


@pytest.mark.parametrize("remat", ["none", "block"])
def test_gather_function_bitwise_on_two_ranks(tmp_path, remat):
    """h2o-danube-1.8b's smoke variant on two gloo ranks, S 1040 (three
    query blocks): the loss through the gathered shards is the unsharded
    loss bit for bit, and each shard's gradient is its slice of the
    gradient summed over the two ranks (a whole leaf's is the rank's
    own), with and without remat; under remat the recompute gathers
    again on both ranks."""
    script = tmp_path / "gather.py"
    script.write_text(textwrap.dedent(_GATHER_SCRIPT))
    _finish(_start(_torchrun(2, str(script), remat, str(tmp_path)),
                   _env()), "the gather check")
    assert all((tmp_path / f"ok{r}").exists() for r in range(2))


# --------------------------------------------------- the P-split merge

class _Rank:
    """A rank's place in the world, for :class:`_Chunks` alone: its
    all-reduce keeps what the rank sends and returns ``total``, or what
    it was given."""

    def __init__(self, rank, world, total=None):
        self.rank, self.world = rank, world
        self.sent = []
        self.total = total

    def sum_world(self, t):
        self.sent.append(t.to(torch.float64))
        return self.total if self.total is not None else self.sent[-1]


def _replicas(R, seed):
    rng = np.random.default_rng(seed)
    trees = [{"a": torch.from_numpy(rng.normal(size=(33, 7)).astype(
                 np.float32)).to(torch.bfloat16),
              "b": {"c": torch.from_numpy(rng.normal(size=(9000,)).astype(
                  np.float32))},
              "d": torch.from_numpy(rng.normal(size=(5, 1700)).astype(
                  np.float32)).to(torch.bfloat16)}
             for _ in range(R)]
    return port.stack_replicas(trees)


@pytest.mark.parametrize("R,R_new,alpha,W", [(4, 2, 1.0, 4), (4, 1, 0.5, 4),
                                             (2, 1, 0.5, 3), (2, 4, 0.7, 2)])
def test_p_split_merge_is_the_unsharded_merge(R, R_new, alpha, W):
    """Each of W ranks merges its tile-aligned P-chunk of the (R, P) rows
    (the flush at K = R, mean, each leaf's dtype, alpha) and reshards it
    to R_new: laid side by side the chunks are the encoding of
    ``reshard_replicas(merge_replicas_slab(...))`` bit for bit, bf16 and
    f32 leaves alike.  The divergence from the chunks' per-leaf partial
    sums is ``replica_divergence`` of the same bf16 and f32 leaves, the
    port's and the reference's, within rtol 1e-5 / atol 1e-6."""
    params_R = _replicas(R, seed=R * 10 + W)
    codec = tslab.slab_codec(port.replica(params_R, 0))
    rows = torch.stack([codec.encode_master(port.replica(params_R, r))
                        for r in range(R)])
    want = port.reshard_replicas(
        port.merge_replicas_slab(params_R, alpha=alpha), R_new)
    want_rows = torch.stack([codec.encode_master(port.replica(want, r))
                             for r in range(R_new)])
    got, sent = [], []
    for j in range(W):
        chunks = _Chunks(codec, _Rank(j, W))
        mine = rows[:, chunks.mine]
        got.append(chunks.reshard(chunks.merge(mine, alpha), R_new))
        chunks.divergence(mine)
        sent += chunks.comm.sent
    got = torch.cat(got, dim=1)
    assert got.shape == want_rows.shape
    assert torch.equal(got, want_rows)
    total = torch.stack(sent).sum(dim=0)
    div = _Chunks(codec, _Rank(0, W, total=total)).divergence(
        rows[:, _Chunks(codec, _Rank(0, W)).mine])
    from repro.core import spmd_hybrid as ref
    from repro_torch.convert import params_to_numpy
    theirs = float(ref.replica_divergence(jax.tree.map(
        jax.numpy.asarray, params_to_numpy(params_R))))
    ours = float(port.replica_divergence(params_R))
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(div, theirs, rtol=RTOL, atol=ATOL)


# ------------------------------------- the aggregator's chunks on devices

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_aggregator_chunks_on_devices_equal_one_chunk(opt, dtype):
    """The aggregator with its chunks placed on a list of devices (three
    CPU devices here; on a host with cards, a card each) flushes bitwise
    as one chunk does: params, moments, count."""
    cfg = smoke_variant(get_config("h2o-danube-1.8b"))
    params = M.init_params(torch.Generator().manual_seed(3), cfg)
    codec = tslab.slab_codec(params, slab_dtype=dtype)
    rng = np.random.default_rng(5)
    rows = [torch.from_numpy(rng.normal(size=codec.padded_size).astype(
        np.float32)).to(codec.slab_dtype) for _ in range(3)]
    outs = []
    for kw in ({}, {"shards": 3, "devices": ["cpu", "cpu", "cpu"]}):
        agg = tslab.SlabAggregator(codec, params, 3,
                                   optimizer=SlabOptimizer(opt), **kw)
        assert agg.shards == (3 if kw else 1)
        assert agg.chunk_devices == (torch.device("cpu"),) * agg.shards
        for w in ([1.0, 0.5, 0.25], [0.3, 0.3]):
            for slot, r in enumerate(rows[:len(w)]):
                agg.stage(r, slot)
            agg.flush_apply(np.asarray(w, np.float32), 0.1)
        outs.append((agg.params_slab, agg.opt_state_host()))
    assert torch.equal(outs[0][0], outs[1][0])
    if opt != "sgd":
        for k, v in outs[0][1].items():
            np.testing.assert_array_equal(v, outs[1][1][k], err_msg=k)


# ----------------------------------------- the driver on four gloo ranks

_REF_SCRIPT = """
    import dataclasses, json, sys
    import jax
    import numpy as np
    from repro.api import ExperimentSpec
    from repro.checkpoint import save_checkpoint
    from repro.launch import train
    dtype = sys.argv[3]
    smoke = train.smoke_variant
    train.smoke_variant = lambda c: dataclasses.replace(smoke(c),
                                                        dtype=dtype)
    spec = ExperimentSpec.from_json(open(sys.argv[1]).read())
    params, history, stats = train.run_training(spec, verbose=False)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    save_checkpoint(sys.argv[2], params, spec.steps)
    with open(sys.argv[2] + ".run.json", "w") as f:
        json.dump({"history": history, "stats": stats}, f)
"""

_PORT_SCRIPT = """
    import dataclasses, json, sys
    import torch
    from repro_torch.api.spec import ExperimentSpec
    from repro_torch.checkpoint.ckpt import (restore_checkpoint,
                                             save_checkpoint)
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import params_to_numpy, tree_map
    from repro_torch.launch import train
    from repro_torch.models import model as M
    dtype, microbatch = sys.argv[4], int(sys.argv[5])
    smoke = train.smoke_variant
    train.smoke_variant = lambda c: dataclasses.replace(smoke(c),
                                                        dtype=dtype)
    spec = ExperimentSpec.from_json(open(sys.argv[1]).read())
    like = M.init_params(torch.Generator().manual_seed(0),
                         train.smoke_variant(get_config(spec.arch)))
    init, _ = restore_checkpoint(sys.argv[2], like)
    params, history, stats = train.run_training(
        spec, verbose=False, device="cpu", params=params_to_numpy(init),
        microbatch=microbatch)
    if params is not None:
        params = tree_map(lambda t: t.float(), params)
        save_checkpoint(sys.argv[3], params, spec.steps)
        with open(sys.argv[3] + ".run.json", "w") as f:
            json.dump({"history": history, "stats": stats}, f)
"""


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _against_reference(tmp_path, arch, dtype="float32", microbatch=1,
                       mode="hybrid"):
    """``arch``'s smoke variant in ``dtype`` over 6 steps on four gloo
    ranks and the reference's ``run_training`` on four forced host
    devices, from the reference's initial params; each rank's rows in
    ``microbatch`` slices.  ``hybrid`` is step:2: g 1 -> 2 -> 4, the g 2
    and g 4 phases in the FSDP layout, merges K 4, 2, 1 split along P;
    ``sync`` is g 4 in the FSDP layout throughout.  Checks the counters,
    the phases and the history's steps; returns the two histories and
    the final params as float32 arrays."""
    fields = dict(arch=arch, backend="spmd", mode=mode, steps=6, batch=8,
                  seq=16, smoke=True, log_every=1)
    if mode == "hybrid":
        fields["schedule"] = "step:2"
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(JaxSpec(**fields).to_json())
    rcfg = dataclasses.replace(ref_smoke_variant(ref_get_config(arch)),
                               dtype=dtype)
    init = jax.tree.map(lambda x: np.asarray(x, np.float32),
                        RM.init_params(jax.random.PRNGKey(0), rcfg))
    ref_save_checkpoint(str(tmp_path / "init"), init, 0)
    for name, body in (("ref.py", _REF_SCRIPT), ("port.py", _PORT_SCRIPT)):
        (tmp_path / name).write_text(textwrap.dedent(body))
    theirs = _start([sys.executable, str(tmp_path / "ref.py"),
                     str(spec_path), str(tmp_path / "ref_final"), dtype],
                    _env(XLA_FLAGS="--xla_force_host_platform_device_count"
                                   "=4"))
    ours = _start(_torchrun(4, str(tmp_path / "port.py"), str(spec_path),
                            str(tmp_path / "init"),
                            str(tmp_path / "port_final"), dtype,
                            str(microbatch)), _env())
    _finish(ours, "the port's torchrun")
    _finish(theirs, "the reference's run_training")
    ref_run = json.loads((tmp_path / "ref_final.run.json").read_text())
    port_run = json.loads((tmp_path / "port_final.run.json").read_text())
    st = port_run["stats"]
    for k in ("num_updates", "num_gradients"):
        assert st[k] == ref_run["stats"][k]
    if mode == "hybrid":
        gs = [1, 1, 2, 2, 4, 4]
        assert [m["K"] for m in st["merges"]] == [4, 2, 1]
        assert [(p["g"], p["fsdp"]) for p in st["layout"]] == \
            [(1, False), (2, True), (4, True)]
        shards = [p["state_bytes"] for p in st["layout"]]
        assert shards[1][0] < shards[0][0] and shards[2][0] < shards[1][0]
    else:
        gs = [4] * 6
        assert [m["K"] for m in st["merges"]] == [1]
        assert [(p["g"], p["fsdp"]) for p in st["layout"]] == [(4, True)]
    assert st["num_gradients"] == sum(4 // g for g in gs)
    hr, hp = ref_run["history"], port_run["history"]
    assert [(h["step"], h["group_size"], h["replicas"]) for h in hp] == \
        [(h["step"], h["group_size"], h["replicas"]) for h in hr] == \
        [(i, g, 4 // g) for i, g in enumerate(gs)]
    assert all((h["divergence"] > 0) == (h["replicas"] > 1) for h in hp)
    got, want = _npz(tmp_path / "port_final.npz"), \
        _npz(tmp_path / "ref_final.npz")
    assert sorted(got) == sorted(want)
    return hp, hr, got, want


def test_hybrid_on_four_ranks_matches_reference(tmp_path):
    """h2o-danube-1.8b smoke, float32, hybrid, one slice of rows a step:
    history, counters and final params within rtol 1e-5 / atol 1e-6 of
    the reference (:func:`_against_reference`)."""
    hp, hr, got, want = _against_reference(tmp_path, "h2o-danube-1.8b")
    for key in ("loss", "divergence"):
        np.testing.assert_allclose([h[key] for h in hp],
                                   [h[key] for h in hr], rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


# bf16 weights: both sides round every step's products and update to
# bf16, in other orders, so a weight may differ by a few of its bf16
# ulps (2^-8 of the value each) after 6 AdamW steps
BF16_TOL = dict(rtol=1.6e-2, atol=1e-5)


@pytest.mark.parametrize("arch,dtype,mode", [
    ("h2o-danube-1.8b", "float32", "hybrid"),
    ("phi4-mini-3.8b", "bfloat16", "sync")])
def test_microbatched_fsdp_on_four_ranks_matches_reference(
        tmp_path, arch, dtype, mode):
    """Each rank's rows in 2 micro-batches, so under FSDP every
    micro-batch's backward reduce-scatters (the sums in another order
    than the reference's whole batch, ROADMAP C.45), against the
    reference's ``run_training`` (:func:`_against_reference`): float32,
    hybrid g 1 -> 2 -> 4, within rtol 1e-5 / atol 1e-6; phi4-mini-3.8b
    in bf16 within a bf16 tolerance, its tied embedding gathered twice
    and its two gradients added in bf16.  The bf16 case runs sync at
    g 4: the reference's driver merges on the host in numpy, which turns
    bf16 leaves into float32 at its first merge, and the port keeps each
    leaf's dtype (ROADMAP C.45)."""
    hp, hr, got, want = _against_reference(tmp_path, arch, dtype,
                                           microbatch=2, mode=mode)
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == "float32" else BF16_TOL
    for key in ("loss", "divergence"):
        np.testing.assert_allclose([h[key] for h in hp],
                                   [h[key] for h in hr], err_msg=key, **tol)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


# -------------------------------------------------- the dry-run's trace

@pytest.mark.parametrize("remat,gathers", [("none", 1), ("block", 2)])
def test_dryrun_traces_the_fsdp_step(remat, gathers):
    """The dry-run's FSDP layout (``launch/dryrun.py::fsdp_layout``) is
    traced through the driver's FSDP step: the state is the partition
    rules' shard bytes, and each micro-batch gathers every sharded
    block-group leaf once (twice under remat: the recompute) and
    reduce-scatters its float32 gradient once (the backward runs through
    the forward's gather), the whole leaves' gradients all-reduced once
    a step."""
    from repro_torch.configs.registry import InputShape
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(smoke_variant(get_config("h2o-danube-1.8b")),
                              remat=remat)
    m, g = 2, 2
    lay = dryrun.fsdp_layout(cfg, InputShape("t", 32, 8, "train"), 2,
                             microbatch=m, optimizer=adamw(1e-3))
    params = dryrun.meta_params(cfg)
    dims = leaf_dims(params, g)
    ag = rs = ar = 0
    for path, leaf in _leaves(params):
        n = leaf.numel()
        uses = 2 if path[0] == "embed" and cfg.tie_embeddings else 1
        if dims[path] is None:
            ar += 2 * 4 * n / 2
        else:
            ag += m * uses * (gathers if path[0] == "groups" else 1) \
                * n * leaf.element_size() / 2
            # the backward runs through the forward's gathers only
            rs += m * uses * n * 4 / 2
    coll = lay["collective_bytes_per_device"]
    assert (coll["all-gather"], coll["reduce-scatter"], coll["all-reduce"]) \
        == (ag, rs, ar)
    assert "peak_traced" in lay
    mesh = {"data": g, "model": 1}
    assert lay["state_bytes"]["params"] == sum(
        _shard_bytes(s, t) for s, (_, t) in zip(
            _shapes(param_shardings(params, mesh)), _leaves(params)))
    assert lay["peak_bytes"] > lay["state_bytes_total"]
