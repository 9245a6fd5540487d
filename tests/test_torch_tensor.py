"""The ``model`` axis of the SPMD trainer (``parallel/tensor.py``) for the
dense families, against the reference's GSPMD layout and its
``run_training`` on four forced host devices.

The two-axis layout is read from the reference's shardings in one child
process; the tensor-parallel gradient runs on four gloo ranks under
``torchrun --standalone`` (a free rendezvous port) against the port's
own ``mesh_model=1`` gradient; ``run_training`` on four gloo ranks against
the reference's ``run_training``.
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
from repro_torch.api.spec import ExperimentSpec
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.core import spmd_hybrid as port
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.train import run_training
from repro_torch.models import model as M
from repro_torch.parallel.fsdp import leaf_dims, shard_tree
from repro_torch.parallel.partition import map_with_path, param_shardings
from repro_torch.parallel.tensor import check_model_axis, model_dims

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
RTOL, ATOL = 1e-5, 1e-6
# bf16 weights, as tests/test_torch_fsdp.py holds them (ROADMAP C.45)
BF16_TOL = dict(rtol=1.6e-2, atol=1e-5)
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


def _forced(n: int):
    return _env(XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")


def _leaves(tree):
    out = []
    map_with_path(lambda p, t: out.append((p, t)), tree)
    return out


# ------------------------------------------------------------ the ranks

@pytest.mark.parametrize("W,R,M", [(4, 1, 2), (4, 2, 2), (4, 1, 4),
                                   (8, 2, 2), (4, 4, 1)])
def test_rank_layout_is_the_hybrid_mesh(W, R, M):
    """Rank ``r*g*M + d*M + k`` is mesh position (r, d, k) of the
    reference's ``build_hybrid_mesh(R, M)`` (``model`` fastest): its
    replica group, data column and model group are the mesh's slices
    through it."""
    g = W // (R * M)
    mesh = np.arange(W).reshape(R, g, M)
    groups = tmesh.replica_groups(W, R)
    assert groups == [list(mesh[r].reshape(-1)) for r in range(R)]
    for r in range(R):
        for d in range(g):
            for k in range(M):
                rank = int(mesh[r, d, k])
                assert tmesh.data_column(rank, g, M) == list(mesh[r, :, k])
                assert tmesh.model_group(rank, M) == list(mesh[r, d, :])


# ------------------------------------------------------------ the layout

_LAYOUT_SCRIPT = """
    import dataclasses, json, sys
    import jax
    import numpy as np
    from repro.configs.registry import get_config, smoke_variant
    from repro.core.spmd_hybrid import replica_param_shardings
    from repro.launch.train import build_hybrid_mesh
    from repro.models import model as RM
    from repro.parallel.sharding import axis_rules

    def key(p):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in p)

    out = {}
    for case in json.loads(sys.argv[1]):
        arch, g, M, kv = case
        cfg = smoke_variant(get_config(arch))
        if kv:
            cfg = dataclasses.replace(cfg, num_kv_heads=kv)
        params = RM.init_params(jax.random.PRNGKey(0), cfg)
        mesh = build_hybrid_mesh(1, M)
        devices = np.asarray(mesh.devices)
        with axis_rules(mesh):
            sh = replica_param_shardings(params, mesh)
        flat_s = jax.tree_util.tree_flatten_with_path(sh)[0]
        flat_p = jax.tree.leaves(params)
        by = {}
        for (path, s), leaf in zip(flat_s, flat_p):
            idx = s.devices_indices_map((1,) + tuple(leaf.shape))
            by[key(path)] = [
                [[sl.start or 0, leaf.shape[i] if sl.stop is None
                  else sl.stop] for i, sl in enumerate(idx[devices[0, d, k]][1:])]
                for d in range(g) for k in range(M)]
        out[json.dumps(case)] = by
    json.dump(out, open(sys.argv[2], "w"))
"""

LAYOUT_CASES = [("h2o-danube-1.8b", 2, 2, 0), ("h2o-danube-1.8b", 1, 4, 0),
                ("phi4-mini-3.8b", 2, 2, 0), ("phi4-mini-3.8b", 1, 4, 0),
                ("h2o-danube-1.8b", 1, 4, 2),
                ("deepseek-v2-lite-16b", 2, 2, 0),
                ("deepseek-v2-lite-16b", 1, 4, 0),
                ("llama4-scout-17b-a16e", 1, 4, 0)]


@pytest.fixture(scope="module")
def reference_layout(tmp_path_factory):
    """Each case's slices by leaf and device (d, k), from the
    reference's ``replica_param_shardings`` on four forced host
    devices."""
    tmp = tmp_path_factory.mktemp("layout")
    (tmp / "layout.py").write_text(textwrap.dedent(_LAYOUT_SCRIPT))
    _finish(_start([sys.executable, str(tmp / "layout.py"),
                    json.dumps(LAYOUT_CASES), str(tmp / "out.json")],
                   _forced(4)), "the reference's shardings")
    return json.loads((tmp / "out.json").read_text())


@pytest.mark.parametrize("case", LAYOUT_CASES,
                         ids=lambda c: f"{c[0]}-data{c[1]}-model{c[2]}"
                         + (f"-kv{c[3]}" if c[3] else ""))
def test_two_axis_layout_matches_reference(reference_layout, case):
    """Rank (d, k)'s leaves, its model slices then its FSDP shards of
    them, are the slices the reference's ``replica_param_shardings``
    places on device (0, d, k), bit for bit, for every leaf; each has
    the partition rules' shard shape over ``{"data": g, "model": M}``
    (the kv heads whole where M does not divide them; MLA's heads on
    dim 1 or 0 and its latent projections whole; the experts' 3-D
    leaves with the experts over ``model`` and d_model over ``data``,
    the router whole)."""
    arch, g, M_, kv = case
    cfg = smoke_variant(get_config(arch))
    if kv:
        cfg = dataclasses.replace(cfg, num_kv_heads=kv)
    params = M.init_params(torch.Generator().manual_seed(1), cfg)
    want = reference_layout[json.dumps(list(case))]
    mdims, ddims = model_dims(params, M_), leaf_dims(params, g, M_)
    shapes = _shape_list(port.replica_param_shardings(params, g, M_))
    sliced = 0
    for d in range(g):
        for k in range(M_):
            mine = shard_tree(shard_tree(params, k, M_, mdims), d, g, ddims)
            for (path, leaf), (_, got), shape in zip(
                    _leaves(params), _leaves(mine), shapes):
                idx = want["/".join(path)][d * M_ + k]
                ref = leaf[tuple(slice(a, b) for a, b in idx)]
                assert tuple(got.shape) == shape, path
                assert torch.equal(got, ref), (path, d, k)
                sliced += got.numel() < leaf.numel()
    assert sliced > 0
    if kv:
        assert all(mdims[p] is None for p, _ in _leaves(params)
                   if p[-1] in ("wk", "wv"))


def _shape_list(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _shape_list(v)]
    if isinstance(tree, (tuple, list)) and tree and \
            not isinstance(tree[0], int):
        return [x for v in tree for x in _shape_list(v)]
    return [tuple(tree)]


# ------------------------------------------------- the gradient, 4 ranks

_GRAD_SCRIPT = """
    import dataclasses, sys
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config, smoke_variant
    from repro_torch.core import gradient
    from repro_torch.data.synthetic import token_stream
    from repro_torch.launch.mesh import Collectives
    from repro_torch.models import model as M
    from repro_torch.parallel.partition import map_with_path
    from repro_torch.parallel.tensor import TensorParallel
    torch.use_deterministic_algorithms(True)
    # cases of (arch, kv, remat, seq), one after another, then the out dir
    *cases, out = sys.argv[1:]
    dist.init_process_group("gloo")
    rank, W = dist.get_rank(), dist.get_world_size()
    done = []
    for i in range(0, len(cases), 4):
        arch, kv, remat, seq = cases[i], int(cases[i + 1]), cases[i + 2], \\
            int(cases[i + 3])
        cfg = dataclasses.replace(smoke_variant(get_config(arch)), remat=remat)
        if kv:
            cfg = dataclasses.replace(cfg, num_kv_heads=kv)
        params = M.init_params(torch.Generator().manual_seed(0), cfg)
        batch = next(token_stream(0, cfg.vocab_size, 2, seq))
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        grad = lambda p, tp=None: gradient.grad_and_value(
            lambda q: M.loss_fn(q, batch, cfg, tp=tp), has_aux=True)(p)
        want_g, (want_l, _) = grad(params)
        comm = Collectives(torch.device("cpu"), W)
        tp = TensorParallel(cfg, params, comm)
        got_g, (got_l, _) = grad(tp.slice(params), tp)
        got_g = tp.sum_partial(got_g)
        # every MoE layer routed alike on every rank of the model group
        moe = any(f == "moe" for _, f in cfg.block_pattern)
        assert (tp.routing is not None) == moe, tp.routing
        routes = (tp.routing if moe else torch.zeros((), dtype=torch.int64)
                  ).reshape(1)
        parts = [torch.empty_like(routes) for _ in range(W)]
        dist.all_gather(parts, routes)
        assert all(torch.equal(parts[0], q) for q in parts), parts
        torch.testing.assert_close(got_l, want_l, rtol=1e-5, atol=1e-6)
        rows = []
        map_with_path(lambda p, t: rows.append((p, t)), tp.slice(want_g))
        got = []
        map_with_path(lambda p, t: got.append((p, t)), got_g)
        whole = 0
        for (path, w), (_, s) in zip(rows, got):
            torch.testing.assert_close(s, w, rtol=1e-5, atol=1e-6,
                                       msg=lambda m: f"{path}: {m}")
            if tp.whole(path):
                # the same bits on every rank of the model group
                parts = [torch.empty_like(s) for _ in range(W)]
                dist.all_gather(parts, s.contiguous())
                assert all(torch.equal(parts[0], q) for q in parts), path
                whole += 1
        assert whole > 0 and comm.seconds_by["tensor"] > 0
        done.append(f"{arch} {float(got_l)} {whole}")
    with open(f"{out}/ok{rank}", "w") as f:
        f.write("\\n".join(done))
    dist.destroy_process_group()
"""


@pytest.mark.parametrize("arch,kv,remat,seq", [
    ("h2o-danube-1.8b", 2, "none", 16),
    ("phi4-mini-3.8b", 0, "block", 1040),
    ("deepseek-v2-lite-16b", 0, "block", 16),
    ("llama4-scout-17b-a16e", 0, "none", 16)])
def test_tensor_parallel_gradient_on_four_ranks(tmp_path, arch, kv, remat,
                                                seq):
    """Four gloo ranks, one model group of M 4, each on the same rows:
    the loss and each rank's gradient (its slices; a whole kv-head
    leaf's summed over the group) within rtol 1e-5 / atol 1e-6 of the
    port's own ``mesh_model=1`` loss and gradient, float32.  KV 2 under
    M 4 is the sanitize path (``wk``/``wv``/``bk``/``bv`` whole, each
    rank's query heads finding their kv head in them); phi4-mini-3.8b's
    case ties the embedding and rematerialises each block group and
    query block at S 1040, so the recompute issues the tensor
    collectives again.  deepseek-v2-lite-16b (MLA + MoE, its block
    group rematerialised) and llama4-scout-17b-a16e (attention + MoE
    with a shared expert): a rank's heads and E/M experts, the latent
    projections and the router whole.  The gradients of leaves whole on
    every model rank are bitwise equal across the group, and so is each
    MoE layer's routing digest (``gate_idx`` and ``keep``)."""
    script = tmp_path / "grad.py"
    script.write_text(textwrap.dedent(_GRAD_SCRIPT))
    _finish(_start(_torchrun(4, str(script), arch, str(kv), remat,
                             str(seq), str(tmp_path)), _env()),
            "the tensor-parallel gradient")
    assert all((tmp_path / f"ok{r}").read_text().startswith(arch)
               for r in range(4))


# ----------------------------------- run_training on four gloo ranks

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
    # each step's aux metric (the driver keeps it out of its history):
    # the replica step's jit, seen through the driver's name for jax
    AUX = []

    class _Jax:
        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def jit(fn, **kw):
            f = jax.jit(fn, **kw)

            def g(*args):
                out = f(*args)
                if isinstance(out, tuple) and len(out) == 3 and \
                        isinstance(out[2], dict) and "aux" in out[2]:
                    AUX.append(float(out[2]["aux"]))
                return out
            return g
    train.jax = _Jax()
    spec = ExperimentSpec.from_json(open(sys.argv[1]).read())
    params, history, stats = train.run_training(spec, verbose=False)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    save_checkpoint(sys.argv[2], params, spec.steps)
    with open(sys.argv[2] + ".run.json", "w") as f:
        json.dump({"history": history, "stats": stats, "aux": AUX}, f)
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
    # the final params cross to rank 0 in many pieces
    train.SEGMENT_PIECE = 1 << 16
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


def _against_reference(tmp_path, arch, mode, mesh_model, dtype="float32",
                       microbatch=1, steps=4, seq=16):
    """``arch``'s smoke variant over ``steps`` steps of 8 rows of
    ``seq`` on four gloo ranks at ``mesh_model`` and the reference's
    ``run_training`` on four forced host devices at the same
    ``mesh_model``, from the reference's initial params.  Checks the
    counters, the merges and the history's steps; returns the two runs
    (each reference record with its step's ``aux`` metric) and the
    final params as float32 arrays."""
    fields = dict(arch=arch, backend="spmd", mode=mode, steps=steps,
                  batch=8, seq=seq, smoke=True, log_every=1,
                  mesh_model=mesh_model)
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
                    _forced(4))
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
        assert st[k] == ref_run["stats"][k], k
    assert st["mesh_model"] == mesh_model
    assert all(p["model"] == mesh_model for p in st["layout"])
    hr, hp = ref_run["history"], port_run["history"]
    for h in hr:
        h["aux"] = ref_run["aux"][h["step"]]
    assert [(h["step"], h["group_size"], h["replicas"]) for h in hp] == \
        [(h["step"], h["group_size"], h["replicas"]) for h in hr]
    assert all((h["divergence"] > 0) == (h["replicas"] > 1) for h in hp)
    got, want = _npz(tmp_path / "port_final.npz"), \
        _npz(tmp_path / "ref_final.npz")
    assert sorted(got) == sorted(want)
    return st, hp, hr, got, want


def test_h2o_hybrid_mesh_model_2_matches_reference(tmp_path):
    """h2o-danube-1.8b smoke, float32, hybrid step:2 at ``mesh_model=2``
    (data 2 x model 2): g 1 -> 2, R 2 -> 1, merges at K 2 and 1, the g 2
    phase in the FSDP layout over each data column; losses, divergence
    and final params within rtol 1e-5 / atol 1e-6 of the reference, its
    counters equal (6 gradients in 4 steps)."""
    st, hp, hr, got, want = _against_reference(
        tmp_path, "h2o-danube-1.8b", "hybrid", 2)
    assert [m["K"] for m in st["merges"]] == [2, 1]
    assert [(p["g"], p["fsdp"]) for p in st["layout"]] == \
        [(1, False), (2, True)]
    assert [h["group_size"] for h in hp] == [1, 1, 2, 2]
    assert st["num_gradients"] == 6
    for key in ("loss", "divergence"):
        np.testing.assert_allclose([h[key] for h in hp],
                                   [h[key] for h in hr], rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_phi4_sync_mesh_model_4_bf16_matches_reference(tmp_path):
    """phi4-mini-3.8b smoke in bf16, sync at ``mesh_model=4`` (data 1 x
    model 4, so g 1 and R 1), 2 micro-batches a rank: its tied
    embedding a vocabulary-parallel lookup and head, the loss
    vocabulary-parallel; losses and final params within C.45's bf16
    tolerance of the reference."""
    st, hp, hr, got, want = _against_reference(
        tmp_path, "phi4-mini-3.8b", "sync", 4, dtype="bfloat16",
        microbatch=2)
    assert [m["K"] for m in st["merges"]] == [1]
    assert [h["group_size"] for h in hp] == [1] * 4
    np.testing.assert_allclose([h["loss"] for h in hp],
                               [h["loss"] for h in hr], **BF16_TOL)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **BF16_TOL)


# ------------------------------------------------------------ the refusal

@pytest.mark.parametrize("arch", ["xlstm-350m", "hubert-xlarge",
                                  "jamba-v0.1-52b"])
def test_other_families_are_refused_naming_a16c(arch):
    """What has no tensor-parallel form raises before any rank starts;
    it never runs with M 1: a frontend (hubert) at ``mesh_model`` 2, and
    the xLSTM cells and mamba (which have a form since the model axis
    covers them) at an M that does not divide their 4 heads."""
    model = 2 if arch == "hubert-xlarge" else 3
    spec = ExperimentSpec(backend="spmd", arch=arch, smoke=True,
                          mesh_model=model, steps=1, batch=2, seq=8)
    with pytest.raises(ValueError, match=f"mesh_model={model}.*A16c"):
        run_training(spec, verbose=False, device="cpu")


@pytest.mark.parametrize("field,value,what", [
    ("num_experts", 6, r"num_experts \(6\)"),
    ("moe_d_ff", 250, r"moe_d_ff \* num_shared_experts \(250\)")])
def test_mesh_model_must_divide_the_experts(field, value, what):
    """M 4 divides deepseek-v2-lite-16b smoke's heads and vocabulary but
    not 6 experts, nor a shared expert 250 wide: refused, naming the
    dimension, before any rank starts."""
    cfg = dataclasses.replace(smoke_variant(get_config(
        "deepseek-v2-lite-16b")), **{field: value})
    with pytest.raises(ValueError,
                       match=f"mesh_model=4 does not divide .*{what}.*A16c"):
        check_model_axis(cfg, 4)
    check_model_axis(cfg, 2)


def test_mesh_model_must_divide_the_world():
    """One process is a world of one rank: M 2 does not divide it, as
    the reference raises where M does not divide its devices."""
    spec = ExperimentSpec(backend="spmd", arch="h2o-danube-1.8b",
                          smoke=True, mesh_model=2, steps=1, batch=2, seq=8)
    with pytest.raises(ValueError, match="mesh_model=2 must divide"):
        run_training(spec, verbose=False, device="cpu")


# ------------------------------------------------------------- the dry-run

@pytest.mark.parametrize("cards,model", [(4, 2), (4, 4)])
def test_dryrun_model_axis_state_and_tensor_collectives(cards, model):
    """``dryrun --cards N --model M``: the traced step's state is the
    partition rules' shard bytes over ``{"data": N/M, "model": M}``, and
    its tensor collectives are counted from its calls: per micro-batch
    and layer an all-reduce of the (B, S, D) activations forward and
    backward at the attention and the MLP, and at the embedding, the
    head and the gold logit; one all-gather of the local logsumexps."""
    from repro_torch.configs.registry import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.optim.optimizers import adamw
    cfg = smoke_variant(get_config("h2o-danube-1.8b"))
    m, B, S = 2, 8, 32
    lay = dryrun.fsdp_layout(cfg, InputShape("t", S, B, "train"), cards,
                             microbatch=m, optimizer=adamw(1e-3),
                             model=model)
    params = dryrun.meta_params(cfg)
    g = cards // model
    mesh = {"data": g, "model": model}
    assert lay["mesh"] == mesh and "peak_traced" in lay
    want = sum(-(-int(np.prod(s)) * t.element_size() // 512) * 512
               for s, (_, t) in zip(_shape_list(param_shardings(params,
                                                                mesh)),
                                    _leaves(params)))
    assert lay["state_bytes"]["params"] == want
    rows = B // g // m
    act = rows * S * cfg.d_model * 4            # float32 smoke weights
    ring = (model - 1) / model
    L = cfg.num_groups * len(cfg.block_pattern)
    # forward and backward: 2 per layer half, plus the embedding and the
    # head's input; the gold logit (rows, S) float32 forward
    ar = m * 2 * ring * (2 * L * act * 2 + act + act
                         + rows * S * 4)
    ag = m * ring * rows * S * 4 * model
    coll = lay["collective_bytes_per_device"]
    assert coll["tensor all-reduce"] == pytest.approx(ar)
    assert coll["tensor all-gather"] == pytest.approx(ag)
