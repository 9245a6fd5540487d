"""The ``model`` axis of the SPMD trainer for mamba and the xLSTM cells
(``parallel/tensor.py``, ``models/mamba.py``, ``models/xlstm.py``):
jamba-v0.1-52b smoke (mamba + MLP, mamba + MoE) and xlstm-350m smoke
(mLSTM + sLSTM) on four gloo ranks against the reference's
``run_training`` on four forced host devices, hybrid at ``mesh_model``
2 (the sync runs are ``test_torch_tensor_ssm_sync.py``); the
tensor-parallel gradient against the port's own
M 1 one; mamba's paired ``w_in`` gathered and checkpointed in the
reference's whole layout; the params drawn sliced leaf by leaf; the
refusals; and the dry-run's tensor collectives for the recurrences.
The harness is ``test_torch_tensor.py``'s."""
import dataclasses
import json
import textwrap
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import InputShape, get_config, \
    smoke_variant
from repro_torch.models import model as M
from repro_torch.parallel.tensor import TensorParallel, check_model_axis
from test_torch_tensor import (ATOL, RTOL, _GRAD_SCRIPT, _against_reference,
                               _env, _finish, _leaves, _shape_list, _start,
                               _torchrun)

torch.set_num_threads(2)
JAMBA, XLSTM = "jamba-v0.1-52b", "xlstm-350m"


def _groups_equal(values, M_):
    """Each model group's ranks (``r // M``) hold one value."""
    return all(values[r] == values[r - r % M_] for r in range(len(values)))


def _close(hp, hr, keys, got, want, **tol):
    tol = tol or dict(rtol=RTOL, atol=ATOL)
    for key in keys:
        np.testing.assert_allclose([h[key] for h in hp],
                                   [h[key] for h in hr], err_msg=key, **tol)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


# --------------------------------------- run_training against the reference

@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_hybrid_mesh_model_2_matches_reference(tmp_path, arch):
    """jamba-v0.1-52b smoke (two mamba layers, one with the MoE) and
    xlstm-350m smoke (mLSTM, sLSTM), float32, hybrid step:2 at
    ``mesh_model=2`` (data 2 x model 2): g 1 -> 2, merges at K 2 and 1,
    the g 2 phase in the FSDP layout over each data column; losses
    (and jamba's aux), divergence and final params within rtol 1e-5 /
    atol 1e-6 of the reference, its counters equal; the whole leaves
    (the norms; jamba's router; the mLSTM's ``lq``/``lk``/``lv``/
    ``w_if``/``b_if``, the sLSTM's ``gn_scale`` and FFN) and jamba's
    routing equal across each model group.  jamba takes 8 rows of 128,
    so each data position's 512 tokens are one MoE group, as the
    reference groups them (ROADMAP C.48).  Rank 0's final params are
    assembled by ``gather_host``, so mamba's paired ``w_in`` comes back
    in the reference's whole layout."""
    st, hp, hr, got, want = _against_reference(
        tmp_path, arch, "hybrid", 2, seq=128 if arch == JAMBA else 16)
    assert [m["K"] for m in st["merges"]] == [2, 1]
    assert [(p["g"], p["fsdp"]) for p in st["layout"]] == \
        [(1, False), (2, True)]
    assert st["num_gradients"] == 6
    assert _groups_equal(st["whole_digest_by_rank"], 2)
    keys = ["loss", "divergence"]
    if arch == JAMBA:
        assert _groups_equal(st["routing_digest_by_rank"], 2)
        keys.append("aux")
    assert any(k.endswith("w_in") for k in want) == (arch == JAMBA)
    _close(hp, hr, keys, got, want)


# ------------------------------------------------- the gradient, 4 ranks

GRAD_CASES = [(JAMBA, 64), (XLSTM, 128)]


@pytest.fixture(scope="module")
def four_rank_gradients(tmp_path_factory):
    """One torchrun of four gloo ranks takes every case of
    :data:`GRAD_CASES` in turn; each rank's ``ok`` file lists the cases
    it held."""
    tmp = tmp_path_factory.mktemp("grad")
    script = tmp / "grad.py"
    script.write_text(textwrap.dedent(_GRAD_SCRIPT))
    cases = [a for arch, seq in GRAD_CASES
             for a in (arch, "0", "block", str(seq))]
    _finish(_start(_torchrun(4, str(script), *cases, str(tmp)), _env()),
            "the tensor-parallel gradient")
    return [(tmp / f"ok{r}").read_text().splitlines() for r in range(4)]


@pytest.mark.parametrize("arch,seq", GRAD_CASES)
def test_tensor_parallel_gradient_on_four_ranks(four_rank_gradients, arch,
                                                seq):
    """Four gloo ranks, one model group of M 4, each on the same rows,
    remat "block" (each block group and each mamba or mLSTM chunk
    checkpointed: mamba's in-chunk ``proj`` all-reduce runs again in the
    recompute): the loss and each rank's gradient (its slices; the
    mLSTM's whole ``lq``/``lk``/``lv``/``w_if``/``b_if`` summed over the
    group) within rtol 1e-5 / atol 1e-6 of the port's own M 1 loss and
    gradient, float32, and the gradients of every leaf whole on the
    model ranks bitwise equal across the group (the sLSTM's, which every
    rank computes alike, and the summed ones)."""
    for held in four_rank_gradients:
        (line,) = [x for x in held if x.split()[0] == arch]
        assert int(line.split()[2]) > 0


# ----------------------------- w_in: gathered and checkpointed whole

_W_IN_SCRIPT = """
    import dataclasses, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.api.spec import ExperimentSpec
    from repro_torch.configs.registry import get_config, smoke_variant
    from repro_torch.launch.mesh import Collectives
    from repro_torch.launch.train import run_training
    from repro_torch.models import model as M
    from repro_torch.multicard_smoke import final_summary
    from repro_torch.parallel.partition import map_with_path
    from repro_torch.parallel.tensor import TensorParallel
    out = sys.argv[1]
    dist.init_process_group("gloo")
    rank = dist.get_rank()
    cfg = smoke_variant(get_config("jamba-v0.1-52b"))
    whole = M.init_params(torch.Generator().manual_seed(0), cfg)
    comm = Collectives(torch.device("cpu"), 2)
    tp = TensorParallel(cfg, whole, comm)
    mine = tp.slice(whole)
    w = mine["groups"][0]["mixer"]["w_in"]
    di = cfg.mamba_d_inner
    # this rank's channels of xi and of z, side by side
    ref = whole["groups"][0]["mixer"]["w_in"]
    k = comm.k
    want = torch.cat([ref[..., k * di // 2:(k + 1) * di // 2],
                      ref[..., di + k * di // 2:di + (k + 1) * di // 2]], -1)
    assert torch.equal(w, want)
    back = tp.gather_host(mine, torch.device("cpu"), 1 << 10)
    if rank == 0:
        got, ref = [], []
        map_with_path(lambda p, t: got.append((p, t)), back)
        map_with_path(lambda p, t: ref.append((p, t)), whole)
        assert [p for p, _ in got] == [p for p, _ in ref]
        for (p, a), (_, b) in zip(got, ref):
            assert a.device.type == "cpu" and torch.equal(a, b), p
    else:
        assert back is None
    # a run that changes nothing (lr 0) checkpoints the initial params
    spec = ExperimentSpec(arch="jamba-v0.1-52b", backend="spmd", mode="sync",
                          steps=1, batch=2, seq=16, lr=0.0, smoke=True,
                          mesh_model=2)
    final, _, stats = run_training(spec, ckpt_dir=out, verbose=False,
                                   device="cpu")
    if rank == 0:
        # the returned params' whole leaves are the ranks' (a sync run's
        # params keep their drawn dicts' order; the digests take the
        # slab's)
        digest = final_summary(final, 2, 0.0)["whole_digest"]
        assert stats["whole_digest_by_rank"] == [digest] * 2, \
            (stats["whole_digest_by_rank"], digest)
        with np.load(f"{out}/step_1.npz") as z:
            flat = []
            map_with_path(lambda p, t: flat.append(("/".join(p), t)), whole)
            for key, t in flat:
                assert np.array_equal(z[key], t.numpy()), key
        open(f"{out}/ok", "w").write("ok")
    dist.destroy_process_group()
"""


def test_gather_host_and_checkpoint_give_the_whole_w_in(tmp_path):
    """Two gloo ranks at M 2 on jamba smoke: a rank's ``w_in`` holds its
    di/M channels of ``xi`` and of ``z`` side by side; ``gather_host``
    (in pieces of 1,024 elements) gives rank 0 every leaf of the whole
    tree bit for bit in host memory, ``w_in`` in the reference's layout;
    and a sync run's checkpoint (lr 0, so the params are the initial
    ones) holds the whole ``w_in`` too, and the whole leaves of the
    params it returns digest as its ranks' do (ROADMAP C.49)."""
    script = tmp_path / "w_in.py"
    script.write_text(textwrap.dedent(_W_IN_SCRIPT))
    _finish(_start(_torchrun(2, str(script), str(tmp_path)), _env()),
            "the gather and the checkpoint")
    assert (tmp_path / "ok").exists()


# ---------------------------------------------------- the sliced draw

@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "deepseek-v2-lite-16b",
                                  JAMBA, XLSTM])
def test_sliced_draw_equals_whole_then_slice(arch):
    """``init_params(gen, cfg, tp.take)``, each leaf sliced on the host
    as it is drawn (``launch/train.py``), gives each model index at M 2
    the params the whole draw sliced by ``tp.slice`` gives, bit for bit:
    the same draws in the same order."""
    cfg = smoke_variant(get_config(arch))
    whole = M.init_params(torch.Generator().manual_seed(3), cfg)
    for k in range(2):
        tp = TensorParallel(cfg, whole, types.SimpleNamespace(model=2, k=k))
        want = _leaves(tp.slice(whole))
        got = _leaves(M.init_params(torch.Generator().manual_seed(3), cfg,
                                    tp.take))
        assert [p for p, _ in got] == [p for p, _ in want]
        sliced = 0
        for (p, a), (_, b) in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (p, k)
            sliced += a.numel() < dict(_leaves(whole))[p].numel()
        assert sliced > 0


# ----------------------------------------------------------- refusals

@pytest.mark.parametrize("arch,fields,model,what", [
    (JAMBA, dict(d_model=258, mamba_expand=1), 4, r"mamba_d_inner \(258\)"),
    (XLSTM, dict(d_model=257), 4, r"mLSTM inner width \(514\)"),
    (XLSTM, dict(d_model=257), 2, r"d_model .*\(257\)"),
    (XLSTM, {}, 3, r"num_heads \(4\)")])
def test_mesh_model_must_divide_the_inner_widths(arch, fields, model, what):
    """An M that does not divide mamba's inner width, the mLSTM's inner
    width, the sLSTM's gate channels (d_model) or the heads is refused,
    naming the dimension and A16c, before any rank starts."""
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), **fields)
    with pytest.raises(ValueError, match=f"mesh_model={model} does not "
                       f"divide .*{what}.*A16c"):
        check_model_axis(cfg, model)


def test_frontends_are_still_refused():
    """A frontend (hubert-xlarge's audio, phi-3-vision's) has no
    tensor-parallel form: refused at M 2, naming A16c."""
    for arch in ("hubert-xlarge", "phi-3-vision-4.2b"):
        cfg = smoke_variant(get_config(arch))
        with pytest.raises(ValueError, match="mesh_model=2.*frontend.*A16c"):
            check_model_axis(cfg, 2)
    for arch in (JAMBA, XLSTM):
        check_model_axis(smoke_variant(get_config(arch)), 2)
        check_model_axis(smoke_variant(get_config(arch)), 4)


# ------------------------------------------------------------- the dry-run

@pytest.mark.parametrize("arch,model", [(JAMBA, 2), (JAMBA, 4),
                                        (XLSTM, 2), (XLSTM, 4)])
def test_dryrun_model_axis_ssm_collectives(arch, model):
    """``dryrun --cards 4 --model M`` on jamba and xlstm smoke: the state
    is the partition rules' shard bytes over ``{"data": 4/M, "model":
    M}`` to the byte (mamba's paired ``w_in`` is as large as a
    contiguous slice), and the tensor collectives are counted from the
    calls, the recurrences' from three trip counts extrapolated to the
    sequence's (8 mamba chunks, 5 mLSTM chunks, 320 sLSTM steps).  Per
    micro-batch: a mamba layer all-reduces its input's gradient, its
    output and, in each chunk, ``proj`` forward and its gradient
    backward; an mLSTM layer its input's gradient and its output, and it
    all-gathers ``xc`` and ``u`` forward and reduce-scatters their
    gradients backward; an sLSTM layer all-reduces its input's gradient
    and all-gathers its gate pre-activations and ``r_h``; the MLP, the
    MoE, the embedding, the head and the loss as in the dense and MoE
    tests."""
    from repro_torch.launch import dryrun
    from repro_torch.optim.optimizers import adamw
    from repro_torch.parallel.partition import param_shardings
    cfg = smoke_variant(get_config(arch))
    cards, m, B = 4, 2, 8
    S = 64 if arch == JAMBA else 320
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
    f32 = rows * S * 4                          # float32 smoke weights
    act = f32 * cfg.d_model
    ring = (model - 1) / model
    ends = act + act + f32                      # embedding, head, gold
    ag = f32 * model                            # the logsumexps
    rs = 0.0
    if arch == JAMBA:
        proj = f32 * (cfg.resolved_dt_rank + 2 * cfg.mamba_d_state)
        mamba = 2 * act + 2 * proj
        mlp = 2 * act
        moe = 2 * act + f32 * cfg.num_experts_per_tok
        ar = 2 * mamba + mlp + moe + ends
    else:
        di, H = 2 * cfg.d_model, cfg.num_heads
        dh = cfg.d_model // H
        ar = 2 * act + act + ends               # mLSTM, sLSTM
        ag += 2 * f32 * di + f32 * 4 * cfg.d_model + 4 * H * dh * 4 * dh
        rs += 2 * f32 * di
    coll = lay["collective_bytes_per_device"]
    assert coll["tensor all-reduce"] == pytest.approx(m * 2 * ring * ar)
    assert coll["tensor all-gather"] == pytest.approx(m * ring * ag)
    assert coll["tensor reduce-scatter"] == pytest.approx(m * ring * rs)


def test_dryrun_cli_traces_the_model_axis(tmp_path):
    """``dryrun --arch xlstm-350m --shape train_4k --cards 4 --model 2``
    (full width, meta device) writes an ``ok`` record with ``fits`` and
    the tensor collectives, where the model axis was skipped naming
    A16c before."""
    from repro_torch.launch import dryrun
    rc = dryrun.main(["--arch", XLSTM, "--shape", "train_4k", "--cards",
                      "4", "--model", "2", "--out-dir", str(tmp_path)])
    assert rc == 0
    (path,) = tmp_path.glob("*.json")
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and isinstance(rec["fits"], bool)
    coll = rec["layouts"][dryrun.FSDP]["collective_bytes_per_device"]
    assert coll["tensor all-reduce"] > 0 and coll["tensor all-gather"] > 0
    assert coll["tensor reduce-scatter"] > 0
