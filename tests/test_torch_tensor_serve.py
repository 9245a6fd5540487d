"""The serving forward over the ``model`` axis (ROADMAP A16c.5,
``launch/serve.py``, ``models/model.py::decode_step``,
``parallel/tensor.py``): the sliced prefill and greedy decode on four
gloo ranks, at data 2 x model 2 and at data 1 x model 4, against the
reference's ``forward`` and ``decode_step`` on the same params.

One torchrun a model width runs every case; the reference's runs, and
the port's own on the whole params, are taken in this process
meanwhile.  Each case holds, in float32: the last-position prefill
logits, gathered whole over the vocabulary; every decode step's logits
of the sliced decode fed the run's tokens; the greedy tokens (equal);
and each rank's cache slice gathered whole after the run.  They are
held within rtol 1e-5 / atol 2e-5 of the reference, and within twice
the whole-params port's own distance to it (plus 1e-6): the
whole-params port is up to 1.05e-05 from the reference on xlstm smoke's
decode logits (|logit| up to 4.5), so atol 1e-6 is out of its reach, and
the slicing must not add to that gap.  The cases: h2o smoke (a ring
over its window of 16, with a 24-token prompt), h2o smoke with 2 kv
heads (at model 4 the cache's sequence is split over the model group),
deepseek smoke (MLA + the MoE at 16 rows and a capacity factor of 0.5,
so every decode step drops tokens and a data position's queues continue
the one's before), jamba smoke (mamba + MLP, mamba + MoE) and xlstm
smoke (mLSTM, sLSTM).  The harness is ``test_torch_tensor.py``'s.

Regime (b) (ROADMAP A16c.5b): a batch the data positions do not divide
(``long_500k``'s B 1) is served on every rank, the cache cut along its
sequence over ``data`` (over ``data x model`` where M does not divide
the kv heads, and for MLA's latent) and the states' channels over
``data x model``.  Its cases run at B 1 at data 2 x model 2 (h2o, h2o
with one kv head, deepseek, jamba, xlstm) and at data 4 x model 1 (h2o,
jamba), and at B 3 at data 2 x model 2 (deepseek with a capacity factor
of 0.5, its prefill's 72 tokens routing 144 choices into 72 slots),
held as above, every rank's tokens equal."""
import dataclasses
import json
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as ref_save_checkpoint
from repro.configs.registry import get_config as ref_get_config
from repro.configs.registry import smoke_variant as ref_smoke_variant
from repro.models import model as RM
from repro_torch.checkpoint.ckpt import restore_checkpoint
from repro_torch.configs.registry import get_config, smoke_variant
from repro_torch.launch.serve import data_rows, prefill_step
from repro_torch.models import model as M
from repro_torch.parallel.partition import cache_shardings
from repro_torch.parallel.tensor import (cache_dims, slice_cache,
                                         unslice_cache)
from test_torch_tensor import RTOL, _env, _finish, _start, _torchrun

torch.set_num_threads(2)
# the whole-params port's own distance to the reference, with room
SERVE_ATOL = 2e-5
PROMPT, GEN, MAX_SEQ = 24, 8, 32
# name -> (arch, config fields, batch)
CASES = {
    "h2o": ("h2o-danube-1.8b", {}, 8),
    "h2o_kv2": ("h2o-danube-1.8b", {"num_kv_heads": 2}, 8),
    "deepseek": ("deepseek-v2-lite-16b", {"moe_capacity_factor": 0.5}, 16),
    "jamba": ("jamba-v0.1-52b", {}, 8),
    "xlstm": ("xlstm-350m", {}, 8),
}
# regime (b): name -> (arch, config fields, batch, the model widths it
# runs at on four ranks), a batch the data positions do not divide
SPREAD = {
    "h2o_b1": ("h2o-danube-1.8b", {}, 1, (2, 1)),
    "h2o_kv1_b1": ("h2o-danube-1.8b", {"num_kv_heads": 1}, 1, (2,)),
    "deepseek_b1": ("deepseek-v2-lite-16b", {}, 1, (2,)),
    "jamba_b1": ("jamba-v0.1-52b", {}, 1, (2, 1)),
    "xlstm_b1": ("xlstm-350m", {}, 1, (2,)),
    "deepseek_b3": ("deepseek-v2-lite-16b", {"moe_capacity_factor": 0.5},
                    3, (2,)),
}
# every case: name -> (arch, config fields, batch)
ALL = {**CASES, **{k: v[:3] for k, v in SPREAD.items()}}


# the torchruns, each four ranks at a model width, in two waves of three
# (with the serve smoke's), so that no more ranks run at once than three
# torchruns have: the cases the data axis divides at 2 and 4, then
# regime (b)'s at 2 and 1
WAVES = (((2, CASES), (4, CASES)), tuple(
    (m, {k: v[:3] for k, v in SPREAD.items() if m in v[3]}) for m in (2, 1)))

_CHILD = """
    import dataclasses, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.ckpt import restore_checkpoint
    from repro_torch.configs.registry import get_config, smoke_variant
    from repro_torch.launch.mesh import Collectives
    from repro_torch.launch.serve import (data_rows, greedy_generate,
                                          prefill_step)
    from repro_torch.models import model as M
    from repro_torch.parallel.fsdp import GroupShards
    from repro_torch.parallel.tensor import (TensorParallel, cache_dims,
                                             unslice_cache)
    torch.set_num_threads(1)
    out_dir, model = sys.argv[1], int(sys.argv[2])
    cases = json.loads(sys.argv[3])
    prompt, gen, max_seq = (int(a) for a in sys.argv[4:7])
    dist.init_process_group("gloo")
    W, rank = dist.get_world_size(), dist.get_rank()
    for name, (arch, fields, B) in cases.items():
        cfg = dataclasses.replace(smoke_variant(get_config(arch)), **fields)
        like = M.init_params(torch.Generator().manual_seed(0), cfg)
        params, _ = restore_checkpoint(f"{out_dir}/{name}_init", like)
        comm = Collectives(torch.device("cpu"), model=model)
        g, d = W // model, comm.position
        tp = TensorParallel(cfg, params, comm) if model > 1 else None
        mine = params if tp is None else tp.slice(params)
        gather = column = None
        if g > 1:
            column = GroupShards(mine, g, d, comm, model)
            mine, gather = column.shard(mine), column.gather
        prompts = np.load(f"{out_dir}/{name}_prompts.npy")
        rows = data_rows(B, column)
        with torch.no_grad():
            pre = prefill_step(mine, {"tokens": torch.as_tensor(
                prompts[rows])}, cfg, gather, tp, column, global_batch=B)
            toks = greedy_generate(cfg, mine, prompts, gen, max_seq, gather,
                                   tp, column)
            # the decode fed the run's tokens, every step's logits
            cache = M.init_cache(cfg, B, max_seq, tp=tp, data=g)
            steps = []
            for i in range(prompt + gen):
                logits, _ = M.decode_step(
                    mine, cache, torch.as_tensor(toks[:, i:i + 1]), i, cfg,
                    gather, tp, column, max_seq, global_batch=B)
                steps.append((logits if tp is None
                              else tp.gather(logits, -1))[:, 0])
            dec = torch.stack(steps, 1)
        got = [None] * W
        dist.all_gather_object(got, {"pre": pre.numpy(), "toks": toks,
                                     "dec": dec.numpy(), "cache": cache})
        if rank == 0:
            # the ranks serving the same rows: a model group, or every
            # rank where the positions do not divide the batch
            spread = B % g != 0
            heads = [got[0]] if spread else [got[p * model]
                                             for p in range(g)]
            dims = cache_dims(M.init_cache(cfg, B, max_seq, device="meta"),
                              B, g, model)
            whole = unslice_cache([o["cache"] for o in got], dims, g, model)
            out = {f"cache/{j}/{k}": v.numpy()
                   for j, c in enumerate(whole) for k, v in c.items()}
            for key in ("pre", "toks", "dec"):
                out[key] = np.concatenate([h[key] for h in heads])
            out["toks_equal"] = np.array(all(
                np.array_equal(o["toks"], got[0 if spread else r - r % model]
                               ["toks"]) for r, o in enumerate(got)))
            np.savez(f"{out_dir}/{name}_m{model}.npz", **out)
    dist.destroy_process_group()
"""


# repro_torch/serve_smoke.py, what the card scripts run, on the CPU in
# bf16 (the card's dtype): 4 prompts, xlstm at data 2 x model 2,
# deepseek at model 4; 1 prompt (regime (b)), h2o and xlstm at data 2 x
# model 2
SMOKE_CASES = (("xlstm-350m", 2), ("deepseek-v2-lite-16b", 4))
SPREAD_SMOKE = (("h2o-danube-1.8b", 2), ("xlstm-350m", 2))
_SMOKE_CHILD = """
    import dataclasses, json, sys
    import torch
    from repro_torch.configs.registry import get_config, smoke_variant
    from repro_torch.launch.mesh import distributed, rank_device
    from repro_torch.serve_smoke import sliced_serve
    torch.set_num_threads(1)
    out_dir, cases = sys.argv[1], json.loads(sys.argv[2])
    with distributed(rank_device("cpu")):
        for arch, model, batch in cases:
            cfg = dataclasses.replace(smoke_variant(get_config(arch)),
                                      dtype="bfloat16")
            served = sliced_serve(cfg, model, batch, 24, 8, 32,
                                  device="cpu")
            if served is not None:
                with open(f"{out_dir}/smoke_{arch}_b{batch}.json",
                          "w") as f:
                    json.dump(served, f)
"""
# each wave's smoke runs: (arch, model, batch)
SMOKE_WAVES = (tuple((a, m, 4) for a, m in SMOKE_CASES),
               tuple((a, m, 1) for a, m in SPREAD_SMOKE))


def _ref_cfg(arch, fields):
    return dataclasses.replace(ref_smoke_variant(ref_get_config(arch)),
                               **fields)


def _reference(rcfg, params, prompts):
    """The reference's prefill logits, greedy tokens, every decode
    step's logits and final cache."""
    B = prompts.shape[0]
    logits, _ = RM.forward(params, {"tokens": jnp.asarray(prompts)}, rcfg)
    step = jax.jit(lambda p, c, t, i: RM.decode_step(p, c, t, i, rcfg))
    cache = RM.init_cache(rcfg, B, MAX_SEQ)
    toks, dec = [prompts], []
    cur = None
    for i in range(PROMPT + GEN):
        t = prompts[:, i:i + 1] if i < PROMPT else cur
        if i >= PROMPT:
            toks.append(t)
        out, cache = step(params, cache, jnp.asarray(t), jnp.int32(i))
        dec.append(np.asarray(out[:, 0]))
        cur = np.asarray(jnp.argmax(out, axis=-1).astype(jnp.int32))
    flat = {}
    for j, c in enumerate(cache):
        for k, v in c.items():
            flat[f"cache/{j}/{k}"] = np.asarray(v, np.float32)
    return {"pre": np.asarray(logits[:, -1]),
            "toks": np.concatenate(toks, 1), "dec": np.stack(dec, 1),
            **flat}


def _whole_port(out, name, want):
    """The port on the whole params: prefill logits, the decode fed the
    reference's tokens, its final cache."""
    arch, fields, B = ALL[name]
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), **fields)
    like = M.init_params(torch.Generator().manual_seed(0), cfg)
    params, _ = restore_checkpoint(str(out / f"{name}_init"), like)
    toks = torch.as_tensor(want["toks"])
    with torch.no_grad():
        pre = prefill_step(params, {"tokens": toks[:, :PROMPT]}, cfg)
        cache = M.init_cache(cfg, B, MAX_SEQ)
        dec = [M.decode_step(params, cache, toks[:, i:i + 1], i, cfg)[0]
               for i in range(PROMPT + GEN)]
    flat = {f"cache/{j}/{k}": v.numpy() for j, c in enumerate(cache)
            for k, v in c.items()}
    return {"pre": pre.numpy(), "dec": torch.cat(dec, 1).numpy(), **flat}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The torchruns (``WAVES`` and the serve smoke's), the reference's
    runs and the whole-params port's, each wave's taken while the wave
    runs: ``(reference by case, {model: port by case, "smoke": serve
    smoke figures by (arch, batch)}, whole-params port by case)``."""
    out = tmp_path_factory.mktemp("serve")
    params = {}
    for name, (arch, fields, B) in ALL.items():
        rcfg = _ref_cfg(arch, fields)
        p = jax.tree.map(lambda x: np.asarray(x, np.float32),
                         RM.init_params(jax.random.PRNGKey(0), rcfg))
        if name.startswith("deepseek"):
            # sharper routing: the queues bind unevenly
            for grp in p["groups"]:
                if "router" in grp.get("ffn", {}):
                    grp["ffn"]["router"] = grp["ffn"]["router"] * 4.0
        ref_save_checkpoint(str(out / f"{name}_init"), p, 0)
        params[name] = (rcfg, p)
        np.save(out / f"{name}_prompts.npy",
                np.random.default_rng(1).integers(
                    0, rcfg.vocab_size, (B, PROMPT)).astype(np.int32))
    (out / "child.py").write_text(textwrap.dedent(_CHILD))
    (out / "smoke.py").write_text(textwrap.dedent(_SMOKE_CHILD))
    want, whole, got = {}, {}, {"smoke": {}}
    for runs_, smoke_runs in zip(WAVES, SMOKE_WAVES):
        procs = [(m, cases, _start(_torchrun(
            4, str(out / "child.py"), str(out), str(m), json.dumps(cases),
            str(PROMPT), str(GEN), str(MAX_SEQ)), _env()))
            for m, cases in runs_]
        smoke = _start(_torchrun(4, str(out / "smoke.py"), str(out),
                                 json.dumps(smoke_runs)), _env())
        for name in {name for _, cases in runs_ for name in cases}:
            if name not in want:
                rcfg, p = params[name]
                want[name] = _reference(rcfg, p, np.load(
                    out / f"{name}_prompts.npy"))
                whole[name] = _whole_port(out, name, want[name])
        for m, cases, proc in procs:
            _finish(proc, f"the sliced serving torchrun at {m}")
            for name in cases:
                with np.load(out / f"{name}_m{m}.npz") as z:
                    got.setdefault(m, {})[name] = {k: z[k]
                                                   for k in z.files}
        _finish(smoke, "the serve smoke torchrun")
        for arch, _, batch in smoke_runs:
            got["smoke"][(arch, batch)] = json.loads(
                (out / f"smoke_{arch}_b{batch}.json").read_text())
    return want, got, whole


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_sliced_serving_matches_reference(runs, case, model):
    """The sliced prefill's last-position logits, the greedy tokens,
    every decode step's logits and the caches gathered whole, against
    the reference's ``forward`` and ``decode_step``: within rtol 1e-5 /
    atol 2e-5, and no farther than twice the whole-params port (plus
    1e-6)."""
    want, got, whole = runs
    _held(want[case], got[model][case], whole[case])


def _held(w, g, o):
    """The sliced run ``g`` against the reference's ``w``: the tokens
    equal, and equal on every rank serving the same rows; each logit and
    cache key within rtol 1e-5 / atol 2e-5 and within twice the
    whole-params port's ``o`` distance (plus 1e-6)."""
    np.testing.assert_array_equal(g["toks"], w["toks"])
    assert bool(g["toks_equal"])
    assert sorted(k for k in g if k.startswith("cache/")) == \
        sorted(k for k in w if k.startswith("cache/"))
    for key in w:
        if key == "toks":
            continue
        np.testing.assert_allclose(g[key], w[key], rtol=RTOL,
                                   atol=SERVE_ATOL, err_msg=key)
        ours = float(np.abs(g[key] - w[key]).max())
        theirs = float(np.abs(o[key] - w[key]).max())
        assert ours <= 2 * theirs + 1e-6, (key, ours, theirs)


@pytest.mark.parametrize("case,model", [
    (name, m) for name, spec in SPREAD.items() for m in spec[3]])
def test_spread_serving_matches_reference(runs, case, model):
    """Regime (b): a batch the data positions do not divide, served on
    every rank with the cache cut along its sequence or channels over
    data x model, against the reference's ``forward`` and
    ``decode_step``: the prefill's last-position logits, every decode
    step's logits, the tokens (equal on every rank) and the cache
    gathered whole, held as the cases the data axis divides are."""
    want, got, whole = runs
    _held(want[case], got[model][case], whole[case])


@pytest.mark.parametrize("arch,model", SMOKE_CASES)
def test_serve_smoke_on_cpu_ranks(runs, arch, model):
    """``serve_smoke.sliced_serve``, which the card scripts run, on four
    gloo ranks, its counted run in bf16: every rank's figures reach rank
    0, the float32 check's logits are the float32 whole run's within
    1e-5, and ``check_served`` holds them (the cache bytes the
    dry-run's, the routing equal across each model group).  On the CPU
    the kernels' wrappers run their plain versions, so no launch is
    counted: the counts are 0 here, and the launch check is the
    card's."""
    from repro_torch.serve_smoke import check_served
    sv = runs[1]["smoke"][(arch, 4)]
    by = sv["by_rank"]
    assert (sv["data"], sv["model"], sv["dtype"]) == (4 // model, model,
                                                      "bfloat16")
    assert all(n == 0 for r in by["launches"] for n in r.values())
    assert sv["max_abs_prefill"] <= 1e-5 and sv["max_abs_decode"] <= 1e-5
    assert sv["logit_max_abs"] > 0
    for r in by["launches"]:
        r.update(rmsnorm=1, flash_attention=1)
    cfg = dataclasses.replace(smoke_variant(get_config(arch)),
                              dtype="bfloat16")
    assert check_served("[cpu]", sv, cfg, 4, model) == \
        by["cache_bytes"][0] > 0


@pytest.mark.parametrize("arch,model", SPREAD_SMOKE)
def test_serve_smoke_spread_on_cpu_ranks(runs, arch, model):
    """``serve_smoke.sliced_serve`` of 1 prompt at data 2 x model 2 on
    four gloo ranks, bf16 (regime (b)): every rank's free-running tokens
    equal, the float32 check's logits within 1e-5 of the float32 whole
    run's, every rank's cache the dry-run's (``check_served``).  The
    launch counts are 0 on the CPU, as above."""
    from repro_torch.serve_smoke import check_served
    sv = runs[1]["smoke"][(arch, 1)]
    by = sv["by_rank"]
    assert (sv["batch"], sv["data"], sv["model"]) == (1, 4 // model, model)
    assert sv["toks_equal"]
    assert sv["max_abs_prefill"] <= 1e-5 and sv["max_abs_decode"] <= 1e-5
    for r in by["launches"]:
        r.update(rmsnorm=1, flash_attention=1)
    cfg = dataclasses.replace(smoke_variant(get_config(arch)),
                              dtype="bfloat16")
    assert check_served("[cpu]", sv, cfg, 4, model) == \
        by["cache_bytes"][0] > 0


def test_deepseek_b3_prefill_drops_tokens():
    """The regime-(b) MoE case binds: its prefill's 3 x 24 replicated
    rows are one group whose 144 choices meet 4 experts of 18 slots."""
    from repro_torch.models.moe import _capacity, _group_size
    arch, fields, B, _ = SPREAD["deepseek_b3"]
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), **fields)
    sg = _group_size(cfg, B * PROMPT)
    assert sg == B * PROMPT
    assert cfg.num_experts * _capacity(sg, cfg) < sg * cfg.num_experts_per_tok


def test_deepseek_decode_drops_tokens():
    """The MoE case binds: 16 rows a decode step route 32 choices into 4
    experts of 4 slots, so every step drops tokens, and the second data
    position's queues continue the first's."""
    from repro_torch.models.moe import _capacity
    cfg = dataclasses.replace(smoke_variant(get_config(
        "deepseek-v2-lite-16b")), **CASES["deepseek"][1])
    B = CASES["deepseek"][2]
    cap = _capacity(B, cfg)
    assert cfg.num_experts * cap < B * cfg.num_experts_per_tok


@pytest.mark.parametrize("data,model", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("name", list(CASES))
def test_cache_slices_are_the_rule_and_invert(name, data, model):
    """Each rank's cache slice holds, leaf by leaf, the bytes of the
    partition rule's shard (``cache_shardings``; mamba's ``h`` and the
    mLSTM's ``C``/``n`` split on another dim of equal size, ROADMAP
    C.53), ``init_cache`` makes it at that shape, and the slices of a
    whole cache gather back to it."""
    arch, fields, B = CASES[name]
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), **fields)
    whole = M.init_cache(cfg, B, MAX_SEQ)
    gen = torch.Generator().manual_seed(0)
    whole = tuple({k: torch.randn(v.shape, generator=gen).to(v.dtype)
                   for k, v in c.items()} for c in whole)
    dims = cache_dims(whole, B, data, model)
    rule = cache_shardings(whole, B, {"data": data, "model": model})
    parts = [slice_cache(whole, dims, r // model, r % model, data, model)
             for r in range(data * model)]
    tp = types.SimpleNamespace(M=model)
    made = M.init_cache(cfg, B, MAX_SEQ, tp=tp if model > 1 else None,
                        data=data)
    for j, c in enumerate(parts[0]):
        for k, t in c.items():
            assert int(np.prod(rule[j][k])) == t.numel(), (j, k)
            assert tuple(made[j][k].shape) == tuple(t.shape), (j, k)
    back = unslice_cache(parts, dims, data, model)
    for a, b in zip(back, whole):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("data,model", [(2, 2), (4, 1)])
@pytest.mark.parametrize("name", list(SPREAD))
def test_spread_cache_slices_are_the_rule_and_invert(name, data, model):
    """Regime (b): each rank's cache slice has, leaf by leaf, the shape
    and bytes of the partition rule's tiny-batch shard
    (``cache_shardings``: no leaf cut along its batch), ``init_cache``
    makes it at that shape, and the slices of a whole cache gather back
    to it bitwise (``conv`` and mamba's ``h`` hold the chunk k D + d,
    ROADMAP C.54)."""
    arch, fields, B, _ = SPREAD[name]
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), **fields)
    whole = M.init_cache(cfg, B, MAX_SEQ)
    gen = torch.Generator().manual_seed(0)
    whole = tuple({k: torch.randn(v.shape, generator=gen).to(v.dtype)
                   for k, v in c.items()} for c in whole)
    dims = cache_dims(whole, B, data, model)
    rule = cache_shardings(whole, B, {"data": data, "model": model})
    parts = [slice_cache(whole, dims, r // model, r % model, data, model)
             for r in range(data * model)]
    tp = types.SimpleNamespace(M=model)
    made = M.init_cache(cfg, B, MAX_SEQ, tp=tp if model > 1 else None,
                        data=data)
    for j, c in enumerate(parts[0]):
        for k, t in c.items():
            assert tuple(rule[j][k]) == tuple(t.shape), (j, k)
            assert tuple(made[j][k].shape) == tuple(t.shape), (j, k)
            assert made[j][k].dtype == whole[j][k].dtype, (j, k)
            assert t.shape[1] == B, (j, k)
    back = unslice_cache(parts, dims, data, model)
    for a, b in zip(back, whole):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_a_batch_the_data_axis_does_not_divide_is_refused():
    """Regime (b), a batch the data positions do not divide (long_500k's
    B 1 at data > 1), is served on every rank (ROADMAP A16c.5b): a
    position's rows are all of them, and the cache is every row's, cut
    along the sequence (h2o: its ring of 16 over 2 positions).  What is
    still refused is a state the data x model ranks do not divide, which
    the rule keeps whole (xlstm's 4 heads of ``m`` over 8 ranks), naming
    ROADMAP A16c.6."""
    column = types.SimpleNamespace(g=2, rank=0)
    assert data_rows(3, column) == slice(0, 3)
    cfg = smoke_variant(get_config("h2o-danube-1.8b"))
    cache = M.init_cache(cfg, 1, MAX_SEQ, data=2)
    assert tuple(cache[0]["k"].shape) == (1, 1, 8, 4, 64)
    xl = smoke_variant(get_config("xlstm-350m"))
    with pytest.raises(ValueError, match="A16c.6"):
        M.init_cache(xl, 1, MAX_SEQ, tp=types.SimpleNamespace(M=2), data=4)
    assert data_rows(8, types.SimpleNamespace(g=2, rank=1)) == slice(4, 8)


class _Recorded:
    """A stand-in for ``Collectives`` in one process: each gather records
    what a rank sends and, once ``parts`` is set, gives every rank's."""

    def __init__(self, model: int = 1, k: int = 0):
        self.model, self.k = model, k
        self.sent, self.parts = [], None

    def timing(self, kind):
        import contextlib
        return contextlib.nullcontext()

    def _gather(self, out, t, *group):
        self.sent.append(t.clone())
        if self.parts is not None:
            out.copy_(self.parts)

    model_all_gather_ = all_gather_ = replica_all_gather_ = _gather


@pytest.mark.parametrize("over", ["model", "data", "replica"])
def test_group_softmax_with_a_masked_rank(over):
    """``group_softmax`` over 4 ranks of a group, one of them with every
    score masked (no filled slot of its own yet: -1e30), equals the
    plain softmax over all the keys on every rank, and that rank adds
    exactly nothing (no NaN from ``-inf - -inf``)."""
    from repro_torch.models.attention import NEG_INF
    from repro_torch.parallel.tensor import group_softmax
    gen = torch.Generator().manual_seed(0)
    n, L, dv = 4, 5, 3
    scores = torch.randn((2, 3, n * L), generator=gen)
    scores[..., L:2 * L] = NEG_INF
    values = torch.randn((2, n * L, dv), generator=gen)
    model, data = {"model": (4, 1), "data": (1, 4), "replica": (2, 2)}[over]

    def weigh(r):
        return lambda e: torch.einsum("bhs,bsd->bhd", e,
                                      values[:, r * L:(r + 1) * L])
    comms = [_Recorded(model) for _ in range(n)]
    for r, comm in enumerate(comms):
        group_softmax(scores[..., r * L:(r + 1) * L], weigh(r), comm, over,
                      data)
    flat = torch.cat([c.sent[0] for c in comms])
    want = torch.einsum("bhs,bsd->bhd", torch.softmax(scores, -1), values)
    outs = []
    for r, comm in enumerate(comms):
        comm.parts = flat
        outs.append(group_softmax(scores[..., r * L:(r + 1) * L], weigh(r),
                                  comm, over, data))
    for out in outs:
        assert torch.isfinite(out).all()
        assert torch.equal(out, outs[0])
        torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_sequence_split_follows_the_rule(name, model):
    """``sequence_split`` says which pattern entries' caches hold a slice
    of their sequence over ``model`` ranks, as the partition rule cuts
    them: an attention cache where M does not divide its kv heads, MLA's
    wherever M divides its length, no state."""
    from repro_torch.models.config import ATTN, ATTN_GLOBAL, MLA
    arch, fields, _ = CASES[name]
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), **fields)
    want = tuple(m == MLA or (m in (ATTN, ATTN_GLOBAL)
                              and cfg.num_kv_heads % model != 0)
                 for m, _ in cfg.block_pattern)
    assert M.sequence_split(cfg, MAX_SEQ, model) == want
    # a length M does not divide (below h2o's ring of 16) stays whole
    assert not any(M.sequence_split(cfg, 15, model))


def test_a_sliced_decode_needs_its_cache_length():
    """How a rank's cache is cut depends on the length it was made at:
    a sliced ``decode_step`` without ``max_seq`` is refused."""
    cfg = smoke_variant(get_config("deepseek-v2-lite-16b"))
    with pytest.raises(ValueError, match="max_seq"):
        M.decode_step({}, (), torch.zeros((1, 1), dtype=torch.int32), 0,
                      cfg, tp=types.SimpleNamespace(M=2))


@pytest.mark.parametrize("entry", ["decode_step", "prefill_step"])
def test_serving_over_data_positions_needs_the_global_batch(entry):
    """The regime follows from the served batch and the data positions,
    so a call over a column of 2 that leaves ``global_batch`` out (a
    regime-(b) B 1 would be taken for regime (a)'s 2 rows) is refused."""
    cfg = smoke_variant(get_config("deepseek-v2-lite-16b"))
    column = types.SimpleNamespace(g=2, rank=0, comm=None)
    tokens = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="global_batch"):
        if entry == "decode_step":
            M.decode_step({}, (), tokens, 0, cfg, column=column, max_seq=32)
        else:
            prefill_step({}, {"tokens": tokens}, cfg, column=column)
