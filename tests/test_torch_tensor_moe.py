"""The ``model`` axis of the SPMD trainer for MLA and the MoE
(``parallel/tensor.py``, ``models/mla.py``, ``models/moe.py``):
deepseek-v2-lite-16b and llama4-scout-17b-a16e smoke on four gloo ranks
against the reference's ``run_training`` on four forced host devices at
the same ``mesh_model``, and the dry-run's tensor collectives for MLA
and the MoE.  The MoE's groups over a data column (ROADMAP C.52): rows
that do not fill whole groups against the reference, and rows that do
routed as before.  The harness is ``test_torch_tensor.py``'s."""
import dataclasses
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as JaxSpec

from repro_torch.configs.registry import InputShape, get_config, \
    smoke_variant
from test_torch_tensor import (ATOL, BF16_TOL, RTOL, _REF_SCRIPT,
                               _against_reference, _finish, _forced,
                               _leaves, _npz, _shape_list, _start)

torch.set_num_threads(2)


class _Column:
    """A data column of ``g`` positions seen from position ``rank`` in one
    process: the aux loss' means pass through, the counts each call
    gives are kept, and the positions' before are ``before`` (zeros when
    None)."""

    def __init__(self, g, rank, before=None):
        self.g, self.rank, self.before = g, rank, before
        self.asked = []

    def column_mean(self, x):
        return x

    def counts_before(self, counts):
        self.asked.append(counts.clone())
        return torch.zeros_like(counts) if self.before is None \
            else self.before


def _moe_layer(fields):
    from repro_torch.convert import tree_map
    from repro_torch.models import model as TM
    cfg = dataclasses.replace(smoke_variant(get_config(
        "deepseek-v2-lite-16b")), **fields)
    p = TM.init_params(torch.Generator().manual_seed(0), cfg)
    ffn = [g["ffn"] for g in p["groups"] if "router" in g.get("ffn", {})][0]
    return cfg, tree_map(lambda t: t[0], ffn)


@pytest.mark.parametrize("B,S,g,group,cf", [
    (4, 4, 2, 512, 1.25),     # one group spans both positions
    (6, 8, 3, 12, 1.25),      # positions hold several groups, end mid-group
    (6, 8, 3, 12, 0.3),       # the same with the capacity binding
    (16, 1, 2, 512, 0.5),     # a decode step: 16 rows, 32 choices, 16 slots
])
def test_moe_groups_span_the_data_column(B, S, g, group, cf):
    """ROADMAP C.52: each data position's rows of a column's batch, routed
    with the counts of the positions before (``counts_before``), give the
    output the whole batch gives in one process, as the reference groups
    a replica's whole batch: a group that spans positions, a position
    that holds several groups or ends mid-group, and queues that
    overflow across positions."""
    from repro_torch.models.moe import moe_forward
    cfg, ffn = _moe_layer({"moe_group_size": group,
                           "moe_capacity_factor": cf})
    x = torch.randn((B, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    want, _ = moe_forward(ffn, x, cfg)
    rows = B // g
    counts = []
    for d in range(g):
        col = _Column(g, d)
        moe_forward(ffn, x[d * rows:(d + 1) * rows], cfg, column=col)
        counts.append(col.asked[0])
    got = []
    for d in range(g):
        before = sum(counts[:d], torch.zeros_like(counts[0]))
        got.append(moe_forward(ffn, x[d * rows:(d + 1) * rows], cfg,
                               column=_Column(g, d, before))[0])
    np.testing.assert_allclose(torch.cat(got).numpy(), want.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_moe_rows_filling_whole_groups_are_unchanged():
    """ROADMAP C.52: a position whose rows fill whole groups (512 tokens,
    every registry training shape) routes alone, as before the column's
    grouping: no counts are asked for, and its output and aux loss are
    bitwise those of the same rows without a column."""
    from repro_torch.models.moe import moe_forward
    cfg, ffn = _moe_layer({})
    x = torch.randn((4, 128, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    col = _Column(2, 1)
    got, got_aux = moe_forward(ffn, x, cfg, column=col)
    want, want_aux = moe_forward(ffn, x, cfg)
    assert not col.asked
    assert torch.equal(got, want) and torch.equal(got_aux, want_aux)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "deepseek-v2-lite-16b"])
def test_moe_hybrid_mesh_model_2_rows_of_16_match_reference(tmp_path, arch):
    """ROADMAP C.52 on four gloo ranks: jamba and deepseek smoke, float32,
    hybrid step:2 at ``mesh_model=2``, 8 rows of 16 a step, so in the g
    2 phase each data position holds 64 of its column's 128 tokens, one
    MoE group that spans both positions (jamba was 9.7e-05 off at step 3
    with each position grouping its own rows): losses, aux values,
    divergence and final params within rtol 1e-5 / atol 1e-6 of the
    reference's ``run_training``, the routing equal across each model
    group."""
    st, hp, hr, got, want = _against_reference(
        tmp_path, arch, "hybrid", 2, seq=16)
    assert [(p["g"], p["fsdp"]) for p in st["layout"]] == \
        [(1, False), (2, True)]
    assert _groups_equal(st["routing_digest_by_rank"], 2)
    for key in ("loss", "aux", "divergence"):
        np.testing.assert_allclose([h[key] for h in hp],
                                   [h[key] for h in hr], rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _groups_equal(values, M):
    """Each model group's ranks (``r // M``) hold one value."""
    return all(values[r] == values[r - r % M] for r in range(len(values)))


def test_deepseek_hybrid_mesh_model_2_matches_reference(tmp_path):
    """deepseek-v2-lite-16b smoke (MLA + MoE with a shared expert),
    float32, hybrid step:2 at ``mesh_model=2`` (data 2 x model 2), 8
    rows of 128 a step (each data position's 512 tokens one MoE group,
    as the reference groups the replica's batch): g 1 -> 2, merges at K
    2 and 1, the g 2 phase in the FSDP layout with the aux loss' means
    over the data column; losses, aux values, divergence and final
    params within rtol 1e-5 / atol 1e-6 of the reference, its counters
    equal; the whole leaves (norms, ``w_dkv``, ``w_kr``, ``router``)
    and every MoE layer's routing equal across each model group."""
    st, hp, hr, got, want = _against_reference(
        tmp_path, "deepseek-v2-lite-16b", "hybrid", 2, seq=128)
    assert [m["K"] for m in st["merges"]] == [2, 1]
    assert [(p["g"], p["fsdp"]) for p in st["layout"]] == \
        [(1, False), (2, True)]
    assert st["num_gradients"] == 6
    assert _groups_equal(st["whole_digest_by_rank"], 2)
    assert _groups_equal(st["routing_digest_by_rank"], 2)
    assert st["routing_digest_by_rank"][0] != st["routing_digest_by_rank"][2]
    for key in ("loss", "aux", "divergence"):
        np.testing.assert_allclose([h[key] for h in hp],
                                   [h[key] for h in hr], rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_llama4_sync_mesh_model_4_float32_matches_reference(tmp_path):
    """llama4-scout-17b-a16e smoke in float32 (chunked and global
    attention, top-1 MoE with a shared expert), sync at
    ``mesh_model=4`` (data 1 x model 4, one expert a rank): losses, aux
    values and final params within rtol 1e-5 / atol 1e-6 of the
    reference, the whole leaves and the routing equal on all four
    ranks."""
    st, hp, hr, got, want = _against_reference(
        tmp_path, "llama4-scout-17b-a16e", "sync", 4)
    assert [h["group_size"] for h in hp] == [1] * 4
    assert len(set(st["routing_digest_by_rank"])) == 1
    assert len(set(st["whole_digest_by_rank"])) == 1
    for key in ("loss", "aux"):
        np.testing.assert_allclose([h[key] for h in hp],
                                   [h[key] for h in hr], rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_llama4_sync_mesh_model_4_bf16_matches_reference(tmp_path):
    """llama4-scout-17b-a16e smoke in bf16 (chunked and global attention,
    top-1 MoE with a shared expert), sync at ``mesh_model=4`` (data 1 x
    model 4): one expert a rank; losses and aux values within C.45's
    bf16 tolerance of the reference, the routing equal on all four
    ranks.  The final params are held leaf by leaf within twice the
    reference's own spread between its ``mesh_model`` 1 and 4 runs:
    bf16 top-1 routing turns on near-ties that a sum order decides, so
    the reference's two layouts already differ beyond C.45's tolerance
    (ROADMAP C.47)."""
    spec1 = tmp_path / "spec1.json"
    spec1.write_text(JaxSpec(
        arch="llama4-scout-17b-a16e", backend="spmd", mode="sync",
        steps=4, batch=8, seq=16, smoke=True, log_every=1,
        mesh_model=1).to_json())
    (tmp_path / "ref1.py").write_text(textwrap.dedent(_REF_SCRIPT))
    ref1 = _start([sys.executable, str(tmp_path / "ref1.py"), str(spec1),
                   str(tmp_path / "ref1_final"), "bfloat16"], _forced(4))
    st, hp, hr, got, want = _against_reference(
        tmp_path, "llama4-scout-17b-a16e", "sync", 4, dtype="bfloat16")
    _finish(ref1, "the reference's run_training at mesh_model 1")
    other = _npz(tmp_path / "ref1_final.npz")
    assert [h["group_size"] for h in hp] == [1] * 4
    assert len(set(st["routing_digest_by_rank"])) == 1
    assert len(set(st["whole_digest_by_rank"])) == 1
    for key in ("loss", "aux"):
        np.testing.assert_allclose([h[key] for h in hp],
                                   [h[key] for h in hr], err_msg=key,
                                   **BF16_TOL)
    assert sorted(other) == sorted(want)
    for k in want:
        spread = float(np.abs(other[k] - want[k]).max())
        assert float(np.abs(got[k] - want[k]).max()) <= 2 * spread, k


@pytest.mark.parametrize("model", [2, 4])
def test_dryrun_model_axis_mla_moe_collectives(model):
    """``dryrun --cards 4 --model M`` on deepseek-v2-lite-16b smoke: the
    state is the partition rules' shard bytes over ``{"data": 4/M,
    "model": M}`` to the byte, and the tensor collectives are counted
    from the calls: per micro-batch and layer, forward, one all-reduce
    of the (B, S, D) activations at MLA's ``wo`` and one at the MoE's
    experts and shared expert; backward, MLA's three (the queries'
    input, the latent, the rope key) and the MoE's two (its input and
    its gate values); plus the embedding, the head and the gold logit,
    and the one all-gather of the local logsumexps."""
    from repro_torch.launch import dryrun
    from repro_torch.optim.optimizers import adamw
    from repro_torch.parallel.partition import param_shardings
    cfg = smoke_variant(get_config("deepseek-v2-lite-16b"))
    cards, m, B, S = 4, 2, 8, 32
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
    L = cfg.num_groups
    mla = act + (act + f32 * (cfg.kv_lora_rank + cfg.rope_head_dim))
    moe = act + (act + f32 * cfg.num_experts_per_tok)
    ar = m * 2 * ring * (L * (mla + moe) + act + act + f32)
    ag = m * ring * f32 * model
    coll = lay["collective_bytes_per_device"]
    assert coll["tensor all-reduce"] == pytest.approx(ar)
    assert coll["tensor all-gather"] == pytest.approx(ag)
