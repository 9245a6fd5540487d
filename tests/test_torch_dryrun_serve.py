"""The dry-run's serving records over the ``model`` axis (ROADMAP A16c.5,
``launch/dryrun.py``): ``prefill_32k`` and ``decode_32k`` traced at
``--cards 4 --model 2`` and ``--model 4`` through the sliced serving
step on one card's model slices, FSDP shards and slice of the cache,
on the meta device: the cache a card holds against the partition
rule's shards leaf by leaf, the traced peak, and the serving collectives
counted from their calls against closed forms; ``long_500k`` (B 1) at
data 2 x model 2 and data 4 x model 1 (regime (b), ROADMAP A16c.5b)
traced the same way for the four sub-quadratic configs, the cache a card
holds the rule's tiny-batch shard, the combines over the data column or
the replica group and the recurrences' state collectives in closed
form; the frontends stay skipped naming A16c."""
import json

import pytest

from repro_torch.configs.registry import SHAPES
from repro_torch.launch import dryrun
from repro_torch.parallel.partition import cache_shardings, map_with_path

ARCHS = ("h2o-danube-1.8b", "deepseek-v2-lite-16b", "jamba-v0.1-52b",
         "xlstm-350m")
FSDP = dryrun.FSDP


def _leaves(tree):
    out = []
    map_with_path(lambda p, t: out.append((p, t)), tree)
    return out


def _prod(shape):
    n = 1
    for s in shape:
        n *= s
    return n


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_a_card_holds_is_the_rule(arch, model):
    """``decode_32k`` at ``--cards 4 --model M``: each leaf of the cache
    a card holds has the element count of ``cache_shardings``' shard over
    ``{"data": 4/M, "model": M}`` (mamba's ``h`` and the mLSTM's
    ``C``/``n`` split on another dim of the same size, ROADMAP C.53)."""
    _, _, info = dryrun.build_step(arch, "decode_32k", cards=4, fsdp=True,
                                   model=model)
    shape = SHAPES["decode_32k"]
    from repro_torch.models import model as M
    whole = M.init_cache(info["cfg"], shape.global_batch, shape.seq_len,
                         device="meta")
    rule = cache_shardings(whole, shape.global_batch,
                           {"data": 4 // model, "model": model})
    held = _leaves(info["cache"])
    # the rule's tree holds shape tuples: one per cache leaf, in order
    shapes = _shape_leaves(rule)
    assert len(shapes) == len(held)
    for (p, t), s in zip(held, shapes):
        assert t.numel() == _prod(s), (p, tuple(t.shape), s)


def _shape_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _shape_leaves(v)]
    if isinstance(tree, (list, tuple)) and tree and \
            not isinstance(tree[0], int):
        return [x for v in tree for x in _shape_leaves(v)]
    return [tree]


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_records_are_traced(arch, shape, model):
    """Each record's FSDP layout is traced (``peak_traced``), its cache
    bytes are the rule's to the byte, and a decode's greedy token takes
    one all-gather of (value, index) pairs over the model group."""
    res = dryrun.run_one(arch, shape, cards=4, model=model)
    assert res["status"] == "ok", res.get("error")
    lay = res["layouts"][FSDP]
    assert "peak_traced" in lay and "peak_is_estimate" not in lay
    assert lay["mesh"] == {"data": 4 // model, "model": model}
    assert lay["peak_bytes"] > lay["state_bytes_total"]
    coll = lay["collective_bytes_per_device"]
    if shape == "decode_32k":
        assert lay["state_bytes"]["cache"] == lay["cache_bytes_rule"]
        rows = SHAPES[shape].global_batch * model // 4
        # (rows, 1, 2) float64 a rank, gathered over M: (M-1)/M of M x
        assert coll["argmax all-gather"] == rows * 2 * 8 * (model - 1)
    else:
        assert "argmax all-gather" not in coll


def test_decode_collectives_closed_forms():
    """The counted serving collectives of ``decode_32k`` against closed
    forms.  h2o at model 2 (kv heads split, data 2): per layer one
    all-reduce of the (64, 1, 2560) bf16 activations at ``wo`` and one
    at the MLP's ``w_down``, plus the embedding's.  deepseek at model 2:
    per layer the absorbed queries gathered into (64, 1, 16, 576)
    float32, the split-softmax combine's (64, 16, 1, 514) float32
    partials from each of the 2 ranks, and
    the MoE's counts, one group of the column's 128 tokens by 64
    experts, float32, over the 2 data positions."""
    h2o = dryrun.run_one("h2o-danube-1.8b", "decode_32k", cards=4, model=2)
    c = h2o["layouts"][FSDP]["collective_bytes_per_device"]
    L, rows, D = 24, 64, 2560
    assert c["tensor all-reduce"] == (2 * L + 1) * rows * D * 2 * 2 * 0.5
    assert "combine all-gather" not in c
    ds = dryrun.run_one("deepseek-v2-lite-16b", "decode_32k", cards=4,
                        model=2)
    c = ds["layouts"][FSDP]["collective_bytes_per_device"]
    L, H, r, rh, E = 27, 16, 512, 64, 64
    assert c["tensor all-gather"] == L * rows * H * (r + rh) * 4 * 0.5
    assert c["combine all-gather"] == L * rows * H * (2 + r) * 4 * 2 * 0.5
    assert c["routing all-gather"] == L * E * 4 * 2 * 0.5
    assert ds["layouts"][FSDP]["state_bytes"]["cache"] == 32_614_907_904
    assert h2o["layouts"][FSDP]["state_bytes"]["cache"] == 8_053_063_680


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "xlstm-350m"])
def test_long_500k_at_data_2_keeps_an_estimate_naming_a16c_5b(arch):
    """``long_500k`` (B 1) at data 2 is regime (b), which the port now
    serves (the name is that of the estimate this test held before
    A16c.5b): the record is traced (``peak_traced``, no estimate, no
    mention of A16c.5b), a card serves the one row and holds the rule's
    cache; at data 1 x model 4 the batch divides and the step is traced
    too."""
    res = dryrun.run_one(arch, "long_500k", cards=4, model=2)
    assert res["status"] == "ok", res.get("error")
    lay = res["layouts"][FSDP]
    assert "peak_traced" in lay and "peak_is_estimate" not in lay
    assert "A16c.5b" not in json.dumps(res)
    assert res["per_card_batch"] == 1
    assert lay["state_bytes"]["cache"] == lay["cache_bytes_rule"]
    res = dryrun.run_one(arch, "long_500k", cards=4, model=4)
    assert "peak_traced" in res["layouts"][FSDP]


LONG_ARCHS = ("h2o-danube-1.8b", "jamba-v0.1-52b", "xlstm-350m",
              "llama4-scout-17b-a16e")


@pytest.mark.parametrize("model", [2, 1])
@pytest.mark.parametrize("arch", LONG_ARCHS)
def test_long_500k_cache_a_card_holds_is_the_rule(arch, model):
    """``long_500k`` at ``--cards 4 --model M`` (data 2 x model 2, data 4
    x model 1): each leaf of the cache a card holds has the shape of
    ``cache_shardings``' tiny-batch shard (the sequence or the channels
    cut, never the batch), the record is traced and its cache bytes are
    the rule's to the byte."""
    from repro_torch.models import model as M
    shape = SHAPES["long_500k"]
    _, _, info = dryrun.build_step(arch, "long_500k", cards=4, fsdp=True,
                                   model=model)
    whole = M.init_cache(info["cfg"], shape.global_batch, shape.seq_len,
                         device="meta")
    rule = _shape_leaves(cache_shardings(whole, shape.global_batch,
                                         {"data": 4 // model,
                                          "model": model}))
    held = _leaves(info["cache"])
    assert len(rule) == len(held)
    for (p, t), s in zip(held, rule):
        assert tuple(t.shape) == tuple(s), (p, tuple(t.shape), s)
    res = dryrun.run_one(arch, "long_500k", cards=4, model=model)
    assert res["status"] == "ok", res.get("error")
    lay = res["layouts"][FSDP]
    assert "peak_traced" in lay
    assert lay["state_bytes"]["cache"] == lay["cache_bytes_rule"]


def test_long_500k_collectives_closed_forms():
    """Regime (b)'s counted collectives of ``long_500k`` against closed
    forms, a card's bytes on a ring.  h2o at data 2 x model 2: per layer
    the combine of (1, 4 kv heads, 4, 1, 2 + 80) float32 partials over
    the data column of 2, the row-parallel all-reduces of (1, 1, 2560)
    bf16 (two a layer and the embedding's), the greedy token's (value,
    index) float64 pair over the model group; at data 4 x model 1 the
    combine over 4 positions of all 8 kv heads.  jamba at 2 x 2: per
    mamba layer (7 of 8 a group, 4 groups) ``proj`` (1, 1, 256 + 2 x 16)
    float32 summed over the 4 ranks and ``y``'s (1, 1, 8192 / 4) bf16
    gathered over the data column; per attention layer the combine of
    (1, 4, 4, 1, 2 + 128).  xlstm-350m at 2 x 2: per mLSTM layer (18)
    ``xc``'s and ``u``'s 2048 / 4 channels and ``m``'s 4 / 4 heads
    gathered over the 4 ranks in float32 and the (1, 4, 512 + 1)
    numerator and normalizer summed; per sLSTM layer (6) the gate
    pre-activations' and the 4 states' 1024 / 4 channels gathered."""
    def coll(arch, model):
        res = dryrun.run_one(arch, "long_500k", cards=4, model=model)
        return res["layouts"][FSDP]["collective_bytes_per_device"]
    c = coll("h2o-danube-1.8b", 2)
    L = 24
    assert c["combine all-gather"] == L * 4 * 4 * 82 * 4 * 2 * 0.5
    assert c["tensor all-reduce"] == (2 * L + 1) * 2560 * 2 * 2 * 0.5
    assert c["argmax all-gather"] == 2 * 8 * 1
    assert "state all-gather" not in c
    c = coll("h2o-danube-1.8b", 1)
    assert c["combine all-gather"] == L * 8 * 4 * 82 * 4 * 4 * 0.75
    c = coll("jamba-v0.1-52b", 2)
    assert c["state all-reduce"] == 28 * (256 + 32) * 4 * 2 * 0.75
    assert c["state all-gather"] == 28 * 2048 * 2 * 2 * 0.5
    assert c["combine all-gather"] == 4 * 4 * 4 * 130 * 4 * 2 * 0.5
    c = coll("jamba-v0.1-52b", 1)
    assert c["state all-gather"] == 28 * 2048 * 2 * 4 * 0.75
    c = coll("xlstm-350m", 2)
    assert c["state all-gather"] == (18 * (512 + 512 + 1)
                                     + 6 * 8 * 256) * 4 * 4 * 0.75
    assert c["state all-reduce"] == 18 * 4 * 513 * 4 * 2 * 0.75


@pytest.mark.parametrize("arch,shape", [
    ("hubert-xlarge", "prefill_32k"), ("phi-3-vision-4.2b", "prefill_32k"),
    ("phi-3-vision-4.2b", "decode_32k")])
def test_frontends_are_skipped_naming_a16c(arch, shape):
    """A frontend has no form on the model axis yet: its serving records
    are skipped naming A16c (hubert, encoder-only, has no decode)."""
    res = dryrun.run_one(arch, shape, cards=4, model=2)
    assert res["status"] == "skipped" and "A16c" in res["reason"]


def test_cli_writes_a_traced_serving_record(tmp_path):
    """``dryrun --arch xlstm-350m --shape decode_32k --cards 4 --model
    2`` exits 0 and writes the traced record."""
    rc = dryrun.main(["--arch", "xlstm-350m", "--shape", "decode_32k",
                      "--cards", "4", "--model", "2", "--out-dir",
                      str(tmp_path)])
    assert rc == 0
    (path,) = tmp_path.glob("xlstm-350m__decode_32k__card4_model2_*.json")
    res = json.loads(path.read_text())
    assert "peak_traced" in res["layouts"][FSDP]
