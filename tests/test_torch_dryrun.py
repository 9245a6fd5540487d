"""The port's dry-run (``launch/dryrun.py``, ``python -m repro_torch
dryrun``) and the registry's shapes and input specs.

- ``applicable_pairs()`` equals the reference's, reasons included, and
  ``input_specs`` gives meta tensors of the reference's shapes and dtypes
  for every applicable pair (the decode cache from ``init_cache`` on
  ``meta``);
- ``dryrun --all --cards 1`` writes a record for every pair: ``ok`` (with
  FLOPs, HBM bytes, collective bytes by kind, peak bytes, ``fits`` and
  the config's own ``remat``, "block") or ``skipped`` for
  ``shape_applicable``'s reasons, and no ``error``.  No time is asserted;
- ``--remat none|block`` is honoured and recorded, and remat lowers a
  train step's gradient-phase peak and adds the recomputed forward's
  FLOPs;
- ``--mesh pod|multipod``, ``--remat`` other than none/block and
  ``--q-block`` are refused; the microbatch derivation; layouts over
  several cards.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro_torch.api import cli
from repro_torch.configs import registry as tregistry
from repro_torch.launch import dryrun
from repro_torch.launch.steps import (H100_MEMORY_BYTES, card_memory_bytes,
                                      derive_microbatch)

torch.set_num_threads(2)
LAYOUT_KEYS = (dryrun.SPMD, dryrun.FSDP)


def test_applicable_pairs_match_reference():
    assert tregistry.applicable_pairs() == jregistry.applicable_pairs()
    assert {s: (v.seq_len, v.global_batch, v.kind)
            for s, v in tregistry.SHAPES.items()} == \
        {s: (v.seq_len, v.global_batch, v.kind)
         for s, v in jregistry.SHAPES.items()}


def _jshapes(tree):
    return [(tuple(x.shape), np.dtype(x.dtype).name)
            for x in jax.tree.leaves(tree)]


def _sorted_leaves(tree):
    """Leaves in ``jax.tree`` order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _tshapes(tree):
    leaves = _sorted_leaves(tree)
    assert all(t.is_meta for t in leaves)
    return [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in leaves]


@pytest.mark.parametrize("arch", tregistry.ARCH_NAMES)
def test_input_specs_match_reference(arch):
    """Every applicable shape's inputs, at a per-card batch of 2: the
    batch (frontends included) or the decode cache and tokens."""
    tcfg, jcfg = tregistry.get_config(arch), jregistry.get_config(arch)
    for name, shape in tregistry.SHAPES.items():
        if not tregistry.shape_applicable(tcfg, shape)[0]:
            continue
        t = tregistry.input_specs(tcfg, shape, batch_override=2)
        j = jregistry.input_specs(jcfg, jregistry.SHAPES[name],
                                  batch_override=2)
        if shape.kind == "decode":
            assert _tshapes(t["cache"]) == _jshapes(j["cache"]), (arch, name)
            assert _tshapes(t["tokens"]) == _jshapes(j["tokens"])
            assert t["cur_index"] == shape.seq_len - 1
        else:
            assert _tshapes(t["batch"]) == _jshapes(j["batch"]), (arch, name)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    rc = cli.main(["dryrun", "--all", "--cards", "1", "--out-dir",
                   str(out)])
    records = {}
    for f in os.listdir(out):
        with open(out / f) as fh:
            r = json.load(fh)
        records[r["arch"], r["shape"]] = r
    return rc, records


def test_dryrun_all_on_meta(sweep):
    rc, records = sweep
    assert rc == 0
    pairs = tregistry.applicable_pairs()
    assert set(records) == {(a, s) for a, s, _, _ in pairs}
    for arch, shape, ok, why in pairs:
        r = records[arch, shape]
        if not ok:
            assert r["status"] == "skipped" and r["reason"] == why
            continue
        assert r["status"] == "ok", r.get("error")
        assert r["remat"] == tregistry.get_config(arch).remat == "block"
        assert r["cards"] == 1
        assert r["flops_per_device"] > 0 and r["hbm_bytes_per_device"] > 0
        coll = r["collective_bytes_per_device"]
        assert set(coll) >= {"total", "all-reduce"} and coll["total"] == 0
        assert isinstance(r["fits"], bool)
        assert r["fits"] == (r["peak_bytes_per_device"]
                             <= r["card_memory_bytes"])
        assert r["fits"] or r["needs_bytes"] == r["peak_bytes_per_device"]
        mem = r["memory"]
        assert mem["peak_bytes"] == mem["held_bytes"] + mem["step_bytes"]
        for lay in LAYOUT_KEYS:
            assert r["layouts"][lay]["state_bytes_total"] > 0
            assert isinstance(r["layouts"][lay]["fits"], bool)
        if shape == "train_4k":
            # AdamW moments are two float32 copies of the params
            st = r["layouts"][dryrun.SPMD]["state_bytes"]
            assert st["opt_state"] >= 2 * 4 * r["num_params"]
            assert r["per_card_batch"] % r["microbatch"] == 0
            phases = mem["phases"]
            assert phases["update"]["peak"] <= mem["peak_bytes"]
            assert max(p["peak"] for p in phases.values()) == \
                mem["peak_bytes"]
    # the serving forward runs the kernels' meta routes: prefill counts
    # flash launches, decode none (its attention is plain)
    h2o = records["h2o-danube-1.8b", "prefill_32k"]["kernels"]
    assert h2o["flash_attention"]["launches"] == 24
    assert h2o["rmsnorm"]["launches"] == 49
    assert "flash_attention" not in \
        records["h2o-danube-1.8b", "decode_32k"]["kernels"]


def test_a_result_is_cached(sweep, capsys, tmp_path):
    argv = ["dryrun", "--arch", "h2o-danube-1.8b", "--shape", "long_500k",
            "--out-dir", str(tmp_path)]
    assert cli.main(argv) == 0
    assert "[run]" in capsys.readouterr().out
    assert cli.main(argv) == 0
    assert "[cached]" in capsys.readouterr().out


@pytest.mark.parametrize("argv,needle", [
    (["--mesh", "pod"], "A16"), (["--mesh", "multipod"], "A16"),
    (["--mesh", "both"], "A16"), (["--remat", "foo"], "remat"),
    (["--q-block", "512"], "C.10")])
def test_refused_flags(argv, needle, capsys, tmp_path):
    rc = cli.main(["dryrun", "--arch", "h2o-danube-1.8b", "--out-dir",
                   str(tmp_path)] + argv)
    assert rc != 0
    assert needle in capsys.readouterr().err
    assert not os.listdir(tmp_path)
    with pytest.raises(ValueError, match=needle):
        dryrun.run_one("h2o-danube-1.8b", "decode_32k",
                       mesh_kind=argv[1] if argv[0] == "--mesh" else None,
                       remat=argv[1] if argv[0] == "--remat" else None,
                       q_block=512 if argv[0] == "--q-block" else None)


@pytest.mark.parametrize("remat", ["none", "block"])
def test_remat_flag_is_honoured_and_recorded(remat, tmp_path):
    argv = ["dryrun", "--arch", "xlstm-350m", "--shape", "train_4k",
            "--microbatch", "256", "--remat", remat, "--out-dir",
            str(tmp_path)]
    assert cli.main(argv) == 0
    path = dryrun.result_path("xlstm-350m", "train_4k", "card1",
                              out_dir=str(tmp_path), remat=remat)
    with open(path) as f:
        r = json.load(f)
    assert r["status"] == "ok" and r["remat"] == remat
    assert r["microbatch"] == 256


def test_default_remat_ignores_a_record_without_remat_in_its_name(
        capsys, tmp_path):
    """A record of an older dry-run, named without its remat and taken
    with remat "none", is not reused as the default: the default run
    takes the config's remat ("block") and names its record by it."""
    stale = tmp_path / "h2o-danube-1.8b__train_4k__card1.json"
    stale.write_text(json.dumps({"arch": "h2o-danube-1.8b",
                                 "shape": "train_4k", "status": "ok",
                                 "remat": "none"}))
    argv = ["dryrun", "--arch", "h2o-danube-1.8b", "--shape", "train_4k",
            "--microbatch", "16", "--out-dir", str(tmp_path)]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "[run]" in out and "[cached]" not in out
    path = dryrun.result_path("h2o-danube-1.8b", "train_4k", "card1",
                              out_dir=str(tmp_path))
    assert path.endswith("__card1_remat-block.json")
    with open(path) as f:
        assert json.load(f)["remat"] == "block"
    assert json.loads(stale.read_text())["remat"] == "none"
    assert cli.main(argv) == 0
    assert "[cached]" in capsys.readouterr().out


def test_remat_recounts_the_forward_and_frees_the_activations():
    """h2o-danube-1.8b, B 1, S 2048 on the meta device: with remat each
    layer's forward runs again in the backward (more FLOPs), and the
    gradient's peak falls; the update phase is the same."""
    shape = tregistry.InputShape("train", 2048, 1, "train")
    cfg = tregistry.get_config("h2o-danube-1.8b")
    reps = {r: dryrun.analyze_step(dataclasses.replace(cfg, remat=r),
                                   shape)[0] for r in ("none", "block")}
    none, block = reps["none"], reps["block"]
    assert block.cost.flops > 1.2 * none.cost.flops
    assert block.phases["start"]["peak"] < 0.5 * none.phases["start"]["peak"]
    assert block.phases["update"] == none.phases["update"]
    assert block.held_bytes == none.held_bytes


def test_derive_microbatch():
    calls = []

    def peak_of(m):                   # falls as slices shrink
        calls.append(m)
        return 10 + 1000 // m
    assert derive_microbatch(256, peak_of, 10 ** 6) == (1, True)
    calls.clear()
    assert derive_microbatch(256, peak_of, 10 + 1000 // 16) == (16, True)
    assert len(calls) <= 5
    assert derive_microbatch(256, peak_of, 10) == (256, False)
    assert derive_microbatch(24, peak_of, 10 + 1000 // 8) == (8, True)
    assert derive_microbatch(1, peak_of, 0) == (1, False)
    assert card_memory_bytes("meta") == H100_MEMORY_BYTES
    with pytest.raises(ValueError):
        card_memory_bytes("cpu")


def test_derived_microbatch_is_the_smallest_that_fits():
    """xlstm-350m train_4k on one card: the derived count fits and half
    of it does not (or it is 1)."""
    r = dryrun.run_one("xlstm-350m", "train_4k")
    assert r["status"] == "ok" and r["microbatch_derived"]
    m = r["microbatch"]
    if r["fits"] and m > 1:
        half = dryrun.run_one("xlstm-350m", "train_4k", microbatch=m // 2)
        assert not half["fits"]


def test_layouts_over_cards():
    """h2o-danube-1.8b train_4k on 8 cards: the port's layout all-reduces
    one f32 slab over the group, the FSDP layout shards params and
    moments (8 x smaller here) and gathers/scatters instead; with
    --hybrid-rep 4 the groups are 2 cards."""
    r = dryrun.run_one("h2o-danube-1.8b", "train_4k", cards=8,
                       microbatch=32)
    assert r["status"] == "ok" and r["per_card_batch"] == 32
    P = r["num_params"]
    spmd, fsdp = r["layouts"][dryrun.SPMD], r["layouts"][dryrun.FSDP]
    ar = spmd["collective_bytes_per_device"]["all-reduce"]
    assert ar == pytest.approx(2 * 4 * P * 7 / 8)
    assert fsdp["state_bytes"]["params"] < spmd["state_bytes"]["params"] / 4
    assert fsdp["collective_bytes_per_device"]["all-gather"] > 0
    assert fsdp["collective_bytes_per_device"]["reduce-scatter"] > 0
    assert fsdp["peak_bytes"] < spmd["peak_bytes"]
    h = dryrun.run_hybrid_one("h2o-danube-1.8b", 4, 8, microbatch=32)
    assert h["tag"] == "hybrid_R4" and h["hybrid_rep"] == 4
    assert h["layouts"][dryrun.SPMD]["collective_bytes_per_device"][
        "all-reduce"] == pytest.approx(2 * 4 * P / 2)
    assert h["flops_per_device"] == r["flops_per_device"]
    with pytest.raises(ValueError):
        dryrun.build_step("h2o-danube-1.8b", "train_4k", cards=8,
                          hybrid_rep=3)
