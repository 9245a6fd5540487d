"""The port's partition rules (``parallel/sharding.py``,
``parallel/partition.py``) against the reference's.

Every leaf of every full config resolves to a logical tuple of its rank
(as ``tests/test_substrate.py::test_param_logical_tree_all_archs``), the
port's logical tree equals the reference's leaf by leaf, and on a (2, 2)
``data`` x ``model`` mesh every param, AdamW-state and decode-cache
leaf's shard shape equals the reference's ``NamedSharding.shard_shape``
after ``sanitize_sharding``, computed in a child process with 4 forced
host devices (as ``tests/test_spmd.py`` does).  Shapes are exact.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import model as JM
from repro.parallel import partition as jpartition
from repro_torch.configs import registry as tregistry
from repro_torch.launch.dryrun import meta_params
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from repro_torch.parallel import partition, sharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_ARCHS = ("jamba-v0.1-52b", "xlstm-350m", "deepseek-v2-lite-16b",
               "phi-3-vision-4.2b", "hubert-xlarge", "h2o-danube-1.8b")
MESH = {"data": 2, "model": 2}


def _flat(tree, path=()):
    """(path, leaf) pairs; the path holds dict keys and indices as
    strings (the reference's ``_path_names``)."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flat(v, path + (k,))]
    if isinstance(tree, (tuple, list)) and not all(
            isinstance(e, (str, int, type(None))) for e in tree):
        return [x for i, v in enumerate(tree)
                for x in _flat(v, path + (str(i),))]
    return [(path, tree)]


@pytest.mark.parametrize("arch", tregistry.ARCH_NAMES)
def test_param_logical_tree_all_archs(arch):
    """Every leaf of every full config resolves to a valid logical tuple,
    the reference's for the same path."""
    cfg = tregistry.get_config(arch)
    params = meta_params(cfg)
    logical = dict(_flat(partition.param_logical_tree(params)))
    leaves = dict(_flat(params))
    assert logical.keys() == leaves.keys()
    for path, names in logical.items():
        assert len(names) == leaves[path].ndim, (arch, path, names)
        assert all(n is None or n in sharding.DEFAULT_RULES for n in names)
    jcfg = jregistry.get_config(arch)
    sds = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                jcfg))
    flat, _ = jax.tree_util.tree_flatten_with_path(sds)
    want = {jpartition._path_names(p): jpartition._resolve(
        tuple(n for n in jpartition._path_names(p) if not n.isdigit()),
        leaf.ndim) for p, leaf in flat}
    assert want == logical


def test_rules_drop_the_pod_axis_and_sanitize():
    rules = sharding.rules_for(MESH)
    assert rules["batch"] == "data" and rules["embed"] == "data"
    assert sharding.rules_for({"pod": 2, **MESH})["batch"] == ("pod", "data")
    assert sharding.logical_spec(("embed", None, "heads"), rules) == \
        ("data", None, "model")
    # 8 kv-heads over a 16-way model axis: dropped; 3 rows over 2: dropped
    mesh = {"data": 2, "model": 16}
    assert partition.sanitize(("data", "model"), (4, 8), mesh) == \
        ("data", None)
    assert partition.sanitize((("data", "model"),), (32,),
                              {"data": 2, "model": 16}) == \
        (("data", "model"),)
    assert partition.shard_shape((4, 32), ("data", ("model",)),
                                 {"data": 2, "model": 16}) == (2, 2)
    with pytest.raises(ValueError):
        partition.shard_shape((3,), ("data",), mesh)


_CHILD = """
    import json
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs.registry import get_config, smoke_variant
    from repro.models import model as M
    from repro.optim import adamw
    from repro.parallel.partition import (_path_names, cache_shardings,
                                          opt_state_shardings,
                                          param_shardings)
    from repro.parallel.sharding import axis_rules

    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))

    def shapes(tree, shardings):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        sh = jax.tree.leaves(shardings)
        return [["/".join(_path_names(p)), list(s.shard_shape(leaf.shape))]
                for (p, leaf), s in zip(flat, sh)]

    out = {}
    for arch in ARCHS:
        cfg = smoke_variant(get_config(arch))
        with axis_rules(mesh):
            params = jax.eval_shape(
                lambda: M.init_params(jax.random.PRNGKey(0), cfg))
            opt = jax.eval_shape(lambda: adamw(3e-4).init(params))
            rec = {"params": shapes(params, param_shardings(params)),
                   "opt": shapes(opt, opt_state_shardings(opt, params))}
            if not cfg.encoder_only:
                for B in (4, 1):
                    cache = jax.eval_shape(lambda: M.init_cache(cfg, B, 64))
                    rec[f"cache{B}"] = shapes(
                        cache, cache_shardings(cache, B, mesh))
        out[arch] = rec
    print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_shards():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    code = f"ARCHS = {SMOKE_ARCHS!r}\n" + textwrap.dedent(_CHILD)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env, cwd=REPO)
    assert p.returncode == 0, f"stdout:\n{p.stdout}\nstderr:\n{p.stderr}"
    line = next(x for x in p.stdout.splitlines() if x.startswith("JSON"))
    return json.loads(line[4:])


def _port_shapes(tree, shards):
    got = {"/".join(p): list(s) for p, s in _flat(shards)}
    assert len(got) == len(_flat(tree))
    return got


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_shard_shapes_match_reference_on_2x2(arch, reference_shards):
    ref = reference_shards[arch]
    cfg = tregistry.smoke_variant(tregistry.get_config(arch))
    params = meta_params(cfg)
    opt = adamw(3e-4).init(params)
    got = {"params": _port_shapes(params,
                                  partition.param_shardings(params, MESH)),
           "opt": _port_shapes(opt, partition.opt_state_shardings(
               opt, params, MESH))}
    if not cfg.encoder_only:
        for B in (4, 1):
            cache = TM.init_cache(cfg, B, 64, device="meta")
            got[f"cache{B}"] = _port_shapes(
                cache, partition.cache_shardings(cache, B, MESH))
    assert got.keys() == ref.keys()
    for kind in ref:
        assert got[kind] == dict(map(tuple, ref[kind])), (arch, kind)
    # the rules shard something on this mesh: a real check, not all-None
    full = {"/".join(p): list(t.shape) for p, t in _flat(params)}
    assert any(full[k] != v for k, v in got["params"].items())


def test_meta_params_hold_no_memory():
    params = meta_params(tregistry.get_config("qwen1.5-110b"))
    leaves = [t for _, t in _flat(params)]
    assert all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in leaves) > 100e9
    assert all(isinstance(t, torch.Tensor) for t in leaves)
