"""Parameter partitioning, after the reference's ``parallel/partition.py``:
key path -> logical axis names -> mesh axes -> per-leaf shard shapes.

FSDP axis = "embed" (mesh ``data``), tensor axes = "heads"/"mlp"/
"vocab"/"experts"/"inner"/"embed_tensor" (mesh ``model``).  Every leaf
under ``params["groups"]`` carries a leading group-stack dim, which is
never sharded.  The rules are the reference's, names and all.  Where the
reference returns ``NamedSharding``s, these return each leaf's **shard
shape** (what one device holds), over a mesh given as a dict of axis
sizes (``parallel/sharding.py``); ``parallel/fsdp.py`` places tensors
by them over the data axis.  A leaf is anything with ``.shape`` and ``.ndim`` (a tensor, a
meta tensor, a numpy array).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.parallel.sharding import (Mesh, MeshAxes, logical_spec,
                                           rules_for)

Spec = Tuple[MeshAxes, ...]


def _resolve(path: Tuple[str, ...], ndim: int) -> Tuple[Optional[str], ...]:
    name = path[-1]
    joined = "/".join(path)
    grouped = path[0] == "groups"

    def g(*names):
        """Prepend the unsharded group-stack axis when inside groups."""
        out = (None,) + names if grouped else names
        assert len(out) == ndim, (joined, ndim, out)
        return out

    # --- embedding / head / frontend
    if name == "embed":
        return ("vocab", "embed")
    if name == "lm_head":
        return ("embed", "vocab")
    if joined.startswith("frontend_proj"):
        return (None, "embed_tensor") if name == "w1" \
            else ("embed_tensor", None)

    # --- norms
    if name in ("scale", "bias"):
        return (None,) * ndim
    if name == "gn_scale":
        return g("heads", None) if ndim - int(grouped) == 2 else g(None)

    # --- attention family
    if name == "wq":
        return g("embed", "heads", None)
    if name in ("wk", "wv"):
        return g("embed", "kv_heads", None)
    if name in ("lq", "lk", "lv"):                 # mLSTM qkv (di, H, dh)
        return g("embed", None, None)
    if name == "wo":
        return g("heads", None, "embed")
    if name in ("bq", "bk", "bv"):
        return g("heads" if name == "bq" else "kv_heads", None)
    if name == "w_dkv" or name == "w_kr":
        return g("embed", None)
    if name in ("w_uk", "w_uv"):
        return g(None, "heads", None)

    # --- MoE
    if "experts" in path:
        if name in ("w_gate", "w_up"):
            return g("experts", "embed", None)
        if name == "w_down":
            return g("experts", None, "embed")
    if name == "router":
        return g("embed", None)

    # --- MLP (incl. moe shared expert, xlstm block projections)
    if name in ("w_up", "w_gate", "w_z"):
        return g("embed", "mlp")
    if name == "w_down":
        return g("mlp", "embed")

    # --- mamba
    if name == "w_in":
        return g("embed", "inner")
    if name == "conv_w":
        return g(None, "inner")
    if name == "conv_b":
        return g("inner")
    if name == "w_x":
        if ndim - int(grouped) == 3:          # slstm (d, 4, d)
            return g("embed", None, "embed_tensor")
        return g("inner", None)               # mamba (di, dt+2s)
    if name == "w_dt":
        return g(None, "inner")
    if name in ("dt_bias", "D"):
        return g("inner")
    if name == "A_log":
        return g("inner", None)
    if name == "w_out":
        return g("inner", "embed")

    # --- xlstm extras
    if name == "w_if":
        return g("embed", None, None)
    if name == "b_if":
        return g(None, None)
    if name == "r_h":
        return g("heads", None, None, None)
    if name == "b":
        return g(None, "embed_tensor")

    return (None,) * ndim


def map_with_path(fn: Callable, tree: Any, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over nested dicts, tuples and lists; a path
    holds dict keys and sequence indices as strings."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _key(path: Tuple[str, ...]) -> Tuple[str, ...]:
    """Drop sequence indices; keep the 'groups' marker for matching."""
    return tuple(n for n in path if not n.isdigit())


def param_logical_tree(params) -> Any:
    """Parallel tree of logical-axis tuples."""
    return map_with_path(lambda p, leaf: _resolve(_key(p), leaf.ndim),
                         params)


def sanitize(spec: Spec, shape, mesh: Mesh) -> Spec:
    """Drop mesh axes from dims they don't divide evenly, as the
    reference's ``sanitize_sharding`` (e.g. 8 kv-heads can't shard over a
    16-way model axis, 4 xLSTM heads can't shard at all)."""
    new = []
    for dim, axes in enumerate(tuple(spec) + (None,) * (len(shape)
                                                        - len(spec))):
        if axes is None:
            new.append(None)
            continue
        kept = []
        size = shape[dim]
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            if size % mesh[a] == 0:
                kept.append(a)
                size //= mesh[a]
        new.append(None if not kept else kept[0] if len(kept) == 1
                   else tuple(kept))
    return tuple(new)


def shard_shape(shape, spec: Spec, mesh: Mesh) -> Tuple[int, ...]:
    """What one device holds of a ``shape`` laid out by ``spec`` (every
    named axis must divide its dim, as after :func:`sanitize`)."""
    out = []
    for dim, axes in enumerate(tuple(spec) + (None,) * (len(shape)
                                                        - len(spec))):
        n = 1
        for a in (() if axes is None else axes if isinstance(axes, tuple)
                  else (axes,)):
            n *= mesh[a]
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"over {axes} ({n})")
        out.append(shape[dim] // n)
    return tuple(out)


def _param_spec(path, leaf, mesh: Mesh, rules) -> Spec:
    return sanitize(logical_spec(_resolve(_key(path), leaf.ndim), rules),
                    leaf.shape, mesh)


def leaf_spec(path: Tuple[str, ...], leaf, mesh: Mesh) -> Spec:
    """The sanitized mesh-axes spec of the param leaf at ``path`` (a
    ``map_with_path`` path)."""
    return _param_spec(path, leaf, mesh, rules_for(mesh))


def param_specs(params, mesh: Mesh) -> Any:
    """Each param leaf's sanitized mesh-axes spec."""
    rules = rules_for(mesh)
    return map_with_path(lambda p, leaf: _param_spec(p, leaf, mesh, rules),
                         params)


def param_shardings(params, mesh: Mesh) -> Any:
    """Each param leaf's shard shape."""
    rules = rules_for(mesh)
    return map_with_path(lambda p, leaf: shard_shape(
        leaf.shape, _param_spec(p, leaf, mesh, rules), mesh), params)


def opt_state_shardings(opt_state, params, mesh: Mesh) -> Any:
    """Optimizer state shards exactly like its mirrored params (mu/nu);
    scalars (the count) replicate."""
    pshard = param_shardings(params, mesh)
    return {k: pshard if k in ("mu", "nu")
            else map_with_path(lambda p, leaf: tuple(leaf.shape), v)
            for k, v in opt_state.items()}


def _cache_spec(batch_size: int, mesh: Mesh):
    """``(path, leaf) -> spec`` for decode-cache leaves, the reference's
    two regimes: (a) batch divisible by the data axes -- shard batch over
    (pod x) data and kv-heads/channels over model; (b) tiny batch
    (long_500k B=1) -- shard the sequence dim of KV caches over ``data``
    and fat channel dims over (data, model)."""
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh)
    dsz = 1
    for a in batch_axes:
        dsz *= mesh[a]
    batch_mode = batch_size % dsz == 0

    def div(n, axis_names):
        """axis tuple if n divides evenly, else None."""
        total = 1
        for a in axis_names:
            total *= mesh[a]
        if n % total == 0:
            return axis_names if len(axis_names) > 1 else axis_names[0]
        return None

    def spec_for(path, leaf):
        name = path[-1]
        nd = leaf.ndim
        shape = leaf.shape
        # dims: 0 = group stack, 1 = batch
        if batch_mode:
            b = batch_axes if len(batch_axes) > 1 else \
                (batch_axes[0] if batch_axes else None)
            if name in ("k", "v"):                    # (G,B,L,KV,hd)
                kvh = div(shape[3], ("model",))
                if kvh is not None:
                    return (None, b, None, kvh, None)
                return (None, b, div(shape[2], ("model",)), None, None)
            if name in ("c_kv", "k_rope"):            # (G,B,L,r)
                return (None, b, div(shape[2], ("model",)), None)
            rest = [None] * (nd - 2)
            # shard the fattest trailing dim over model when divisible
            if nd > 2:
                rest[-1] = div(shape[-1], ("model",))
            return (None, b, *rest)
        # tiny-batch regime: shard sequence / channels instead
        if name in ("k", "v"):
            kvh = div(shape[3], ("model",))
            seq_axes = ("data",) if kvh is not None else ("data", "model")
            return (None, None, div(shape[2], seq_axes), kvh, None)
        if name in ("c_kv", "k_rope"):
            return (None, None, div(shape[2], ("data", "model")), None)
        if name == "conv":                             # (G,B,dc-1,di)
            return (None, None, None, div(shape[3], ("data", "model")))
        if name == "h" and nd == 4:                    # mamba h (G,B,di,ds)
            return (None, None, div(shape[2], ("data", "model")), None)
        if name == "C":                                # mlstm (G,B,H,dh,dh)
            return (None, None, None, div(shape[3], ("data", "model")),
                    None)
        if name == "n" and nd == 4:                    # mlstm n (G,B,H,dh)
            return (None, None, None, div(shape[3], ("data", "model")))
        if nd == 3:                                    # slstm states (G,B,d)
            return (None, None, div(shape[2], ("data", "model")))
        return (None,) * nd

    return lambda p, leaf: spec_for(_key(p) or ("x",), leaf)


def cache_specs(cache, batch_size: int, mesh: Mesh) -> Any:
    """Each decode-cache leaf's mesh-axes spec."""
    return map_with_path(_cache_spec(batch_size, mesh), cache)


def cache_leaf_specs(cache, batch_size: int, mesh: Mesh) -> Dict:
    """Each decode-cache leaf's mesh-axes spec, by its ``map_with_path``
    path."""
    spec, out = _cache_spec(batch_size, mesh), {}
    map_with_path(lambda p, leaf: out.__setitem__(p, spec(p, leaf)), cache)
    return out


def cache_shardings(cache, batch_size: int, mesh: Mesh) -> Any:
    """Each decode-cache leaf's shard shape."""
    spec = _cache_spec(batch_size, mesh)
    return map_with_path(lambda p, leaf: shard_shape(
        leaf.shape, spec(p, leaf), mesh), cache)
