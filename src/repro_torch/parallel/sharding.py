"""Logical-axis sharding rules, after the reference's
``parallel/sharding.py`` (MaxText-style).

Layers name their tensors' axes logically; a rule-set maps each logical
name to mesh axes.  The port has no ``Mesh`` object and no
``torch.distributed`` here: a mesh is a dict of axis sizes, e.g.
``{"data": 16, "model": 16}`` or ``{"pod": 2, "data": 16, "model": 16}``,
and these are pure functions of names.  The dry-run
(``launch/dryrun.py``) reads shard shapes from them, and
``parallel/fsdp.py`` places tensors by them.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]
Mesh = Mapping[str, int]

# Default logical->mesh rules for the production mesh (the reference's
# ``DEFAULT_RULES``, names and all).
#  - "batch" shards over the pod axis too (data parallel across pods).
#  - "embed" is the FSDP axis (weights' d_model dim over `data`).
#  - "heads"/"mlp"/"vocab"/"experts" are the tensor axes (over `model`).
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "batch_nopod": "data",
    "seq": None,
    "seq_shard": "data",        # long-context cache sharding over sequence
    "embed": "data",            # fsdp axis for weights
    "embed_tensor": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_capacity": None,
    "inner": "model",           # ssm / xlstm inner channels
    "state": None,
    "buffer": None,             # hybrid gradient-buffer slot axis
}


def drop_axis(axes: MeshAxes, name: str) -> MeshAxes:
    """``axes`` without mesh axis ``name`` (None if nothing is left)."""
    if axes is None or axes == name:
        return None if axes == name else axes
    if isinstance(axes, tuple):
        kept = tuple(a for a in axes if a != name)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return axes


def rules_for(mesh: Mesh, rules: Optional[Dict[str, MeshAxes]] = None
              ) -> Dict[str, MeshAxes]:
    """The rule-set the reference's ``axis_rules`` installs for ``mesh``:
    every axis the mesh does not have is dropped from every rule (the
    reference drops ``pod`` on a one-pod mesh; a mesh here may also lack
    ``model``, as the port's data-only layouts do)."""
    out = dict(DEFAULT_RULES if rules is None else rules)
    for axis in ("pod", "data", "model"):
        if axis not in mesh:
            out = {k: drop_axis(v, axis) for k, v in out.items()}
    return out


def logical_spec(names: Sequence[Optional[str]],
                 rules: Dict[str, MeshAxes]) -> Tuple[MeshAxes, ...]:
    """Logical names -> one mesh-axes entry per dim (a PartitionSpec's
    entries)."""
    return tuple(rules.get(n) if n is not None else None for n in names)
