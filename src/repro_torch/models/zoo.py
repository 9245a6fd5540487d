"""The model zoo on the cluster path: ``zoo:<kind>`` workloads, a port of
the reference's ``models/zoo.py``.

The registry describes published configurations (350M to 110B); the
zoo puts scaled instances of two of those families on the simulator and
the cluster backend: real forward and backward through the model stack
(:mod:`repro_torch.models.model`), the slab aggregation path and the
wire, so ``ExperimentSpec(arch="zoo:xlstm", backend="cluster",
transport="proc")`` runs as ``cnn-cifar`` does, serving plane included
(a serve client rebuilds the workload from the wire spec through
:class:`repro_torch.serve.workload.ProbeAdapter`).

* ``zoo:xlstm``: the registry's ``xlstm-350m`` (mLSTM/sLSTM blocks).
* ``zoo:transformer``: the registry's dense ATTN+MLP family
  (``h2o-danube-1.8b``) re-tiered to the same 350M class.

``spec.zoo_scale`` multiplies the tier's widths: ``d_model``, ``d_ff``
and depth linearly, the vocabulary quadratically, each rounded to a
multiple of 64; 1.0 is the published tier's shape.  Zoo configs train
in float32 with tied embeddings.  The task is next-symbol succession
(``label = (token + 1) mod V``) on the reference's numpy data, so both
packages train on the same tokens.  The initial params are drawn from a
CPU ``torch.Generator`` (the same on every device; ROADMAP C.6).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.models.config import ModelConfig

ZOO_SEQ = 32


def _transformer_350m() -> ModelConfig:
    """The registry's dense ATTN+MLP family at the xlstm-350m class."""
    from repro_torch.configs.registry import get_config
    base = get_config("h2o-danube-1.8b")
    return dataclasses.replace(
        base, name="transformer-350m", d_model=1024, num_heads=16,
        num_kv_heads=8, head_dim=64, d_ff=2816, num_groups=24,
        sliding_window=None, vocab_size=50304,
        source="repro.models.zoo")


def _xlstm_350m() -> ModelConfig:
    from repro_torch.configs.registry import get_config
    return get_config("xlstm-350m")


ZOO_TIERS: Dict[str, Callable[[], ModelConfig]] = {
    "xlstm": _xlstm_350m,
    "transformer": _transformer_350m,
}


def _mult(x: float, m: int, lo: int) -> int:
    """``x`` rounded to a positive multiple of ``m``, at least ``lo``."""
    return max(lo, m * max(1, round(x / m)))


def _scaled_kv_heads(num_heads: int, base: ModelConfig) -> int:
    """The largest divisor of ``num_heads`` within the tier's GQA
    ratio."""
    if base.num_kv_heads <= 0:
        return 0
    want = max(1, round(num_heads * base.num_kv_heads
                        / max(1, base.num_heads)))
    return max(d for d in range(1, num_heads + 1)
               if num_heads % d == 0 and d <= want)


def zoo_config(kind: str, scale: float = 0.25) -> ModelConfig:
    """The tier of zoo member ``kind`` at width multiplier ``scale``."""
    tier = ZOO_TIERS.get(kind)
    if tier is None:
        known = ", ".join(f"zoo:{k}" for k in sorted(ZOO_TIERS))
        raise ValueError(f"unknown zoo member {kind!r} (known: {known})")
    base = tier()
    s = float(scale)
    d_model = _mult(base.d_model * s, 64, 64)
    num_heads = max(1, min(base.num_heads, d_model // 64))
    return dataclasses.replace(
        base,
        name=f"zoo-{kind}-x{s:g}",
        d_model=d_model,
        vocab_size=_mult(base.vocab_size * s * s, 64, 256),
        num_groups=max(1, round(base.num_groups * s)),
        num_heads=num_heads,
        num_kv_heads=_scaled_kv_heads(num_heads, base),
        head_dim=d_model // num_heads,
        d_ff=_mult(base.d_ff * s, 64, 64) if base.d_ff else 0,
        # training settings, not the family's shape: f32 params keep the
        # slab plane's bitwise contract, tied embeddings halve the
        # dominant table
        tie_embeddings=True, dtype="float32", param_dtype="float32",
        remat="none", source="repro.models.zoo")


def num_params(params) -> int:
    if isinstance(params, dict):
        return sum(num_params(v) for v in params.values())
    if isinstance(params, (tuple, list)):
        return sum(num_params(v) for v in params)
    return params.numel()


def _data(seed: int, n: int, seq: int, vocab: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (n, seq)).astype(np.int32)
    y = ((x + 1) % vocab).astype(np.int32)
    n_test = max(1, n // 8)
    return (x[n_test:], y[n_test:], x[:n_test], y[:n_test])


def init_zoo_params(cfg: ModelConfig, seed: int):
    """The initial params, drawn on the CPU from ``seed``."""
    from repro_torch.models import model as M
    return M.init_params(torch.Generator().manual_seed(seed), cfg)


def zoo_workload(spec, device: torch.device):
    """``SIM_WORKLOADS`` builder for ``spec.arch == "zoo:<kind>"``:
    ``(loss_fn, init_params, data, accuracy_fn)``, params on ``device``,
    data ``(x_tr, y_tr, x_te, y_te)`` as numpy.  Training differentiates
    :func:`~repro_torch.models.model.loss_fn` (the plain forward); the
    accuracy runs the serving forward (the kernels on the card)."""
    from repro_torch.convert import tree_to
    from repro_torch.models import model as M

    kind = spec.arch.split(":", 1)[1]
    cfg = zoo_config(kind, getattr(spec, "zoo_scale", 0.25))
    n = 256 if spec.smoke else 2_048
    data = _data(spec.seed, n, ZOO_SEQ, cfg.vocab_size)
    params = tree_to(init_zoo_params(cfg, spec.seed), device)

    def loss(p, x, y):
        return M.loss_fn(p, {"tokens": x, "labels": y}, cfg)[0]

    def accuracy(p, x, y):
        logits, _ = M.forward(p, {"tokens": x}, cfg)
        return torch.mean((torch.argmax(logits, dim=-1) == y).float())

    return loss, params, data, accuracy
