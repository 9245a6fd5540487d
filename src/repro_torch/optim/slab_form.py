"""Slab-form optimizer choice — the server-side optimizer config.

:class:`repro_torch.core.slab.SlabAggregator` owns the optimizer state
as f32 slab-shaped buffers and applies every flush through one fused
kernel per optimizer.  Moment names follow the pytree state keys:
momentum carries ``mu``; AdamW carries ``mu``/``nu``.  Mirrors
``src/repro/optim/slab_form.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.optim.optimizers import Optimizer, adamw, momentum, sgd

OPTIMIZER_NAMES: Tuple[str, ...] = ("sgd", "momentum", "adamw")


@dataclasses.dataclass(frozen=True)
class SlabOptimizer:
    """Server-side optimizer choice + hyperparameters.

    ``beta1`` doubles as momentum's decay and AdamW's b1; ``beta2``,
    ``eps`` and ``weight_decay`` are AdamW-only.  ``sgd`` carries no
    moment buffers.
    """

    name: str = "sgd"
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    def __post_init__(self):
        if self.name not in OPTIMIZER_NAMES:
            raise ValueError(f"optimizer must be one of "
                             f"{OPTIMIZER_NAMES}, got {self.name!r}")
        if not (0.0 <= self.beta1 < 1.0 and 0.0 <= self.beta2 < 1.0):
            raise ValueError(f"betas must be in [0, 1): "
                             f"beta1={self.beta1}, beta2={self.beta2}")

    @property
    def moment_names(self) -> Tuple[str, ...]:
        if self.name == "momentum":
            return ("mu",)
        if self.name == "adamw":
            return ("mu", "nu")
        return ()

    def pair(self) -> Optimizer:
        """The tree-form ``(init, update)`` pair at unit learning rate."""
        if self.name == "momentum":
            return momentum(1.0, beta=self.beta1)
        if self.name == "adamw":
            return adamw(1.0, b1=self.beta1, b2=self.beta2, eps=self.eps,
                         weight_decay=self.weight_decay)
        return sgd(1.0)
