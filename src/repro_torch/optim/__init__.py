"""Optimizers: tree-form pairs and the slab-form server config."""
from repro_torch.optim.optimizers import (Optimizer, adamw, bias_correction,
                                          momentum, sgd)
from repro_torch.optim.slab_form import OPTIMIZER_NAMES, SlabOptimizer

__all__ = ["Optimizer", "adamw", "bias_correction", "momentum", "sgd",
           "OPTIMIZER_NAMES", "SlabOptimizer"]
