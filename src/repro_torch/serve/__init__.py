"""``repro_torch.serve``: the live serving plane.

Read-only SERVE peers that stream fresh params from a training leader
over the slab wire and run inference on every pushed version, and the
``lm-tiny`` workload they decode with.
"""
from repro_torch.serve.client import ServeClient, infer_main
from repro_torch.serve.workload import (LMAdapter, ProbeAdapter,
                                        build_infer_adapter, lm_tiny_config,
                                        lm_tiny_workload)

__all__ = [
    "ServeClient", "infer_main", "LMAdapter", "ProbeAdapter",
    "build_infer_adapter", "lm_tiny_config", "lm_tiny_workload",
]
