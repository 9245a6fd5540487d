"""Dense MLP blocks, after the reference's ``models/mlp.py``: SwiGLU
(llama-style) and GELU.  ``jax.nn.gelu`` defaults to the tanh
approximation, so the port uses ``approximate="tanh"``."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype) -> dict:
    dev = gen.device
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    p = {
        "w_up": (torch.randn((d_model, d_ff), generator=gen, device=dev)
                 * s_in).to(dtype),
        "w_down": (torch.randn((d_ff, d_model), generator=gen, device=dev)
                   * s_out).to(dtype),
    }
    if act == "swiglu":
        p["w_gate"] = (torch.randn((d_model, d_ff), generator=gen,
                                   device=dev) * s_in).to(dtype)
    return p


def mlp_forward(params, x, act: str):
    up = x @ params["w_up"]
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ params["w_down"]
