"""The paper's experiment models: small CNNs for MNIST/CIFAR-10-like data
and an MLP for the random 20-dim/10-class dataset (paper §5–6).

Functional models over dicts of tensors, mirroring
``src/repro/models/cnn.py``.  Parameters keep the reference's names and
layouts (conv weights HWIO, inputs NHWC), so the two packages' slabs
compare byte for byte; PyTorch's NCHW/OIHW layouts stay inside
:func:`cnn_forward`.  Negative log-likelihood loss, as in the paper.

PyTorch cannot replay ``jax.random``: :func:`init_cnn` and
:func:`init_mlp_clf` draw the same distributions from a
``torch.Generator``, and tests that compare with the reference carry the
reference's initial parameters over instead
(:func:`repro_torch.convert.params_from_numpy`).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _conv(x_nchw: torch.Tensor, w_hwio: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    # SAME padding for a 3x3 kernel at stride 1 is one pixel each side
    return F.conv2d(x_nchw, w_hwio.permute(3, 2, 0, 1), b, padding=1)


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(device)


def init_cnn(gen: torch.Generator, image_shape: Tuple[int, int, int],
             num_classes: int = 10, device="cpu"):
    """image_shape = (H, W, C)."""
    H, W, C = image_shape
    c1, c2 = 16, 32
    flat = (H // 4) * (W // 4) * c2
    z = lambda n: torch.zeros((n,), dtype=torch.float32,  # noqa: E731
                              device=device)
    return {
        "conv1_w": _normal(gen, (3, 3, C, c1), device) * (9 * C) ** -0.5,
        "conv1_b": z(c1),
        "conv2_w": _normal(gen, (3, 3, c1, c2), device) * (9 * c1) ** -0.5,
        "conv2_b": z(c2),
        "fc1_w": _normal(gen, (flat, 128), device) * flat ** -0.5,
        "fc1_b": z(128),
        "fc2_w": _normal(gen, (128, num_classes), device) * 128 ** -0.5,
        "fc2_b": z(num_classes),
    }


def cnn_forward(params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) -> logits (B, num_classes)."""
    h = x.permute(0, 3, 1, 2)
    h = F.relu(_conv(h, params["conv1_w"], params["conv1_b"]))
    h = F.max_pool2d(h, 2, 2)
    h = F.relu(_conv(h, params["conv2_w"], params["conv2_b"]))
    h = F.max_pool2d(h, 2, 2)
    # back to NHWC before flattening: fc1's rows are in HWC order
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.relu(h @ params["fc1_w"] + params["fc1_b"])
    return h @ params["fc2_w"] + params["fc2_b"]


def init_mlp_clf(gen: torch.Generator, in_dim: int = 20, hidden: int = 64,
                 num_classes: int = 10, device="cpu"):
    z = lambda n: torch.zeros((n,), dtype=torch.float32,  # noqa: E731
                              device=device)
    return {
        "w1": _normal(gen, (in_dim, hidden), device) * in_dim ** -0.5,
        "b1": z(hidden),
        "w2": _normal(gen, (hidden, hidden), device) * hidden ** -0.5,
        "b2": z(hidden),
        "w3": _normal(gen, (hidden, num_classes), device) * hidden ** -0.5,
        "b3": z(num_classes),
    }


def mlp_clf_forward(params, x: torch.Tensor) -> torch.Tensor:
    h = F.relu(x @ params["w1"] + params["b1"])
    h = F.relu(h @ params["w2"] + params["b2"])
    return h @ params["w3"] + params["b3"]


def nll_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Negative log-likelihood (the paper's loss)."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None]).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, -1) == labels).float().mean()
