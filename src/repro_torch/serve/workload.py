"""Serving-plane workloads: a tiny trainable LM and the inference adapters.

A port of ``src/repro/serve/workload.py``.

* ``lm-tiny``: a generative workload, registered in
  :mod:`repro_torch.api.trainers` under that name.  A 2-layer
  attention+MLP decoder from the model stack (:mod:`repro_torch.models.
  model`), float32, so its params ride the ``<f4`` slab wire unchanged.
  The synthetic task is next-symbol succession (``label = (token + 1)
  mod V``): the loss falls within a handful of gradients, and a serve
  client sees its generations change from one params version to the
  next.  Workers differentiate :func:`~repro_torch.models.model.loss_fn`
  (the plain forward); the data are the reference's, bit for bit.
* **Inference adapters**: what a serve client does with a decoded params
  snapshot.  :func:`build_infer_adapter` returns an object with
  ``codec`` (the slab codec of the leader's params layout),
  ``decode(slab)`` and ``run(params, i) -> dict``: greedy generation
  through the serving forward (the rmsnorm kernel on the card) for
  ``lm-tiny``, a forward-pass probe (the loss on one held-out batch) for
  the classifier workloads.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.convert import Device, resolve_device, to_device, tree_to
from repro_torch.models.config import ATTN, MLP, ModelConfig, \
    uniform_pattern

LM_TINY_SEQ = 16


def lm_tiny_config() -> ModelConfig:
    """The serving demo's model: d 64, vocab 128, 2 layers, 4 heads of
    16, d_ff 128, float32, tied embeddings."""
    return ModelConfig(
        name="lm-tiny", arch_type="dense", d_model=64, vocab_size=128,
        block_pattern=uniform_pattern(ATTN, MLP, 2), num_groups=1,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
        tie_embeddings=True, dtype="float32", param_dtype="float32",
        remat="none", source="repro.serve")


def _lm_tiny_data(seed: int, n: int, seq: int, vocab: int):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (n, seq)).astype(np.int32)
    y = ((x + 1) % vocab).astype(np.int32)
    n_test = max(1, n // 8)
    return (x[n_test:], y[n_test:], x[:n_test], y[:n_test])


def _lm_tiny_params(seed: int):
    """The initial params, drawn on the CPU from ``seed`` (the same on
    every device)."""
    from repro_torch.models import model as M
    return M.init_params(torch.Generator().manual_seed(seed),
                         lm_tiny_config())


def lm_tiny_workload(spec, device: torch.device):
    """``SIM_WORKLOADS`` builder: ``(loss_fn, init_params, data,
    accuracy_fn)``, params on ``device``, data ``(x_tr, y_tr, x_te,
    y_te)`` as numpy."""
    from repro_torch.models import model as M

    cfg = lm_tiny_config()
    n = 512 if spec.smoke else 4_096
    data = _lm_tiny_data(spec.seed, n, LM_TINY_SEQ, cfg.vocab_size)
    params = tree_to(_lm_tiny_params(spec.seed), device)

    def loss(p, x, y):
        return M.loss_fn(p, {"tokens": x, "labels": y}, cfg)[0]

    def accuracy(p, x, y):
        logits, _ = M.forward(p, {"tokens": x}, cfg)
        return torch.mean((torch.argmax(logits, dim=-1) == y).float())

    return loss, params, data, accuracy


# ----------------------------------------------------------- adapters


class LMAdapter:
    """Greedy generation against pushed params (``lm-tiny``), through the
    serving forward: on the card every norm launches the rmsnorm
    kernel."""

    kind = "lm"

    def __init__(self, spec, *, batch: int = 2, prompt_len: int = 8,
                 gen_len: int = 8, device: Device = None):
        from repro_torch.core.slab import slab_codec

        self.device = resolve_device(device)
        self.cfg = lm_tiny_config()
        self.codec = slab_codec(_lm_tiny_params(spec.seed),
                                getattr(spec, "slab_dtype", "f32"))
        rng = np.random.default_rng(spec.seed)
        self.prompts = rng.integers(
            0, self.cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
        self.gen_len = int(gen_len)

    def decode(self, slab):
        return self.codec.decode(slab.to(self.device))

    def run(self, params, i: int):
        from repro_torch.launch.serve import greedy_generate
        with torch.inference_mode():
            out = greedy_generate(self.cfg, params, self.prompts,
                                  self.gen_len)
        return {"tokens": out[0, -self.gen_len:].tolist(),
                "n": int(self.prompts.shape[0]) * self.gen_len}

    def summary(self, out) -> str:
        return f"generated tokens {out['tokens']}"


class ProbeAdapter:
    """Forward-pass probe for the classifier workloads: the loss on one
    fixed held-out batch, the arch-agnostic inference a serve client can
    run against any registered workload."""

    kind = "probe"

    def __init__(self, spec, *, batch: int = 64, device: Device = None):
        from repro_torch.api.trainers import SIM_WORKLOADS
        from repro_torch.core.slab import slab_codec

        self.device = resolve_device(device)
        loss, template, data, _ = SIM_WORKLOADS[spec.arch](spec,
                                                           self.device)
        self.codec = slab_codec(template,
                                getattr(spec, "slab_dtype", "f32"))
        self._probe = (to_device(data[2][:batch], self.device),
                       to_device(data[3][:batch], self.device))
        self._loss = loss

    def decode(self, slab):
        return self.codec.decode(slab.to(self.device))

    def run(self, params, i: int):
        xb, yb = self._probe
        with torch.no_grad():
            probe = float(self._loss(params, xb, yb))
        return {"probe_loss": probe, "n": int(xb.shape[0])}

    def summary(self, out) -> str:
        return f"probe loss {out['probe_loss']:.4f}"


def build_infer_adapter(spec, *, batch: int = 2, prompt_len: int = 8,
                        gen_len: int = 8, device: Device = None):
    """The serve client's inference engine for ``spec.arch`` on
    ``device``: generation for ``lm-tiny``, a forward-pass probe
    otherwise."""
    if spec.arch == "lm-tiny":
        return LMAdapter(spec, batch=batch, prompt_len=prompt_len,
                         gen_len=gen_len, device=device)
    return ProbeAdapter(spec, batch=max(batch, 64), device=device)
