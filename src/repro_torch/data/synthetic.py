"""Deterministic synthetic datasets.

The container is offline: MNIST/CIFAR-10 are replaced by synthetic
stand-ins of identical shape and cardinality whose classes are genuinely
learnable (class-conditional pattern + noise), so optimization dynamics
(the paper's subject) are preserved.  The random 20-dim/10-class dataset
reproduces the paper's §6 setup exactly.

A numpy-only copy of ``src/repro/data/synthetic.py``: the same seeds
give the same arrays.  Datasets are built on the host and moved to the
device once by the trainer.

An image set is a few hundred MB drawn from one generator stream, which
every worker process of a fleet would otherwise draw whole to keep its
shard.  With ``REPRO_TORCH_DATA_CACHE`` naming a directory, the first
build of a set writes its four arrays there and later builds (in any
process) map them read-only, copy on write: the same bytes, drawn once.
"""
from __future__ import annotations

import os

import numpy as np

_CHUNK_ROWS = 4096
CACHE_ENV = "REPRO_TORCH_DATA_CACHE"
_PARTS = ("x_tr", "y_tr", "x_te", "y_te")


def _cached(name: str, build):
    """``build()``'s arrays, through the directory ``CACHE_ENV`` names
    (under ``name``), when it is set."""
    root = os.environ.get(CACHE_ENV)
    if not root:
        return build()
    paths = [os.path.join(root, f"{name}.{part}.npy") for part in _PARTS]
    if all(os.path.exists(p) for p in paths):
        return tuple(np.asarray(np.load(p, mmap_mode="c")) for p in paths)
    arrays = build()
    os.makedirs(root, exist_ok=True)
    for p, a in zip(paths, arrays):
        tmp = f"{p}.{os.getpid()}.tmp.npy"
        np.save(tmp, a)
        os.replace(tmp, p)      # whole or absent to a concurrent reader
    return arrays


def _class_image_dataset(n_train: int, n_test: int, shape, num_classes: int,
                         seed: int, noise: float):
    """Images = class template (low-frequency pattern) + per-sample noise."""
    key = f"images-{n_train}-{n_test}-{'x'.join(map(str, shape))}-" \
        f"{num_classes}-{seed}-{noise!r}"
    return _cached(key, lambda: _draw_images(n_train, n_test, shape,
                                             num_classes, seed, noise))


def _draw_images(n_train: int, n_test: int, shape, num_classes: int,
                 seed: int, noise: float):
    rng = np.random.default_rng(seed)
    H, W, C = shape
    # smooth class templates: random low-rank outer products per channel
    templates = np.zeros((num_classes, H, W, C), np.float32)
    for c in range(num_classes):
        for ch in range(C):
            u = rng.normal(size=(H, 3)).astype(np.float32)
            v = rng.normal(size=(3, W)).astype(np.float32)
            templates[c, :, :, ch] = (u @ v) / 3.0

    def make(n, seed2):
        r = np.random.default_rng(seed2)
        y = r.integers(0, num_classes, size=n)
        # drawn in row chunks: the generator's stream and the elementwise
        # sum are those of one draw of all n rows, bitwise, without the
        # float64 temporaries of all n rows at once (25 worker processes
        # build this set side by side)
        x = np.empty((n, H, W, C), np.float32)
        for lo in range(0, n, _CHUNK_ROWS):
            hi = min(n, lo + _CHUNK_ROWS)
            x[lo:hi] = templates[y[lo:hi]] + noise * r.normal(
                size=(hi - lo, H, W, C)).astype(np.float32)
        return x, y.astype(np.int32)

    x_tr, y_tr = make(n_train, seed + 1)
    x_te, y_te = make(n_test, seed + 2)
    return x_tr, y_tr, x_te, y_te


def mnist_like(seed: int = 0, n_train: int = 60_000, n_test: int = 10_000):
    """MNIST stand-in: 28x28x1, 10 classes, 60k/10k."""
    return _class_image_dataset(n_train, n_test, (28, 28, 1), 10, seed,
                                noise=0.8)


def cifar10_like(seed: int = 0, n_train: int = 50_000, n_test: int = 10_000):
    """CIFAR-10 stand-in: 32x32x3, 10 classes, 50k/10k; noisier => the
    'harder optimization problem' role CIFAR plays in the paper."""
    return _class_image_dataset(n_train, n_test, (32, 32, 3), 10, seed,
                                noise=1.6)


def random_classification(seed: int = 0, n: int = 10_000, dim: int = 20,
                          num_classes: int = 10, train_frac: float = 0.8):
    """The paper's randomly-generated dataset: 20 dims, 10 classes, 10k
    samples, 80:20 split.  Labels from a random linear teacher + noise."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    teacher = rng.normal(size=(dim, num_classes)).astype(np.float32)
    logits = x @ teacher + 0.5 * rng.normal(size=(n, num_classes))
    y = np.argmax(logits, axis=-1).astype(np.int32)
    k = int(train_frac * n)
    return x[:k], y[:k], x[k:], y[k:]


def token_stream(seed: int, vocab_size: int, batch: int, seq: int):
    """Deterministic LM token batches: a bigram-ish synthetic language so
    loss actually decreases during example training runs."""
    rng = np.random.default_rng(seed)
    # random sparse bigram table
    next_tok = rng.integers(0, vocab_size, size=(vocab_size, 4))

    def batches():
        r = np.random.default_rng(seed + 1)
        while True:
            t = np.empty((batch, seq + 1), np.int64)
            t[:, 0] = r.integers(0, vocab_size, size=batch)
            for i in range(seq):
                choice = r.integers(0, 4, size=batch)
                noise = r.random(batch) < 0.1
                nxt = next_tok[t[:, i], choice]
                t[:, i + 1] = np.where(
                    noise, r.integers(0, vocab_size, size=batch), nxt)
            yield {"tokens": t[:, :-1].astype(np.int32),
                   "labels": t[:, 1:].astype(np.int32)}

    return batches()
