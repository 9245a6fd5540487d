"""The image sets' cache (``repro_torch/data/synthetic.py``): with
``REPRO_TORCH_DATA_CACHE`` set, a set is drawn once and later builds, in
this process or another, map the same bytes; each equals the
reference's draw (``src/repro/data/synthetic.py``) bit for bit."""
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.data import synthetic as ref_synthetic
from repro_torch.data import synthetic

SIZES = dict(seed=3, n_train=300, n_test=40)


def _same(got, want):
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert type(a) is np.ndarray
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["cifar10_like", "mnist_like"])
def test_cached_set_equals_the_reference_draw(tmp_path, monkeypatch, name):
    """The first build draws and writes the four arrays, the second maps
    them; both, and the build with no cache, equal the reference's."""
    want = getattr(ref_synthetic, name)(**SIZES)
    _same(getattr(synthetic, name)(**SIZES), want)
    monkeypatch.setenv(synthetic.CACHE_ENV, str(tmp_path / "cache"))
    _same(getattr(synthetic, name)(**SIZES), want)
    files = sorted(os.listdir(tmp_path / "cache"))
    assert len(files) == 4 and all(f.endswith(".npy") for f in files)
    mapped = getattr(synthetic, name)(**SIZES)
    _same(mapped, want)
    # copy on write: a caller's write stays its own
    mapped[0][0] += 1.0
    _same(getattr(synthetic, name)(**SIZES), want)


def test_cache_keys_every_argument(tmp_path, monkeypatch):
    """Another seed or size is another set, never a cached one."""
    monkeypatch.setenv(synthetic.CACHE_ENV, str(tmp_path))
    synthetic.cifar10_like(**SIZES)
    for other in (dict(SIZES, seed=4), dict(SIZES, n_train=200),
                  dict(SIZES, n_test=10)):
        _same(synthetic.cifar10_like(**other),
              ref_synthetic.cifar10_like(**other))
    assert len(os.listdir(tmp_path)) == 16


_CHILD = """
import hashlib
from repro_torch.data import synthetic
arrays = synthetic.cifar10_like(seed=3, n_train=300, n_test=40)
print(hashlib.sha256(b"".join(a.tobytes() for a in arrays)).hexdigest())
"""


def test_another_process_maps_the_cached_set(tmp_path):
    """A second interpreter, as a worker process is, reads the set the
    first wrote: the same bytes, without writing."""
    want = hashlib.sha256(b"".join(
        a.tobytes() for a in ref_synthetic.cifar10_like(**SIZES))).hexdigest()
    env = dict(os.environ, **{synthetic.CACHE_ENV: str(tmp_path)})
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    outs = []
    for _ in range(2):
        outs.append(subprocess.run(
            [sys.executable, "-c", _CHILD], env=env, check=True,
            capture_output=True, text=True).stdout.strip())
        stamps = {f: os.stat(tmp_path / f).st_mtime_ns
                  for f in os.listdir(tmp_path)}
    assert outs == [want, want]
    assert {f: os.stat(tmp_path / f).st_mtime_ns
            for f in os.listdir(tmp_path)} == stamps
