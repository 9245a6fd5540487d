"""Shared test setup.

The property-based tests use ``hypothesis``, which is not part of the
pinned CPU image.  When the real package is available we use it; when it
is missing we install a minimal, deterministic stand-in into
``sys.modules`` that supports exactly the subset these tests use:

  * ``strategies.integers(lo, hi)`` / ``sampled_from(seq)`` / ``booleans()``
  * ``@given(**kwargs)`` — draws ``max_examples`` pseudo-random examples
    from a fixed seed (so runs are reproducible) and calls the test once
    per example
  * ``@settings(max_examples=..., deadline=...)`` — only ``max_examples``
    is honoured

This keeps the seed suite runnable in the hermetic container without
pip-installing anything, while real hypothesis (when present) still does
the full shrinking search.
"""
from __future__ import annotations

import functools
import inspect
import random
import sys
import types


def _install_hypothesis_stub():
    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

        def example(self, rng):
            return self._draw(rng)

    def integers(min_value, max_value):
        return _Strategy(lambda rng: rng.randint(min_value, max_value))

    def sampled_from(elements):
        elements = list(elements)
        return _Strategy(lambda rng: elements[rng.randrange(len(elements))])

    def booleans():
        return _Strategy(lambda rng: bool(rng.getrandbits(1)))

    def given(*arg_strategies, **kw_strategies):
        if arg_strategies:
            raise TypeError("stub @given supports keyword strategies only")

        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                n = getattr(wrapper, "_stub_max_examples", None) \
                    or getattr(fn, "_stub_max_examples", None) or 20
                rng = random.Random(f"{fn.__module__}.{fn.__qualname__}")
                for i in range(n):
                    drawn = {k: s.example(rng)
                             for k, s in kw_strategies.items()}
                    try:
                        fn(*args, **kwargs, **drawn)
                    except Exception as e:
                        raise AssertionError(
                            f"falsifying example ({i + 1}/{n}): {drawn}"
                        ) from e
            # pytest must not see the drawn parameters (it would look for
            # fixtures of the same name), nor follow __wrapped__ back to
            # the original signature.
            del wrapper.__wrapped__
            sig = inspect.signature(fn)
            wrapper.__signature__ = sig.replace(parameters=[
                p for name, p in sig.parameters.items()
                if name not in kw_strategies])
            wrapper.hypothesis = types.SimpleNamespace(inner_test=fn)
            return wrapper

        return deco

    def settings(max_examples=20, deadline=None, **_ignored):
        def deco(fn):
            fn._stub_max_examples = max_examples
            return fn

        return deco

    mod = types.ModuleType("hypothesis")
    mod.given = given
    mod.settings = settings
    mod.strategies = types.ModuleType("hypothesis.strategies")
    mod.strategies.integers = integers
    mod.strategies.sampled_from = sampled_from
    mod.strategies.booleans = booleans
    mod.__stub__ = True
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = mod.strategies


try:  # pragma: no cover - trivial import guard
    import hypothesis  # noqa: F401
except ImportError:
    _install_hypothesis_stub()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips on a host without "
        "CUDA (run on the card with `python -m pytest -m cuda`)")
