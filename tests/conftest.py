"""Shared fixtures + a deterministic fallback for ``hypothesis``.

The property tests (``test_float_codec``, ``test_modulation``,
``test_kernels``) are written against the real `hypothesis` API. When the
package is unavailable (hermetic CI images pin only jax + pytest), we install
a minimal deterministic stand-in *before collection*: same decorator surface
(`given`, `settings`,
`strategies.lists/floats/integers/sampled_from/booleans/tuples`), but
examples are drawn from a fixed per-test PRNG seeded by the test name, with
boundary values injected first. No shrinking — a failing example prints its
arguments via the assertion itself.
"""

import importlib.util
import random
import sys
import types
import zlib

import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running end-to-end test")
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


# --------------------------------------------------------------------------
# hypothesis fallback (only installed when the real package is missing)
# --------------------------------------------------------------------------


class _Strategy:
    """Base: ``example(rng, i)`` returns the i-th example for this test run."""

    def example(self, rng: random.Random, i: int):
        raise NotImplementedError


class _Integers(_Strategy):
    def __init__(self, min_value, max_value):
        self.lo, self.hi = int(min_value), int(max_value)

    def example(self, rng, i):
        if i == 0:
            return self.lo
        if i == 1:
            return self.hi
        return rng.randint(self.lo, self.hi)


class _Floats(_Strategy):
    def __init__(self, min_value=-1e9, max_value=1e9, width=64, **_kw):
        self.lo, self.hi = float(min_value), float(max_value)
        self.width = width

    def example(self, rng, i):
        if i == 0:
            v = self.lo
        elif i == 1:
            v = self.hi
        elif i == 2 and self.lo <= 0.0 <= self.hi:
            v = 0.0
        else:
            v = rng.uniform(self.lo, self.hi)
        if self.width == 32:
            # hypothesis(width=32) only emits exactly-representable float32s
            import numpy as np

            v = float(np.float32(v))
            v = min(max(v, self.lo), self.hi)
        return v


class _SampledFrom(_Strategy):
    def __init__(self, items):
        self.items = list(items)

    def example(self, rng, i):
        # Guarantee full coverage of small domains before going random.
        if i < len(self.items):
            return self.items[i]
        return rng.choice(self.items)


class _Booleans(_Strategy):
    def example(self, rng, i):
        # Both values first, then random.
        if i < 2:
            return bool(i)
        return rng.random() < 0.5


class _Tuples(_Strategy):
    def __init__(self, *elems):
        self.elems = elems

    def example(self, rng, i):
        # Boundary-first elementwise on the first examples, then random.
        return tuple(e.example(rng, i if i < 2 else 3 + rng.randint(0, 7))
                     for e in self.elems)


class _Lists(_Strategy):
    def __init__(self, elem, min_size=0, max_size=10):
        self.elem, self.lo, self.hi = elem, int(min_size), int(max_size)

    def example(self, rng, i):
        size = self.lo if i == 0 else rng.randint(self.lo, self.hi)
        return [self.elem.example(rng, 3 + rng.randint(0, 7)) for _ in range(size)]


def _stub_given(*strategies):
    def deco(fn):
        # Deliberately *not* functools.wraps: the wrapper must expose a
        # zero-arg signature so pytest doesn't treat the strategy parameters
        # as fixtures.
        def wrapper():
            n = getattr(wrapper, "_stub_max_examples", 20)
            prng = random.Random(zlib.crc32(fn.__qualname__.encode()))
            for i in range(n):
                fn(*[s.example(prng, i) for s in strategies])

        wrapper.__name__ = fn.__name__
        wrapper.__doc__ = fn.__doc__
        wrapper.__module__ = fn.__module__
        return wrapper

    return deco


def _stub_settings(max_examples: int = 20, deadline=None, **_kw):
    def deco(fn):
        fn._stub_max_examples = max_examples
        return fn

    return deco


def _install_hypothesis_stub() -> None:
    st = types.ModuleType("hypothesis.strategies")
    st.integers = lambda min_value=0, max_value=0, **kw: _Integers(min_value, max_value)
    st.floats = lambda **kw: _Floats(
        min_value=kw.get("min_value", -1e9),
        max_value=kw.get("max_value", 1e9),
        width=kw.get("width", 64),
    )
    st.sampled_from = _SampledFrom
    st.lists = lambda elem, min_size=0, max_size=10, **kw: _Lists(elem, min_size, max_size)
    st.booleans = lambda **kw: _Booleans()
    st.tuples = _Tuples

    hyp = types.ModuleType("hypothesis")
    hyp.given = _stub_given
    hyp.settings = _stub_settings
    hyp.strategies = st
    hyp.__stub__ = True
    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = st


if importlib.util.find_spec("hypothesis") is None:
    _install_hypothesis_stub()
