"""The port's optimizers and schedules against ``repro.optim``.

Each optimizer runs 5 updates on a mixed bfloat16 / float32 tree (nested
dicts), on gradients drawn from a seed, in both packages:

* against the reference run eagerly (op by op, as jnp dispatches it):
  **Exact**, params and state, for ``sgd``, ``momentum_sgd`` and ``adam``,
  each with a constant rate, ``cosine`` and ``warmup_cosine``. The port
  rounds each Python-float constant once to float32, as jnp's weak types
  do, and ``torch.pow`` / ``torch.cos`` gave XLA's values at these steps
  (``sgd`` keeps its step as a Python int, equal in value to the
  reference's int32);
* against the reference under ``jax.jit``: **Bounded**. XLA on the CPU
  contracts ``p - eta * g`` and ``beta * m + g`` into fmas, so float32
  leaves and states differ by up to ``JIT_REL`` of the leaf's largest
  value (2.2e-7 measured), and bfloat16 leaves by up to one bfloat16 ULP
  of it (none measured); jitted schedules differ by up to ``JIT_ULPS``
  float32 ULPs (3 measured, in ``cosine``).

The schedules alone, at every step of their range: within ``EAGER_ULPS``
of the reference run eagerly (``torch.cos`` and XLA's ``cos`` differ by
one float32 ULP at one step of 16 in one schedule; the rest Exact).

Also: the exports, the state's dtypes (int32 step, float32 moments), the
schedules at every step of their range against the reference, and
``adam``'s root: taken in float64 and rounded, it is numpy's correctly
rounded float32 root bit for bit, and XLA's on every normal input (XLA
flushes subnormal inputs; PyTorch's own float32 ``sqrt`` is not
correctly rounded on the CPU's vectorised path).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as JO  # noqa: E402
from repro_torch import optim as TO  # noqa: E402

torch.set_num_threads(1)

JIT_REL = 2.0**-20
JIT_ULPS = 4
EAGER_ULPS = 1
BF16 = ("a", "d")  # leaf names held in bfloat16, the rest float32


def _tree(rng):
    return {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal((7,)).astype(np.float32),
                  "d": rng.standard_normal((2, 2, 3)).astype(np.float32)}}


def _name(path):
    return path[-1].key


def _jax(t):
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(x, jnp.bfloat16 if _name(p) in BF16
                                 else jnp.float32), t)


def _torch(t):
    return jax.tree_util.tree_map_with_path(
        lambda p, x: torch.from_numpy(x).to(
            torch.bfloat16 if _name(p) in BF16 else torch.float32), t)


def _np(x):
    if isinstance(x, int):  # sgd's step
        return np.int32(x)
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x.astype(jnp.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else x)


def _pairs(jt, tt):
    """``(name, reference leaf, port leaf)`` in leaf order."""
    jl = jax.tree_util.tree_flatten_with_path(jt)[0]
    tl = jax.tree_util.tree_leaves(tt)
    assert len(jl) == len(tl)
    return [(_name(p), _np(a), _np(b)) for (p, a), b in zip(jl, tl)]


def _f32_ulps(a, b) -> int:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


OPTS = {
    "sgd": (lambda M: M.sgd(0.1)),
    "sgd-warmup_cosine": (lambda M: M.sgd(M.warmup_cosine(0.3, 2, 5))),
    "momentum_sgd": (lambda M: M.momentum_sgd(0.1)),
    "momentum_sgd-cosine": (lambda M: M.momentum_sgd(M.cosine(0.3, 4))),
    "momentum_sgd-warmup_cosine":
        (lambda M: M.momentum_sgd(M.warmup_cosine(0.3, 2, 5), beta=0.8)),
    "adam": (lambda M: M.adam(1e-2)),
    "adam-constant": (lambda M: M.adam(M.constant(3e-3), b2=0.99)),
    "adam-cosine": (lambda M: M.adam(M.cosine(1e-2, 4))),
    "adam-warmup_cosine": (lambda M: M.adam(M.warmup_cosine(1e-2, 2, 5))),
}


@pytest.fixture(scope="module")
def runs():
    """Per optimizer, 5 updates in the port, the reference run eagerly and
    the reference under ``jax.jit``: ``{name: [(params, state) x 3] a
    step}``."""
    out = {}
    for name, make in OPTS.items():
        jo, to = make(JO), make(TO)
        rng = np.random.default_rng(0)
        p0 = _tree(rng)
        pj, pt, pjj = _jax(p0), _torch(p0), _jax(p0)
        sj, st, sjj = jo.init(pj), to.init(pt), jo.init(pjj)
        upd = jax.jit(jo.update)
        steps = []
        for _ in range(5):
            g = _tree(rng)
            pj, sj = jo.update(_jax(g), sj, pj)
            pjj, sjj = upd(_jax(g), sjj, pjj)
            pt, st = to.update(_torch(g), st, pt)
            steps.append(((pt, st), (pj, sj), (pjj, sjj)))
        out[name] = steps
    return out


def test_exports():
    import repro_torch.optim as M

    for name in ("sgd", "momentum_sgd", "adam", "constant", "cosine",
                 "warmup_cosine"):
        assert callable(getattr(M, name))
        assert callable(getattr(JO, name))


@pytest.mark.parametrize("name", list(OPTS))
def test_against_the_reference_eagerly_exact(runs, name):
    for i, ((pt, st), (pj, sj), _) in enumerate(runs[name]):
        for tree_j, tree_t in ((pj, pt), (sj, st)):
            for leaf, a, b in _pairs(tree_j, tree_t):
                assert a.dtype == b.dtype, (i, leaf)
                np.testing.assert_array_equal(a, b, err_msg=f"{i} {leaf}")


@pytest.mark.parametrize("name", list(OPTS))
def test_against_the_reference_jitted_bounded(runs, name):
    for i, ((pt, st), _, (pj, sj)) in enumerate(runs[name]):
        for tree_j, tree_t in ((pj, pt), (sj, st)):
            for leaf, a, b in _pairs(tree_j, tree_t):
                if not np.issubdtype(a.dtype, np.floating):
                    np.testing.assert_array_equal(a, b)
                    continue
                top = float(np.abs(a).max())
                tol = (2.0**-8 if leaf in BF16 and tree_t is pt
                       else JIT_REL) * top
                assert float(np.abs(a - b).max()) <= tol, (i, leaf)


@pytest.mark.parametrize("name", ["momentum_sgd", "adam"])
def test_state_dtypes(runs, name):
    (pt, st), _, _ = runs[name][-1]
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 5
    for k in ("mu", "m", "v"):
        for leaf in jax.tree_util.tree_leaves(st.get(k, {})):
            assert leaf.dtype == torch.float32
    assert pt["a"].dtype == torch.bfloat16
    assert pt["b"]["c"].dtype == torch.float32


@pytest.mark.parametrize("sched,args", [
    ("constant", (0.3,)), ("cosine", (0.3, 7)), ("cosine", (1e-2, 4, 0.0)),
    ("warmup_cosine", (0.3, 3, 11)), ("warmup_cosine", (1e-3, 0, 5, 0.2))])
def test_schedules(sched, args):
    """Every step of the range and past it: within ``EAGER_ULPS`` of the
    reference run eagerly, ``JIT_ULPS`` under ``jax.jit``; ints and int32
    tensors give the same values."""
    js, ts = getattr(JO, sched)(*args), getattr(TO, sched)(*args)
    steps = range(16)
    want = np.array([np.float32(js(jnp.int32(s))) for s in steps])
    jitted = np.array([np.float32(jax.jit(js)(jnp.int32(s))) for s in steps])
    got = np.array([float(ts(s)) for s in steps], np.float32)
    got_t = np.array([float(ts(torch.tensor(s, dtype=torch.int32)))
                      for s in steps], np.float32)
    np.testing.assert_array_equal(got, got_t)
    assert _f32_ulps(want, got) <= EAGER_ULPS
    assert _f32_ulps(jitted, got) <= JIT_ULPS
    assert ts(3).dtype == torch.float32


def test_adam_root_correctly_rounded():
    from repro_torch.optim.adam import _sqrt_rn

    rng = np.random.default_rng(4)
    x = np.concatenate([rng.random(1 << 18).astype(np.float32) ** 8,
                        rng.random(1 << 12).astype(np.float32) * 1e-38,
                        np.float32([0.0, 1.0, 4.0, 3.4e38])])
    got = _sqrt_rn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.sqrt(x).view(np.int32))
    normal = x >= np.finfo(np.float32).tiny
    ref = np.asarray(jnp.sqrt(jnp.asarray(x)))
    np.testing.assert_array_equal(got[normal].view(np.int32),
                                  ref[normal].view(np.int32))
