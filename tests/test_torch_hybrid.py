"""The port's hybrid family (Griffin / RecurrentGemma: RG-LRU blocks and
local attention) against the reference's ``models/transformer.py``, and
the two tree repairs it needs.

Grades, as the ROADMAP defines them:

* **The repairs** (each fails on the tree before them): ``_stack`` of no
  keys gives ``(0, ...)`` leaves, as the reference's ``vmap`` does; a tree
  holding lists (the hybrid ``tail``) flattens in ``jax.tree_util``'s
  order, with the reference's paths, in the transport, the checkpoint,
  ``convert`` and the sharding rules, and round-trips through each.
* **Exact**: the param tree's paths, shapes and dtypes, and the uplink
  row's length and order, at ``cfg.reduced()`` (2 layers: no group, a
  tail of 2), ``n_layers=3`` (one group, an empty tail) and
  ``n_layers=5`` (one group, a tail of 2); ``lam``; ``init_cache``'s tree;
  the sharding specs of every leaf (params, batch, cache) on fake meshes.
* **Bounded** (bound in each test): ``init_params`` (the dense family's
  grades); ``_rglru_scan`` at odd and even lengths; ``_causal_conv``;
  logits, loss and gradients with the dense family's bounds; decode
  against the reference's decode past ``local_window``, so that the
  attention's ring cache wraps.
* **The contraction** (ROADMAP Queue 3): XLA on the CPU computes the
  scan's combine ``a2 * b1 + b2`` as an fma and flushes subnormal results
  to zero. A numpy copy of jax's odd/even recursion doing just that equals
  the jitted reference bit for bit; the port keeps the written
  arithmetic, multiply then add, so its scan is Bounded.
* **Trajectory**: ``train.main --arch recurrentgemma-2b --reduced`` for 6
  approx steps at 20 dB against the reference's ``main``, within
  ``TRAJ_TOL``.

Sizes: ``cfg.reduced()`` widths (d_model 128, lru_width 128,
local_window 64), the drivers at d_model 64.
"""

import contextlib
import dataclasses
import io
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.checkpoint import io as JCK  # noqa: E402
from repro.launch import serve as JSV  # noqa: E402
from repro.launch import sharding as JSH  # noqa: E402
from repro.launch import train as JTR  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import io as TCK  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.core import transport as TTP  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402
from repro_torch.launch import sharding as TSH  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as TTR  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCH = "recurrentgemma-2b"
# reduced(): 2 layers at attn_period 3 -> no group and a tail of 2
DEPTHS = {"reduced": {}, "3 layers": dict(n_layers=3),
          "5 layers": dict(n_layers=5)}
# (logits rel, loss abs), the dense family's bounds (test_torch_models.py)
FWD_BOUNDS = {"float32": (2e-6, 2e-6), "bfloat16": (3e-2, 1e-2)}
GRAD_REL = 1e-5
# Decode against the reference's, float32: the RG-LRU state carries each
# step's rounding into the next (measured over 70 steps: 1.3e-6 at 2
# layers, 3.0e-6 at 5, of the largest logit), so the gradients' bound.
DECODE_REL = 1e-5
# The scan, float32: each y[b, t, w] within SCAN_ULPS float32 ULPs of the
# largest |y[b, :, w]| (measured: 0.92 for the combine alone, where only
# the fma differs; the gates' sigmoid / exp round on their own besides).
SCAN_ULPS = 4
TRAJ_TOL = 0.25
SMALL = dict(n_layers=4, d_model=64, d_ff=128, vocab_size=128, lru_width=32)
FLT_MIN = np.float32(2.0**-126)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    tensor ops split over every core stall each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


def _cfgs(depth="reduced", **kw):
    kw = dict(DEPTHS[depth], **kw)
    return JC.get_config(ARCH).reduced(**kw), TC.get_config(ARCH).reduced(**kw)


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy()


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rel, what):
    """``|got - want| <= rel * max|want|`` everywhere."""
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def _path(keypath) -> str:
    """A ``jax`` key path as the port's ``_map_with_path`` spells it:
    dict keys and list indices joined by ``/``."""
    return "/".join(str(k.key) if hasattr(k, "key") else str(k.idx)
                    for k in keypath)


# ---------------------------------------------------------------- repairs


def test_stack_of_no_keys_gives_empty_leaves():
    """``_stack`` over zero keys (``cfg.reduced()``'s zero groups): every
    leaf ``(0, ...)`` with the dtype and trailing shape of one layer, on
    the keys' device, as the reference's ``vmap`` over ``split(key, 0)``;
    one key still draws what ``fn`` draws."""
    cj, ct = _cfgs(dtype="bfloat16")

    def jlayer(k):
        return JT._init_dense_layer(k, cj, jnp.bfloat16)

    def tlayer(k):
        return TT._init_dense_layer(k, ct, torch.bfloat16)

    want = jax.vmap(jlayer)(jax.random.split(jax.random.PRNGKey(1), 0))
    got = TT._stack(P.split(P.PRNGKey(1), 0), tlayer)
    lw = jax.tree_util.tree_leaves_with_path(want)
    lg, _ = TTP.tree_flatten(got)
    assert len(lg) == len(lw) == 9
    for (path, a), b in zip(lw, lg):
        assert tuple(b.shape) == tuple(a.shape) and b.shape[0] == 0, path
        assert str(b.dtype) == "torch." + str(a.dtype), path
        assert b.device.type == "cpu"
    one = TT._stack(P.split(P.PRNGKey(1), 1), tlayer)
    direct = tlayer(P.split(P.PRNGKey(1), 1)[0])
    for a, b in zip(TTP.tree_flatten(one)[0], TTP.tree_flatten(direct)[0]):
        assert torch.equal(a[0], b)


def _list_tree(rng):
    """A tree with an empty list and a two-item list, one item a dict."""
    return {"tail": [rng.standard_normal((3, 2)).astype(np.float32),
                     {"w": rng.standard_normal((4,)).astype(np.float32),
                      "b": rng.standard_normal((2, 2)).astype(np.float32)}],
            "empty": [],
            "a": rng.standard_normal((5,)).astype(np.float32)}


def test_list_trees_flatten_in_jax_order():
    """``tree_flatten`` of a tree with lists: leaves in ``jax.tree_util``'s
    order (dict keys sorted, list items in order, nothing for an empty
    list); ``tree_unflatten`` and ``tree_map`` give back lists; the
    checkpoint's keys are the reference's ``['tail']/[1]/['b']``; the
    sharding walk's paths are ``normalize_path`` of the reference's
    ``keystr``."""
    tree_np = _list_tree(np.random.default_rng(0))
    tree = convert.params_from_jax(tree_np)
    leaves, spec = TTP.tree_flatten(tree)
    want = jax.tree_util.tree_flatten_with_path(tree_np)[0]
    assert len(leaves) == len(want) == 4
    for (_, a), b in zip(want, leaves):
        np.testing.assert_array_equal(b.numpy(), a)
    back = TTP.tree_unflatten(spec, leaves)
    assert isinstance(back["tail"], list) and back["empty"] == []
    assert set(back["tail"][1]) == {"w", "b"}
    doubled = TTP.tree_map(lambda t: t * 2, tree)
    assert isinstance(doubled["tail"], list) and doubled["empty"] == []
    assert torch.equal(doubled["tail"][0], tree["tail"][0] * 2)
    assert TCK.tree_keys(tree) == JCK._flatten_with_paths(tree_np)[0]
    paths = TTP.tree_flatten(TSH._map_with_path(lambda p, leaf: p, tree))[0]
    assert paths == [JSH.normalize_path(jax.tree_util.keystr(p))
                     for p, _ in want]
    assert paths[1] == "tail/0"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_list_trees_round_trip(tmp_path, dtype):
    """The list tree through ``params_from_jax`` / ``params_to_numpy``
    and through the checkpoint, port to reference and reference to port,
    bit for bit in float32 and bf16."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tree_j = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jd),
                                    _list_tree(np.random.default_rng(1)))
    tree_t = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            tree_j))
    again = convert.params_to_numpy(tree_t)
    assert isinstance(again["tail"], list) and again["empty"] == []
    for a, b in zip(jax.tree_util.tree_leaves(again),
                    jax.tree_util.tree_leaves(tree_j)):
        np.testing.assert_array_equal(a, _f32(b))
    TCK.save(str(tmp_path / "t"), tree_t, step=5)
    back_j, step = JCK.restore(str(tmp_path / "t"), tree_j)
    assert step == 5
    for a, b in zip(jax.tree_util.tree_leaves(back_j),
                    jax.tree_util.tree_leaves(tree_j)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_f32(a), _f32(b))
    JCK.save(str(tmp_path / "j"), tree_j, step=6)
    keys = json.load(open(tmp_path / "j" / "manifest.json"))["keys"]
    assert keys == TCK.tree_keys(tree_t)
    back_t, step = TCK.restore(str(tmp_path / "j"), tree_t)
    assert step == 6 and isinstance(back_t["tail"], list)
    for a, b in zip(TTP.tree_flatten(back_t)[0], TTP.tree_flatten(tree_t)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------------------------ exact


@pytest.mark.parametrize("depth", list(DEPTHS))
def test_param_tree_and_uplink_row_exact(depth):
    """Paths, shapes and dtypes of ``init_params`` against the reference's
    ``eval_shape`` tree; ``groups`` ``(G, ...)`` and the ``tail`` list; the
    uplink row (the leaves flattened and concatenated, as
    ``transport_pytree`` builds it) of the reference's weights has the
    reference's length and order, bit for bit."""
    cj, ct = _cfgs(depth, dtype="bfloat16")
    G, tail_n = divmod(ct.n_layers, ct.attn_period)
    pt = TR.init_params(P.PRNGKey(0), ct)
    shapes = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0), cj))
    lw = jax.tree_util.tree_leaves_with_path(shapes)
    lt, _ = TTP.tree_flatten(pt)
    assert len(lt) == len(lw)
    assert TCK.tree_keys(pt) == [
        "/".join(str(k) for k in p) for p, _ in lw]
    for (path, a), b in zip(lw, lt):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(b.dtype) == "torch." + str(a.dtype), path
    assert isinstance(pt["tail"], list) and len(pt["tail"]) == tail_n
    assert pt["groups"]["attn"]["ln1"].shape[0] == G
    pj = JR.init_params(jax.random.PRNGKey(0), cj)
    row_j = np.concatenate([_f32(a).reshape(-1)
                            for a in jax.tree_util.tree_leaves(pj)])
    ptj = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    row_t = torch.cat([t.reshape(-1).to(torch.float32)
                       for t in TTP.tree_flatten(ptj)[0]])
    assert row_t.numel() == row_j.size == sum(t.numel() for t in lt)
    np.testing.assert_array_equal(row_t.numpy(), row_j)
    hat, _ = TTP.transmit_pytree(ptj, P.PRNGKey(3),
                                 TTP.TransportConfig(mode="perfect"),
                                 device="cpu")
    for a, b in zip(TTP.tree_flatten(hat)[0], TTP.tree_flatten(ptj)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(hat["tail"], list)


def test_full_width_tree_matches_reference():
    """recurrentgemma-2b at its published widths on the meta device, at 5
    layers (one group and a tail of 2, the card's row: 1,751,201,280
    parameters) and 3 (1,567,664,640): the reference's ``eval_shape``
    shapes and dtypes."""
    for n, count in ((5, 1_751_201_280), (3, 1_567_664_640)):
        cj = dataclasses.replace(JC.get_config(ARCH), n_layers=n)
        ct = dataclasses.replace(TC.get_config(ARCH), n_layers=n)
        pt = TR.init_params(P.PRNGKey(0, device="meta"), ct)
        pj = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0), cj))
        lj = jax.tree_util.tree_leaves(pj)
        lt, _ = TTP.tree_flatten(pt)
        assert [tuple(a.shape) for a in lj] == [tuple(b.shape) for b in lt]
        assert [str(a.dtype) for a in lj] == [
            str(b.dtype).replace("torch.", "") for b in lt]
        assert sum(b.numel() for b in lt) == count


def test_lam_exact():
    """``lam`` is float32 2.0 in a bf16 model, in every rec block."""
    cj, ct = _cfgs("5 layers", dtype="bfloat16")
    pj = JR.init_params(jax.random.PRNGKey(0), cj)
    pt = TR.init_params(P.PRNGKey(0), ct)
    lams = [pt["groups"]["rec0"]["rec"]["lam"],
            pt["groups"]["rec1"]["rec"]["lam"]] + [
        b["rec"]["lam"] for b in pt["tail"]]
    want = [pj["groups"]["rec0"]["rec"]["lam"],
            pj["groups"]["rec1"]["rec"]["lam"]] + [
        b["rec"]["lam"] for b in pj["tail"]]
    for a, b in zip(lams, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("depth", list(DEPTHS))
def test_init_cache_exact(depth):
    """``init_cache``'s paths, shapes and dtypes (``h`` float32, ``conv``
    bf16, ring caches of ``min(cache_len, local_window)`` slots), all
    zeros, at a cache longer and shorter than the window."""
    cj, ct = _cfgs(depth)
    for clen in (24, 100):
        a = JR.init_cache(cj, 3, clen)
        b = TR.init_cache(ct, 3, clen)
        la = jax.tree_util.tree_leaves_with_path(a)
        lb, _ = TTP.tree_flatten(b)
        assert TCK.tree_keys(b) == ["/".join(str(k) for k in p)
                                    for p, _ in la]
        for (path, x), y in zip(la, lb):
            assert tuple(x.shape) == tuple(y.shape), path
            assert str(y.dtype) == "torch." + str(x.dtype), path
            assert not bool(y.any())
        assert isinstance(b["tail"], list)


MESHES = {
    "pod2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "1x1": (("data", "model"), (1, 1)),
    "4x2": (("data", "model"), (4, 2)),
}


def _fake(axis_names, sizes):
    class FakeMesh:
        pass

    m = FakeMesh()
    m.axis_names = tuple(axis_names)
    m.shape = dict(zip(axis_names, sizes))
    return m


@pytest.fixture(scope="module")
def full_trees():
    """recurrentgemma-2b at full depth: the reference's ``eval_shape``
    params and the port's meta-device params."""
    cj, ct = JC.get_config(ARCH), TC.get_config(ARCH)
    shapes = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0), cj))
    return shapes, TR.init_params(P.PRNGKey(0, device="meta"), ct)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharding_specs_exact(full_trees, mesh_name, monkeypatch):
    """Every param leaf of recurrentgemma-2b at full depth (8 groups, a
    tail of 2) through ``param_rules`` and ``tree_specs`` (fsdp on and
    off), the batch specs of every input shape, and the cache specs of
    the decode shapes, against the reference's ``PartitionSpec`` entries.
    The reference wraps cache specs in a ``NamedSharding``, which needs a
    real mesh; the fake mesh keeps the bare spec."""
    from jax.sharding import PartitionSpec

    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)
    mesh = _fake(*MESHES[mesh_name])
    cj, ct = JC.get_config(ARCH), TC.get_config(ARCH)
    shapes, pt = full_trees
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    for fsdp in (True, False):
        specs, _ = TTP.tree_flatten(TSH.tree_specs(pt, ct, mesh, fsdp=fsdp))
        assert len(specs) == len(leaves)
        for (keypath, leaf), got in zip(leaves, specs):
            want = tuple(JSH.param_rules(jax.tree_util.keystr(keypath),
                                         leaf.shape, cj, mesh, fsdp=fsdp))
            assert got == want, (_path(keypath), fsdp)
            assert TSH.param_rules(_path(keypath), leaf.shape, ct, mesh,
                                   fsdp=fsdp) == want
    for name in JC.INPUT_SHAPES:
        sj, st = JC.INPUT_SHAPES[name], TC.INPUT_SHAPES[name]
        want = {k: tuple(v) for k, v in JSH.batch_specs(cj, sj, mesh).items()}
        assert TSH.batch_specs(ct, st, mesh) == want
        if sj.kind != "decode":
            continue
        clen = JR.cache_len_for(cj, sj)
        assert TR.cache_len_for(ct, st) == clen
        assert TR.uses_ring_cache(ct, st) == JR.uses_ring_cache(cj, sj)
        cache_j = jax.eval_shape(lambda: JR.init_cache(cj, sj.global_batch,
                                                       clen))
        specs_j = jax.tree_util.tree_map(
            tuple, JSH.cache_specs(cj, sj, mesh, cache_j),
            is_leaf=lambda s: isinstance(s, PartitionSpec))
        cache_t = TR.init_cache(ct, st.global_batch, clen, device="meta")
        assert TSH.cache_specs(ct, st, mesh, cache_t) == specs_j


# ---------------------------------------------------------------- bounded


@pytest.mark.parametrize("depth", list(DEPTHS))
def test_init_params_bounded(depth):
    """``init_params`` from ``PRNGKey(0)`` in bf16: every leaf within 1 bf16
    ULP (2**-7 relative) of the reference's draw, ``lam`` exact (the dense
    family's grade)."""
    cj, ct = _cfgs(depth, dtype="bfloat16")
    pj = JR.init_params(jax.random.PRNGKey(0), cj)
    pt = TR.init_params(P.PRNGKey(0), ct)
    lj = jax.tree_util.tree_leaves_with_path(pj)
    lt, _ = TTP.tree_flatten(pt)
    assert len(lj) == len(lt)
    for (path, a), b in zip(lj, lt):
        err = np.abs(_f32(a) - _np(b))
        assert np.all(err <= 2.0**-7 * np.abs(_f32(a)) + 1e-30), \
            jax.tree_util.keystr(path)


@pytest.fixture(scope="module")
def jitted():
    """The reference's scan, conv and RG-LRU block, jitted once."""
    return {"scan": jax.jit(JT._rglru_scan),
            "conv": jax.jit(JT._causal_conv),
            "comb": jax.jit(lambda a, b: jax.lax.associative_scan(
                lambda c1, c2: (c1[0] * c2[0], c2[0] * c1[1] + c2[1]),
                (a, b), axis=1))}


def _rec(dtype="float32", seed=0):
    cj, ct = _cfgs(dtype=dtype)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    blk = JT._init_rglru_block(jax.random.PRNGKey(seed), cj, jd)
    return blk, convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               blk))


def _col_ulps(got, want):
    """Each element's error in float32 ULPs of the largest ``|want|`` of its
    ``(b, :, w)`` column."""
    scale = np.abs(want).max(axis=1, keepdims=True)
    return np.abs(got - want) / np.maximum(scale * 2.0**-23, 2.0**-149)


@pytest.mark.parametrize("seq", [1, 2, 37, 256])
def test_rglru_scan_bounded(jitted, seq):
    """``_rglru_scan`` at odd and even lengths on a reference rec block
    (W = 128), float32: ``y`` and ``h_last`` within ``SCAN_ULPS`` of each
    column's largest ``|y|``. The recursion is jax's, so the operations
    and their order are the reference's; the combine's fma (XLA) against
    the port's multiply then add, and the gates' ``sigmoid`` / ``exp``,
    round differently."""
    blk, blk_t = _rec()
    x = np.random.default_rng(seq).standard_normal(
        (2, seq, 128)).astype(np.float32)
    yj, hj = jitted["scan"](jnp.asarray(x), blk["rec"])
    yt, ht = TT._rglru_scan(torch.from_numpy(x), blk_t["rec"])
    assert yt.dtype == torch.float32 and tuple(yt.shape) == (2, seq, 128)
    u = _col_ulps(_np(yt), np.asarray(yj))
    assert float(u.max()) <= SCAN_ULPS, float(u.max())
    np.testing.assert_array_equal(_np(ht), _np(yt[:, -1]))
    np.testing.assert_array_equal(np.asarray(hj), np.asarray(yj)[:, -1])


def _comb_fma(a1, b1, a2, b2):
    """The combine as XLA on the CPU runs it: ``a2 * b1 + b2`` as one fma
    (the float32 product is exact in float64, so the float64 sum rounds
    once, and its float32 cast once more), subnormal results flushed to a
    signed zero."""
    def ftz(v):
        return np.where(np.abs(v) < FLT_MIN, np.copysign(np.float32(0), v),
                        v).astype(np.float32)

    b = (a2.astype(np.float64) * b1.astype(np.float64)
         + b2.astype(np.float64)).astype(np.float32)
    return ftz(a1 * a2), ftz(b)


def _interleave_np(a, b):
    za = np.zeros((a.shape[0], a.shape[1] + b.shape[1]) + a.shape[2:],
                  np.float32)
    zb = za.copy()
    za[:, 0::2] = a
    zb[:, 1::2] = b
    return za + zb


def _comb_mul_add(a1, b1, a2, b2):
    return a1 * a2, a2 * b1 + b2


def _scan_np(a, b, comb):
    """jax's odd/even ``associative_scan`` recursion over axis 1, in
    numpy, with the combine ``comb``."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = _scan_np(*comb(a[:, 0:n - 1:2], b[:, 0:n - 1:2],
                            a[:, 1::2], b[:, 1::2]), comb)
    if n % 2 == 0:
        ea, eb = comb(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = comb(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = np.concatenate([a[:, :1], ea], axis=1)
    eb = np.concatenate([b[:, :1], eb], axis=1)
    return _interleave_np(ea, oa), _interleave_np(eb, ob)


def _decays(seq, seed):
    """``(a, b)`` as the RG-LRU makes them: ``a = exp(-8 softplus(2) r)``
    for ``r`` in (0, 1), ``b = sqrt(1 - a**2) * gated``."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0, 1, (2, seq, 64)).astype(np.float32)
    a = np.exp(np.float32(-8 * 2.126928) * r).astype(np.float32)
    g = (rng.standard_normal((2, seq, 64)) * 0.5).astype(np.float32)
    b = (np.sqrt(np.maximum(1 - a * a, 1e-12)) * g).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seq", [2, 37, 256])
def test_scan_contraction_pinned(jitted, seq):
    """The jitted reference's ``associative_scan`` of the combine equals a
    numpy copy of jax's recursion with the combine as an fma and subnormals
    flushed, bit for bit (both outputs); the port's recursion equals the
    same copy with multiply then add and IEEE subnormals bit for bit, and
    differs from the reference within ``SCAN_ULPS`` / 4 of each column's
    largest ``|y|`` (ROADMAP Queue 3: measured 0.92 ULPs, 174 of 4,736
    elements differing at length 37)."""
    a, b = _decays(seq, seq)
    ja, jb = (np.asarray(t) for t in jitted["comb"](a, b))
    fa, fb = _scan_np(a, b, _comb_fma)
    np.testing.assert_array_equal(fb, jb)
    np.testing.assert_array_equal(fa, ja)
    ta, tb = (t.numpy() for t in TT._assoc_scan(torch.from_numpy(a),
                                                 torch.from_numpy(b)))
    with np.errstate(under="ignore"):
        ma, mb = _scan_np(a, b, _comb_mul_add)
    np.testing.assert_array_equal(tb, mb)
    np.testing.assert_array_equal(ta, ma)
    assert bool((tb != jb).any())
    assert float(_col_ulps(tb, jb).max()) <= SCAN_ULPS / 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_bounded(jitted, dtype):
    """``_causal_conv`` (4 taps, float32 products summed ``j = 0..3``) on
    the reference block's ``conv_w``: float32 within 2 ULPs of the
    largest output (XLA contracts the taps' adds), bf16 within 1 bf16 ULP
    of each output (one rounding at the cast)."""
    blk, blk_t = _rec(dtype)
    x = np.random.default_rng(4).standard_normal((2, 37, 128)).astype(
        np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = _f32(jitted["conv"](jnp.asarray(x).astype(jd),
                               blk["rec"]["conv_w"]))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = TT._causal_conv(xt, blk_t["rec"]["conv_w"])
    assert got.dtype == xt.dtype and got.shape == xt.shape
    if dtype == "float32":
        _close(_np(got), want, 2 * 2.0**-23, "conv")
    else:
        assert np.all(np.abs(_np(got) - want) <= 2.0**-8 * np.abs(want)
                      + 1e-30)
    # the first position sees only tap 3 (the others read the padding)
    w3 = _np(blk_t["rec"]["conv_w"][3])
    np.testing.assert_array_equal(
        _np(TT._causal_conv(xt, blk_t["rec"]["conv_w"])[:, 0]),
        _np((xt[:, 0].to(torch.float32) * torch.from_numpy(w3)).to(xt.dtype)))


@pytest.fixture(scope="module")
def weights():
    """The reference's params and both packages' configs at each depth,
    float32, and at 5 layers in bf16."""
    out = {}
    with jax.threefry_partitionable(True):
        for depth, dtype in [(d, "float32") for d in DEPTHS] + [
                ("5 layers", "bfloat16")]:
            cj, ct = _cfgs(depth, dtype=dtype)
            pj = JR.init_params(jax.random.PRNGKey(0), cj)
            pt = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                pj))
            out[depth, dtype] = (cj, ct, pj, pt)
    return out


def _batch(seed=0, b=2, s=16, vocab=512):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


@pytest.mark.parametrize("depth,dtype", [(d, "float32") for d in DEPTHS]
                         + [("5 layers", "bfloat16")])
def test_forward_and_loss_bounded(weights, depth, dtype):
    """Logits and the loss within the dense family's bounds; the aux loss
    a float32 zero."""
    cj, ct, pj, pt = weights[depth, dtype]
    b = _batch()
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    lj, _ = JR.forward(pj, bj, cj)
    with torch.no_grad():
        lt, auxt = TR.forward(pt, bt, ct)
        losst = TR.loss_fn(pt, bt, ct)
    assert lt.dtype == torch.float32 and lt.shape == (2, 16, 512)
    assert auxt.dtype == torch.float32 and float(auxt) == 0.0
    rel, abs_loss = FWD_BOUNDS[dtype]
    _close(_np(lt), np.asarray(lj), rel, "logits")
    lossj = float(JR.loss_fn(pj, bj, cj))
    assert abs(float(losst) - lossj) <= abs_loss, (float(losst), lossj)


@pytest.mark.parametrize("depth", list(DEPTHS))
def test_gradients_bounded_f32(weights, depth):
    """float32 gradients of ``loss_fn`` through ``steps.value_and_grad``
    (each group and tail block under checkpoint) within ``GRAD_REL`` of
    each leaf's largest entry; the ``(0, ...)`` groups of
    ``cfg.reduced()`` get ``(0, ...)`` gradients."""
    cj, ct, pj, pt = weights[depth, "float32"]
    b = _batch(1)
    lj, gj = jax.value_and_grad(JR.loss_fn)(
        pj, {k: jnp.asarray(v) for k, v in b.items()}, cj)
    lt, gt = TS.value_and_grad(ct, pt, {k: torch.from_numpy(v) for k, v in
                                        b.items()})
    assert abs(float(lt) - float(lj)) <= 2e-6
    lgt, _ = TTP.tree_flatten(gt)
    lgj = jax.tree_util.tree_leaves_with_path(gj)
    assert len(lgt) == len(lgj)
    for (path, a), g in zip(lgj, lgt):
        assert g.dtype == torch.float32 and tuple(g.shape) == a.shape
        if a.size:
            _close(_np(g), np.asarray(a), GRAD_REL,
                   jax.tree_util.keystr(path))


@pytest.mark.parametrize("depth", ["reduced", "5 layers"])
def test_decode_past_the_window_bounded(weights, depth):
    """Port decode against the reference's on the same weights, float32,
    70 steps of a 70-position cache: the attention's ring holds
    ``local_window`` = 64 slots, so it wraps at step 64; logits and the
    float32 states within ``DECODE_REL`` of their largest at every step,
    and the caches' trees equal."""
    cj, ct, pj, pt = weights[depth, "float32"]
    assert ct.local_window == 64
    tokens = _batch(2, s=70)["tokens"]
    cj_cache = JR.init_cache(cj, 2, 70)
    ct_cache = TR.init_cache(ct, 2, 70)
    step = jax.jit(lambda p, c, t, pos: JR.decode_step(p, c, t, pos, cj))
    for t in range(70):
        a, cj_cache = step(pj, cj_cache, jnp.asarray(tokens[:, t:t + 1]),
                           jnp.int32(t))
        b, ct_cache = TR.decode_step(pt, ct_cache,
                                     torch.from_numpy(tokens[:, t:t + 1]), t,
                                     ct)
        _close(_np(b), np.asarray(a), DECODE_REL, f"decode step {t}")
    assert TCK.tree_keys(ct_cache) == [
        "/".join(str(k) for k in p)
        for p, _ in jax.tree_util.tree_leaves_with_path(cj_cache)]
    for x, y in zip(jax.tree_util.tree_leaves(cj_cache),
                    TTP.tree_flatten(ct_cache)[0]):
        assert tuple(x.shape) == tuple(y.shape)
        assert str(y.dtype) == "torch." + str(x.dtype)
        if x.dtype == jnp.float32 and x.size:
            _close(_np(y), np.asarray(x), DECODE_REL, "cache")


def test_decode_matches_forward(weights):
    """Inside the port, float32: decode over 20 tokens equals the training
    forward at every position within 1e-5 of the largest logit (the
    recurrence one step at a time against the scan)."""
    _, ct, _, pt = weights["5 layers", "float32"]
    tokens = torch.from_numpy(_batch(3, s=20)["tokens"])
    with torch.no_grad():
        ref, _ = TR.forward(pt, {"tokens": tokens}, ct)
    cache = TR.init_cache(ct, 2, 20)
    outs = []
    for t in range(20):
        lg, cache = TR.decode_step(pt, cache, tokens[:, t:t + 1], t, ct)
        outs.append(lg[:, 0])
    _close(_np(torch.stack(outs, dim=1)), _np(ref), 1e-5, "decode")


# --------------------------------------------------------- registry, drivers


def test_registry_runs_hybrid_and_raises_for_the_rest():
    """``family_module`` is the transformer for hybrid and vlm, and
    ``models/ssm.py`` / ``models/audio.py`` for the ssm and audio families
    (which raised before they were ported), whose ``init_params`` runs;
    ``moe_impl="expert_parallel"``, which raised before
    ``moe_ffn_shardmap`` was ported, is the transformer too and passes
    ``check_family``; an unknown family still raises."""
    from repro_torch.models import audio, ssm

    for arch in (ARCH, "pixtral-12b"):
        assert TR.family_module(TC.get_config(arch)) is TT
    for arch, mod in (("falcon-mamba-7b", ssm), ("whisper-large-v3", audio)):
        cfg = TC.get_config(arch)
        assert TR.family_module(cfg) is mod
        params = TR.init_params(P.PRNGKey(0), cfg.reduced())
        assert params["embed"].shape == (512, 128)
    moe = dataclasses.replace(TC.get_config("phi3.5-moe-42b-a6.6b"),
                              moe_impl="expert_parallel")
    assert TR.family_module(moe) is TT
    TT.check_family(moe)
    params = TR.init_params(P.PRNGKey(0), moe.reduced())
    assert params["layers"]["moe"]["wi"].shape[1] == moe.reduced().n_experts
    with pytest.raises(ValueError):
        TT.check_family(dataclasses.replace(moe, family="ssm"))
    with pytest.raises(ValueError):
        TR.family_module(dataclasses.replace(moe, family="cnn"))


class _Small:
    """A config whose ``reduced(...)`` is this file's driver widths, so the
    drivers' ``--reduced`` runs at them."""

    def __init__(self, cfg):
        self.cfg = cfg

    def reduced(self, **kw):
        return self.cfg.reduced(**SMALL)


def test_train_main_trajectory():
    """``train.main --arch recurrentgemma-2b --reduced --steps 6 --mode
    approx`` at 20 dB (both drivers' ``--reduced`` pointed at 4 layers, one
    group and a tail of 1, d_model 64, lru_width 32): the printed losses
    within ``TRAJ_TOL``, step 0 within 1e-2 (bf16 weights), the same
    parameter count."""
    argv = ["--arch", ARCH, "--reduced", "--steps", "6", "--mode", "approx",
            "--batch", "2", "--seq", "16", "--snr-db", "20"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTR, "get_config", lambda a: _Small(JC.get_config(a)))
        mp.setattr(TTR, "get_config", lambda a: _Small(TC.get_config(a)))
        out_j, out_t = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out_j):
            lj = JTR.main(argv)
        with contextlib.redirect_stdout(out_t):
            lt = TTR.main(argv + ["--device", "cpu"])
    a = [float(m) for m in re.findall(r"loss (\S+)", out_j.getvalue())]
    b = [float(m) for m in re.findall(r"loss (\S+)", out_t.getvalue())]
    assert len(a) == len(b) == 6
    assert abs(a[0] - b[0]) <= 1e-2
    assert max(abs(x - y) for x, y in zip(a, b)) <= TRAJ_TOL, (a, b)
    assert abs(lt - lj) <= TRAJ_TOL
    count = re.compile(r"\(reduced\): (\S+)M params")
    assert count.findall(out_t.getvalue()) == count.findall(out_j.getvalue())


def test_serve_main_greedy_tokens():
    """``serve.main --arch recurrentgemma-2b --reduced`` (bf16, batch 2, 8
    prompt + 6 generated tokens; the attention on its ring of 14 slots)
    beside the reference's ``serve.main``: the prompt is the reference's
    draw (Exact), and each greedy token is one the reference's decode, fed
    the port's tokens, ranks within the bf16 forward bound (3e-2 of its
    largest logit) of its own argmax (a random model's top logits lie
    within bf16 rounding of each other, so the tokens are not Exact)."""
    args = ["--arch", ARCH, "--batch", "2", "--prompt-len", "8", "--gen", "6"]
    with contextlib.redirect_stdout(io.StringIO()):
        prompt, gen, _ = TSV.main(args + ["--reduced", "--device", "cpu"])
        JSV.main(args)
    assert tuple(gen.shape) == (2, 6)
    cfg = JC.get_config(ARCH).reduced()
    key = jax.random.PRNGKey(0)
    params = JR.init_params(key, cfg)
    want_prompt = jax.random.randint(key, (2, 8), 0, cfg.vocab_size, jnp.int32)
    np.testing.assert_array_equal(prompt.numpy(), np.asarray(want_prompt))
    seq = np.concatenate([prompt.numpy(), gen.numpy()], axis=1)
    cache = JR.init_cache(cfg, 2, 14)
    step = jax.jit(lambda p, c, t, pos: JR.decode_step(p, c, t, pos, cfg))
    for pos in range(13):
        logits, cache = step(params, cache, jnp.asarray(seq[:, pos:pos + 1]),
                             jnp.int32(pos))
        if pos + 1 >= 8:
            lg = np.asarray(logits[:, -1])
            chosen = lg[np.arange(2), seq[:, pos + 1]]
            tol = FWD_BOUNDS["bfloat16"][0] * np.abs(lg).max()
            assert np.all(chosen >= lg.max(axis=-1) - tol), (pos, chosen,
                                                               lg.max(-1))
