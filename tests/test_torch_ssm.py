"""The port's ssm family (Mamba-1, falcon-mamba-7b: the selective scan)
against the reference's ``models/ssm.py``.

Grades, as the ROADMAP defines them:

* **Exact**: the key schedule (every leaf's draw, with the normals
  replaced in both packages by the same exact function of the key's
  bits: 8 keys a layer of which ``ks[0..4]`` draw); the param tree's
  paths, shapes and dtypes at ``cfg.reduced()``, 3 layers, and the
  published widths at 12 layers (the card's row, 1,796,427,776
  parameters) and 64; ``init_cache``'s tree; the sharding specs of
  every leaf (params, batch, cache) on fake meshes; ``convert`` and the
  checkpoint both ways.
* **Bounded** (bound in each test): ``init_params`` (the dense family's
  grades); ``_causal_conv``; ``_ssm_scan`` against the jitted reference;
  logits, loss and gradients with the dense family's bounds; decode
  against the reference's decode; decode against forward inside the
  port (float32 within the gradients' bound; bf16 within
  ``DECODE_FWD_BF16``, as forward rounds the conv and SiLU outputs to bf16
  and decode does not, in the reference too).
* **The contraction** (ROADMAP Queue 3): XLA on the CPU computes the
  scan's combine ``a2 * b1 + b2`` as an fma and flushes subnormals to
  zero. A numpy copy of jax's odd/even recursion doing just that equals
  the jitted reference bit for bit on the ssm's ``(B, S, Di, N)`` decays,
  where ``exp(dt A)`` reaches subnormals; the port keeps multiply then add
  and IEEE subnormals.
* **Trajectory**: ``train.main --arch falcon-mamba-7b --reduced`` for 6
  approx steps at 20 dB against the reference's ``main``, within
  ``TRAJ_TOL``; ``serve.main``'s greedy tokens.

Sizes: ``cfg.reduced()`` widths (d_model 128, Di 256, ssm_state 8,
dt_rank 8), the drivers at d_model 64.
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
from repro.models import ssm as JS  # noqa: E402
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
from repro_torch.models import ssm as TSM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCH = "falcon-mamba-7b"
DEPTHS = {"reduced": {}, "3 layers": dict(n_layers=3)}
# (logits rel, loss abs), the dense family's bounds (test_torch_models.py)
FWD_BOUNDS = {"float32": (2e-6, 2e-6), "bfloat16": (3e-2, 1e-2)}
GRAD_REL = 1e-5
# Decode against the reference's, float32: the state carries each step's
# rounding into the next, so the gradients' bound (measured 8.6e-7 over
# 24 steps at 3 layers).
DECODE_REL = 1e-5
# The scan, float32: y and h_last within SCAN_REL of their largest, the
# dense family's float32 logits bound (measured up to 9.8e-7 at lengths 1
# to 256: the x_proj / dt_proj matmuls, softplus and exp round on their
# own besides the combine's fma, and y sums N products).
SCAN_REL = 2e-6
# The combine alone: each element within COMB_ULPS float32 ULPs of the
# largest |h| of its (b, :, d, n) column (measured up to 1.86 at length
# 256; 4,975 of 9,472 elements differ at length 37).
COMB_ULPS = 4
# Decode against forward inside the port in bf16: forward rounds the
# conv's and SiLU's outputs to bf16 before the scan (ssm.py:68, :105 of
# the reference) and decode keeps them in float32, so the scan's inputs
# differ by up to a bf16 half-ULP at every position and the state carries
# it. Logits within DECODE_FWD_BF16 of the largest, the bf16 forward bound
# (measured 1.20e-2 at 3 layers over 24 positions; the reference's decode
# differs from its own forward by the same 1.20e-2).
DECODE_FWD_BF16 = 3e-2
TRAJ_TOL = 0.25
SMALL = dict(n_layers=2, d_model=64, vocab_size=128)
FLT_MIN = np.float32(2.0**-126)
FULL_COUNTS = {12: 1_796_427_776, 64: 7_272_665_088}


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
    return "/".join(str(k.key) if hasattr(k, "key") else str(k.idx)
                    for k in keypath)


def _keys_path(lw):
    return ["/".join(str(k) for k in p) for p, _ in lw]


# ------------------------------------------------------------------ exact


def test_key_schedule_exact(monkeypatch):
    """Every leaf of ``init_params`` in float32 with the normals replaced,
    in both packages, by the same exact function of the key's bits (the
    top 23 bits of ``bits(key)`` as a float in [0, 1)): Exact, so each
    leaf draws from the reference's key (3 keys at the top, ``n_layers``
    from ``ks[0]``, 8 a layer of which ``ks[0..4]`` draw). ``A_log`` is
    ``log`` of 1..N, within 1 ULP (``torch.log`` against XLA's)."""
    def jnormal(key, shape=(), dtype=jnp.float32):
        return ((jax.random.bits(key, shape) >> 9).astype(jnp.float32)
                * np.float32(2.0**-23)).astype(dtype)

    def tnormal(key, shape=()):
        return (P.random_bits(key, shape) >> 9).to(torch.float32) * 2.0**-23

    monkeypatch.setattr(jax.random, "normal", jnormal)
    monkeypatch.setattr(P, "normal", tnormal)
    cj, ct = _cfgs("3 layers", dtype="float32")
    pj = JR.init_params(jax.random.PRNGKey(0), cj)
    pt = TR.init_params(P.PRNGKey(0), ct)
    lj = jax.tree_util.tree_leaves_with_path(pj)
    lt, _ = TTP.tree_flatten(pt)
    assert TCK.tree_keys(pt) == _keys_path(lj)
    for (path, a), b in zip(lj, lt):
        a = np.asarray(a)
        if _path(path) == "layers/A_log":
            assert np.all(np.abs(_np(b) - a) <= 2.0**-23 * np.abs(a)), path
        else:
            np.testing.assert_array_equal(_np(b), a, err_msg=_path(path))
    # the draws are distinct per leaf and per layer
    conv = _np(pt["layers"]["conv_w"])
    assert not np.array_equal(conv[0], conv[1])


@pytest.mark.parametrize("depth", list(DEPTHS))
def test_param_tree_and_uplink_row_exact(depth):
    """Paths, shapes and dtypes of ``init_params`` against the reference's
    ``eval_shape`` tree (``dt_bias``, ``A_log`` and ``D_skip`` float32 in a
    bf16 model); the uplink row of the reference's weights in the
    reference's length and order, bit for bit."""
    cj, ct = _cfgs(depth, dtype="bfloat16")
    pt = TR.init_params(P.PRNGKey(0), ct)
    shapes = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0), cj))
    lw = jax.tree_util.tree_leaves_with_path(shapes)
    lt, _ = TTP.tree_flatten(pt)
    assert len(lt) == len(lw) == 13
    assert TCK.tree_keys(pt) == _keys_path(lw)
    for (path, a), b in zip(lw, lt):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(b.dtype) == "torch." + str(a.dtype), path
    assert pt["layers"]["A_log"].dtype == torch.float32
    pj = JR.init_params(jax.random.PRNGKey(0), cj)
    row_j = np.concatenate([_f32(a).reshape(-1)
                            for a in jax.tree_util.tree_leaves(pj)])
    ptj = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    row_t = torch.cat([t.reshape(-1).to(torch.float32)
                       for t in TTP.tree_flatten(ptj)[0]])
    np.testing.assert_array_equal(row_t.numpy(), row_j)


@pytest.fixture(scope="module")
def full_trees():
    """falcon-mamba-7b at full depth: the reference's ``eval_shape`` params
    and the port's meta-device params."""
    cj, ct = JC.get_config(ARCH), TC.get_config(ARCH)
    shapes = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0), cj))
    return shapes, TR.init_params(P.PRNGKey(0, device="meta"), ct)


@pytest.mark.parametrize("n_layers", sorted(FULL_COUNTS))
def test_full_width_tree_matches_reference(full_trees, n_layers):
    """falcon-mamba-7b at its published widths on the meta device: at 12
    layers (the card's row) and all 64, the reference's ``eval_shape``
    shapes, dtypes and parameter count."""
    if n_layers == 64:
        pj, pt = full_trees
    else:
        cj = dataclasses.replace(JC.get_config(ARCH), n_layers=n_layers)
        ct = dataclasses.replace(TC.get_config(ARCH), n_layers=n_layers)
        pt = TR.init_params(P.PRNGKey(0, device="meta"), ct)
        pj = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0),
                                                   cj))
    lj = jax.tree_util.tree_leaves(pj)
    lt, _ = TTP.tree_flatten(pt)
    assert [tuple(a.shape) for a in lj] == [tuple(b.shape) for b in lt]
    assert [str(a.dtype) for a in lj] == [
        str(b.dtype).replace("torch.", "") for b in lt]
    assert sum(b.numel() for b in lt) == FULL_COUNTS[n_layers]
    assert TSM._dt_rank(TC.get_config(ARCH)) == 256
    assert JS._dt_rank(JC.get_config(ARCH)) == 256


@pytest.mark.parametrize("depth", list(DEPTHS))
def test_init_cache_exact(depth):
    """``init_cache``'s paths, shapes and dtypes (``h`` float32 ``(L, B,
    Di, N)``, ``conv`` ``(L, B, K-1, Di)`` in the model dtype), all zeros;
    ``cache_len`` changes nothing."""
    cj, ct = _cfgs(depth)
    for clen in (0, 100):
        a = JR.init_cache(cj, 3, clen)
        b = TR.init_cache(ct, 3, clen)
        la = jax.tree_util.tree_leaves_with_path(a)
        lb, _ = TTP.tree_flatten(b)
        assert TCK.tree_keys(b) == _keys_path(la)
        for (path, x), y in zip(la, lb):
            assert tuple(x.shape) == tuple(y.shape), path
            assert str(y.dtype) == "torch." + str(x.dtype), path
            assert not bool(y.any())


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


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharding_specs_exact(full_trees, mesh_name, monkeypatch):
    """Every param leaf of falcon-mamba-7b at full depth through
    ``param_rules`` and ``tree_specs`` (fsdp on and off), the batch specs
    of every input shape, and the cache specs (the ssm state and conv
    window) of the decode shapes, against the reference's entries."""
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
    for name in JC.INPUT_SHAPES:
        sj, st = JC.INPUT_SHAPES[name], TC.INPUT_SHAPES[name]
        want = {k: tuple(v) for k, v in JSH.batch_specs(cj, sj, mesh).items()}
        assert TSH.batch_specs(ct, st, mesh) == want
        if sj.kind != "decode":
            continue
        clen = JR.cache_len_for(cj, sj)
        assert TR.cache_len_for(ct, st) == clen
        cache_j = jax.eval_shape(lambda: JR.init_cache(cj, sj.global_batch,
                                                       clen))
        specs_j = jax.tree_util.tree_map(
            tuple, JSH.cache_specs(cj, sj, mesh, cache_j),
            is_leaf=lambda s: isinstance(s, PartitionSpec))
        cache_t = TR.init_cache(ct, st.global_batch, clen, device="meta")
        assert TSH.cache_specs(ct, st, mesh, cache_t) == specs_j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_and_checkpoint_round_trip(tmp_path, dtype):
    """The reference's params through ``params_from_jax`` /
    ``params_to_numpy`` and through the checkpoint, port to reference and
    reference to port, bit for bit with the dtypes kept (float32 leaves
    in a bf16 model included)."""
    cj, _ = _cfgs(dtype=dtype)
    pj = JR.init_params(jax.random.PRNGKey(2), cj)
    pt = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    for a, b in zip(jax.tree_util.tree_leaves(convert.params_to_numpy(pt)),
                    jax.tree_util.tree_leaves(pj)):
        np.testing.assert_array_equal(a, _f32(b))
    TCK.save(str(tmp_path / "t"), pt, step=3)
    back_j, step = JCK.restore(str(tmp_path / "t"), pj)
    assert step == 3
    for a, b in zip(jax.tree_util.tree_leaves(back_j),
                    jax.tree_util.tree_leaves(pj)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_f32(a), _f32(b))
    JCK.save(str(tmp_path / "j"), pj, step=4)
    keys = json.load(open(tmp_path / "j" / "manifest.json"))["keys"]
    assert keys == TCK.tree_keys(pt)
    back_t, step = TCK.restore(str(tmp_path / "j"), pt)
    assert step == 4
    for a, b in zip(TTP.tree_flatten(back_t)[0], TTP.tree_flatten(pt)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------- bounded


@pytest.mark.parametrize("depth,dtype", [("reduced", "bfloat16"),
                                         ("3 layers", "bfloat16"),
                                         ("reduced", "float32")])
def test_init_params_bounded(depth, dtype):
    """``init_params`` from ``PRNGKey(0)``: every leaf within 1 ULP of its
    dtype of the reference's draw (bf16: 2**-7 relative; float32 leaves,
    and every leaf of a float32 model: 64 ULP, the normals' ``erfinv``);
    ``dt_bias`` and ``D_skip`` exact."""
    cj, ct = _cfgs(depth, dtype=dtype)
    pj = JR.init_params(jax.random.PRNGKey(0), cj)
    pt = TR.init_params(P.PRNGKey(0), ct)
    lj = jax.tree_util.tree_leaves_with_path(pj)
    lt, _ = TTP.tree_flatten(pt)
    assert len(lj) == len(lt)
    for (path, a), b in zip(lj, lt):
        rel = 2.0**-7 if b.dtype == torch.bfloat16 else 64 * 2.0**-23
        err = np.abs(_f32(a) - _np(b))
        assert np.all(err <= rel * np.abs(_f32(a)) + 1e-30), _path(path)
    for k in ("dt_bias", "D_skip"):
        np.testing.assert_array_equal(_np(pt["layers"][k]),
                                      np.asarray(pj["layers"][k]))


@pytest.fixture(scope="module")
def jitted():
    """The reference's scan, conv and the scan's combine, jitted once."""
    cj, _ = _cfgs(dtype="float32")
    return {"scan": jax.jit(lambda x, p: JS._ssm_scan(x, p, cj)),
            "conv": jax.jit(JS._causal_conv),
            "comb": jax.jit(lambda a, b: jax.lax.associative_scan(
                lambda c1, c2: (c1[0] * c2[0], c2[0] * c1[1] + c2[1]),
                (a, b), axis=1))}


def _layer(dtype="float32", seed=0):
    """Layer 0 of the reference's params and its port copy."""
    cj, ct = _cfgs(dtype=dtype)
    pj = JR.init_params(jax.random.PRNGKey(seed), cj)
    lj = jax.tree_util.tree_map(lambda a: a[0], pj["layers"])
    return lj, convert.params_from_jax(jax.tree_util.tree_map(np.asarray, lj))


def _col_ulps(got, want):
    """Each element's error in float32 ULPs of the largest ``|want|`` of its
    ``(b, :, d)`` column."""
    scale = np.abs(want).max(axis=1, keepdims=True)
    return np.abs(got - want) / np.maximum(scale * 2.0**-23, 2.0**-149)


@pytest.mark.parametrize("seq", [1, 2, 37, 256])
def test_ssm_scan_bounded(jitted, seq):
    """``_ssm_scan`` at odd and even lengths on a reference layer (Di 256,
    N 8), float32: ``y`` and ``h_last`` (B, Di, N) within ``SCAN_REL`` of
    their largest. The recursion is jax's, so the order is the reference's; the
    combine's fma (XLA) against multiply then add, and the projections,
    ``softplus`` and ``exp``, round differently."""
    lj, lt = _layer()
    x = np.random.default_rng(seq).standard_normal(
        (2, seq, 256)).astype(np.float32)
    yj, hj = jitted["scan"](jnp.asarray(x), lj)
    _, ct = _cfgs(dtype="float32")
    yt, ht = TSM._ssm_scan(torch.from_numpy(x), lt, ct)
    assert yt.dtype == torch.float32 and tuple(yt.shape) == (2, seq, 256)
    assert ht.dtype == torch.float32 and tuple(ht.shape) == (2, 256, 8)
    _close(_np(yt), np.asarray(yj), SCAN_REL, "y")
    _close(_np(ht), np.asarray(hj), SCAN_REL, "h_last")


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


def _comb_mul_add(a1, b1, a2, b2):
    return a1 * a2, a2 * b1 + b2


def _interleave_np(a, b):
    za = np.zeros((a.shape[0], a.shape[1] + b.shape[1]) + a.shape[2:],
                  np.float32)
    zb = za.copy()
    za[:, 0::2] = a
    zb[:, 1::2] = b
    return za + zb


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


def _decays(seq, seed, dt_scale):
    """``(a, b)`` of shape ``(2, seq, 16, 8)`` as the ssm makes them:
    ``a = exp(dt A)`` with ``A = -(1..8)`` and ``dt = softplus(-4 + ...)``
    times ``dt_scale``, ``b = (dt x) B``. At ``dt_scale`` 1 the decays
    stay normal over the sequence; at 20 the long products reach
    subnormals."""
    rng = np.random.default_rng(seed)
    dt = (np.log1p(np.exp(-4 + rng.standard_normal((2, seq, 16))))
          * dt_scale).astype(np.float32)
    A = -np.arange(1, 9, dtype=np.float32)
    a = np.exp(dt[..., None] * A).astype(np.float32)
    x = rng.standard_normal((2, seq, 16)).astype(np.float32)
    Bm = rng.standard_normal((2, seq, 8)).astype(np.float32)
    b = ((dt * x)[..., None] * Bm[:, :, None, :]).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seq,dt_scale", [(2, 1.0), (37, 1.0), (64, 20.0)])
def test_scan_contraction_pinned(jitted, seq, dt_scale):
    """The jitted reference's ``associative_scan`` of the combine over the
    ssm's 4-D decays equals a numpy copy of jax's recursion with the
    combine as an fma and subnormals flushed, bit for bit (both outputs);
    the port's recursion equals the same copy with multiply then add and
    IEEE subnormals bit for bit, within ``COMB_ULPS`` of each column's
    largest ``|h|``. At ``dt_scale`` 20 the products of ``a`` reach
    subnormals, which only the port keeps."""
    a, b = _decays(seq, seq, dt_scale)
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
    sub = (ta != 0) & (np.abs(ta) < FLT_MIN)
    assert bool(sub.any()) == (dt_scale > 1)
    assert not bool(((ja != 0) & (np.abs(ja) < FLT_MIN)).any())
    assert float(_col_ulps(tb, jb).max()) <= COMB_ULPS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_bounded(jitted, dtype):
    """``_causal_conv`` (4 taps, float32 products summed ``j = 0..3``, then
    the bias) on a reference layer's ``conv_w`` and a random ``conv_b``:
    float32 within 2 ULPs of the largest output (XLA contracts the taps'
    adds), bf16 within 1 bf16 ULP of each output (one rounding at the
    cast); the first position sees only tap 3 and the bias."""
    lj, lt = _layer(dtype)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 37, 256)).astype(np.float32)
    bias = rng.standard_normal(256).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    want = _f32(jitted["conv"](jnp.asarray(x).astype(jd), lj["conv_w"],
                               jnp.asarray(bias).astype(jd)))
    xt = torch.from_numpy(x).to(td)
    bt = torch.from_numpy(bias).to(td)
    got = TSM._causal_conv(xt, lt["conv_w"], bt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    if dtype == "float32":
        _close(_np(got), want, 2 * 2.0**-23, "conv")
    else:
        assert np.all(np.abs(_np(got) - want) <= 2.0**-8 * np.abs(want)
                      + 1e-30)
    w3 = lt["conv_w"][3].to(torch.float32)
    np.testing.assert_array_equal(
        _np(got[:, 0]),
        _np((xt[:, 0].to(torch.float32) * w3 + bt.to(torch.float32)).to(td)))


@pytest.fixture(scope="module")
def weights():
    """The reference's params and both packages' configs, float32 at each
    depth and bf16 at 3 layers."""
    out = {}
    with jax.threefry_partitionable(True):
        for depth, dtype in [(d, "float32") for d in DEPTHS] + [
                ("3 layers", "bfloat16")]:
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
                         + [("3 layers", "bfloat16")])
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
    (each layer under checkpoint) within ``GRAD_REL`` of each leaf's
    largest entry, ``A_log``, ``dt_bias`` and ``D_skip`` included."""
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
        _close(_np(g), np.asarray(a), GRAD_REL, _path(path))


@pytest.mark.parametrize("depth", list(DEPTHS))
def test_decode_bounded(weights, depth):
    """Port decode against the reference's on the same weights, float32,
    24 steps: logits and the float32 states within ``DECODE_REL`` of their
    largest at every step, the conv windows too, and the caches' trees
    equal."""
    cj, ct, pj, pt = weights[depth, "float32"]
    tokens = _batch(2, s=24)["tokens"]
    cj_cache = JR.init_cache(cj, 2, 24)
    ct_cache = TR.init_cache(ct, 2, 24)
    step = jax.jit(lambda p, c, t, pos: JR.decode_step(p, c, t, pos, cj))
    for t in range(24):
        a, cj_cache = step(pj, cj_cache, jnp.asarray(tokens[:, t:t + 1]),
                           jnp.int32(t))
        b, ct_cache = TR.decode_step(pt, ct_cache,
                                     torch.from_numpy(tokens[:, t:t + 1]), t,
                                     ct)
        assert b.shape == (2, 1, 512) and b.dtype == torch.float32
        _close(_np(b), np.asarray(a), DECODE_REL, f"decode step {t}")
    assert TCK.tree_keys(ct_cache) == _keys_path(
        jax.tree_util.tree_leaves_with_path(cj_cache))
    for x, y in zip(jax.tree_util.tree_leaves(cj_cache),
                    TTP.tree_flatten(ct_cache)[0]):
        assert tuple(x.shape) == tuple(y.shape)
        assert str(y.dtype) == "torch." + str(x.dtype)
        _close(_np(y), np.asarray(x), DECODE_REL, "cache")


def test_decode_matches_forward(weights):
    """Inside the port, decode over 24 tokens against the training forward
    at every position: float32 within 1e-5 of the largest logit (the
    recurrence one step at a time against the scan); bf16 within
    ``DECODE_FWD_BF16`` (risk of the reference's own split: forward rounds
    the conv and SiLU outputs to bf16, decode does not). The reference's
    bf16 decode differs from its forward by as much."""
    tokens = _batch(3, s=24)["tokens"]
    tt = torch.from_numpy(tokens)
    for dtype, rel in (("float32", 1e-5), ("bfloat16", DECODE_FWD_BF16)):
        cj, ct, pj, pt = weights["3 layers", dtype]
        with torch.no_grad():
            ref, _ = TR.forward(pt, {"tokens": tt}, ct)
        cache = TR.init_cache(ct, 2, 24)
        outs = []
        for t in range(24):
            lg, cache = TR.decode_step(pt, cache, tt[:, t:t + 1], t, ct)
            outs.append(lg[:, 0])
        _close(_np(torch.stack(outs, dim=1)), _np(ref), rel,
               f"decode vs forward {dtype}")
    # the reference in bf16 splits the same way
    fj, _ = JR.forward(pj, {"tokens": jnp.asarray(tokens)}, cj)
    cache_j = JR.init_cache(cj, 2, 24)
    outs_j = []
    step = jax.jit(lambda p, c, t, pos: JR.decode_step(p, c, t, pos, cj))
    for t in range(24):
        lg, cache_j = step(pj, cache_j, jnp.asarray(tokens[:, t:t + 1]),
                           jnp.int32(t))
        outs_j.append(np.asarray(lg[:, 0]))
    gap = np.abs(np.stack(outs_j, axis=1) - np.asarray(fj)).max()
    assert 0 < gap <= DECODE_FWD_BF16 * np.abs(np.asarray(fj)).max()


# --------------------------------------------------------- registry, drivers


def test_registry_returns_ssm():
    """``family_module`` is ``models/ssm.py`` for falcon-mamba-7b at any
    depth; the module's API is the transformer's."""
    for cfg in (TC.get_config(ARCH), TC.get_config(ARCH).reduced()):
        assert TR.family_module(cfg) is TSM
    for name in ("init_params", "forward", "loss_fn", "init_cache",
                 "decode_step"):
        assert callable(getattr(TSM, name))


class _Small:
    """A config whose ``reduced(...)`` is this file's driver widths, so the
    drivers' ``--reduced`` runs at them."""

    def __init__(self, cfg):
        self.cfg = cfg

    def reduced(self, **kw):
        return self.cfg.reduced(**SMALL)


def test_train_main_trajectory():
    """``train.main --arch falcon-mamba-7b --reduced --steps 6 --mode
    approx`` at 20 dB (both drivers' ``--reduced`` pointed at 2 layers,
    d_model 64, Di 128): the printed losses within ``TRAJ_TOL``, step 0
    within 1e-2 (bf16 weights), the same parameter count."""
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
    """``serve.main --arch falcon-mamba-7b --reduced`` (bf16, batch 2, 8
    prompt + 6 generated tokens) beside the reference's ``serve.main``: the
    prompt is the reference's draw (Exact), and each greedy token is one
    the reference's decode, fed the port's tokens, ranks within the bf16
    forward bound (3e-2 of its largest logit) of its own argmax."""
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
