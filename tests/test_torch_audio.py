"""The port's audio family (the Whisper encoder-decoder, whisper-large-v3)
against the reference's ``models/audio.py``.

Grades, as the ROADMAP defines them:

* **Exact**: the key schedule (every leaf's draw, with the normals
  replaced in both packages by the same exact function of the key's
  bits: 6 keys at the top of which ``ks[0..3]`` draw, 2 an encoder layer,
  3 a decoder layer, 4 an attention); the param tree's paths, shapes and
  dtypes at ``cfg.reduced()``, at 1 + 3 layers, and at the published
  widths and full depth (32 + 32 layers, 1,588,016,640 parameters);
  ``init_cache``'s tree; ``make_batch``'s integers; the sharding specs of
  every leaf (params, batch with ``frames``, cache) on fake meshes;
  ``convert`` and the checkpoint both ways.
* **Bounded** (bound in each test): ``init_params`` and ``make_batch``'s
  frames (the normals' ``erfinv``); ``layernorm``; ``encode``, which runs
  in float32 against bf16 weights as ``jnp`` promotes; logits, loss and
  gradients with the dense family's bounds; decode against the
  reference's decode on the full and the ring cache.
* **Copied on purpose** (ROADMAP Queue 3): nothing fills the
  cross-attention cache ``xk`` / ``xv``, so decode's cross-attention is
  uniform over zero keys and adds ``bo``, in both packages.
* **Trajectory**: ``train.main --arch whisper-large-v3`` raises
  ``KeyError: 'frames'`` in both packages (``TokenStream`` yields tokens
  only); ``serve.main``'s greedy tokens.

Sizes: ``cfg.reduced()`` widths (d_model 128, 4 heads of 32, d_ff 256,
2 + 2 layers, encoder_seq 64, max_position 512).
"""

import contextlib
import dataclasses
import io
import json

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
from repro.models import audio as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import io as TCK  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.core import transport as TTP  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402
from repro_torch.launch import sharding as TSH  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as TTR  # noqa: E402
from repro_torch.models import audio as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402

ARCH = "whisper-large-v3"
DEPTHS = {"reduced": {}, "1 + 3 layers": dict(encoder_layers=1, n_layers=3)}
# (logits rel, loss abs), the dense family's bounds (test_torch_models.py)
FWD_BOUNDS = {"float32": (2e-6, 2e-6), "bfloat16": (3e-2, 1e-2)}
GRAD_REL = 1e-5
# The encoder's float32 output against the reference's, of its largest
# (measured 2.4e-7 with float32 and with bf16 weights).
ENC_REL = 2e-6
# Decode against the reference's, float32: the logits' bound (measured
# 8.5e-7 over 12 steps, full and ring caches; the caches 7.5e-7).
DECODE_REL = 2e-6
FULL_PARAMS = 1_588_016_640


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


def _train_shape(seq=16, batch=2):
    sj = dataclasses.replace(JC.INPUT_SHAPES["train_4k"], seq_len=seq,
                             global_batch=batch)
    st = dataclasses.replace(TC.INPUT_SHAPES["train_4k"], seq_len=seq,
                             global_batch=batch)
    return sj, st


# ------------------------------------------------------------------ exact


def test_key_schedule_exact(monkeypatch):
    """Every leaf of ``init_params`` in float32 with the normals replaced,
    in both packages, by the same exact function of the key's bits (the
    top 23 bits of ``bits(key)`` as a float in [0, 1)): Exact, so each
    leaf draws from the reference's key."""
    def jnormal(key, shape=(), dtype=jnp.float32):
        return ((jax.random.bits(key, shape) >> 9).astype(jnp.float32)
                * np.float32(2.0**-23)).astype(dtype)

    def tnormal(key, shape=()):
        return (P.random_bits(key, shape) >> 9).to(torch.float32) * 2.0**-23

    monkeypatch.setattr(jax.random, "normal", jnormal)
    monkeypatch.setattr(P, "normal", tnormal)
    cj, ct = _cfgs("1 + 3 layers", dtype="float32")
    pj = JR.init_params(jax.random.PRNGKey(0), cj)
    pt = TR.init_params(P.PRNGKey(0), ct)
    lj = jax.tree_util.tree_leaves_with_path(pj)
    lt, _ = TTP.tree_flatten(pt)
    assert TCK.tree_keys(pt) == _keys_path(lj)
    for (path, a), b in zip(lj, lt):
        np.testing.assert_array_equal(_np(b), np.asarray(a),
                                      err_msg=_path(path))
    wq = _np(pt["dec_layers"]["cross_attn"]["wq"])
    assert not np.array_equal(wq[0], wq[1])


@pytest.mark.parametrize("depth", list(DEPTHS))
def test_param_tree_and_uplink_row_exact(depth):
    """Paths, shapes and dtypes of ``init_params`` against the reference's
    ``eval_shape`` tree; the uplink row of the reference's weights in the
    reference's length and order, bit for bit."""
    cj, ct = _cfgs(depth, dtype="bfloat16")
    pt = TR.init_params(P.PRNGKey(0), ct)
    shapes = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0), cj))
    lw = jax.tree_util.tree_leaves_with_path(shapes)
    lt, _ = TTP.tree_flatten(pt)
    assert len(lt) == len(lw) == 45
    assert TCK.tree_keys(pt) == _keys_path(lw)
    for (path, a), b in zip(lw, lt):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(b.dtype) == "torch." + str(a.dtype), path
    pj = JR.init_params(jax.random.PRNGKey(0), cj)
    row_j = np.concatenate([_f32(a).reshape(-1)
                            for a in jax.tree_util.tree_leaves(pj)])
    ptj = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    row_t = torch.cat([t.reshape(-1).to(torch.float32)
                       for t in TTP.tree_flatten(ptj)[0]])
    np.testing.assert_array_equal(row_t.numpy(), row_j)


@pytest.fixture(scope="module")
def full_trees():
    """whisper-large-v3 at full depth: the reference's ``eval_shape``
    params and the port's meta-device params."""
    cj, ct = JC.get_config(ARCH), TC.get_config(ARCH)
    shapes = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0), cj))
    return shapes, TR.init_params(P.PRNGKey(0, device="meta"), ct)


def test_full_width_tree_matches_reference(full_trees):
    """whisper-large-v3 at its published widths and full depth (32 + 32
    layers) on the meta device: the reference's ``eval_shape`` shapes,
    dtypes and parameter count, under K0's 2**31 - 1 words."""
    pj, pt = full_trees
    lj = jax.tree_util.tree_leaves(pj)
    lt, _ = TTP.tree_flatten(pt)
    assert [tuple(a.shape) for a in lj] == [tuple(b.shape) for b in lt]
    assert [str(a.dtype) for a in lj] == [
        str(b.dtype).replace("torch.", "") for b in lt]
    n = sum(b.numel() for b in lt)
    assert n == FULL_PARAMS < 2**31 - 1


@pytest.mark.parametrize("depth", list(DEPTHS))
def test_init_cache_exact(depth):
    """``init_cache``'s paths, shapes and dtypes (self-attention ``k`` /
    ``v`` of ``cache_len`` slots, cross ``xk`` / ``xv`` of
    ``encoder_seq``), all zeros."""
    cj, ct = _cfgs(depth)
    for clen in (8, 100):
        a = JR.init_cache(cj, 3, clen)
        b = TR.init_cache(ct, 3, clen)
        la = jax.tree_util.tree_leaves_with_path(a)
        lb, _ = TTP.tree_flatten(b)
        assert TCK.tree_keys(b) == _keys_path(la)
        assert sorted(b) == ["k", "v", "xk", "xv"]
        for (path, x), y in zip(la, lb):
            assert tuple(x.shape) == tuple(y.shape), path
            assert str(y.dtype) == "torch." + str(x.dtype), path
            assert not bool(y.any())


def test_make_batch_draws_frames():
    """``registry.make_batch`` at a small train shape: the same names and
    shapes, the integers Exact and ``frames`` (float32 normals
    ``(B, encoder_seq, d_model)``) within 64 ULPs (the normals'
    ``erfinv``)."""
    cj, ct = _cfgs()
    sj, st = _train_shape(seq=8)
    bj = JR.make_batch(cj, sj, jax.random.PRNGKey(3))
    bt = TR.make_batch(ct, st, P.PRNGKey(3))
    assert sorted(bt) == sorted(bj) == ["frames", "labels", "tokens"]
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]))
    fj, ft = np.asarray(bj["frames"]), bt["frames"].numpy()
    assert ft.shape == (2, 64, 128) and ft.dtype == np.float32
    assert np.all(np.abs(ft - fj) <= 64 * 2.0**-23 * np.abs(fj) + 1e-30)


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
    """Every param leaf of whisper-large-v3 at full depth through
    ``param_rules`` and ``tree_specs`` (fsdp on and off), the batch specs
    of every input shape (``frames`` on train and prefill), and the cache
    specs of the decode shapes, against the reference's entries."""
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
        got = TSH.batch_specs(ct, st, mesh)
        assert got == want
        assert ("frames" in got) == (st.kind != "decode")
        if sj.kind != "decode" or not JR.supports_shape(cj, sj)[0]:
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
    reference to port, bit for bit with the dtypes kept."""
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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_params_bounded(dtype):
    """``init_params`` from ``PRNGKey(0)``: every leaf within 1 ULP of its
    dtype of the reference's draw (bf16: 2**-7 relative; float32: 64 ULP,
    the normals' ``erfinv``); the norms' ones and zeros exact."""
    cj, ct = _cfgs("1 + 3 layers", dtype=dtype)
    pj = JR.init_params(jax.random.PRNGKey(0), cj)
    pt = TR.init_params(P.PRNGKey(0), ct)
    lj = jax.tree_util.tree_leaves_with_path(pj)
    lt, _ = TTP.tree_flatten(pt)
    assert len(lj) == len(lt)
    rel = 2.0**-7 if dtype == "bfloat16" else 64 * 2.0**-23
    for (path, a), b in zip(lj, lt):
        err = np.abs(_f32(a) - _np(b))
        assert np.all(err <= rel * np.abs(_f32(a)) + 1e-30), _path(path)
    for k in ("enc_norm", "dec_norm"):
        for leaf in ("scale", "bias"):
            np.testing.assert_array_equal(_np(pt[k][leaf]),
                                          _f32(pj[k][leaf]))


def test_layernorm_and_dot_bounded():
    """``layernorm`` (mean, then the mean of squared deviations) in float32
    and bf16 within 4 ULPs of its dtype of the reference's largest output;
    ``dot`` of a float32 activation and bf16 weights gives float32, the
    weights upcast (the product of the upcast weights, bit for bit) as
    ``jnp.einsum`` promotes."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((3, 5, 128)) * 3 + 1).astype(np.float32)
    s = rng.standard_normal(128).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    for dt, ulp in ((jnp.float32, 2.0**-23), (jnp.bfloat16, 2.0**-8)):
        want = _f32(JL.layernorm(*(jnp.asarray(v).astype(dt)
                                   for v in (x, s, b))))
        td = getattr(torch, str(jnp.dtype(dt)))
        got = TL.layernorm(*(torch.from_numpy(v).to(td) for v in (x, s, b)))
        assert got.dtype == td
        _close(_np(got), want, 4 * ulp, f"layernorm {dt}")
    w = torch.from_numpy(rng.standard_normal((128, 64)).astype(
        np.float32)).to(torch.bfloat16)
    xt = torch.from_numpy(x)
    y = TL.dot(xt, w)
    assert y.dtype == torch.float32
    assert torch.equal(y, xt @ w.to(torch.float32))
    assert TL.dot(xt.to(torch.bfloat16), w).dtype == torch.bfloat16


@pytest.fixture(scope="module")
def weights():
    """The reference's params and both packages' configs: float32 at each
    depth, and bf16 at ``cfg.reduced()``."""
    out = {}
    with jax.threefry_partitionable(True):
        for depth, dtype in [(d, "float32") for d in DEPTHS] + [
                ("reduced", "bfloat16")]:
            cj, ct = _cfgs(depth, dtype=dtype)
            pj = JR.init_params(jax.random.PRNGKey(0), cj)
            pt = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                pj))
            out[depth, dtype] = (cj, ct, pj, pt)
    return out


def _batch(seed=0, b=2, s=16, vocab=512, enc=(64, 128)):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "frames": rng.standard_normal((b,) + enc).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_float32_bounded(weights, dtype):
    """``encode`` on float32 frames: float32 in both packages whatever the
    weights' dtype (``jnp`` promotes the bf16 weights; the port upcasts
    them), within ``ENC_REL`` of the reference's largest output."""
    cj, ct, pj, pt = weights["reduced", dtype]
    frames = _batch()["frames"]
    want = JA.encode(pj, jnp.asarray(frames), cj)
    assert want.dtype == jnp.float32
    with torch.no_grad():
        got = TA.encode(pt, torch.from_numpy(frames), ct)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 64, 128)
    _close(_np(got), np.asarray(want), ENC_REL, f"encode ({dtype} weights)")


@pytest.mark.parametrize("depth,dtype", [(d, "float32") for d in DEPTHS]
                         + [("reduced", "bfloat16")])
def test_forward_and_loss_bounded(weights, depth, dtype):
    """Logits (the tied head) and the loss within the dense family's
    bounds; the aux loss a float32 zero."""
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
    (each encoder and decoder layer under checkpoint; the tied embedding
    gets the head's and the lookup's) within ``GRAD_REL`` of each leaf's
    largest entry."""
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


@pytest.mark.parametrize("ring", [False, True])
def test_decode_bounded(weights, ring):
    """Port decode against the reference's on the same weights, float32,
    12 steps: on a full cache of 12 slots, and on a ring of 8 that wraps
    at step 8; logits within ``DECODE_REL`` of their largest at every
    step, the caches' trees equal and their K/V within the same; the
    cross caches stay the zeros ``init_cache`` made, in both."""
    cj, ct, pj, pt = weights["1 + 3 layers", "float32"]
    tokens = _batch(2, s=12)["tokens"]
    clen = 8 if ring else 12
    cj_cache = JR.init_cache(cj, 2, clen)
    ct_cache = TR.init_cache(ct, 2, clen)
    step = jax.jit(lambda p, c, t, pos: JR.decode_step(p, c, t, pos, cj,
                                                       ring=ring))
    for t in range(12):
        a, cj_cache = step(pj, cj_cache, jnp.asarray(tokens[:, t:t + 1]),
                           jnp.int32(t))
        b, ct_cache = TR.decode_step(pt, ct_cache,
                                     torch.from_numpy(tokens[:, t:t + 1]), t,
                                     ct, ring=ring)
        assert b.shape == (2, 1, 512) and b.dtype == torch.float32
        _close(_np(b), np.asarray(a), DECODE_REL, f"decode step {t}")
    assert TCK.tree_keys(ct_cache) == _keys_path(
        jax.tree_util.tree_leaves_with_path(cj_cache))
    for x, y in zip(jax.tree_util.tree_leaves(cj_cache),
                    TTP.tree_flatten(ct_cache)[0]):
        assert tuple(x.shape) == tuple(y.shape)
        _close(_np(y), np.asarray(x), DECODE_REL, "cache")
    for k in ("xk", "xv"):
        assert not bool(ct_cache[k].any()) and not bool(cj_cache[k].any())


def test_decode_cross_attention_adds_the_bias(weights):
    """On the cache ``init_cache`` makes, decode's cross-attention is a
    uniform softmax over zero keys of zero values: each layer adds its
    cross ``bo`` and nothing else, so with the cross ``wq`` replaced by
    random weights the logits stay bit for bit the same, in both
    packages; with ``xk`` / ``xv`` filled they change."""
    cj, ct, pj, pt = weights["reduced", "float32"]
    tok = _batch(4)["tokens"][:, :1]
    rng = np.random.default_rng(9)
    wq = rng.standard_normal(np.shape(pj["dec_layers"]["cross_attn"]["wq"]))
    pj2 = jax.tree_util.tree_map(lambda a: a, pj)
    pj2["dec_layers"]["cross_attn"]["wq"] = jnp.asarray(wq, jnp.float32)
    pt2 = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, pj2))
    outs = []
    for p_j, p_t in ((pj, pt), (pj2, pt2)):
        a, _ = JR.decode_step(p_j, JR.init_cache(cj, 2, 4), jnp.asarray(tok),
                              0, cj)
        b, _ = TR.decode_step(p_t, TR.init_cache(ct, 2, 4),
                              torch.from_numpy(tok), 0, ct)
        outs.append((np.asarray(a), _np(b)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    cache = TR.init_cache(ct, 2, 4)
    cache["xk"] = torch.randn(cache["xk"].shape)
    cache["xv"] = torch.randn(cache["xv"].shape)
    c, _ = TR.decode_step(pt, cache, torch.from_numpy(tok), 0, ct)
    assert not np.array_equal(_np(c), outs[0][1])


# --------------------------------------------------------- registry, drivers


def test_registry_returns_audio():
    """``family_module`` is ``models/audio.py`` for whisper-large-v3; the
    module's API is the transformer's, plus ``encode``."""
    for cfg in (TC.get_config(ARCH), TC.get_config(ARCH).reduced()):
        assert TR.family_module(cfg) is TA
    for name in ("init_params", "encode", "forward", "loss_fn",
                 "init_cache", "decode_step"):
        assert callable(getattr(TA, name))


def test_train_main_raises_key_error():
    """``train.main --arch whisper-large-v3 --reduced`` fails in both
    packages on step 0 with ``KeyError: 'frames'``: ``TokenStream`` yields
    tokens and labels only."""
    argv = ["--arch", ARCH, "--reduced", "--steps", "1", "--mode", "approx",
            "--batch", "2", "--seq", "8"]
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(KeyError, match="frames"):
            JTR.main(argv)
        with pytest.raises(KeyError, match="frames"):
            TTR.main(argv + ["--device", "cpu"])


def test_serve_main_greedy_tokens():
    """``serve.main --arch whisper-large-v3 --reduced`` (bf16, batch 2, 8
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
