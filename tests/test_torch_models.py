"""The port's dense transformer against the reference's (``models/``,
``configs/``, ``data/tokens.py``).

Grades, as the ROADMAP defines them:

* **Exact**: every ``ModelConfig`` (all ten architectures, reduced or
  not), ``INPUT_SHAPES``, ``input_specs`` shapes and dtypes for every
  architecture and shape, ``TokenStream`` batches, the integer draws of
  ``make_batch``, the NotImplementedError of the expert-parallel moe
  dispatch the port does not run yet, and the registry's modules for the
  ssm and audio families (the moe, vlm, hybrid, ssm and audio families
  are in ``test_torch_moe.py``, ``test_torch_vlm.py``,
  ``test_torch_hybrid.py``, ``test_torch_ssm.py`` and
  ``test_torch_audio.py``).
* **Bounded** (bound in each test): ``init_params(PRNGKey(0))`` leaves
  (the normals go through ``torch.erfinv``, not XLA's ``erf_inv``);
  ``rmsnorm``, ``apply_rope``, the attentions and the decode attends in
  float32; ``forward`` logits, ``loss_fn`` and the gradients on the same
  weights (carried across by ``convert.params_from_jax``), float32 and one
  bf16 case. The einsums and reductions sum in another order, so these
  are never Exact; in bf16 the reference's einsums also round their
  outputs to bf16 where torch's CPU matmul rounds once from float32.
* Inside the port: decode over a full and a ring cache equals the
  training forward at every position (the reference's
  ``test_decode_matches_forward`` cases), and the blockwise attention
  equals the materialized one.

Sizes are the reference tests' reduced ones: 2 layers, d_model 64, d_ff
128, vocab 128.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.data.tokens import TokenStream as JTokenStream  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.core.transport import tree_flatten  # noqa: E402
from repro_torch.data.tokens import TokenStream as TTokenStream  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402

SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=128)
DENSE = ["yi-6b", "chatglm3-6b", "qwen2-1.5b", "deepseek-coder-33b"]


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


def _cfgs(arch="qwen2-1.5b", **kw):
    kw = dict(SMALL, **kw)
    return JC.get_config(arch).reduced(**kw), TC.get_config(arch).reduced(**kw)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy()


def _close(got, want, rel, what):
    """``|got - want| <= rel * max|want|`` everywhere."""
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_config_equal(arch):
    j, t = JC.get_config(arch), TC.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert dataclasses.asdict(j.reduced(**SMALL)) == dataclasses.asdict(
        t.reduced(**SMALL))
    assert (j.resolved_head_dim, j.is_subquadratic) == (
        t.resolved_head_dim, t.is_subquadratic)


def test_registry_lists_equal():
    assert JC.ARCH_IDS == TC.ARCH_IDS
    assert JC.list_configs() == TC.list_configs()
    assert {k: dataclasses.asdict(v) for k, v in JC.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in TC.INPUT_SHAPES.items()}
    with pytest.raises(KeyError):
        TC.get_config("no-such-arch")


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
@pytest.mark.parametrize("shape_name", list(JC.INPUT_SHAPES))
def test_input_specs_equal(arch, shape_name):
    cj, ct = JC.get_config(arch), TC.get_config(arch)
    sj, st = JC.INPUT_SHAPES[shape_name], TC.INPUT_SHAPES[shape_name]
    a, b = JR.input_specs(cj, sj), TR.input_specs(ct, st)
    assert sorted(a) == sorted(b)
    for k in a:
        assert tuple(a[k].shape) == b[k].shape
        assert str(a[k].dtype) == str(b[k].dtype).replace("torch.", "")
    assert JR.supports_shape(cj, sj) == TR.supports_shape(ct, st)
    assert JR.uses_ring_cache(cj, sj) == TR.uses_ring_cache(ct, st)
    assert JR.cache_len_for(cj, sj) == TR.cache_len_for(ct, st)


@pytest.mark.parametrize("arch", [a for a in JC.ARCH_IDS
                                  if JC.get_config(a).family
                                  not in ("dense", "moe", "vlm", "hybrid")]
                         + ["expert_parallel:" + a for a in JC.ARCH_IDS
                            if JC.get_config(a).family == "moe"])
def test_other_families_raise(arch):
    """The families and dispatches that raised before now run: a moe
    config's expert-parallel dispatch builds the same tree as the dense
    config (the registry returns the transformer), and the ssm and audio
    families get ``models/ssm.py`` / ``models/audio.py``, whose
    ``init_params`` builds the reference's tree (the moe, vlm, hybrid, ssm
    and audio families are held against the reference in
    ``test_torch_moe.py``, ``test_torch_moe_ep.py``, ``test_torch_vlm.py``,
    ``test_torch_hybrid.py``, ``test_torch_ssm.py`` and
    ``test_torch_audio.py``)."""
    from repro_torch.models import audio, ssm
    from repro_torch.models import transformer

    name = arch.split(":")[-1]
    cfg = TC.get_config(name).reduced()
    jcfg = JC.get_config(name).reduced()
    if arch.startswith("expert_parallel:"):
        dense = cfg
        cfg = dataclasses.replace(cfg, moe_impl="expert_parallel")
        jcfg = dataclasses.replace(jcfg, moe_impl="expert_parallel")
        assert TR.family_module(cfg) is transformer
        got, _ = tree_flatten(TR.init_params(P.PRNGKey(0), cfg))
        want, _ = tree_flatten(TR.init_params(P.PRNGKey(0), dense))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert TR.family_module(cfg) is {"ssm": ssm,
                                         "audio": audio}[cfg.family]
    params = TR.init_params(P.PRNGKey(0), cfg)
    leaves, _ = tree_flatten(params)
    want = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    assert [tuple(t.shape) for t in leaves] == [
        tuple(a.shape) for a in jax.tree_util.tree_leaves(want)]


@pytest.mark.parametrize("seed,vocab,seq,batch",
                         [(0, 128, 16, 4), (3, 151936, 64, 2), (7, 1024, 1, 8)])
def test_token_stream_exact(seed, vocab, seq, batch):
    a = JTokenStream(vocab, seq, batch, seed=seed)
    b = TTokenStream(vocab, seq, batch, seed=seed)
    for _ in range(3):
        x, y = a.next_batch(), b.next_batch()
        for k in ("tokens", "labels"):
            assert x[k].dtype == y[k].dtype == np.int32
            np.testing.assert_array_equal(x[k], y[k])


def test_make_batch_integers_exact():
    cj, ct = _cfgs()
    shape = dataclasses.replace(JC.INPUT_SHAPES["train_4k"], seq_len=16,
                                global_batch=3)
    a = JR.make_batch(cj, shape, jax.random.PRNGKey(5))
    b = TR.make_batch(ct, shape, P.PRNGKey(5))
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy())


# ------------------------------------------------------------------- init


@pytest.mark.parametrize("arch,dtype", [("qwen2-1.5b", "bfloat16"),
                                        ("chatglm3-6b", "bfloat16"),
                                        ("qwen2-1.5b", "float32")])
def test_init_params_bounded(arch, dtype):
    """Same tree, shapes and dtypes; leaves within 1 ULP of their dtype
    (bf16: 2**-7 relative; float32: 64 ULP, the normals' erfinv spread,
    measured at a few)."""
    cj, ct = _cfgs(arch, dtype=dtype)
    pj = JR.init_params(jax.random.PRNGKey(0), cj)
    pt = TR.init_params(P.PRNGKey(0), ct)
    lj = jax.tree_util.tree_leaves_with_path(pj)
    lt, _ = tree_flatten(pt)
    assert len(lj) == len(lt)
    ulp = 2.0**-7 if dtype == "bfloat16" else 64 * 2.0**-23
    for (path, a), b in zip(lj, lt):
        assert tuple(a.shape) == tuple(b.shape), jax.tree_util.keystr(path)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        a, b = _f32(a), _np(b)
        err = np.abs(a - b)
        assert np.all(err <= ulp * np.abs(a) + 1e-30), jax.tree_util.keystr(path)


def test_full_width_tree_matches_reference():
    """qwen2-1.5b at its published widths on the meta device: the port's
    tree, shapes and dtypes are the reference's ``eval_shape``, and the
    count is 1,777,088,000."""
    cfg = TC.get_config("qwen2-1.5b")
    pt = TR.init_params(P.PRNGKey(0, device="meta"), cfg)
    pj = jax.eval_shape(lambda: JR.init_params(
        jax.random.PRNGKey(0), JC.get_config("qwen2-1.5b")))
    lj = jax.tree_util.tree_leaves(pj)
    lt, _ = tree_flatten(pt)
    assert [tuple(a.shape) for a in lj] == [tuple(b.shape) for b in lt]
    assert all(b.dtype == torch.bfloat16 for b in lt)
    assert sum(b.numel() for b in lt) == 1_777_088_000


# ----------------------------------------------------------------- layers


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


def test_rmsnorm_bounded():
    x, s = _rand((2, 5, 64), 1), _rand((64,), 2, 0.1)
    a = JL.rmsnorm(jnp.asarray(x), jnp.asarray(s))
    b = TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(s))
    _close(_np(b), _f32(a), 4e-7, "rmsnorm f32")  # a few ULP
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    a = JL.rmsnorm(xb, jnp.asarray(s).astype(jnp.bfloat16))
    b = TL.rmsnorm(torch.from_numpy(x).to(torch.bfloat16),
                   torch.from_numpy(s).to(torch.bfloat16))
    assert b.dtype == torch.bfloat16
    _close(_np(b), _f32(a), 2.0**-8, "rmsnorm bf16")  # one bf16 rounding


@pytest.mark.parametrize("fraction,theta", [(1.0, 1e6), (0.5, 1e4)])
def test_apply_rope_bounded(fraction, theta):
    x = _rand((2, 7, 4, 32), 3)
    pos = np.arange(7, dtype=np.int32)[None, :] + 100
    a = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), fraction, theta)
    b = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), fraction,
                      theta)
    _close(_np(b), _f32(a), 1e-5, "rope")
    rot = int(32 * fraction)
    np.testing.assert_array_equal(_np(b)[..., rot:], x[..., rot:])


def test_mlps_positions_and_unstack_bounded():
    """``swiglu`` and ``gelu_mlp`` (tanh GELU, ``jax.nn.gelu``'s default)
    within 1e-5 of the largest output in float32; the sinusoid table
    within 1e-5 (float32 ``sin`` / ``cos`` of the same angles);
    ``unstack_tree`` exact."""
    x, wi, wg = _rand((3, 64), 20), _rand((64, 96), 21, 0.1), _rand(
        (64, 96), 22, 0.1)
    wo, bi, bo = _rand((96, 64), 23, 0.1), _rand((96,), 24), _rand((64,), 25)
    a = JL.swiglu(*map(jnp.asarray, (x, wi, wg, wo)))
    b = TL.swiglu(*map(torch.from_numpy, (x, wi, wg, wo)))
    _close(_np(b), _f32(a), 1e-5, "swiglu")
    a = JL.gelu_mlp(*map(jnp.asarray, (x, wi, bi, wo, bo)))
    b = TL.gelu_mlp(*map(torch.from_numpy, (x, wi, bi, wo, bo)))
    _close(_np(b), _f32(a), 1e-5, "gelu_mlp")
    _close(_np(TL.sinusoidal_positions(64, 32)),
           _f32(JL.sinusoidal_positions(64, 32)), 1e-5, "sinusoids")
    tree = {"a": torch.arange(6.0).reshape(3, 2), "b": {"c": torch.arange(3)}}
    one = TL.unstack_tree(tree, 1)
    assert torch.equal(one["a"], tree["a"][1]) and int(one["b"]["c"]) == 1
    assert TL.maybe_shard(tree["a"], "data", None) is tree["a"]


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_attend_train_bounded(causal, window):
    q, k, v = _rand((2, 16, 4, 8), 4), _rand((2, 16, 2, 8), 5), _rand(
        (2, 16, 2, 8), 6)
    a = JA.attend_train(*map(jnp.asarray, (q, k, v)), causal=causal,
                        window=window)
    b = TA.attend_train(*map(torch.from_numpy, (q, k, v)), causal=causal,
                        window=window)
    _close(_np(b), _f32(a), 1e-5, "attend_train")


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40)])
def test_attend_blockwise_bounded(causal, window):
    q, k, v = _rand((1, 128, 4, 16), 7), _rand((1, 128, 2, 16), 8), _rand(
        (1, 128, 2, 16), 9)
    kw = dict(causal=causal, window=window, block_q=32, block_kv=64)
    a = JA.attend_train_blockwise(*map(jnp.asarray, (q, k, v)), **kw)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    b = TA.attend_train_blockwise(tq, tk, tv, **kw)
    _close(_np(b), _f32(a), 1e-5, "blockwise vs reference")
    full = TA.attend_train(tq, tk, tv, causal=causal, window=window)
    _close(_np(b), _np(full), 1e-5, "blockwise vs materialized")
    assert TA._pick_block(128, 512) == JA._pick_block(128, 512)
    assert TA._pick_block(4096, 1024) == JA._pick_block(4096, 1024)


@pytest.mark.parametrize("pos", [0, 5, 11])
def test_decode_attends_bounded(pos):
    q = _rand((2, 1, 4, 8), 10)
    kc, vc = _rand((2, 12, 2, 8), 11), _rand((2, 12, 2, 8), 12)
    a = JA.decode_attend_full(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                              jnp.int32(pos))
    b = TA.decode_attend_full(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), pos)
    _close(_np(b), _f32(a), 1e-5, "decode full")
    # a 4-slot ring at positions past one wrap
    kr, vr = kc[:, :4], vc[:, :4]
    for p in (pos, pos + 9):
        a = JA.decode_attend_ring(jnp.asarray(q), jnp.asarray(kr),
                                  jnp.asarray(vr), jnp.int32(p))
        b = TA.decode_attend_ring(torch.from_numpy(q), torch.from_numpy(kr),
                                  torch.from_numpy(vr), p)
        _close(_np(b), _f32(a), 1e-5, "decode ring")
    new = _rand((2, 1, 2, 8), 13)
    for jf, tf in ((JA.update_cache_full, TA.update_cache_full),
                   (JA.update_cache_ring, TA.update_cache_ring)):
        ja = jf(jnp.asarray(kr), jnp.asarray(vr), jnp.asarray(new),
                jnp.asarray(new), jnp.int32(pos % 4 if jf is
                                            JA.update_cache_full else pos))
        before = torch.from_numpy(kr.copy())
        ta = tf(before, torch.from_numpy(vr), torch.from_numpy(new),
                torch.from_numpy(new), pos % 4 if tf is TA.update_cache_full
                else pos)
        np.testing.assert_array_equal(ta[0].numpy(), np.asarray(ja[0]))
        np.testing.assert_array_equal(before.numpy(), kr)  # functional


# ------------------------------------------------------- forward and loss


@pytest.fixture(scope="module")
def weights():
    """The reference's params and both packages' configs, float32 and bf16."""
    out = {}
    with jax.threefry_partitionable(True):
        for dtype in ("float32", "bfloat16"):
            cj, ct = _cfgs(dtype=dtype)
            pj = JR.init_params(jax.random.PRNGKey(0), cj)
            pt = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                pj))
            out[dtype] = (cj, ct, pj, pt)
    return out


def _batch(seed=0, b=2, s=16, vocab=128):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


# (logits rel, loss abs): float32 sums in another order; bf16 rounds every
# einsum output to bf16 in the reference and once from float32 here.
FWD_BOUNDS = {"float32": (2e-6, 2e-6), "bfloat16": (3e-2, 1e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_bounded(weights, dtype):
    cj, ct, pj, pt = weights[dtype]
    b = _batch()
    lj, auxj = JR.forward(pj, {k: jnp.asarray(v) for k, v in b.items()}, cj)
    with torch.no_grad():
        lt, auxt = TR.forward(pt, {k: torch.from_numpy(v) for k, v in
                                   b.items()}, ct)
        losst = TR.loss_fn(pt, {k: torch.from_numpy(v) for k, v in b.items()},
                           ct)
    assert lt.dtype == torch.float32 and lt.shape == (2, 16, 128)
    assert float(auxt) == float(auxj) == 0.0
    rel, abs_loss = FWD_BOUNDS[dtype]
    _close(_np(lt), np.asarray(lj), rel, "logits")
    lossj = float(JR.loss_fn(pj, {k: jnp.asarray(v) for k, v in b.items()},
                             cj))
    assert abs(float(losst) - lossj) <= abs_loss, (float(losst), lossj)


def test_gradients_bounded_f32(weights):
    """float32 gradients within 1e-5 of each leaf's largest entry."""
    cj, ct, pj, pt = weights["float32"]
    b = _batch(1)
    lj, gj = jax.value_and_grad(JR.loss_fn)(
        pj, {k: jnp.asarray(v) for k, v in b.items()}, cj)
    lt, gt = TS.value_and_grad(ct, pt, {k: torch.from_numpy(v) for k, v in
                                        b.items()})
    assert abs(float(lt) - float(lj)) <= 2e-6
    lgt, _ = tree_flatten(gt)
    for (path, a), g in zip(jax.tree_util.tree_leaves_with_path(gj), lgt):
        assert g.dtype == torch.float32
        _close(_np(g), np.asarray(a), 1e-5, jax.tree_util.keystr(path))


@pytest.mark.parametrize("ring", [False, True])
def test_decode_matches_forward(weights, ring):
    """Teacher-forced decode over 12 tokens reproduces the forward's logits
    (the reference's bound: rtol 3e-2, atol 5e-2 in bf16), on a full cache
    and on a ring cache whose window (8) wraps."""
    _, ct, _, pt = weights["bfloat16"]
    ct = dataclasses.replace(ct, decode_window=8)
    S = 12
    tokens = TR.make_batch(ct, dataclasses.replace(
        TC.INPUT_SHAPES["train_4k"], seq_len=S, global_batch=2),
        P.PRNGKey(0))["tokens"]
    window = 8 if ring else 0
    with torch.no_grad():
        ref, _ = TR.forward(pt, {"tokens": tokens},
                            dataclasses.replace(ct, sliding_window=window))
    cache = TR.init_cache(ct, 2, ct.decode_window if ring else S)
    outs = []
    for t in range(S):
        lg, cache = TR.decode_step(pt, cache, tokens[:, t:t + 1], t, ct,
                                   ring=ring)
        outs.append(lg[:, 0])
    got = torch.stack(outs, dim=1)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=3e-2, atol=5e-2)


def test_decode_step_bounded(weights):
    """Port decode logits against the reference's on the same weights,
    float32, for 6 steps of a full cache."""
    cj, ct, pj, pt = weights["float32"]
    tokens = _batch(2, s=6)["tokens"]
    cj_cache = JR.init_cache(cj, 2, 6)
    ct_cache = TR.init_cache(ct, 2, 6)
    for t in range(6):
        a, cj_cache = JR.decode_step(pj, cj_cache, jnp.asarray(tokens[:, t:t + 1]),
                                     jnp.int32(t), cj)
        b, ct_cache = TR.decode_step(pt, ct_cache,
                                     torch.from_numpy(tokens[:, t:t + 1]), t, ct)
        _close(_np(b), np.asarray(a), 2e-6, f"decode step {t}")
