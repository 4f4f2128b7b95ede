"""The port's vlm family (pixtral-12b: the dense decoder behind a projected
patch-embedding prefix) against the reference's ``models/transformer.py``.

Grades, as the ROADMAP defines them:

* **Exact**: the param tree's paths, shapes and dtypes (``vision_proj``
  drawn from ``ks[6]``, the layers the dense family's), reduced and at
  the published widths on the meta device (1,892,705,280 parameters at 2
  layers, the card's row; 1,620,065,280 at 1); ``init_cache``'s tree;
  the integer draws of ``registry.make_batch``; the sharding specs of
  every leaf and of the batch (``patch_embeds``) on fake meshes.
* **Bounded** (bound in each test): ``init_params`` and ``make_batch``'s
  normals; the projected prefix; logits, loss and gradients with the
  dense family's bounds; the prefill step; decode (the dense path: decode
  sees no image).
* **Trajectory**: ``make_train_step_approx`` with batches that carry
  ``patch_embeds``, 3 approx steps at 20 dB against the reference's step
  on a ``(1, 1)`` mesh, within ``TRAJ_TOL``.
* ``train.main --arch pixtral-12b`` raises ``KeyError`` in both packages:
  ``TokenStream`` yields no ``patch_embeds``.

Sizes: ``cfg.reduced()`` (16 patches of width 64, d_model 128), the
trainer at d_model 64.
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.core import channel as JCH  # noqa: E402
from repro.core import transport as JTP  # noqa: E402
from repro.launch import sharding as JSH  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.launch import train as JTR  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.optim.sgd import sgd as jsgd  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import io as TCK  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.core import transport as TTP  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch import sharding as TSH  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as TTR  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim.sgd import sgd as tsgd  # noqa: E402

ARCH = "pixtral-12b"
# (logits rel, loss abs), the dense family's bounds (test_torch_models.py)
FWD_BOUNDS = {"float32": (2e-6, 2e-6), "bfloat16": (3e-2, 1e-2)}
GRAD_REL = 1e-5
# The projected prefix against the reference's einsum, relative to its
# largest entry: float32 sums in another order; in bf16 both round a
# float32 sum once, so an entry may land one bf16 ULP of itself away.
PREFIX_REL = {"float32": 2e-6, "bfloat16": 2.0**-7}
TRAJ_TOL = 0.25
SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=128)


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


def _cfgs(**kw):
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


def _batch(cfg, seed=0, b=2, s=16):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "patch_embeds": rng.standard_normal(
                (b, cfg.n_patches, cfg.vision_dim)).astype(np.float32)}


def _both(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


# ------------------------------------------------------------------ exact


def test_param_tree_exact():
    """``cfg.reduced()``: the reference's paths, shapes and dtypes, with
    ``vision_proj`` ``(vision_dim, d_model)``; ``init_cache`` is the dense
    family's."""
    cj, ct = _cfgs()
    pt = TR.init_params(P.PRNGKey(0), ct)
    shapes = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0), cj))
    lw = jax.tree_util.tree_leaves_with_path(shapes)
    lt, _ = TTP.tree_flatten(pt)
    assert TCK.tree_keys(pt) == ["/".join(str(k) for k in p) for p, _ in lw]
    for (path, a), b in zip(lw, lt):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(b.dtype) == "torch." + str(a.dtype), path
    assert tuple(pt["vision_proj"].shape) == (64, 128)
    a, b = JR.init_cache(cj, 3, 24), TR.init_cache(ct, 3, 24)
    assert sorted(a) == sorted(b) == ["k", "v"]
    for k in a:
        assert tuple(a[k].shape) == tuple(b[k].shape)
        assert str(b[k].dtype) == "torch." + str(a[k].dtype)


@pytest.mark.parametrize("n_layers,count", [(2, 1_892_705_280),
                                            (1, 1_620_065_280)])
def test_full_width_tree_matches_reference(n_layers, count):
    """pixtral-12b at its published widths on the meta device: the
    reference's ``eval_shape`` shapes and dtypes, and the parameter count
    (2 layers is the card's row)."""
    cj = dataclasses.replace(JC.get_config(ARCH), n_layers=n_layers)
    ct = dataclasses.replace(TC.get_config(ARCH), n_layers=n_layers)
    pt = TR.init_params(P.PRNGKey(0, device="meta"), ct)
    pj = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0), cj))
    lj = jax.tree_util.tree_leaves(pj)
    lt, _ = TTP.tree_flatten(pt)
    assert [tuple(a.shape) for a in lj] == [tuple(b.shape) for b in lt]
    assert [str(a.dtype) for a in lj] == [
        str(b.dtype).replace("torch.", "") for b in lt]
    assert sum(b.numel() for b in lt) == count


def _fake(axis_names, sizes):
    class FakeMesh:
        pass

    m = FakeMesh()
    m.axis_names = tuple(axis_names)
    m.shape = dict(zip(axis_names, sizes))
    return m


@pytest.mark.parametrize("mesh_name,axes", [
    ("pod2x16x16", (("pod", "data", "model"), (2, 16, 16))),
    ("4x2", (("data", "model"), (4, 2)))])
def test_sharding_specs_exact(mesh_name, axes):
    """Every param leaf of pixtral-12b at 2 layers (``vision_proj``
    included) through ``tree_specs`` (fsdp on and off), and the batch
    specs of every input shape (``patch_embeds`` on train and prefill),
    against the reference's ``PartitionSpec`` entries."""
    mesh = _fake(*axes)
    cj = dataclasses.replace(JC.get_config(ARCH), n_layers=2)
    ct = dataclasses.replace(TC.get_config(ARCH), n_layers=2)
    pt = TR.init_params(P.PRNGKey(0, device="meta"), ct)
    shapes = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0), cj))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    for fsdp in (True, False):
        specs, _ = TTP.tree_flatten(TSH.tree_specs(pt, ct, mesh, fsdp=fsdp))
        for (keypath, leaf), got in zip(leaves, specs):
            want = tuple(JSH.param_rules(jax.tree_util.keystr(keypath),
                                         leaf.shape, cj, mesh, fsdp=fsdp))
            assert got == want, (jax.tree_util.keystr(keypath), fsdp)
    for name in JC.INPUT_SHAPES:
        sj, st = JC.INPUT_SHAPES[name], TC.INPUT_SHAPES[name]
        want = {k: tuple(v) for k, v in JSH.batch_specs(cj, sj, mesh).items()}
        got = TSH.batch_specs(ct, st, mesh)
        assert got == want
        assert ("patch_embeds" in got) == (st.kind != "decode")


def test_make_batch_draws_patches():
    """``registry.make_batch`` at a small train shape: the same names and
    shapes, the integer draws Exact and ``patch_embeds`` (float32 normals)
    within 64 ULPs (the normals' ``erfinv``)."""
    cj, ct = _cfgs()
    shape = dataclasses.replace(JC.INPUT_SHAPES["train_4k"], seq_len=8,
                                global_batch=2)
    shape_t = dataclasses.replace(TC.INPUT_SHAPES["train_4k"], seq_len=8,
                                  global_batch=2)
    bj = JR.make_batch(cj, shape, jax.random.PRNGKey(3))
    bt = TR.make_batch(ct, shape_t, P.PRNGKey(3))
    assert sorted(bt) == sorted(bj) == ["labels", "patch_embeds", "tokens"]
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]))
    pe_j, pe_t = np.asarray(bj["patch_embeds"]), bt["patch_embeds"].numpy()
    assert pe_t.shape == (2, 16, 64) and pe_t.dtype == np.float32
    assert np.all(np.abs(pe_t - pe_j) <= 64 * 2.0**-23 * np.abs(pe_j) + 1e-30)


# ---------------------------------------------------------------- bounded


def test_init_params_bounded():
    """``init_params`` from ``PRNGKey(0)`` in bf16: every leaf within 1 bf16
    ULP (2**-7 relative) of the reference's draw, ``vision_proj``
    included."""
    cj, ct = _cfgs()
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
def weights():
    """The reference's reduced params and both configs, float32 and bf16."""
    out = {}
    with jax.threefry_partitionable(True):
        for dtype in ("float32", "bfloat16"):
            cj, ct = _cfgs(dtype=dtype)
            pj = JR.init_params(jax.random.PRNGKey(0), cj)
            pt = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                pj))
            out[dtype] = (cj, ct, pj, pt)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_bounded(weights, dtype):
    """Logits over the tokens only (the prefix cut), and the loss, within
    the dense family's bounds; the aux loss a float32 zero."""
    cj, ct, pj, pt = weights[dtype]
    bj, bt = _both(_batch(cj))
    lj, _ = JR.forward(pj, bj, cj)
    with torch.no_grad():
        lt, auxt = TR.forward(pt, bt, ct)
        losst = TR.loss_fn(pt, bt, ct)
    assert lt.dtype == torch.float32 and lt.shape == (2, 16, 512)
    assert float(auxt) == 0.0
    rel, abs_loss = FWD_BOUNDS[dtype]
    _close(_np(lt), np.asarray(lj), rel, "logits")
    lossj = float(JR.loss_fn(pj, bj, cj))
    assert abs(float(losst) - lossj) <= abs_loss, (float(losst), lossj)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefix_and_its_cut(weights, dtype):
    """The projected prefix, ``patches.astype(dtype) @ vision_proj``,
    within ``PREFIX_REL`` of the reference's einsum; the trunk runs ``P + S`` positions
    and the cut keeps the last ``S`` after the final norm (the port's
    logits equal its own layers run by hand on the concatenation); the
    prefix reaches every token (changing a patch moves each token's
    logits)."""
    cj, ct, pj, pt = weights[dtype]
    b = _batch(cj, 1)
    bj, bt = _both(b)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = _f32(jnp.einsum("bpv,vd->bpd", bj["patch_embeds"].astype(jd),
                           pj["vision_proj"]))
    x = TT._embed_tokens(pt, bt["tokens"], ct)
    proj = torch.matmul(bt["patch_embeds"].to(x.dtype), pt["vision_proj"])
    _close(_np(proj), want, PREFIX_REL[dtype], "prefix")
    with torch.no_grad():
        h = torch.cat([proj, x], dim=1)
        pos = torch.arange(h.shape[1], dtype=torch.int32)[None, :]
        for pl in TT._unstack_layers(pt["layers"], ct.n_layers):
            h = TT._layer(h, pl, ct, pos, ct.sliding_window)
        h = TT.L.rmsnorm(h, pt["final_norm"])[:, ct.n_patches:]
        by_hand = torch.matmul(h, pt["lm_head"]).to(torch.float32)
        logits, _ = TR.forward(pt, bt, ct)
        assert torch.equal(logits, by_hand)
        other = dict(bt, patch_embeds=bt["patch_embeds"].clone())
        other["patch_embeds"][:, 0] += 1.0
        moved, _ = TR.forward(pt, other, ct)
    assert bool(((moved - logits).abs().amax(-1) > 0).all())


def test_gradients_bounded_f32(weights):
    """float32 gradients of ``loss_fn`` through ``steps.value_and_grad``
    (``vision_proj`` included) within ``GRAD_REL`` of each leaf's largest
    entry."""
    cj, ct, pj, pt = weights["float32"]
    bj, bt = _both(_batch(cj, 2))
    lj, gj = jax.value_and_grad(JR.loss_fn)(pj, bj, cj)
    lt, gt = TS.value_and_grad(ct, pt, bt)
    assert abs(float(lt) - float(lj)) <= 2e-6
    lgt, _ = TTP.tree_flatten(gt)
    lgj = jax.tree_util.tree_leaves_with_path(gj)
    assert len(lgt) == len(lgj)
    for (path, a), g in zip(lgj, lgt):
        assert g.dtype == torch.float32
        _close(_np(g), np.asarray(a), GRAD_REL, jax.tree_util.keystr(path))
    assert float(gt["vision_proj"].abs().max()) > 0


def test_prefill_step_with_patches(weights):
    """``make_prefill_step`` on a batch with patches: the forward's last
    token position, bit for bit, and the reference's prefill step within
    the float32 logits bound."""
    cj, ct, pj, pt = weights["float32"]
    b = _batch(cj, 3)
    b.pop("labels")
    bj, bt = _both(b)
    got = TS.make_prefill_step(ct)(pt, bt)
    with torch.no_grad():
        full, _ = TR.forward(pt, bt, ct)
    assert torch.equal(got, full[:, -1])
    want = JST.make_prefill_step(cj)(pj, bj)
    _close(_np(got), np.asarray(want), FWD_BOUNDS["float32"][0], "prefill")


def test_decode_step_bounded(weights):
    """Port decode logits against the reference's on the same weights,
    float32, 5 steps of a full cache (the dense path: no image): within
    2e-6 of the largest."""
    cj, ct, pj, pt = weights["float32"]
    tokens = _batch(cj, 4, s=5)["tokens"]
    cj_cache = JR.init_cache(cj, 2, 5)
    ct_cache = TR.init_cache(ct, 2, 5)
    for t in range(5):
        a, cj_cache = JR.decode_step(pj, cj_cache,
                                     jnp.asarray(tokens[:, t:t + 1]),
                                     jnp.int32(t), cj)
        b, ct_cache = TR.decode_step(pt, ct_cache,
                                     torch.from_numpy(tokens[:, t:t + 1]), t,
                                     ct)
        _close(_np(b), np.asarray(a), 2e-6, f"decode step {t}")


# -------------------------------------------------------------- the trainer


def test_train_step_approx_with_patches_trajectory():
    """``make_train_step_approx`` at a world of one against the reference's
    on a ``(1, 1)`` mesh, layered approx at 20 dB, float32, 3 steps of
    batches that carry ``patch_embeds``: step 0's loss within 2e-6, every
    step within ``TRAJ_TOL``, the same bits on the air."""
    kw = dict(SMALL, dtype="float32")
    cj, ct = _cfgs(**kw)
    tj = JTP.TransportConfig(mode="approx", simulate_fec=False,
                             channel=JCH.ChannelConfig(snr_db=20.0))
    tt = TTP.TransportConfig(mode="approx", simulate_fec=False,
                             channel=TCH.ChannelConfig(snr_db=20.0))
    pj = JR.init_params(jax.random.PRNGKey(0), cj)
    pt = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    oj, ot = jsgd(0.5), tsgd(0.5)
    sj, st = oj.init(pj), ot.init(pt)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    tstep = TS.make_train_step_approx(ct, ot, tt, TM.world_mesh())
    kj, kt = jax.random.PRNGKey(0), P.PRNGKey(0)
    lj_all, lt_all = [], []
    with jax.set_mesh(mesh):
        jstep = jax.jit(JST.make_train_step_approx(cj, oj, tj, mesh))
        for i in range(3):
            b = _batch(cj, 10 + i, b=4, s=16)
            kj, skj = jax.random.split(kj)
            ks = P.split(kt)
            kt, skt = ks[0], ks[1]
            pj, sj, lj, stj = jstep(pj, sj, {k: jnp.asarray(v)
                                             for k, v in b.items()}, skj)
            pt, st, lt, stt = tstep(pt, st, b, skt)
            lj_all.append(float(lj))
            lt_all.append(float(lt))
            assert float(stt.n_bits) == float(stj.n_bits)
    assert abs(lt_all[0] - lj_all[0]) <= 2e-6
    assert max(abs(a - b) for a, b in zip(lj_all, lt_all)) <= TRAJ_TOL, (
        lj_all, lt_all)


def test_train_main_raises_key_error():
    """``train.main --arch pixtral-12b --reduced`` fails in both packages
    on step 0 with ``KeyError: 'patch_embeds'``: ``TokenStream`` yields
    tokens and labels only."""
    argv = ["--arch", ARCH, "--reduced", "--steps", "1", "--mode", "approx",
            "--batch", "2", "--seq", "8"]
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(KeyError, match="patch_embeds"):
            JTR.main(argv)
        with pytest.raises(KeyError, match="patch_embeds"):
            TTR.main(argv + ["--device", "cpu"])
