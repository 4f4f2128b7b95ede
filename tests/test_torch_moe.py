"""The port's moe family against the reference's (``models/moe.py`` and the
moe branch of ``models/transformer.py``).

Grades, as the ROADMAP defines them:

* **Exact**: ``capacity`` over a grid of token counts; the routing of
  ``_local_dispatch`` (the scatter buffer ``buf``, and ``se``, ``st``,
  ``slot_c`` of every assignment, hence the dropped set) on the same
  weights and inputs, float32 and bf16, with ties toward the lower expert
  index on equal router columns; the combine's update order against the
  reference's scatter-add at top-8 in bf16; ``init_cache``'s keys and
  shapes; the ``init_params`` tree and shapes (reduced, and phi3.5-moe at
  its published widths on the meta device, 1,562,980,352 parameters at
  one layer); the sharding rules of both moe configs (in
  ``test_torch_launch.py``).
* **Near ties**: the router matmul and softmax agree only to rounding, so
  a token whose ``K``-th and ``K+1``-th probabilities lie within
  ``NEAR_TIE`` (relative) of each other may route to the other expert in
  the two packages. The routing is held Exact where the reference's
  probabilities have no such token, and every input here is checked to
  have none.
* **Bounded** (bound in each test): the routing weights ``sw`` (a
  division of router probabilities, a few float32 ULP); ``moe_ffn``'s
  output and aux loss; its gradients in float32; ``init_params`` leaves (1
  bf16 ULP, 64 float32 ULP for the router); ``forward``, ``loss_fn`` and
  the gradients with the dense family's bounds; ``decode_step``.
  The expert products sum in another order, and in bf16 the jitted
  reference keeps some products in float32.
* **Trajectory**: ``launch/train.py::main --arch phi3.5-moe-42b-a6.6b
  --reduced`` against the reference's, within ``TRAJ_TOL``.
* Inside the port: decode equals the training forward at every prompt
  position when ``capacity_factor = n_experts / top_k`` (no token is
  dropped); ``moe_impl="expert_parallel"`` outside a data-parallel scope
  is the dense dispatch, bit for bit (over ranks: ``test_torch_moe_ep.py``).

The arithmetic copied from XLA, checked against the jitted reference: the
aux loss's means multiply by the float32 reciprocal of the token count,
the weights' ``topv / sum(topv)`` stays a division, and the combine's
``y * sw`` is rounded before its add (no fma).

Sizes: ``tests/test_moe.py::_tiny_cfg``'s widths for the FFN (d_model 32,
moe_d_ff 16, 4 experts, top-2), and 2 layers at d_model 64 for the model.
"""

import contextlib
import dataclasses
import io
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.launch import serve as JSV  # noqa: E402
from repro.launch import train as JTR  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.core.transport import tree_flatten, tree_unflatten  # noqa: E402,E501
from repro_torch.launch import serve as TSV  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as TTR  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

PHI, KIMI = "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"
MOE = [PHI, KIMI]
TINY = dict(d_model=32, moe_d_ff=16, n_experts=4, top_k=2)
SMALL = dict(n_layers=2, d_model=64, vocab_size=128, moe_d_ff=64)
NEAR_TIE = 1e-6
# (logits rel, loss abs), the dense family's bounds (test_torch_models.py)
FWD_BOUNDS = {"float32": (2e-6, 2e-6), "bfloat16": (3e-2, 1e-2)}
# moe_ffn output, relative to its largest entry: float32 sums in another
# order; bf16 rounds each product (2 bf16 ULPs of the largest)
FFN_BOUNDS = {"float32": 2e-6, "bfloat16": 2 * 2.0**-7}
TRAJ_TOL = 0.25


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


def _cfgs(arch=PHI, base=TINY, **kw):
    kw = dict(base, **kw)
    return JC.get_config(arch).reduced(**kw), TC.get_config(arch).reduced(**kw)


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy()


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rel, what):
    """``|got - want| <= rel * max|want|`` everywhere."""
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def _ffn_case(cj, ct, dtype, seed, T=64):
    """The reference's ``init_moe`` weights carried across, and ``(T, D)``
    numpy-seeded inputs, in both packages."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    pj = JM.init_moe(jax.random.PRNGKey(seed), cj, jdt)
    pt = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    x = np.random.default_rng(100 + seed).standard_normal(
        (T, cj.d_model)).astype(np.float32)
    return pj, pt, jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _no_near_tie(xj, pj, cfg):
    """Assert the reference's router has no token whose ``K``-th and
    ``K+1``-th probabilities are within ``NEAR_TIE`` of each other."""
    probs = np.asarray(jax.nn.softmax(xj.astype(jnp.float32) @ pj["router"],
                                      axis=-1))
    s = -np.sort(-probs, axis=-1)
    k = cfg.top_k
    if k < s.shape[-1]:
        gap = s[:, k - 1] - s[:, k]
        ties = (gap > 0) & (gap <= NEAR_TIE * s[:, k - 1])
        assert not ties.any(), np.nonzero(ties)


def _dispatch_pair(xj, pj, cj, xt, pt, ct):
    C = JM.capacity(xj.shape[0], cj)
    dj = jax.jit(lambda x, p: JM._local_dispatch(x, p, cj, C))(xj, pj)
    dt = TM._local_dispatch(xt, pt, ct, C)
    return C, dj, dt


def _routing_exact(dj, dt):
    """``buf``, ``se``, ``st``, ``slot_c`` Exact; ``sw`` within 4 float32
    ULP of 1 (its largest possible value); aux within 1e-6."""
    bj, sej, slj, stj, swj, auxj = dj
    bt, set_, slt, stt, swt, auxt = dt
    np.testing.assert_array_equal(_np(bt), _f32(bj))
    assert bt.dtype == getattr(torch, str(bj.dtype))
    for a, b in ((sej, set_), (slj, slt), (stj, stt)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert float(np.abs(_np(swt) - np.asarray(swj)).max()) <= 4 * 2.0**-23
    assert abs(float(auxt) - float(auxj)) <= 1e-6


# --------------------------------------------------------------- capacity


@pytest.mark.parametrize("arch,factor", [(PHI, 1.5), (PHI, 0.25),
                                         (KIMI, 1.5), (PHI, 8.0)])
def test_capacity_exact(arch, factor):
    cj, ct = JC.get_config(arch), TC.get_config(arch)
    cj, ct = (dataclasses.replace(c, capacity_factor=factor) for c in (cj, ct))
    for T in [1, 2, 3, 4, 7, 8, 9, 31, 64, 100, 385, 2048, 4096, 10**6]:
        assert TM.capacity(T, ct) == JM.capacity(T, cj), T


# ---------------------------------------------------------------- moe_ffn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_ffn_bounded_routing_exact(dtype, seed):
    """``moe_ffn`` at the reference test's widths, 64 tokens, the
    configs' capacity factor (1.5): routing Exact, output within
    ``FFN_BOUNDS`` of the jitted reference, aux within 1e-6."""
    cj, ct = _cfgs()
    pj, pt, xj, xt = _ffn_case(cj, ct, dtype, seed)
    _no_near_tie(xj, pj, cj)
    _, dj, dt = _dispatch_pair(xj, pj, cj, xt, pt, ct)
    _routing_exact(dj, dt)
    oj, auxj = jax.jit(lambda x, p: JM.moe_ffn(x, p, cj))(xj, pj)
    ot, auxt = TM.moe_ffn(xt, pt, ct)
    assert ot.dtype == xt.dtype and ot.shape == xt.shape
    assert auxt.dtype == torch.float32 and auxt.shape == ()
    _close(_np(ot), _f32(oj), FFN_BOUNDS[dtype], "moe_ffn out")
    assert abs(float(auxt) - float(auxj)) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forced_drops_exact(dtype):
    """``capacity_factor`` 0.25 over 64 tokens (capacity 9 of about 32
    assignments an expert): the dropped set (``slot_c == C``) and every
    kept slot Exact, the output Bounded; a dropped assignment adds 0."""
    cj, ct = _cfgs(capacity_factor=0.25)
    pj, pt, xj, xt = _ffn_case(cj, ct, dtype, 3)
    _no_near_tie(xj, pj, cj)
    C, dj, dt = _dispatch_pair(xj, pj, cj, xt, pt, ct)
    assert C == 9
    _routing_exact(dj, dt)
    dropped = dt[2] == C
    assert 0 < int(dropped.sum()) < dropped.numel()
    oj, _ = jax.jit(lambda x, p: JM.moe_ffn(x, p, cj))(xj, pj)
    ot, _ = TM.moe_ffn(xt, pt, ct)
    _close(_np(ot), _f32(oj), FFN_BOUNDS[dtype], "moe_ffn out with drops")
    # a token all of whose assignments dropped gets exactly 0
    none_kept = torch.ones(64, dtype=torch.bool)
    none_kept[dt[3][~dropped]] = False
    assert bool(none_kept.any()) and not bool(ot[none_kept].any())


def test_tied_router_columns_exact():
    """Router columns 0, 1 and 2 equal: each token's three equal
    probabilities tie exactly in both packages, and both pick the lower
    indices (``lax.top_k``'s rule, the port's stable sort)."""
    cj, ct = _cfgs()
    pj, pt, xj, xt = _ffn_case(cj, ct, "float32", 4)
    r = np.asarray(pj["router"]).copy()
    r[:, 1] = r[:, 0]
    r[:, 2] = r[:, 0]
    pj = dict(pj, router=jnp.asarray(r))
    pt = dict(pt, router=torch.from_numpy(r))
    _, dj, dt = _dispatch_pair(xj, pj, cj, xt, pt, ct)
    _routing_exact(dj, dt)
    experts = {t: [] for t in range(64)}
    for t, e in zip(dt[3].tolist(), dt[1].tolist()):
        experts[t].append(e)
    assert {tuple(sorted(v)) for v in experts.values()} == {(0, 1), (0, 3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_update_order_exact(dtype):
    """The combine at top-8 (kimi-k2's K), where the order of the adds
    matters: the port's ``_combine`` equals the reference's
    ``zeros.at[st].add(y * sw)`` (eager and jitted) bit for bit."""
    T, K, D = 96, 8, 16
    rng = np.random.default_rng(7)
    e = np.stack([rng.permutation(24)[:K] for _ in range(T)])  # (T, K)
    flat_e = e.reshape(-1)
    order = np.argsort(flat_e, kind="stable")
    st = np.repeat(np.arange(T), K)[order]
    y = rng.standard_normal((T * K, D)).astype(np.float32) * np.exp2(
        rng.integers(-6, 6, (T * K, 1))).astype(np.float32)
    sw = rng.random(T * K).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    yj, swj = jnp.asarray(y).astype(jdt), jnp.asarray(sw)

    def ref(yj, swj, st):
        return jnp.zeros((T, D), jdt).at[st].add(yj * swj[:, None].astype(jdt))

    want = [ref(yj, swj, jnp.asarray(st)),
            jax.jit(ref)(yj, swj, jnp.asarray(st))]
    yt = torch.from_numpy(y).to(getattr(torch, dtype))
    contrib = yt * torch.from_numpy(sw)[:, None].to(yt.dtype)
    got = TM._combine(contrib, torch.from_numpy(st), T, K, yt.dtype)
    for w in want:
        np.testing.assert_array_equal(_np(got), _f32(w))


def test_kimi_shared_expert_bounded():
    """kimi-k2 at ``cfg.reduced()`` widths (4 experts, top-2, a shared
    expert): routing Exact, output within 2e-6 of the largest in float32."""
    cj, ct = _cfgs(KIMI, base={})
    assert ct.n_shared_experts == 1
    pj, pt, xj, xt = _ffn_case(cj, ct, "float32", 5, T=48)
    assert set(pt) == {"router", "wi", "wg", "wo", "shared"}
    _no_near_tie(xj, pj, cj)
    _, dj, dt = _dispatch_pair(xj, pj, cj, xt, pt, ct)
    _routing_exact(dj, dt)
    oj, auxj = jax.jit(lambda x, p: JM.moe_ffn(x, p, cj))(xj, pj)
    ot, auxt = TM.moe_ffn(xt, pt, ct)
    _close(_np(ot), _f32(oj), FFN_BOUNDS["float32"], "kimi moe_ffn")
    assert abs(float(auxt) - float(auxj)) <= 1e-6


@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_grads_bounded(arch):
    """Gradients of ``sum(out * r) + aux`` in float32 with respect to the
    input and every weight, against ``jax.grad``: within 1e-5 of each
    leaf's largest entry."""
    cj, ct = _cfgs(arch, base=TINY if arch == PHI else {})
    pj, pt, xj, xt = _ffn_case(cj, ct, "float32", 6, T=40)
    _no_near_tie(xj, pj, cj)
    r = np.random.default_rng(8).standard_normal(xj.shape).astype(np.float32)

    def fj(x, p):
        out, aux = JM.moe_ffn(x, p, cj)
        return jnp.sum(out * r) + aux

    gxj, gpj = jax.jit(jax.grad(fj, argnums=(0, 1)))(xj, pj)
    leaves, spec = tree_flatten(pt)
    req = [t.clone().requires_grad_() for t in [xt] + leaves]
    out, aux = TM.moe_ffn(req[0], tree_unflatten(spec, req[1:]), ct)
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(r)) + aux, req)
    want = [gxj] + jax.tree_util.tree_leaves(gpj)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(_np(g), np.asarray(w), 1e-5, "grad")


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("arch", MOE)
def test_moe_families_run(arch):
    """The registry runs both moe configs: ``family_module`` is the
    transformer and ``init_params`` builds the reduced tree."""
    cfg = TC.get_config(arch).reduced()
    assert TR.family_module(cfg) is TT
    params = TR.init_params(P.PRNGKey(0), cfg)
    assert "router" in params["layers"]["moe"]
    assert ("dense_layers" in params) == bool(cfg.first_dense_layers)


def test_expert_parallel_raises():
    """``moe_impl="expert_parallel"`` (the reference's
    ``moe_ffn_shardmap``) no longer raises: outside an ``expert_group``
    scope, and in a world of one, every model entry point runs the dense
    dispatch, bit for bit (its exchange over ranks is held in
    ``test_torch_moe_ep.py``)."""
    dense = TC.get_config(PHI).reduced()
    cfg = dataclasses.replace(dense, moe_impl="expert_parallel")
    params = TR.init_params(P.PRNGKey(0), cfg)
    want = TR.init_params(P.PRNGKey(0), dense)
    for a, b in zip(tree_flatten(params)[0], tree_flatten(want)[0]):
        assert torch.equal(a, b)
    tokens = torch.randint(0, dense.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(0),
                           dtype=torch.int64).to(torch.int32)
    for c in (cfg, dense):
        assert TR.family_module(c) is TT
    for scope in (contextlib.nullcontext(), TM.expert_group(None)):
        with scope:
            got = TR.forward(params, {"tokens": tokens}, cfg)
        ref = TR.forward(params, {"tokens": tokens}, dense)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    cache = TR.init_cache(cfg, 2, 8)
    ref_cache = TR.init_cache(dense, 2, 8)
    for a, b in zip(tree_flatten(cache)[0], tree_flatten(ref_cache)[0]):
        assert torch.equal(a, b)
    got, _ = TR.decode_step(params, cache, tokens[:, :1], 0, cfg)
    ref, _ = TR.decode_step(params, ref_cache, tokens[:, :1], 0, dense)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("arch", MOE)
def test_init_params_bounded(arch):
    """``cfg.reduced()``: the same tree, shapes and dtypes; leaves within
    1 bf16 ULP (2**-7 relative), the float32 router within 64 ULP (the
    normals' ``erfinv`` spread)."""
    cj, ct = JC.get_config(arch).reduced(), TC.get_config(arch).reduced()
    pj = JR.init_params(jax.random.PRNGKey(0), cj)
    pt = TR.init_params(P.PRNGKey(0), ct)
    lj = jax.tree_util.tree_leaves_with_path(pj)
    lt, _ = tree_flatten(pt)
    assert len(lj) == len(lt)
    for (path, a), b in zip(lj, lt):
        name = jax.tree_util.keystr(path)
        assert tuple(a.shape) == tuple(b.shape), name
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), name
        ulp = 64 * 2.0**-23 if "router" in name else 2.0**-7
        err = np.abs(_f32(a) - _np(b))
        assert np.all(err <= ulp * np.abs(_f32(a)) + 1e-30), name


def test_full_width_tree_matches_reference():
    """phi3.5-moe at its published widths, one layer, on the meta device:
    the reference's ``eval_shape`` tree and 1,562,980,352 parameters (the
    card's row)."""
    cj = dataclasses.replace(JC.get_config(PHI), n_layers=1)
    ct = dataclasses.replace(TC.get_config(PHI), n_layers=1)
    pt = TR.init_params(P.PRNGKey(0, device="meta"), ct)
    pj = jax.eval_shape(lambda: JR.init_params(jax.random.PRNGKey(0), cj))
    lj = jax.tree_util.tree_leaves(pj)
    lt, _ = tree_flatten(pt)
    assert [tuple(a.shape) for a in lj] == [tuple(b.shape) for b in lt]
    assert [str(a.dtype) for a in lj] == [
        str(b.dtype).replace("torch.", "") for b in lt]
    assert sum(b.numel() for b in lt) == 1_562_980_352


@pytest.fixture(scope="module")
def weights():
    """The reference's params and both packages' configs at 2 layers,
    d_model 64: phi3.5-moe float32 and bf16, kimi-k2 float32 (one dense
    layer, one moe layer with a shared expert)."""
    out = {}
    with jax.threefry_partitionable(True):
        for arch, dtype in ((PHI, "float32"), (PHI, "bfloat16"),
                            (KIMI, "float32")):
            cj, ct = _cfgs(arch, base=SMALL, dtype=dtype)
            pj = JR.init_params(jax.random.PRNGKey(0), cj)
            pt = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                pj))
            out[arch, dtype] = (cj, ct, pj, pt)
    return out


def _batch(seed=0, b=2, s=16, vocab=128):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}


@pytest.mark.parametrize("arch,dtype", [(PHI, "float32"), (PHI, "bfloat16"),
                                        (KIMI, "float32")])
def test_forward_and_loss_bounded(weights, arch, dtype):
    """Logits within the dense family's bounds, the aux loss (summed over
    the moe layers) within 1e-6 in float32 and 1e-3 in bf16, the loss
    (with ``aux_loss_coef * aux``) within the dense bound."""
    cj, ct, pj, pt = weights[arch, dtype]
    b = _batch()
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    lj, auxj = JR.forward(pj, bj, cj)
    with torch.no_grad():
        lt, auxt = TR.forward(pt, bt, ct)
        losst = TR.loss_fn(pt, bt, ct)
    assert lt.dtype == torch.float32 and lt.shape == (2, 16, 128)
    assert auxt.dtype == torch.float32 and float(auxt) > 0
    assert abs(float(auxt) - float(auxj)) <= (1e-6 if dtype == "float32"
                                              else 1e-3)
    rel, abs_loss = FWD_BOUNDS[dtype]
    _close(_np(lt), np.asarray(lj), rel, "logits")
    lossj = float(JR.loss_fn(pj, bj, cj))
    assert abs(float(losst) - lossj) <= abs_loss, (float(losst), lossj)


@pytest.mark.parametrize("arch", MOE)
def test_gradients_bounded_f32(weights, arch):
    """float32 gradients of ``loss_fn`` (aux included) within 1e-5 of each
    leaf's largest entry, through ``steps.value_and_grad`` (each layer
    under checkpoint)."""
    cj, ct, pj, pt = weights[arch, "float32"]
    b = _batch(1)
    lj, gj = jax.value_and_grad(JR.loss_fn)(
        pj, {k: jnp.asarray(v) for k, v in b.items()}, cj)
    lt, gt = TS.value_and_grad(ct, pt, {k: torch.from_numpy(v) for k, v in
                                        b.items()})
    assert abs(float(lt) - float(lj)) <= 2e-6
    lgt, _ = tree_flatten(gt)
    lgj = jax.tree_util.tree_leaves_with_path(gj)
    assert len(lgt) == len(lgj)
    for (path, a), g in zip(lgj, lgt):
        assert g.dtype == torch.float32
        _close(_np(g), np.asarray(a), 1e-5, jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", MOE)
def test_init_cache_exact(arch):
    """Keys, shapes and dtypes of ``init_cache``: ``k`` / ``v`` over the
    moe layers, ``dk`` / ``dv`` over the leading dense ones."""
    cj, ct = JC.get_config(arch).reduced(), TC.get_config(arch).reduced()
    a = JR.init_cache(cj, 3, 24)
    b = TR.init_cache(ct, 3, 24)
    assert sorted(a) == sorted(b)
    assert ("dk" in b) == bool(ct.first_dense_layers)
    for k in a:
        assert tuple(a[k].shape) == tuple(b[k].shape), k
        assert str(a[k].dtype) == str(b[k].dtype).replace("torch.", "")
        assert not bool(b[k].any())


@pytest.mark.parametrize("arch", MOE)
def test_decode_step_bounded(weights, arch):
    """Port decode logits against the reference's on the same weights,
    float32, 5 steps of a full cache: within 2e-6 of the largest."""
    cj, ct, pj, pt = weights[arch, "float32"]
    tokens = _batch(2, s=5)["tokens"]
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
    assert sorted(ct_cache) == sorted(cj_cache)


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_forward_no_drop(weights, arch):
    """Decode over 12 tokens equals the training forward at every
    position (float32, within 1e-5 of the largest logit) once
    ``capacity_factor = n_experts / top_k``, so that the forward's
    ``capacity(T) == T`` drops no token (a decode step routes ``B``
    tokens and never drops)."""
    _, ct, _, pt = weights[arch, "float32"]
    ct = dataclasses.replace(ct, capacity_factor=ct.n_experts / ct.top_k)
    assert TM.capacity(2 * 12, ct) == 2 * 12
    tokens = torch.from_numpy(_batch(3, s=12)["tokens"])
    with torch.no_grad():
        ref, _ = TR.forward(pt, {"tokens": tokens}, ct)
    cache = TR.init_cache(ct, 2, 12)
    outs = []
    for t in range(12):
        lg, cache = TR.decode_step(pt, cache, tokens[:, t:t + 1], t, ct)
        outs.append(lg[:, 0])
    _close(_np(torch.stack(outs, dim=1)), _np(ref), 1e-5, "decode")


# ---------------------------------------------------------------- trainer


class _Small:
    """A config whose ``reduced(...)`` is this file's small widths, so the
    drivers' ``--reduced`` runs at them."""

    def __init__(self, cfg):
        self.cfg = cfg

    def reduced(self, **kw):
        return self.cfg.reduced(**SMALL)


def test_train_main_trajectory():
    """``train.main --arch phi3.5-moe-42b-a6.6b --reduced --steps 3 --mode
    approx`` (both drivers' ``--reduced`` pointed at the small widths) at
    20 dB: the printed losses within ``TRAJ_TOL``, step 0 within 1e-2
    (bf16 weights), the parameter count of the same tree.

    The reference's ``main`` builds its ``(1, 1)`` mesh with explicit axes
    on jax 0.9.0, under which its ``moe_ffn`` raises (``jnp.repeat`` asks
    for ``out_sharding``; ROADMAP Queue 3), so here it builds the mesh with
    ``Auto`` axes: the same step, keys and batches."""
    argv = ["--arch", PHI, "--reduced", "--steps", "3", "--mode", "approx",
            "--batch", "2", "--seq", "16", "--snr-db", "20"]
    make_mesh = jax.make_mesh

    def auto_mesh(shape, names):
        auto = jax.sharding.AxisType.Auto
        return make_mesh(shape, names, axis_types=(auto,) * len(names))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTR, "get_config", lambda a: _Small(JC.get_config(a)))
        mp.setattr(TTR, "get_config", lambda a: _Small(TC.get_config(a)))
        mp.setattr(jax, "make_mesh", auto_mesh)
        out_j, out_t = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out_j):
            lj = JTR.main(argv)
        with contextlib.redirect_stdout(out_t):
            lt = TTR.main(argv + ["--device", "cpu"])
    a = [float(m) for m in re.findall(r"loss (\S+)", out_j.getvalue())]
    b = [float(m) for m in re.findall(r"loss (\S+)", out_t.getvalue())]
    assert len(a) == len(b) == 3
    assert abs(a[0] - b[0]) <= 1e-2
    assert max(abs(x - y) for x, y in zip(a, b)) <= TRAJ_TOL, (a, b)
    assert abs(lt - lj) <= TRAJ_TOL
    count = re.compile(r"\(reduced\): (\S+)M params")
    assert count.findall(out_t.getvalue()) == count.findall(out_j.getvalue())


def test_serve_main_greedy_tokens():
    """``serve.main --arch phi3.5-moe-42b-a6.6b --reduced`` (bf16, full
    cache, batch 2, 8 prompt + 6 generated tokens) beside the reference's
    ``serve.main``: the prompt is the reference's draw (Exact), and each
    greedy token is one the reference's decode, fed the port's tokens,
    ranks within the bf16 forward bound (3e-2 of its largest logit) of
    its own argmax. The tokens themselves are not Exact: a random
    model's top logits lie within bf16 rounding of each other, and the
    jitted reference keeps some bf16 products in float32."""
    args = ["--arch", PHI, "--batch", "2", "--prompt-len", "8", "--gen", "6"]
    with contextlib.redirect_stdout(io.StringIO()):
        prompt, gen, _ = TSV.main(args + ["--reduced", "--device", "cpu"])
        JSV.main(args)
    assert tuple(gen.shape) == (2, 6)
    cfg = JC.get_config(PHI).reduced()
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
