"""The port's transport layer against the reference's, on the kernel path.

``transmit_flat`` / ``transmit_batch`` / ``transmit_batch_aggregate`` and
the pytree front-ends must reproduce the reference's key schedule, seeds,
payload bits and ``TxStats``. Payload bits are Exact at noise 0 and
Bounded with noise (a word may differ only where a demod pre-round value
sits within ``EDGE`` of a half-integer; see ``test_torch_kernels.py``).
Pytrees flatten in sorted-key order, as ``jax.tree_util`` does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import channel as JCH  # noqa: E402
from repro.core import transport as JT  # noqa: E402
from repro_torch.core import aggregation as TA  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.core import transport as TT  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

EDGE = 1e-4
M, D = 4, 3000
STAT_FIELDS = ("data_symbols", "transmissions", "n_bits", "bits_on_air")


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


def _cfgs(mode="approx", snr_db=10.0, **kw):
    j = JT.TransportConfig(mode=mode, use_kernel=mode != "perfect",
                           channel=JCH.ChannelConfig(snr_db=snr_db), **kw)
    t = TT.TransportConfig(mode=mode, use_kernel=mode != "perfect",
                           channel=TCH.ChannelConfig(snr_db=snr_db), **kw)
    return j, t


def _payload(seed=0, shape=(M, D)):
    return np.random.default_rng(seed).uniform(-0.9, 0.9, shape).astype(
        np.float32)


def _edges(x, key, cfg, snr_db=None):
    """Per-word decision-edge distances of the port's batch uplink."""
    c, n = x.shape
    bw = 1024
    xp = torch.nn.functional.pad(torch.from_numpy(x), (0, (-n) % bw))
    wb, mask, k = TT._transport_kernel_params(cfg)
    if wb == 16:
        xp = xp.to(torch.bfloat16)
    seeds = TO._seed_from_key(TT.client_keys(key, c))
    npow, gains = TT._link_params(cfg, c, snr_db, torch.device("cpu"))
    _, _, edges = TR.approx_channel_batch_ref(
        xp, seeds, npow, gains, bits_per_symbol=k, fading=cfg.channel.fading,
        fade_block=cfg.channel.block_len, clamp_mask=mask, word_bits=wb,
        with_edges=True)
    return edges[:, :n].numpy()


def _check_bits(ref, got, edges):
    """Bit-equal words, except where a decision edge allows a flip; two
    NaNs count as equal (a bf16 -> f32 upcast in XLA canonicalizes NaN
    payloads, PyTorch's keeps them)."""
    ref, got = np.asarray(ref), got.numpy()
    diff = (ref.view(np.uint32) != got.view(np.uint32)) & ~(
        np.isnan(ref) & np.isnan(got))
    assert np.all(edges[diff] < EDGE)
    return int(diff.sum())


def _check_stats(js, ts, exact_errors):
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(ts, f).numpy())
    if exact_errors:
        np.testing.assert_array_equal(np.asarray(js.bit_errors),
                                      ts.bit_errors.numpy())


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["approx", "naive"])
@pytest.mark.parametrize("modulation", ["qpsk", "256qam"])
def test_transmit_batch_vs_reference(mode, wire, modulation):
    jc, tc = _cfgs(mode, modulation=modulation, wire_dtype=wire)
    x = _payload()
    xr, sr = JT.transmit_batch(jnp.asarray(x), jax.random.PRNGKey(4), jc)
    xt, st = TT.transmit_batch(torch.from_numpy(x), P.PRNGKey(4), tc,
                               device="cpu")
    assert xt.dtype == torch.float32 and xt.shape == (M, D)
    n_diff = _check_bits(xr, xt, _edges(x, P.PRNGKey(4), tc))
    _check_stats(sr, st, n_diff == 0)


def test_transmit_batch_noiseless_exact():
    jc, tc = _cfgs("approx", snr_db=300.0, modulation="16qam")
    x = _payload(1)
    xr, sr = JT.transmit_batch(jnp.asarray(x), jax.random.PRNGKey(2), jc)
    xt, st = TT.transmit_batch(torch.from_numpy(x), P.PRNGKey(2), tc,
                               device="cpu")
    np.testing.assert_array_equal(np.asarray(xr).view(np.uint32),
                                  xt.numpy().view(np.uint32))
    _check_stats(sr, st, True)
    assert not st.bit_errors.any()


def test_per_client_snr_override():
    jc, tc = _cfgs("approx")
    x = _payload(2)
    snr = np.array([0.0, 5.0, 10.0, 20.0], np.float32)
    xr, sr = JT.transmit_batch(jnp.asarray(x), jax.random.PRNGKey(8), jc,
                               snr_db=jnp.asarray(snr))
    xt, st = TT.transmit_batch(torch.from_numpy(x), P.PRNGKey(8), tc,
                               snr_db=snr, device="cpu")
    np.testing.assert_allclose(
        np.asarray(JCH.noise_power_for(jc.channel, jnp.asarray(snr))),
        TCH.noise_power_for(tc.channel, snr).numpy(), rtol=2e-7)
    _check_bits(xr, xt, _edges(x, P.PRNGKey(8), tc, snr))
    _check_stats(sr, st, False)
    with pytest.raises(ValueError, match="clients"):
        TT.transmit_batch(torch.from_numpy(x), P.PRNGKey(8), tc,
                          snr_db=[1.0, 2.0], device="cpu")


def test_transmit_flat_vs_reference_and_batch_row():
    jc, tc = _cfgs("approx", modulation="16qam")
    x = _payload(3, (1, 2500))
    key = jax.random.PRNGKey(6)
    xr, sr = JT.transmit_flat(jnp.asarray(x[0]), jax.random.fold_in(key, 0),
                              jc)
    kt = P.fold_in(P.PRNGKey(6), 0)
    xt, st = TT.transmit_flat(torch.from_numpy(x[0]), kt, tc, device="cpu")
    _check_bits(xr, xt, _edges(x, P.PRNGKey(6), tc)[0])
    for f in STAT_FIELDS:
        assert float(getattr(sr, f)) == float(getattr(st, f))
    # a batch row is the single-client call with that client's key
    xb, sb = TT.transmit_batch(torch.from_numpy(x), P.PRNGKey(6), tc,
                               device="cpu")
    np.testing.assert_array_equal(xb[0].numpy().view(np.uint32),
                                  xt.numpy().view(np.uint32))
    assert float(sb.bit_errors[0]) == float(st.bit_errors)


def test_perfect_mode_identity():
    jc, tc = _cfgs("perfect")
    x = _payload(4)
    xr, sr = JT.transmit_batch(jnp.asarray(x), jax.random.PRNGKey(0), jc)
    xt, st = TT.transmit_batch(torch.from_numpy(x), P.PRNGKey(0), tc,
                               device="cpu")
    np.testing.assert_array_equal(xt.numpy(), x)
    _check_stats(sr, st, True)
    w = TA.normalize_weights(torch.ones(M))
    agg, _ = TT.transmit_batch_aggregate(torch.from_numpy(x), P.PRNGKey(0),
                                         tc, w, device="cpu")
    np.testing.assert_array_equal(
        agg.numpy(), TA.fedsgd_aggregate_batch(torch.from_numpy(x), w).numpy())


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_transmit_batch_aggregate_vs_reference_and_layered(wire):
    jc, tc = _cfgs("approx", wire_dtype=wire)
    x = _payload(5)
    w = np.full(M, 1.0 / M, np.float32)  # exact products at M = 4
    ar, sr = JT.transmit_batch_aggregate(jnp.asarray(x),
                                         jax.random.PRNGKey(9), jc,
                                         jnp.asarray(w))
    at, st = TT.transmit_batch_aggregate(torch.from_numpy(x), P.PRNGKey(9),
                                         tc, torch.from_numpy(w),
                                         device="cpu")
    calm = np.all(_edges(x, P.PRNGKey(9), tc) >= EDGE, axis=0)
    np.testing.assert_array_equal(np.asarray(ar).view(np.uint32)[calm],
                                  at.numpy().view(np.uint32)[calm])
    _check_stats(sr, st, bool(calm.all()))
    # fused == layered inside the port, bit for bit
    xt, sl = TT.transmit_batch(torch.from_numpy(x), P.PRNGKey(9), tc,
                               device="cpu")
    lay = TA.fedsgd_aggregate_batch(xt, torch.from_numpy(w))
    np.testing.assert_array_equal(at.numpy().view(np.uint32),
                                  lay.numpy().view(np.uint32))
    np.testing.assert_array_equal(st.bit_errors.numpy(),
                                  sl.bit_errors.numpy())


def _tree(seed):
    """A client tree whose insertion order is not sorted."""
    rng = np.random.default_rng(seed)
    return {
        "fc2_w": rng.uniform(-1, 1, (M, 6, 3)).astype(np.float32),
        "conv1_b": rng.uniform(-1, 1, (M, 5)).astype(np.float32),
        "fc1_w": rng.uniform(-1, 1, (M, 40, 6)).astype(np.float32),
        "conv1_w": rng.uniform(-1, 1, (M, 5, 1, 3, 3)).astype(np.float32),
    }


def test_pytree_flatten_order_is_sorted_keys():
    tree = _tree(0)
    leaves, _ = TT.tree_flatten(
        {k: torch.from_numpy(v) for k, v in tree.items()})
    flat, _ = TT.pack(leaves, 1)
    ref, _ = JT._flatten_client_tree({k: jnp.asarray(v)
                                      for k, v in tree.items()})
    np.testing.assert_array_equal(np.asarray(ref), flat.numpy())


def _wire_tree(kind, dtypes, lead, whole, seed=0):
    """A tree of ``lead``-prefixed leaves: ``dict`` (unsorted keys) or
    ``list`` (the hybrid family's ``tail``: a list of layer dicts); the
    leaves' dtypes cycle through ``dtypes``. ``whole`` sizes the row to
    exactly two tiles."""
    g = torch.Generator().manual_seed(seed)
    shapes = [(37, 11), (5,), (), (3, 4)]
    shapes.append((2048 - sum(int(np.prod(s)) for s in shapes),) if whole
                  else (700,))
    leaves = [torch.randn(lead + s, generator=g).to(dtypes[i % len(dtypes)])
              for i, s in enumerate(shapes)]
    if kind == "dict":
        return dict(zip(["w", "b_half", "s", "a", "z"], leaves))
    return {"embed": leaves[0],
            "tail": [{"wi": leaves[1], "norm": leaves[2]},
                     {"wi": leaves[3], "norm": leaves[4]}]}


@pytest.mark.parametrize("whole", [False, True], ids=["ragged", "whole"])
@pytest.mark.parametrize("pad_to", [1, 1024])
@pytest.mark.parametrize("kind", ["dict", "list"])
@pytest.mark.parametrize("dtypes", [(torch.float32,), (torch.bfloat16,),
                                    (torch.float32, torch.bfloat16)],
                         ids=["f32", "bf16", "mixed"])
@pytest.mark.parametrize("lead", ["none", "clients", "shard"])
def test_pack_unpack_match_cat_and_pad(lead, dtypes, kind, pad_to, whole):
    """``pack`` and ``unpack`` against the concatenation, ``F.pad`` and
    split loops they replace, bit for bit: one tree (lead 0), a client
    tree (lead 1), and shard blocks (strided views of the leaves, as
    ``corrupt_per_shard`` sends them)."""
    tree = _wire_tree(kind, dtypes, (3,) if lead == "clients" else (6, 5)
                      if lead == "shard" else (), whole)
    leaves, _ = TT.tree_flatten(tree)
    if lead == "shard":
        leaves = [l[2:5, 1:4] for l in leaves]
    k = 1 if lead == "clients" else 0
    pre = tuple(leaves[0].shape[:k])
    flat = torch.cat([l.reshape(pre + (-1,)).to(torch.float32)
                      for l in leaves], dim=-1)
    d = flat.shape[-1]
    want = torch.nn.functional.pad(flat, (0, (-d) % pad_to))
    row, n = TT.pack(leaves, k, pad_to)
    assert n == d and row.dtype == torch.float32 and row.is_contiguous()
    assert row.shape == want.shape and torch.equal(row, want)
    assert (row.shape[-1] == d) == (pad_to == 1 or whole)

    def split(r, dims, cast):
        out, off = [], 0
        for l in leaves:
            tail = tuple(l.shape[k:])
            size = int(np.prod(tail))
            part = r[..., off:off + size].reshape(r.shape[:-1] + tail)
            out.append(part.to(l.dtype) if cast else part)
            off += size
        return out

    received = row * 3 - 1  # any row the link could hand back
    views = [(received, True)]
    if lead == "clients":  # the aggregate drops the client axis
        views.append((received.sum(0), False))
    else:  # broadcast copies gain one
        views.append((received.expand((4,) + received.shape), True))
    for r, cast in views:
        got = TT.unpack(r, leaves, k, cast=cast)
        for g, w, l in zip(got, split(r, k, cast), leaves):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert torch.equal(g, w)
            if g.dtype == torch.float32:  # a view of the row, not a copy
                assert g.untyped_storage().data_ptr() == \
                    r.untyped_storage().data_ptr()


def test_transmit_pytree_batch_vs_reference():
    jc, tc = _cfgs("approx")
    tree = _tree(1)
    tr, sr = JT.transmit_pytree_batch(
        {k: jnp.asarray(v) for k, v in tree.items()}, jax.random.PRNGKey(3),
        jc)
    tt, st = TT.transmit_pytree_batch(
        {k: torch.from_numpy(v) for k, v in tree.items()}, P.PRNGKey(3), tc,
        device="cpu")
    assert sorted(tt) == sorted(tree)
    flat = np.concatenate([tree[k].reshape(M, -1) for k in sorted(tree)], 1)
    edges = _edges(flat, P.PRNGKey(3), tc)
    off = 0
    for k in sorted(tree):
        size = tree[k][0].size
        assert tt[k].shape == tree[k].shape
        _check_bits(tr[k].reshape(M, -1), tt[k].reshape(M, -1),
                    edges[:, off:off + size])
        off += size
    _check_stats(sr, st, False)
    w = np.full(M, 0.25, np.float32)
    ar, _ = JT.transmit_pytree_batch_aggregate(
        {k: jnp.asarray(v) for k, v in tree.items()}, jax.random.PRNGKey(3),
        jc, jnp.asarray(w))
    at, _ = TT.transmit_pytree_batch_aggregate(
        {k: torch.from_numpy(v) for k, v in tree.items()}, P.PRNGKey(3), tc,
        torch.from_numpy(w), device="cpu")
    calm = np.all(edges >= EDGE, axis=0)
    off = 0
    for k in sorted(tree):
        size = tree[k][0].size
        assert at[k].shape == tree[k].shape[1:]
        c = calm[off:off + size]
        np.testing.assert_array_equal(
            np.asarray(ar[k]).reshape(-1).view(np.uint32)[c],
            at[k].reshape(-1).numpy().view(np.uint32)[c])
        off += size


def test_scan_weighted_sum_masks_rows():
    rows = torch.from_numpy(_payload(6))
    rows[3, 5] = float("nan")
    w = torch.tensor([0.5, 0.25, 0.25, 0.0])
    agg = TT._scan_weighted_sum(rows, w, num_active=3)
    want = TA.fedsgd_aggregate_batch(rows[:3], w[:3])
    np.testing.assert_array_equal(agg.numpy(), want.numpy())
    assert not torch.isnan(agg).any()
