"""The port's sparse uplink (``compress/sparsify.py``, ``compress/framing.py``,
``prng.permutation``) against the reference's ``repro.compress``.

* Exact — ``prng.permutation`` (jax's ``_shuffle`` under
  ``threefry_partitionable``); ``resolve_k`` at the .5 cases (Python's
  half-even ``round``); the three selections on inputs with ties, NaN,
  +-inf and +-0 (the reference's lexsort puts NaN last and +-inf first);
  ``selection_keys``; index packing and unpacking; ``scatter_received``
  with out-of-range and duplicate indices; the error-feedback identity
  ``scatter(values) + residual == acc`` and a dropped client; the Gray
  header's symbols and received indices; the ECRT and perfect headers;
  ``TxStats`` of every sparse batch; inside the port, the batch against a
  loop of ``transmit_sparse`` and the bucketed against the select
  dispatch on kernel-cleared rows, bit for bit.
* Received words against the reference: equal except where a value word's
  symbols lie within ``layered_edge(L)`` of a decision edge (layered PHY,
  ``transport._word_margins``) or within ``EDGE`` (the plain K1 against
  the Pallas kernel in interpret mode), and except where the port keeps a
  subnormal that XLA on the CPU flushed to zero: XLA:CPU runs with
  denormals flushed, so the reference's ``zeros.at[idx].add(v)`` gives 0
  for a subnormal received value; the port keeps the IEEE sum (ROADMAP
  Queue 3). The same rule excuses a Gray header index whose bits ride a
  symbol within ``layered_edge`` of an edge.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.compress import framing as JF  # noqa: E402
from repro.compress import sparsify as JS  # noqa: E402
from repro.core import channel as JCH  # noqa: E402
from repro.core import transport as JT  # noqa: E402
from repro.link import policy as JP  # noqa: E402
from repro_torch.compress import framing as TF  # noqa: E402
from repro_torch.compress import sparsify as TS  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import modulation as TM  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.core import transport as TT  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.link import policy as TP  # noqa: E402

EDGE = 1e-4
D, K, M = 2000, 40, 5  # 11 index bits; one value tile per client
STAT_FIELDS = ("data_symbols", "transmissions", "bit_errors", "n_bits",
               "bits_on_air")
F32_TINY = np.finfo(np.float32).tiny


@pytest.fixture(autouse=True)
def partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    tensor ops split over every core stall each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def layered_edge(levels):
    """As ``test_torch_phy.layered_edge``: normals agree to 128 ULP."""
    return levels * 2.0**-14


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _same(ref, got) -> np.ndarray:
    """Bitwise equality, two NaNs counting as equal."""
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    return (_bits(ref) == _bits(got)) | (np.isnan(ref) & np.isnan(got))


def _cfgs(mode="approx", use_kernel=False, snr_db=6.0, modulation="qpsk"):
    return (JT.TransportConfig(mode=mode, modulation=modulation,
                               use_kernel=use_kernel,
                               channel=JCH.ChannelConfig(snr_db=snr_db)),
            TT.TransportConfig(mode=mode, modulation=modulation,
                               use_kernel=use_kernel,
                               channel=TCH.ChannelConfig(snr_db=snr_db)))


def _special(m=6, n=500, seed=0) -> np.ndarray:
    """Rows with ties (values on a 1/8 grid), NaN, +-inf and +-0."""
    rng = np.random.default_rng(seed)
    x = (np.round(rng.standard_normal((m, n)) * 8) / 8).astype(np.float32)
    for r in range(m):
        at = rng.choice(n, 12, replace=False)
        x[r, at] = [np.nan, np.nan, np.inf, -np.inf, 0.0, -0.0, 0.0, -0.0,
                    np.inf, np.nan, -np.inf, 5.0]
    return x


def _sparse_inputs(m=M, dim=D, k=K, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.sort(np.stack([rng.choice(dim, k, replace=False)
                            for _ in range(m)]), axis=1)
    vals = rng.uniform(-0.9, 0.9, (m, k)).astype(np.float32)
    return vals, idx


# ------------------------------------------------------------ permutation


@pytest.mark.parametrize("n", [1, 2, 10, 1000, 21840])
def test_permutation_exact(n):
    for seed in (0, 5):
        kj = jax.random.fold_in(jax.random.PRNGKey(seed), 17)
        got = P.permutation(P.fold_in(P.PRNGKey(seed), 17), n)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax.random.permutation(kj, n)))


def test_permutation_batched_exact():
    kj = jax.random.split(jax.random.PRNGKey(4), 5)
    want = np.stack([np.asarray(jax.random.permutation(k, 300)) for k in kj])
    got = P.permutation(torch.from_numpy(np.asarray(kj).astype(np.int64)),
                        300)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------- selection


@pytest.mark.parametrize("ratio,k,dim", [
    (0.25, None, 10), (0.35, None, 10), (0.05, None, 50), (0.15, None, 10),
    (0.02, None, 21840), (0.01, None, 21840), (1e-6, None, 100),
    (1.0, None, 7), (0.5, 5000, 100), (0.5, 3, 100)])
def test_resolve_k_exact(ratio, k, dim):
    jc, tc = JS.CompressionConfig(ratio=ratio, k=k), TS.CompressionConfig(
        ratio=ratio, k=k)
    assert TS.resolve_k(tc, dim) == JS.resolve_k(jc, dim)


def test_compress_k_table_iot_lowrate():
    ratios = (0.01, 0.02, 0.05, 0.10)
    tp = TP.PolicyConfig(compress_ratios=ratios)
    jp = JP.PolicyConfig(compress_ratios=ratios)
    got = TP.compress_k_table(tp, 21840, 0.02)
    assert got == JP.compress_k_table(jp, 21840, 0.02)
    assert got == (218, 437, 1092, 2184)


@pytest.mark.parametrize("k", range(1, 11))
def test_select_topk_non_finite_order(k):
    """The reference's order on NaN, +-inf and +-0: lexsort of ``-|x|``
    gives ``[3 7 2 6 9 0 4 5 1 8]`` (inf first, NaN last)."""
    x = np.array([1, np.nan, -3, np.inf, 0, -0.0, 3, -np.inf, np.nan, 2],
                 np.float32)
    vj, ij = JS.select_topk(jnp.asarray(x), k)
    vt, it = TS.select_topk(torch.from_numpy(x), k)
    want = np.sort(np.array([3, 7, 2, 6, 9, 0, 4, 5, 1, 8])[:k])
    np.testing.assert_array_equal(it.numpy(), want)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert _same(vj, vt.numpy()).all()


@pytest.mark.parametrize("method", ["topk", "randk", "threshold"])
def test_select_batch_exact(method):
    x = _special()
    jc = JS.CompressionConfig(method=method, k=37, threshold=0.5)
    tc = TS.CompressionConfig(method=method, k=37, threshold=0.5)
    jkeys = JS.selection_keys(jax.random.PRNGKey(3), 6)
    tkeys = TS.selection_keys(P.PRNGKey(3), 6)
    vj, ij = JS.select_batch(jnp.asarray(x), 37, jc, jkeys)
    vt, it = TS.select_batch(torch.from_numpy(x), 37, tc, tkeys)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert _same(vj, vt.numpy()).all()
    for r in range(6):  # the batch is a loop of single-client selections
        v1, i1 = TS.select(torch.from_numpy(x[r]), 37, tc, tkeys[r])
        np.testing.assert_array_equal(i1.numpy(), it[r].numpy())
        assert _same(v1.numpy(), vt[r].numpy()).all()
    if method != "randk":  # no NaN coordinate ahead of a finite one
        assert not np.isnan(x[np.arange(6)[:, None], it.numpy()]).any()


def test_selection_keys_exact():
    for offset in (0, 5):
        np.testing.assert_array_equal(
            TS.selection_keys(P.PRNGKey(9), 7, offset).numpy(),
            np.asarray(JS.selection_keys(jax.random.PRNGKey(9), 7, offset)))


@pytest.mark.parametrize("active", [None, (1, 0, 1, 1, 0, 1)])
@pytest.mark.parametrize("method", ["topk", "randk", "threshold"])
def test_ef_identity_and_dropped_client(method, active):
    rng = np.random.default_rng(1)
    res = rng.standard_normal((6, 500)).astype(np.float32)
    g = rng.standard_normal((6, 500)).astype(np.float32)
    jc = JS.CompressionConfig(method=method, k=37, threshold=0.5)
    tc = TS.CompressionConfig(method=method, k=37, threshold=0.5)
    jkeys = JS.selection_keys(jax.random.PRNGKey(2), 6)
    tkeys = TS.selection_keys(P.PRNGKey(2), 6)
    act = None if active is None else np.asarray(active, np.float32)
    vj, ij, rj = JS.ef_select_batch(
        jnp.asarray(res), jnp.asarray(g), 37, jc, jkeys,
        active=None if act is None else jnp.asarray(act))
    vt, it, rt = TS.ef_select_batch(
        torch.from_numpy(res), torch.from_numpy(g), 37, tc, tkeys,
        active=None if act is None else torch.from_numpy(act))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(_bits(vt), _bits(vj))
    np.testing.assert_array_equal(_bits(rt), _bits(rj))
    acc = torch.from_numpy(res) + torch.from_numpy(g)
    sent = TS.scatter_dense_batch(vt, it, 500)
    on = np.ones(6, bool) if act is None else act.astype(bool)
    np.testing.assert_array_equal(_bits((sent + rt)[on]), _bits(acc[on]))
    np.testing.assert_array_equal(_bits(rt[~on]), _bits(acc[~on]))
    # error feedback off: zero residual, selection from the gradient alone
    off = dataclasses.replace(tc, error_feedback=False)
    vo, io, ro = TS.ef_select_batch(torch.from_numpy(res), torch.from_numpy(g),
                                    37, off, tkeys)
    assert not ro.any()
    np.testing.assert_array_equal(
        io.numpy(), TS.select_batch(torch.from_numpy(g), 37, off,
                                    tkeys)[1].numpy())


# ---------------------------------------------------------------- framing


@pytest.mark.parametrize("dim", [1, 2, 3, 1000, 21840, (1 << 20) + 1])
def test_pack_unpack_exact(dim):
    rng = np.random.default_rng(dim)
    k = 37
    idx = np.sort(rng.integers(0, dim, (3, k)), axis=1)
    idx[:, -1] = dim - 1
    assert TF.index_bits(dim) == JF.index_bits(dim)
    for r in range(3):
        wj = np.asarray(JF.pack_index_bits(jnp.asarray(idx[r], jnp.int32),
                                           dim))
        wt = TF.pack_index_bits(torch.from_numpy(idx[r]), dim)
        np.testing.assert_array_equal(wt.numpy(), wj.astype(np.int64))
        np.testing.assert_array_equal(
            TF.unpack_index_bits(torch.from_numpy(wj.astype(np.int64)), k,
                                 dim).numpy(), idx[r])
    wt = TF.pack_index_bits(torch.from_numpy(idx), dim)  # batched rows
    np.testing.assert_array_equal(TF.unpack_index_bits(wt, k, dim).numpy(),
                                  idx)


def _corrupt_indices(seed=0, m=3, k=50):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, D + 300, (m, k))  # some out of range
    idx[:, 5:10] = idx[:, :1]  # duplicates, in and maybe out of range
    idx[:, 10] = D - 1
    idx[:, 11] = D
    return idx


def test_scatter_received_exact():
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((3, 50)).astype(np.float32)
    idx = _corrupt_indices()
    for r in range(3):
        want = np.asarray(JF.scatter_received(
            jnp.asarray(vals[r]), jnp.asarray(idx[r], jnp.int32), D))
        got = TF.scatter_received(torch.from_numpy(vals[r]),
                                  torch.from_numpy(idx[r]), D)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    got = TF.scatter_received(torch.from_numpy(vals), torch.from_numpy(idx),
                              D)
    for r in range(3):
        np.testing.assert_array_equal(
            _bits(got[r]), _bits(TF.scatter_received(
                torch.from_numpy(vals[r]), torch.from_numpy(idx[r]), D)))


def test_scatter_received_keeps_subnormals():
    """XLA:CPU flushes denormals, so the reference's scatter-add turns a
    subnormal received value into 0; the port keeps the IEEE sum. Every
    other word is the reference's."""
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((3, 50)).astype(np.float32)
    vals[:, :6] = np.float32(F32_TINY) * rng.uniform(-0.9, 0.9, (3, 6))
    idx = _corrupt_indices(seed=1)
    idx[:, :6] = np.arange(100, 106)
    got = TF.scatter_received(torch.from_numpy(vals), torch.from_numpy(idx),
                              D).numpy()
    want = np.stack([np.asarray(JF.scatter_received(
        jnp.asarray(vals[r]), jnp.asarray(idx[r], jnp.int32), D))
        for r in range(3)])
    diff = ~_same(want, got)
    assert diff.any()
    assert np.all(want[diff] == 0)
    assert np.all((got[diff] != 0) & (np.abs(got[diff]) < F32_TINY))
    np.testing.assert_array_equal(got[:, 100:106], vals[:, :6])


def _capture(monkeypatch, module):
    """Record the symbol streams fed to ``module._through_channel``."""
    seen, inner = [], module._through_channel

    def spy(sym, *a, **kw):
        seen.append(np.asarray(sym))
        return inner(sym, *a, **kw)

    monkeypatch.setattr(module, "_through_channel", spy)
    return seen


@pytest.mark.parametrize("modulation,snr_db", [
    ("qpsk", 0.0), ("qpsk", 6.0), ("16qam", 4.0), ("256qam", 4.0)])
def test_header_gray_exact(monkeypatch, modulation, snr_db):
    jc, tc = _cfgs(snr_db=snr_db, modulation=modulation)
    _, idx = _sparse_inputs(m=4, k=41)  # 451 bits: an odd count
    keys = TT.client_keys(P.PRNGKey(5), 4)
    hkeys = P.fold_in(keys, TF.HEADER_KEY_LANE)
    seen_t = _capture(monkeypatch, TT)
    got_idx, st = TF._header_batch(torch.from_numpy(idx), D, hkeys, tc,
                                   TS.CompressionConfig(), None)
    seen_j = _capture(monkeypatch, JT)
    km = tc.scheme.bits_per_symbol
    n_sym = -(-41 * 11 // 2)
    for r in range(4):
        kj = jax.random.fold_in(JT.client_keys(jax.random.PRNGKey(5), 4)[r],
                                JF.HEADER_KEY_LANE)
        want = JF._header_gray(jnp.asarray(idx[r], jnp.int32), D, kj, jc,
                               None)
        np.testing.assert_array_equal(seen_t[0][r], seen_j[-1])  # symbols
        assert (float(st.data_symbols[r]), float(st.transmissions[r]),
                float(st.n_bits[r]), float(st.bits_on_air[r])) == (
            want[1], want[2], want[4], want[5])
        assert want[1] == n_sym and want[5] == n_sym * km
        # received indices: equal except where a bit rides an edge symbol
        y, _ = TT._through_channel(torch.from_numpy(seen_t[0][r:r + 1]),
                                   hkeys[r:r + 1], tc, None)
        margin = TM.decision_margin(y, tc.scheme).numpy()[0]
        near = margin < layered_edge(tc.scheme.levels)
        near_idx = np.zeros(41, bool)
        for s in np.nonzero(near)[0]:
            near_idx[[b // 11 for b in (2 * s, 2 * s + 1) if b < 451]] = True
        differ = got_idx[r].numpy() != np.asarray(want[0])
        assert not (differ & ~near_idx).any()
        if not near.any():
            assert float(st.bit_errors[r]) == float(want[3])
    if snr_db == 0.0:
        assert float(st.bit_errors.sum()) > 0


@pytest.mark.parametrize("header", ["ecrt", "perfect"])
def test_header_ecrt_and_perfect_exact(header):
    jc, tc = _cfgs(snr_db=6.0, modulation="16qam")
    _, idx = _sparse_inputs(m=3)
    jcomp = JS.CompressionConfig(header=header, header_ecrt_expected_tx=1.5)
    tcomp = TS.CompressionConfig(header=header, header_ecrt_expected_tx=1.5)
    keys = P.fold_in(TT.client_keys(P.PRNGKey(1), 3), TF.HEADER_KEY_LANE)
    got_idx, st = TF._header_batch(torch.from_numpy(idx), D, keys, tc, tcomp,
                                   None)
    np.testing.assert_array_equal(got_idx.numpy(), idx)
    for r in range(3):
        wi, parts = JF.transmit_header(
            jnp.asarray(idx[r], jnp.int32), D,
            jnp.asarray(keys[r].numpy().astype(np.uint32)), jc, jcomp)
        ti, tparts = TF.transmit_header(torch.from_numpy(idx[r]), D, keys[r],
                                        tc, tcomp, device="cpu")
        np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
        for a, b in zip(parts, tparts):
            assert float(b) == float(a)


# --------------------------------------------------------- sparse batches


def _slot_margins(vals, keys, cfg, snr):
    """Per value slot ``(C, k)``: < 1 where a received word may differ from
    another implementation's (the plain K1's demod edges in units of
    ``EDGE``, or the layered PHY's margins in units of ``layered_edge``);
    ``inf`` on lossless legs."""
    x = torch.from_numpy(vals)
    if cfg.mode not in ("approx", "naive"):
        return np.full(vals.shape, np.inf)
    s = None if snr is None else torch.from_numpy(snr)
    if cfg.use_kernel:
        n = x.shape[1]
        xp = torch.nn.functional.pad(x, (0, (-n) % 1024))
        wb, mask, k = TT._transport_kernel_params(cfg)
        npow, gains = TT._link_params(cfg, x.shape[0], s, torch.device("cpu"))
        _, _, edges = TR.approx_channel_batch_ref(
            xp, TO._seed_from_key(keys), npow, gains, bits_per_symbol=k,
            fading=cfg.channel.fading, fade_block=cfg.channel.block_len,
            clamp_mask=mask, word_bits=wb, with_edges=True)
        return edges[:, :n].numpy() / EDGE
    return (TT._word_margins(x, keys, cfg, s).numpy()
            / layered_edge(cfg.scheme.levels))


def _check_dense(want, got, idx_rx, slot_margin):
    """Dense rows equal but for value slots near an edge and subnormals the
    reference flushed; ``idx_rx`` must be the reference's already."""
    want, got = np.asarray(want, np.float32), got.numpy()
    diff = ~_same(want, got)
    excused = np.zeros_like(diff)
    rows = np.arange(want.shape[0])[:, None]
    near = slot_margin < 1
    ok_idx = idx_rx < want.shape[1]
    excused[rows.repeat(idx_rx.shape[1], 1)[near & ok_idx],
            idx_rx[near & ok_idx]] = True
    ftz = (want == 0) & (np.abs(got) < F32_TINY)
    assert not (diff & ~excused & ~ftz).any()
    return int(diff.sum())


@pytest.mark.parametrize("header", ["gray", "ecrt", "perfect"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_transmit_sparse_batch_equals_loop(use_kernel, header):
    _, tc = _cfgs(use_kernel=use_kernel)
    comp = TS.CompressionConfig(header=header)
    vals, idx = _sparse_inputs()
    key = P.PRNGKey(8)
    dense, st = TT.transmit_sparse_batch(vals, idx, D, key, tc, comp,
                                         device="cpu")
    assert dense.shape == (M, D)
    for r in range(M):
        d1, s1 = TT.transmit_sparse(vals[r], idx[r], D, P.fold_in(key, r),
                                    tc, comp, device="cpu")
        np.testing.assert_array_equal(_bits(d1), _bits(dense[r]))
        for f in STAT_FIELDS:
            assert float(getattr(s1, f)) == float(getattr(st, f)[r]), f


@pytest.mark.parametrize("mode,use_kernel,header,per_client_snr", [
    ("approx", True, "gray", False), ("approx", True, "perfect", True),
    ("naive", True, "ecrt", False), ("approx", False, "gray", True),
    ("naive", False, "perfect", False), ("approx", False, "ecrt", False)])
def test_transmit_sparse_batch_vs_reference(mode, use_kernel, header,
                                            per_client_snr):
    jc, tc = _cfgs(mode=mode, use_kernel=use_kernel)
    jcomp = JS.CompressionConfig(header=header)
    tcomp = TS.CompressionConfig(header=header)
    vals, idx = _sparse_inputs(seed=3)
    snr = (np.linspace(2.0, 14.0, M).astype(np.float32) if per_client_snr
           else None)
    dj, sj = JF.transmit_sparse_batch(
        jnp.asarray(vals), jnp.asarray(idx, jnp.int32), D,
        jax.random.PRNGKey(6), jc, jcomp,
        snr_db=None if snr is None else jnp.asarray(snr))
    dt, st = TF.transmit_sparse_batch(
        vals, idx, D, P.PRNGKey(6), tc, tcomp,
        snr_db=None if snr is None else torch.from_numpy(snr), device="cpu")
    keys = TT.client_keys(P.PRNGKey(6), M)
    idx_rx, _ = TF._header_batch(
        torch.from_numpy(idx), D, P.fold_in(keys, TF.HEADER_KEY_LANE), tc,
        tcomp, None if snr is None else torch.from_numpy(snr))
    margin = _slot_margins(vals, keys, tc, snr)
    n = _check_dense(dj, dt, idx_rx.numpy(), margin)
    for f in STAT_FIELDS:
        if f != "bit_errors" or not (margin < 1).any():
            np.testing.assert_array_equal(getattr(st, f).numpy(),
                                          np.asarray(getattr(sj, f)), f)
    assert float(st.bit_errors.sum()) > 0
    print(f"{mode} kernel={use_kernel} {header}: dense words differing {n}")


def _mode_tables(use_kernel):
    jb, tb = _cfgs(use_kernel=use_kernel, snr_db=10.0)
    return (JP.build_mode_cfgs(jb, JP.PolicyConfig(), ecrt_expected_tx=2.0),
            TP.build_mode_cfgs(tb, TP.PolicyConfig(), ecrt_expected_tx=2.0,
                               device="cpu"))


def test_sparse_adaptive_bucketed_equals_select_and_reference():
    """On the kernel-cleared table: the port's bucketed and select
    dispatches bit for bit, and both against the reference's select
    (a vmapped switch) with the layered-margin and subnormal rules; on the
    kernel table, the bucketed dispatch against the reference's."""
    m = 8
    vals, idx = _sparse_inputs(m=m, seed=4)
    modes = np.array([0, 3, 1, 1, 2, 0, 3, 1], np.int32)
    snr = np.linspace(4.0, 24.0, m).astype(np.float32)
    comp_j, comp_t = JS.CompressionConfig(), TS.CompressionConfig()
    for use_kernel in (False, True):
        jt, tt = _mode_tables(use_kernel)
        if not use_kernel:
            jt, tt = JT.clear_kernel_rows(jt), TT.clear_kernel_rows(tt)
        dispatches = ("bucketed", "select") if not use_kernel else (
            "bucketed",)
        outs = {}
        for dispatch in dispatches:
            outs[dispatch] = TF.transmit_sparse_batch_adaptive(
                vals, idx, D, P.PRNGKey(2), tt, modes, comp_t,
                snr_db=torch.from_numpy(snr), dispatch=dispatch,
                device="cpu")
        if not use_kernel:
            (db, sb), (ds, ss) = outs["bucketed"], outs["select"]
            np.testing.assert_array_equal(_bits(db), _bits(ds))
            for f in STAT_FIELDS:
                np.testing.assert_array_equal(getattr(sb, f).numpy(),
                                              getattr(ss, f).numpy())
        dt, st = outs["bucketed"]
        dj, sj = JF.transmit_sparse_batch_adaptive(
            jnp.asarray(vals), jnp.asarray(idx, jnp.int32), D,
            jax.random.PRNGKey(2), jt, jnp.asarray(modes), comp_j,
            snr_db=jnp.asarray(snr), dispatch=dispatches[-1])
        np.testing.assert_array_equal(st.mode_idx.numpy(),
                                      np.asarray(sj.mode_idx))
        keys = TT.client_keys(P.PRNGKey(2), m)
        margin = np.full(vals.shape, np.inf)
        idx_rx = np.zeros_like(idx)
        for mode in range(4):
            rows = np.nonzero(modes == mode)[0]
            kb = keys[torch.from_numpy(rows)]
            margin[rows] = _slot_margins(vals[rows], kb, tt[mode], snr[rows])
            idx_rx[rows] = TF._header_batch(
                torch.from_numpy(idx[rows]), D,
                P.fold_in(kb, TF.HEADER_KEY_LANE), tt[mode], comp_t,
                torch.from_numpy(snr[rows]))[0].numpy()
        _check_dense(dj, dt, idx_rx, margin)
        for f in STAT_FIELDS:
            if f != "bit_errors" or not (margin < 1).any():
                np.testing.assert_array_equal(getattr(st, f).numpy(),
                                              np.asarray(getattr(sj, f)), f)
    with pytest.raises(ValueError, match="select"):
        TF.transmit_sparse_batch_adaptive(vals, idx, D, P.PRNGKey(2), tt,
                                          modes, comp_t, dispatch="select",
                                          device="cpu")


@pytest.mark.parametrize("modulation", ["qpsk", "16qam", "256qam"])
def test_comp_bits_on_air(modulation):
    """Bits on air per client: ``32 k`` value bits plus the Gray header's
    ``ceil(15 k / 2)`` symbols at ``bits_per_symbol`` each (QPSK, k = 437:
    13,984 + 6,556 = 20,540, against 698,880 dense)."""
    dim, k = 21840, 437
    jc, tc = _cfgs(use_kernel=True, modulation=modulation, snr_db=10.0)
    vals, idx = _sparse_inputs(m=2, dim=dim, k=k, seed=5)
    _, st = TF.transmit_sparse_batch(vals, idx, dim, P.PRNGKey(0), tc,
                                     device="cpu")
    _, sj = JF.transmit_sparse_batch(jnp.asarray(vals),
                                     jnp.asarray(idx, jnp.int32), dim,
                                     jax.random.PRNGKey(0), jc)
    km = tc.scheme.bits_per_symbol
    want = 32 * k + -(-15 * k // 2) * km
    np.testing.assert_array_equal(st.bits_on_air.numpy(), [want, want])
    np.testing.assert_array_equal(st.bits_on_air.numpy(),
                                  np.asarray(sj.bits_on_air))
    np.testing.assert_array_equal(st.n_bits.numpy(), [32 * k + 15 * k] * 2)
    if modulation == "qpsk":
        assert want == 20540 and 32 * dim / want == pytest.approx(34.0, 0.01)
