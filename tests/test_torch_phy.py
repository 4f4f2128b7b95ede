"""The port's layered PHY against the reference: codec, QAM, channel, uplink.

Grades (ROADMAP "what tested against the reference means"):

* Exact — ``float_codec`` packing, interleave and clamp; ``modulate``;
  ``demod_hard`` on equal inputs; ``popcount``; the ``TxStats`` counters
  of the layered uplink; a batch row against the single-client call.
* Bounded — ``channel.transmit`` (its normals agree to
  ``NORMAL_MAX_ULP``, ``tests/test_torch_prng.py``), ``equalize`` (XLA
  contracts Smith's algorithm into fmas, the port rounds each step:
  ``EQ_ULP``), ``noise_var_post_eq``, ``bit_llrs`` and ``demod_ml`` (a
  squared distance as ``re*re + im*im`` against ``abs(.)**2``:
  ``DIST_RTOL``).
* Edge rule — a received word of the layered uplink may differ from the
  reference's only where one of its symbols' demod pre-round values lies
  within ``layered_edge(L)`` of a decision edge (``_word_margins``); the
  largest such margin is printed. ``bit_errors`` is Exact when no word
  differs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import channel as JCH  # noqa: E402
from repro.core import float_codec as JFC  # noqa: E402
from repro.core import modulation as JM  # noqa: E402
from repro.core import transport as JT  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import float_codec as TFC  # noqa: E402
from repro_torch.core import modulation as TM  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.core import transport as TT  # noqa: E402

NORMAL_MAX_ULP = 128
EQ_ULP = 4
DIST_RTOL = 4e-7
ULP = 2.0**-23
STAT_FIELDS = ("data_symbols", "transmissions", "n_bits", "bits_on_air")
SCHEMES = ["qpsk", "16qam", "256qam"]


def layered_edge(levels):
    """Decision margin within which a layered word may differ: normals
    agree to 128 ULP, so a pre-round value inside the grid (``|y/a| <=
    2L``) moves by at most ``0.5 * 2L * 2 * 128 * 2**-23 = L * 3.1e-5``;
    this doubles it."""
    return levels * 2.0**-14


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


# ------------------------------------------------------------ float_codec


@pytest.mark.parametrize("word_bits", [32, 16])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_codec_exact(k, word_bits):
    rng = np.random.default_rng(k + word_bits)
    u = rng.integers(0, 2**word_bits, (5, 37), dtype=np.uint64).astype(
        np.uint32)
    sj = np.asarray(JFC.words_to_symbols(jnp.asarray(u[0]), k, word_bits))
    st = TFC.words_to_symbols(torch.from_numpy(u.astype(np.int64)), k,
                              word_bits)
    np.testing.assert_array_equal(st[0].numpy(), sj)
    s_per = word_bits // k
    stream_j = np.asarray(JFC.interleave(jnp.asarray(sj)))
    stream_t = TFC.interleave(st)
    np.testing.assert_array_equal(stream_t[0].numpy(), stream_j)
    np.testing.assert_array_equal(
        TFC.deinterleave(stream_t, 37, s_per).numpy(), st.numpy())
    np.testing.assert_array_equal(
        np.asarray(JFC.deinterleave(jnp.asarray(stream_j), 37, s_per)), sj)
    back_j = np.asarray(JFC.symbols_to_words(jnp.asarray(sj), k, word_bits))
    back_t = TFC.symbols_to_words(st, k, word_bits)
    np.testing.assert_array_equal(back_t[0].numpy(), back_j)
    np.testing.assert_array_equal(back_t.numpy(), u)
    for bound in (2.0, 1.0, 0.25):
        if word_bits == 32:
            want = JFC.clamp_exponent_bits(jnp.asarray(u), bound)
            got = TFC.clamp_exponent_bits(torch.from_numpy(u.astype(
                np.int64)), bound)
        else:
            want = JFC.clamp_exponent_bits16(jnp.asarray(u.astype(np.uint16)),
                                             bound)
            got = TFC.clamp_exponent_bits16(torch.from_numpy(u.astype(
                np.int64)), bound)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- modulation


@pytest.mark.parametrize("name", SCHEMES)
def test_modulation_exact(name):
    js, ts = JM.MOD_SCHEMES[name], TM.MOD_SCHEMES[name]
    sym = np.arange(js.points, dtype=np.uint32)
    cj = np.asarray(JM.modulate(jnp.asarray(sym), js))
    ct = TM.modulate(torch.from_numpy(sym.astype(np.int64)), ts).numpy()
    np.testing.assert_array_equal(ct.view(np.uint32), cj.view(np.uint32))
    np.testing.assert_array_equal(TM.constellation(ts, "cpu").numpy(), cj)
    # demod on identical received points: Exact, including NaN and points
    # far outside the grid
    rng = np.random.default_rng(js.points)
    y = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)) * 0.9
    y = y.astype(np.complex64)
    y[:3] = [np.nan, 40 + 40j, -40 - 1j]
    dj = np.asarray(JM.demod_hard(jnp.asarray(y), js))
    dt = TM.demod_hard(torch.from_numpy(y), ts).numpy()
    np.testing.assert_array_equal(dt, dj)
    # the ML oracle and the LLRs go through squared distances
    mj = np.asarray(JM.demod_ml(jnp.asarray(y[3:]), js))
    mt = TM.demod_ml(torch.from_numpy(y[3:]), ts).numpy()
    d2 = np.abs(y[3:, None] - cj[None]) ** 2
    best = np.sort(d2, axis=1)
    tie = best[:, 1] - best[:, 0] <= 4 * DIST_RTOL * best[:, 1]
    assert np.all((mt == mj) | tie)
    np.testing.assert_array_equal(mt, dt[3:])
    nv = rng.uniform(0.01, 1.0, y.size - 3).astype(np.float32)
    lj = np.asarray(JM.bit_llrs(jnp.asarray(y[3:]), jnp.asarray(nv), js))
    lt = TM.bit_llrs(torch.from_numpy(y[3:]), torch.from_numpy(nv), ts)
    scale = (d2.max(axis=1) / nv)[:, None]
    assert np.all(np.abs(lt.numpy() - lj) <= 4 * DIST_RTOL * scale)


def test_popcount_and_closed_form_exact():
    x = np.random.default_rng(0).integers(0, 2**32, 1000, dtype=np.uint64)
    np.testing.assert_array_equal(
        TM.popcount(torch.from_numpy(x.astype(np.int64))).numpy(),
        np.asarray(JM.popcount(jnp.asarray(x.astype(np.uint32)))))
    for snr in (0.0, 10.0, 20.0):
        assert TM.rayleigh_qpsk_ber(snr) == JM.rayleigh_qpsk_ber(snr)


@pytest.mark.parametrize("name", SCHEMES)
def test_measure_ber_bounded(name):
    """Same key, same draws to the normals' rounding: the bit-error counts
    may differ only by symbols at a decision edge (at most 4 here)."""
    n = 1 << 12
    js, ts = JM.MOD_SCHEMES[name], TM.MOD_SCHEMES[name]
    bj = float(JM.measure_ber(jax.random.PRNGKey(2), js, 10.0, n_symbols=n))
    bt = float(TM.measure_ber(P.PRNGKey(2), ts, 10.0, n_symbols=n,
                              device="cpu"))
    print(f"{name}: BER reference {bj!r}, port {bt!r}")
    assert abs(bj - bt) * n * ts.bits_per_symbol <= 4


# ---------------------------------------------------------------- channel


@pytest.mark.parametrize("snr_db", [None, 7.0])
@pytest.mark.parametrize("fading", ["rayleigh", "awgn", "block_rayleigh"])
def test_channel_bounded(fading, snr_db):
    scheme = TM.MOD_SCHEMES["16qam"]
    rng = np.random.default_rng(1)
    sym = rng.integers(0, 16, 3000)
    s_t = TM.modulate(torch.from_numpy(sym), scheme)
    s_j = jnp.asarray(s_t.numpy())
    cfg_j = JCH.ChannelConfig(snr_db=12.0, fading=fading, block_len=50)
    cfg_t = TCH.ChannelConfig(snr_db=12.0, fading=fading, block_len=50)
    kw_j = {} if snr_db is None else {"snr_db": jnp.float32(snr_db)}
    kw_t = {} if snr_db is None else {"snr_db": torch.tensor(snr_db)}
    rj, cj = (np.array(v) for v in JCH.transmit(
        s_j, jax.random.PRNGKey(3), cfg_j, **kw_j))
    rt, ct = (v.numpy() for v in TCH.transmit(s_t, P.PRNGKey(3), cfg_t,
                                               **kw_t))
    amp = np.sqrt(np.float32(cfg_t.large_scale_gain))
    tol = (NORMAL_MAX_ULP + 2) * ULP
    c_err = np.abs(ct - cj) / np.maximum(np.abs(cj), amp * 1e-3)
    # r = c s + n: the normals' error on both terms, plus the product's
    r_scale = 2 * np.abs(cj) * np.abs(s_t.numpy()) + np.abs(rj)
    r_err = np.abs(rt - rj) / r_scale
    print(f"{fading} snr={snr_db}: c {c_err.max() / ULP:.1f} ULP, "
          f"r {r_err.max() / ULP:.1f} ULP of scale")
    assert c_err.max() <= tol and r_err.max() <= tol
    # equalize and the post-equalization noise variance on the SAME inputs
    yj = np.asarray(JCH.equalize(jnp.asarray(rj), jnp.asarray(cj)))
    yt = TCH.equalize(torch.from_numpy(rj), torch.from_numpy(cj)).numpy()
    assert np.all(np.abs(yt - yj) <= EQ_ULP * ULP * np.abs(yj))
    vj = np.asarray(JCH.noise_var_post_eq(jnp.asarray(cj), cfg_j, **kw_j))
    vt = TCH.noise_var_post_eq(torch.from_numpy(cj), cfg_t, **kw_t).numpy()
    np.testing.assert_allclose(vt, vj, rtol=4 * ULP)


def test_with_snr():
    cfg = TCH.ChannelConfig(snr_db=3.0, fading="awgn")
    assert cfg.with_snr(9.0) == TCH.ChannelConfig(snr_db=9.0, fading="awgn")
    assert JCH.ChannelConfig(snr_db=3.0).with_snr(9.0).noise_power == \
        cfg.with_snr(9.0).noise_power


# ------------------------------------------------------- layered uplink


def _check_uplink(xj, xt, margins, levels):
    xj, xt = np.asarray(xj), xt.numpy()
    diff = (xj.view(np.uint32) != xt.view(np.uint32)) & ~(
        np.isnan(xj) & np.isnan(xt))
    if diff.any():
        worst = float(margins[diff].max())
        print(f"{int(diff.sum())} words differ; largest margin {worst:.3g}")
        assert worst < layered_edge(levels)
    return int(diff.sum())


N_SYM = 4800  # symbols per client in every configuration below


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("interleave", [True, False])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("mod", SCHEMES)
@pytest.mark.parametrize("mode", ["naive", "approx"])
def test_layered_uplink_vs_reference(mode, mod, wire, interleave, chunked):
    """``transmit_batch`` against the reference's; a batch row against the
    port's ``transmit_flat`` bit for bit (the reference pins its own batch
    to its loop). Payloads are sized so every configuration puts
    ``N_SYM`` symbols per client on the air (and chunks of 0.6 of them),
    which keeps the reference's compiled shapes to a few."""
    wb = 16 if wire == "bfloat16" else 32
    tc = TT.TransportConfig(modulation=mod)
    n = N_SYM * tc.scheme.bits_per_symbol // wb
    kw = dict(mode=mode, modulation=mod, wire_dtype=wire,
              interleave=interleave, chunk_elems=n * 3 // 5 if chunked else 0)
    jc = JT.TransportConfig(channel=JCH.ChannelConfig(snr_db=10.0), **kw)
    tc = TT.TransportConfig(channel=TCH.ChannelConfig(snr_db=10.0), **kw)
    x = np.random.default_rng(7).uniform(-0.9, 0.9, (3, n)).astype(
        np.float32)
    key = P.PRNGKey(5)
    keys = TT.client_keys(key, 3)
    xj, sj = JT.transmit_batch(jnp.asarray(x), jax.random.PRNGKey(5), jc)
    xt, st = TT.transmit_batch(torch.from_numpy(x), key, tc, device="cpu")
    margins = TT._word_margins(torch.from_numpy(x), keys, tc).numpy()
    n_diff = _check_uplink(xj, xt, margins, tc.scheme.levels)
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)))
    if n_diff == 0:
        np.testing.assert_array_equal(st.bit_errors.numpy(),
                                      np.asarray(sj.bit_errors))
    xft, sft = TT.transmit_flat(torch.from_numpy(x[1]), keys[1], tc,
                                device="cpu")
    np.testing.assert_array_equal(xft.numpy().view(np.uint32),
                                  xt[1].numpy().view(np.uint32))
    for f in STAT_FIELDS + ("bit_errors",):
        assert getattr(sft, f).shape == ()
        assert float(getattr(sft, f)) == float(getattr(st, f)[1])


def test_layered_transmit_flat_vs_reference():
    cfg = dict(mode="approx", modulation="16qam", chunk_elems=1000)
    jc = JT.TransportConfig(channel=JCH.ChannelConfig(snr_db=8.0), **cfg)
    tc = TT.TransportConfig(channel=TCH.ChannelConfig(snr_db=8.0), **cfg)
    x = np.random.default_rng(11).uniform(-1, 1, 2500).astype(np.float32)
    for snr in (None, 4.0):
        xj, sj = JT.transmit_flat(jnp.asarray(x), jax.random.PRNGKey(6), jc,
                                  snr_db=snr)
        xt, st = TT.transmit_flat(torch.from_numpy(x), P.PRNGKey(6), tc,
                                  snr_db=snr, device="cpu")
        snr_vec = None if snr is None else TCH.snr_db_vector(snr, 1)
        margins = TT._word_margins(torch.from_numpy(x)[None],
                                   P.PRNGKey(6)[None], tc, snr_vec)[0]
        n_diff = _check_uplink(xj, xt, margins.numpy(), tc.scheme.levels)
        for f in STAT_FIELDS + ("bit_errors",) * (n_diff == 0):
            assert float(getattr(st, f)) == float(getattr(sj, f))


def test_layered_per_client_snr_and_aggregate():
    """Per-client SNR (row 0 noiseless: Exact) and the non-kernel fused
    aggregate, which is the client-order sum over the layered batch."""
    snr = (float("inf"), 0.0, 20.0)
    jc = JT.TransportConfig(channel=JCH.ChannelConfig(snr_db=snr))
    tc = TT.TransportConfig(channel=TCH.ChannelConfig(snr_db=snr))
    x = np.random.default_rng(8).uniform(-0.9, 0.9, (3, 1000)).astype(
        np.float32)
    xj, _ = JT.transmit_batch(jnp.asarray(x), jax.random.PRNGKey(9), jc)
    xt, st = TT.transmit_batch(torch.from_numpy(x), P.PRNGKey(9), tc,
                               device="cpu")
    np.testing.assert_array_equal(xt[0].numpy(), x[0])
    assert float(st.bit_errors[0]) == 0
    margins = TT._word_margins(torch.from_numpy(x),
                               TT.client_keys(P.PRNGKey(9), 3), tc,
                               TCH.snr_db_vector(snr, 3)).numpy()
    _check_uplink(xj, xt, margins, tc.scheme.levels)
    w = torch.tensor([0.25, 0.5, 0.25])
    agg, _ = TT.transmit_batch_aggregate(torch.from_numpy(x), P.PRNGKey(9),
                                         tc, w, device="cpu")
    assert torch.equal(agg, TT._scan_weighted_sum(xt, w))


def test_transmit_pytree_matches_flat():
    tree = {"b": torch.arange(6, dtype=torch.float32).reshape(2, 3) / 10,
            "a": {"w": torch.full((4,), -0.5, dtype=torch.bfloat16)}}
    cfg = TT.TransportConfig(channel=TCH.ChannelConfig(snr_db=15.0))
    out, st = TT.transmit_pytree(tree, P.PRNGKey(1), cfg, device="cpu")
    flat = torch.cat([tree["a"]["w"].float(), tree["b"].reshape(-1)])
    want, sw = TT.transmit_flat(flat, P.PRNGKey(1), cfg, device="cpu")
    assert out["a"]["w"].dtype == torch.bfloat16
    assert out["b"].shape == (2, 3)
    assert torch.equal(out["a"]["w"], want[:4].to(torch.bfloat16))
    assert torch.equal(out["b"].reshape(-1), want[4:])
    assert float(st.bit_errors) == float(sw.bit_errors)
    jt = {"b": jnp.asarray(tree["b"].numpy()),
          "a": {"w": jnp.asarray(tree["a"]["w"].float().numpy(),
                                 jnp.bfloat16)}}
    _, sj = JT.transmit_pytree(jt, jax.random.PRNGKey(1), JT.TransportConfig(
        channel=JCH.ChannelConfig(snr_db=15.0)))
    for f in STAT_FIELDS:
        assert float(getattr(st, f)) == float(getattr(sj, f))
