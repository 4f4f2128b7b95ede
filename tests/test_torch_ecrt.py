"""The port's ECRT baseline, its pricing and the bound certificates against
the reference.

* Exact — the code (``H``, ``P``), ``encode``, ``syndrome_ok``; the real
  ECRT chain's payload and ``TxStats`` on a 64-float payload (every draw
  and every decision equal); ``_ecrt_analytic``; ``interp_expected_tx``
  at and beyond the grid edges; ``bounds``.
* Bounded — ``decode``: the port adds each variable's 2-4 check messages
  in row order, the reference reduces a dense column in XLA's order, so a
  hard bit or ``ok`` flag may differ only where the port's posterior lies
  within ``POST_TOL`` of 0 (relative to the largest |LLR|). Interpolation
  inside the grid: XLA fuses ``fp + (delta / dx) * df`` into an fma, the
  port rounds each step: ``INTERP_ULP``.
* ``calibrate_ecrt`` — Bounded through the normals and the decoder: with
  8 codewords a count may move by one per codeword whose decode sits at a
  posterior of 0, so the mean may differ by ``1/8`` per such codeword;
  ``CALIB_TOL`` allows one.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bounds as JB  # noqa: E402
from repro.core import channel as JCH  # noqa: E402
from repro.core import ecrt as JE  # noqa: E402
from repro.core import latency as JL  # noqa: E402
from repro.core import transport as JT  # noqa: E402
from repro_torch.core import bounds as TB  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import ecrt as TE  # noqa: E402
from repro_torch.core import latency as TL  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.core import transport as TT  # noqa: E402

POST_TOL = 1e-5
INTERP_ULP = 2
CALIB_TOL = 1 / 8
STAT_FIELDS = ("data_symbols", "transmissions", "bit_errors", "n_bits",
               "bits_on_air")


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


@pytest.fixture(scope="module")
def codes():
    return JE.LdpcCode(), TE.LdpcCode()


def test_code_encode_syndrome_exact(codes):
    jc, tc = codes
    np.testing.assert_array_equal(tc.H, jc.H)
    np.testing.assert_array_equal(tc.P, jc.P)
    assert (tc.n, tc.k, tc.iters, tc.alpha) == (jc.n, jc.k, jc.iters,
                                                jc.alpha)
    with jax.threefry_partitionable(True):
        mj = jax.random.randint(jax.random.PRNGKey(0), (4, jc.k), 0, 2)
    mt = P.randint(P.PRNGKey(0), (4, tc.k), 0, 2)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    cwj = np.asarray(JE.encode(mj.astype(jnp.uint32), jc))
    cwt = TE.encode(mt, tc)
    np.testing.assert_array_equal(cwt.numpy(), cwj)
    assert bool(TE.syndrome_ok(cwt, tc).all())
    flipped = cwt.clone()
    flipped[0, 17] ^= 1
    got = TE.syndrome_ok(flipped, tc).numpy()
    want = np.asarray(JE.syndrome_ok(jnp.asarray(flipped.numpy()), jc))
    np.testing.assert_array_equal(got, want)
    assert not got[0] and got[1:].all()


def _check_decode(llr, codes):
    jc, tc = codes
    hj, okj = (np.asarray(v) for v in JE.decode(jnp.asarray(llr), jc))
    post = TE._minsum_posterior(torch.from_numpy(llr), tc).numpy()
    ht, okt = (v.numpy() for v in TE.decode(torch.from_numpy(llr), tc))
    np.testing.assert_array_equal(ht, (post < 0).astype(np.int64))
    near = np.abs(post) <= POST_TOL * np.abs(llr).max()
    assert np.all((ht == hj) | near)
    rows = (ht != hj).any(axis=1)
    assert np.all((okt == okj) | rows)
    print(f"hard bits differing {int((ht != hj).sum())}, ok differing "
          f"{int((okt != okj).sum())} of {okt.size}")
    return ht, okt


@pytest.mark.parametrize("scale", [1.0, 2.0, 4.0])
def test_decode_on_seeded_llrs_bounded(codes, scale):
    jc, _ = codes
    rng = np.random.default_rng(int(scale))
    msg = rng.integers(0, 2, (12, jc.k)).astype(np.uint32)
    cw = np.asarray(JE.encode(jnp.asarray(msg), jc))
    llr = (1.0 - 2.0 * cw) * scale + rng.standard_normal(cw.shape) * 2.0
    _check_decode(llr.astype(np.float32), codes)


@pytest.mark.parametrize("n_flips", [0, 4, 8, 12])
def test_minsum_corrects_hard_flips(codes, n_flips):
    """The reference's own min-sum cases: far beyond the 7-bit
    bounded-distance guarantee."""
    jc, tc = codes
    with jax.threefry_partitionable(True):
        msg = jax.random.randint(jax.random.PRNGKey(1), (4, jc.k), 0, 2)
    cw = np.asarray(JE.encode(msg.astype(jnp.uint32), jc))
    llr = (1.0 - 2.0 * cw.astype(np.float32)) * 6.0
    rng = np.random.default_rng(2)
    for i in range(4):
        llr[i, rng.choice(jc.n, n_flips, replace=False)] *= -1
    hard, ok = _check_decode(llr, codes)
    assert ok.all()
    np.testing.assert_array_equal(hard, cw)


@pytest.mark.parametrize("fading,snr", [("rayleigh", 10.0),
                                        ("block_rayleigh", 3.0)])
def test_ecrt_real_vs_reference(fading, snr):
    """64 floats, max_tx 4: the block-fading point retransmits."""
    kw = dict(mode="ecrt", max_tx=4)
    jc = JT.TransportConfig(channel=JCH.ChannelConfig(snr_db=snr,
                                                      fading=fading), **kw)
    tc = TT.TransportConfig(channel=TCH.ChannelConfig(snr_db=snr,
                                                      fading=fading), **kw)
    x = np.random.default_rng(3).uniform(-1, 1, 64).astype(np.float32)
    xj, sj = JT.transmit_flat(jnp.asarray(x), jax.random.PRNGKey(4), jc)
    xt, st = TT.transmit_flat(torch.from_numpy(x), P.PRNGKey(4), tc,
                              device="cpu")
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(xt.numpy(), x)
    for f in STAT_FIELDS:
        assert float(getattr(st, f)) == float(getattr(sj, f)), f
    print(f"{fading} {snr} dB: transmissions {float(st.transmissions)}")
    # the batch path: row 1 is the single-client call with fold_in(key, 1)
    xb, sb = TT.transmit_batch(torch.from_numpy(np.stack([x, -x])),
                               P.PRNGKey(4), tc, device="cpu")
    xf, sf = TT.transmit_flat(torch.from_numpy(-x), P.fold_in(P.PRNGKey(4), 1),
                              tc, device="cpu")
    assert torch.equal(xb[1], xf)
    for f in STAT_FIELDS:
        assert float(getattr(sf, f)) == float(getattr(sb, f)[1])


@pytest.mark.parametrize("modulation", ["qpsk", "16qam"])
def test_ecrt_analytic_exact(modulation):
    kw = dict(mode="ecrt", modulation=modulation, simulate_fec=False,
              ecrt_expected_tx=1.37)
    jc, tc = JT.TransportConfig(**kw), TT.TransportConfig(**kw)
    x = np.random.default_rng(5).uniform(-1, 1, (3, 64)).astype(np.float32)
    xj, sj = JT.transmit_batch(jnp.asarray(x), jax.random.PRNGKey(0), jc)
    xt, st = TT.transmit_batch(torch.from_numpy(x), P.PRNGKey(0), tc,
                               device="cpu")
    np.testing.assert_array_equal(xt.numpy(), x)
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)))
    _, s1 = TT.transmit_flat(torch.from_numpy(x[0]), P.PRNGKey(0), tc,
                             device="cpu")
    assert float(s1.transmissions) == float(np.float32(1.37))


@pytest.mark.parametrize("decoder", ["minsum", "bounded"])
@pytest.mark.parametrize("snr,modulation", [(0.0, "qpsk"), (10.0, "qpsk"),
                                            (6.0, "16qam")])
def test_calibrate_ecrt_vs_reference(snr, modulation, decoder):
    args = (snr, modulation, "block_rayleigh", 8, 3, 0, decoder)
    ej = JL.calibrate_ecrt(*args)
    et = TL.calibrate_ecrt(*args, device="cpu")
    print(f"{args}: reference {ej!r}, port {et!r}")
    assert abs(ej - et) <= CALIB_TOL
    assert 1.0 <= et <= 3.0
    # canonical cache key: keyword and float64 forms share the entry
    assert TL.calibrate_ecrt(np.float64(snr), modulation=modulation,
                             n_codewords=8, max_tx=3, decoder=decoder,
                             device="cpu") == et


def test_expected_tx_curve_profile_and_interp():
    grid = [10.0, 0.0]
    gj, vj = JL.ecrt_expected_tx_curve(grid, n_codewords=8, max_tx=3)
    gt, vt = TL.ecrt_expected_tx_curve(grid, n_codewords=8, max_tx=3,
                                       device="cpu")
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    assert np.all(np.abs(vt.numpy() - np.asarray(vj)) <= CALIB_TOL)
    snr = np.array([0.0, 10.0, 10.0, 0.0], np.float32)
    pj = JL.ecrt_expected_tx_profile(snr, n_codewords=8, max_tx=3)
    pt = TL.ecrt_expected_tx_profile(snr, n_codewords=8, max_tx=3,
                                     device="cpu")
    assert pt.dtype == np.float32 and pt.shape == (4,)
    assert np.all(np.abs(pt - pj) <= CALIB_TOL)
    # interpolation on the same curve: Exact at and beyond the edges
    g = np.array([0.0, 5.0, 10.0, 20.0], np.float32)
    e = np.array([2.75, 1.5, 1.125, 1.0], np.float32)
    edges = np.array([-30.0, -1e-3, 0.0, 5.0, 10.0, 20.0, 20.001, 99.0],
                     np.float32)
    got = TL.interp_expected_tx(torch.from_numpy(edges), g, e).numpy()
    np.testing.assert_array_equal(got, np.asarray(JL.interp_expected_tx(
        jnp.asarray(edges), g, e)))
    inside = np.random.default_rng(6).uniform(0, 20, 1000).astype(np.float32)
    got = TL.interp_expected_tx(torch.from_numpy(inside), g, e).numpy()
    want = np.asarray(JL.interp_expected_tx(jnp.asarray(inside), g, e))
    assert np.all(np.abs(got - want) <= INTERP_ULP * 2.0**-23 * want)
    assert float(TL.interp_expected_tx(7.5, g, e)) == pytest.approx(
        float(JL.interp_expected_tx(7.5, g, e)), rel=1e-6)
    one = TL.interp_expected_tx(torch.tensor([-5.0, 3.0]), [4.0], [1.5])
    np.testing.assert_array_equal(one.numpy(), [1.5, 1.5])


# ------------------------------------------------------------------ bounds

_STACKS = [
    ([(8, "sigmoid", 1.0), (10, "softmax_xent", 1.0)], 1.0),
    ([(8, "relu", 1.0), (10, "softmax_xent", 1.0)], 1.0),
    ([(5, "sigmoid", 1.0), (4, "softmax_xent", 1.0)], 1.0),
    ([(4, "sigmoid", 0.5), (4, "tanh", 0.25), (3, "softmax_xent", 0.1)], 0.5),
    ([(64, "sigmoid", 0.01), (10, "softmax_xent", 0.01)], 2.0),
]


@pytest.mark.parametrize("stack,input_bound", _STACKS)
def test_bounds_match_reference(stack, input_bound):
    lj = [JB.LayerSpec(*s) for s in stack]
    lt = [TB.LayerSpec(*s) for s in stack]
    bj = JB.gradient_bound(lj, input_bound)
    bt = TB.gradient_bound(lt, input_bound)
    assert len(bt) == len(bj)
    for a, b in zip(bt, bj):
        assert a == b or (math.isinf(a) and math.isinf(b))
    assert (TB.certified_clamp_bound(lt, input_bound)
            == JB.certified_clamp_bound(lj, input_bound))
    fields = lambda a: (a.name, a.output_bound, a.deriv_bound)  # noqa: E731
    assert ({k: fields(v) for k, v in TB.ACTIVATIONS.items()}
            == {k: fields(v) for k, v in JB.ACTIVATIONS.items()})
