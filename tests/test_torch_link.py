"""The port's link adaptation against the reference (``repro.link``).

Grades (ROADMAP "what tested against the reference means"):

* Exact — ``jakes_rho`` and the dynamics presets; the uniform offsets and
  Bernoulli blockage of ``init_state``/``step``/``trajectory``;
  ``bernoulli``; the oracle estimator and the staleness mask; the policy's
  decisions on equal inputs (grids through every ``threshold +- h``); the
  mode table rows; the eleven scenario presets, field by field; the
  driver's modes, ``active`` and ``straggler`` vectors, except for a
  client whose reference estimate lies within ``EDGE_DB`` of a decision
  edge (and that client's later rounds, since hysteresis carries it).
* Bounded — the normal-derived tracks (``prng.normal``: ``NORMAL_ULP``)
  and ``gamma`` (``GAMMA_ULP``); the driver's SNR and CSI; airtime to
  ``2**-20`` relative.
* Statistical — ``gamma`` against ``scipy.stats.gamma`` on 10^5 draws.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy import stats as sps  # noqa: E402

from repro.core import channel as JCH  # noqa: E402
from repro.core import latency as JL  # noqa: E402
from repro.core import transport as JT  # noqa: E402
from repro.link import dynamics as JD  # noqa: E402
from repro.link import estimator as JE  # noqa: E402
from repro.link import policy as JP  # noqa: E402
from repro.link import scenario as JS  # noqa: E402
from repro_torch.compress import sparsify as TSP  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import latency as TL  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.core import transport as TT  # noqa: E402
from repro_torch.link import dynamics as TD  # noqa: E402
from repro_torch.link import estimator as TE  # noqa: E402
from repro_torch.link import policy as TP  # noqa: E402
from repro_torch.link import scenario as TS  # noqa: E402

NORMAL_ULP = 128  # prng.normal against jax.random.normal
# gamma returns d * v^3 with v = 1 + x c; for a >= 16, |x c| < 1 at
# |x| < 6, so v's relative error is below x's and V's is three times it.
GAMMA_ULP = 3 * NORMAL_ULP + 4
EDGE_DB = 1e-4
AIR_RTOL = 2.0**-20


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


def _ulp(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _bounded(ref, got, max_ulp):
    u = _ulp(np.asarray(ref), got.numpy())
    assert u.max() <= max_ulp, u.max()
    return int(u.max())


# ------------------------------------------------------------------ dynamics


@pytest.mark.parametrize("doppler,interval", [
    (0.0, 1.0), (5.0, 0.01), (5.0, 0.05), (20.0, 0.02), (100.0, 0.004),
    (100.0, 1.0), (0.3, 1.0)])
def test_jakes_rho_exact(doppler, interval):
    assert TD.jakes_rho(doppler, interval) == JD.jakes_rho(doppler, interval)


def test_dynamics_presets_exact():
    assert list(TD.DYNAMICS_PRESETS) == list(JD.DYNAMICS_PRESETS)
    for name, cfg in JD.DYNAMICS_PRESETS.items():
        assert (dataclasses.asdict(TD.DYNAMICS_PRESETS[name])
                == dataclasses.asdict(cfg)), name
        assert (TD._stationary_blocked_prob(TD.DYNAMICS_PRESETS[name])
                == JD._stationary_blocked_prob(cfg))


@pytest.mark.parametrize("preset", sorted(JD.DYNAMICS_PRESETS))
def test_init_step_vs_reference(preset):
    jc, tc = JD.DYNAMICS_PRESETS[preset], TD.DYNAMICS_PRESETS[preset]
    js = JD.init_state(jax.random.PRNGKey(4), 64, jc)
    ts = TD.init_state(P.PRNGKey(4), 64, tc)
    np.testing.assert_array_equal(ts.offset_db.numpy(),
                                  np.asarray(js.offset_db))
    np.testing.assert_array_equal(ts.blocked.numpy(), np.asarray(js.blocked))
    _bounded(js.fast_db, ts.fast_db, NORMAL_ULP)
    _bounded(js.shadow_db, ts.shadow_db, NORMAL_ULP)
    for r in range(4):
        js, jsnr = JD.step(js, jax.random.PRNGKey(10 + r), jc)
        ts, tsnr = TD.step(ts, P.PRNGKey(10 + r), tc)
        np.testing.assert_array_equal(ts.blocked.numpy(),
                                      np.asarray(js.blocked))
        np.testing.assert_array_equal(ts.offset_db.numpy(),
                                      np.asarray(js.offset_db))
        # sums of normal-derived terms around 10 dB: absolute bound
        np.testing.assert_allclose(tsnr.numpy(), np.asarray(jsnr),
                                   rtol=0, atol=1e-4)


def test_trajectory_vs_reference():
    cfg_j, cfg_t = JD.DYNAMICS_PRESETS["bursty"], TD.DYNAMICS_PRESETS["bursty"]
    j = np.asarray(JD.trajectory(jax.random.PRNGKey(2), cfg_j, 16, 6))
    t = TD.trajectory(P.PRNGKey(2), cfg_t, 16, 6).numpy()
    assert t.shape == j.shape == (6, 16)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)
    # the blockage spells (an 18 dB drop) are the Exact part
    np.testing.assert_array_equal(t < 0, j < 0)


def test_event_layer_names_its_item():
    """Item 7's event layer is ported: the four draws run on the key's
    device and equal the reference's on the degenerate configs (the full
    grades are in ``tests/test_torch_async.py``)."""
    key, jkey = P.PRNGKey(0), jax.random.PRNGKey(0)
    for got, ref in (
            (TD.compute_times(key, TD.ComputeTimeConfig(), 4),
             JD.compute_times(jkey, JD.ComputeTimeConfig(), 4)),
            (TD.client_speed_factors(key, 4, TD.ComputeTimeConfig()),
             JD.client_speed_factors(jkey, 4, JD.ComputeTimeConfig())),
            (TD.idle_gaps(key, 4, TD.ArrivalConfig()),
             JD.idle_gaps(jkey, 4, JD.ArrivalConfig())),
            (TD.churn_step(key, torch.ones(4), TD.ArrivalConfig()),
             JD.churn_step(jkey, jnp.ones(4), JD.ArrivalConfig()))):
        assert got.device == key.device and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------------------ prng


@pytest.mark.parametrize("lo,hi", [(-6.0, 6.0), (-2.0, 2.0), (0.25, 3.0)])
def test_uniform_range_exact(lo, hi):
    """``uniform`` over ``[minval, maxval)``, which the dynamics' offsets
    draw: XLA computes the scale and shift as one fma, and so does the
    port."""
    separate = 0
    for seed in range(3):
        ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed),
                                            (4096,), jnp.float32, lo, hi))
        np.testing.assert_array_equal(
            P.uniform(P.PRNGKey(seed), (4096,), lo, hi).numpy(), ref)
        # the same draws as a float32 multiply, then an add
        unit = P._bits_to_unit_f32(P.random_bits(P.PRNGKey(seed),
                                                 (4096,))).numpy()
        lo32, span = np.float32(lo), np.float32(hi) - np.float32(lo)
        separate += int((np.maximum(lo32, unit * span + lo32) != ref).sum())
    print(f"[{lo}, {hi}): a separate multiply-add differs from the "
          f"reference in {separate} of {3 * 4096} draws")


@pytest.mark.parametrize("p", [0.0, 0.05, 0.2, 0.5, 0.9, 1.0])
def test_bernoulli_exact(p):
    for seed in range(3):
        np.testing.assert_array_equal(
            P.bernoulli(P.PRNGKey(seed), p, (2000,)).numpy(),
            np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), p,
                                            (2000,))))


@pytest.mark.parametrize("a", [16.0, 64.0])
def test_gamma_bounded(a):
    """Same keys, same rejection steps: every draw within GAMMA_ULP (a
    draw that took another number of rejections would be a different
    number altogether)."""
    worst = 0
    for seed in range(8):
        j = jax.random.gamma(jax.random.PRNGKey(seed), a, (256,),
                             jnp.float32)
        worst = max(worst, _bounded(j, P.gamma(P.PRNGKey(seed), a, (256,)),
                                    GAMMA_ULP))
    print(f"gamma({a}): largest difference {worst} ULP")


@pytest.mark.parametrize("a", [0.5, 16.0])
def test_gamma_statistical(a):
    n = 100_000
    s = P.gamma(P.PRNGKey(1), a, (n,)).numpy().astype(np.float64)
    assert sps.kstest(s, "gamma", args=(a,)).pvalue > 1e-3
    assert abs(s.mean() - a) < 5 * np.sqrt(a / n)
    # Var of the sample variance: sigma^4 (2 + 6/a) / n for Gamma(a, 1)
    assert abs(s.var() - a) < 5 * a * np.sqrt((2 + 6 / a) / n)


# ------------------------------------------------------------------ estimator


def test_oracle_estimator_exact():
    snr = np.linspace(-5, 30, 41).astype(np.float32)
    for bias in (0.0, 1.5):
        jc = JE.EstimatorConfig(n_pilots=0, bias_db=bias)
        tc = TE.EstimatorConfig(n_pilots=0, bias_db=bias)
        np.testing.assert_array_equal(
            TE.estimate_snr_db(torch.from_numpy(snr), P.PRNGKey(0),
                               tc).numpy(),
            np.asarray(JE.estimate_snr_db(jnp.asarray(snr),
                                          jax.random.PRNGKey(0), jc)))


@pytest.mark.parametrize("n_pilots", [16, 64])
def test_pilot_estimate_bounded(n_pilots):
    snr = np.linspace(-5, 30, 64).astype(np.float32)
    jc = JE.EstimatorConfig(n_pilots=n_pilots, bias_db=0.5)
    tc = TE.EstimatorConfig(n_pilots=n_pilots, bias_db=0.5)
    j = np.asarray(JE.estimate_snr_db(jnp.asarray(snr),
                                      jax.random.PRNGKey(3), jc))
    t = TE.estimate_snr_db(torch.from_numpy(snr), P.PRNGKey(3), tc).numpy()
    # 10 log10(G) moves by 10/ln(10) * (G's relative error) dB
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)


def test_staleness_mask_exact():
    """Stale clients take the previous estimate bit for bit; fresh ones
    take the oracle's value: the mask itself is Exact."""
    snr = np.linspace(0, 20, 200).astype(np.float32)
    prev = np.full(200, -99.0, np.float32)
    jc = JE.EstimatorConfig(n_pilots=0, stale_prob=0.3)
    tc = TE.EstimatorConfig(n_pilots=0, stale_prob=0.3)
    j = np.asarray(JE.step_estimate(jnp.asarray(snr), jnp.asarray(prev),
                                    jax.random.PRNGKey(5), jc))
    t = TE.step_estimate(torch.from_numpy(snr), torch.from_numpy(prev),
                         P.PRNGKey(5), tc).numpy()
    np.testing.assert_array_equal(t, j)
    assert 0 < (t == -99.0).sum() < 200


# ------------------------------------------------------------------ policy


def _edge_grid(cfg):
    """Every threshold and threshold +- h, each with its float32
    neighbours, plus a coarse sweep."""
    h = cfg.hysteresis_db / 2.0
    pts = []
    for thr in cfg.thresholds_db:
        for p in (thr - h, thr, thr + h):
            p32 = np.float32(p)
            pts += [np.nextafter(p32, np.float32(-np.inf)), p32,
                    np.nextafter(p32, np.float32(np.inf))]
    pts += list(np.linspace(-10, 40, 101, dtype=np.float32))
    return np.asarray(pts, np.float32)


def test_initial_and_downlink_mode_exact():
    jc, tc = JP.PolicyConfig(), TP.PolicyConfig()
    snr = _edge_grid(jc)
    np.testing.assert_array_equal(
        TP.initial_mode(torch.from_numpy(snr), tc).numpy(),
        np.asarray(JP.initial_mode(jnp.asarray(snr), jc)))
    for off in (0.0, 3.0, -2.5):
        np.testing.assert_array_equal(
            TP.downlink_mode(torch.from_numpy(snr), tc, off).numpy(),
            np.asarray(JP.downlink_mode(jnp.asarray(snr), jc, off)))


@pytest.mark.parametrize("hyst", [0.0, 2.0, 3.0])
def test_choose_mode_exact(hyst):
    jc = JP.PolicyConfig(hysteresis_db=hyst)
    tc = TP.PolicyConfig(hysteresis_db=hyst)
    snr = _edge_grid(jc)
    n = snr.size
    rng = np.random.default_rng(0)
    observed = (rng.uniform(size=n) < 0.7).astype(np.float32)
    for prev_m in range(4):
        prev = np.full(n, prev_m, np.int32)
        for obs in (None, observed):
            j = JP.choose_mode(jnp.asarray(snr), jnp.asarray(prev), jc,
                               observed=None if obs is None
                               else jnp.asarray(obs))
            t = TP.choose_mode(torch.from_numpy(snr), torch.from_numpy(prev),
                               tc, observed=None if obs is None
                               else torch.from_numpy(obs))
            assert t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_policy_helpers_exact():
    assert TP.mode_names(TP.PolicyConfig()) == JP.mode_names(
        JP.PolicyConfig())
    fj, ft = JP.fixed_policy("ecrt", "16qam"), TP.fixed_policy("ecrt",
                                                                 "16qam")
    assert dataclasses.asdict(fj) == dataclasses.asdict(ft)
    for cfg_j, cfg_t in ((JP.PolicyConfig(), TP.PolicyConfig()), (fj, ft)):
        assert (TP.ecrt_anchor_snr_db(cfg_t, 9.5)
                == JP.ecrt_anchor_snr_db(cfg_j, 9.5))
    ratios = (0.01, 0.02, 0.05, 0.1)
    for r in (None, ratios):
        assert (TP.compress_k_table(TP.PolicyConfig(compress_ratios=r),
                                    21840, 0.02)
                == JP.compress_k_table(JP.PolicyConfig(compress_ratios=r),
                                       21840, 0.02))
    for bad in (dict(thresholds_db=(6.0,)),
                dict(thresholds_db=(16.0, 6.0, 26.0)),
                dict(compress_ratios=(0.1,)),
                dict(compress_ratios=(0.1, 0.2, 0.0, 1.0))):
        with pytest.raises(ValueError):
            JP.PolicyConfig(**bad)
        with pytest.raises(ValueError):
            TP.PolicyConfig(**bad)


def _row_fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("ldpc")
    return d


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_build_mode_cfgs_rows_exact(use_kernel, wire):
    jb = JT.TransportConfig(use_kernel=use_kernel, wire_dtype=wire,
                            channel=JCH.ChannelConfig(snr_db=12.0))
    tb = TT.TransportConfig(use_kernel=use_kernel, wire_dtype=wire,
                            channel=TCH.ChannelConfig(snr_db=12.0))
    jr = JP.build_mode_cfgs(jb, JP.PolicyConfig(), ecrt_expected_tx=2.25)
    tr = TP.build_mode_cfgs(tb, TP.PolicyConfig(), ecrt_expected_tx=2.25,
                            device="cpu")
    assert [_row_fields(c) for c in tr] == [_row_fields(c) for c in jr]
    assert [c.use_kernel for c in tr] == [False] + [use_kernel] * 3


def test_build_mode_cfgs_rejects_64qam():
    pol = dict(modes=(("ecrt", "qpsk"), ("approx", "64qam")),
               thresholds_db=(6.0,))
    with pytest.raises(ValueError, match="64qam"):
        JP.build_mode_cfgs(JT.TransportConfig(), JP.PolicyConfig(**pol),
                           ecrt_expected_tx=2.0)
    with pytest.raises(ValueError, match="64qam"):
        TP.build_mode_cfgs(TT.TransportConfig(), TP.PolicyConfig(**pol),
                           ecrt_expected_tx=2.0, device="cpu")


def test_build_mode_cfgs_calibrated_ecrt_exact():
    """``ecrt_expected_tx=None``: E[tx] calibrated at the anchor (6 dB)
    with 48 codewords, the same value in both packages."""
    jr = JP.build_mode_cfgs(JT.TransportConfig(), JP.PolicyConfig())
    tr = TP.build_mode_cfgs(TT.TransportConfig(), TP.PolicyConfig(),
                            device="cpu")
    assert tr[0].ecrt_expected_tx == jr[0].ecrt_expected_tx > 1.0
    assert tr[0].ecrt_expected_tx == TL.calibrate_ecrt(
        6.0, "qpsk", n_codewords=48, max_tx=6, device="cpu")


# ------------------------------------------------------------------ scenarios


def test_scenario_presets_field_by_field():
    assert TS.list_scenarios() == JS.list_scenarios()
    assert len(TS.list_scenarios()) == 11
    for name in JS.list_scenarios():
        assert (dataclasses.asdict(TS.get_scenario(name))
                == dataclasses.asdict(JS.get_scenario(name))), name
    with pytest.raises(KeyError, match="registered"):
        TS.get_scenario("no-such-scenario")


def test_compression_config_validation():
    assert (dataclasses.asdict(TSP.CompressionConfig(ratio=0.1))
            == dataclasses.asdict(
                JS.CompressionConfig(ratio=0.1)))
    for bad in (dict(method="median"), dict(header="shouted"),
                dict(ratio=0.0), dict(k=0)):
        with pytest.raises(ValueError):
            TSP.CompressionConfig(**bad)
        with pytest.raises(ValueError):
            JS.CompressionConfig(**bad)


def _edges_of(est, cfg):
    """Clients whose estimate lies within EDGE_DB of a decision edge."""
    h = cfg.hysteresis_db / 2.0
    edges = np.asarray([t + s for t in cfg.thresholds_db for s in (-h, 0, h)],
                       np.float32)
    if edges.size == 0:
        return np.zeros(est.shape, bool)
    return (np.abs(est[:, None] - edges[None, :]) < EDGE_DB).any(axis=1)


def _drivers(name, oracle=False):
    """The preset in both packages at a fixed E[tx] (no calibration),
    with the oracle estimator if asked."""
    js, ts = JS.get_scenario(name), TS.get_scenario(name)
    js = dataclasses.replace(js, ecrt_expected_tx=2.0, estimator=(
        dataclasses.replace(js.estimator, n_pilots=0) if oracle
        else js.estimator))
    ts = dataclasses.replace(ts, ecrt_expected_tx=2.0, estimator=(
        dataclasses.replace(ts.estimator, n_pilots=0) if oracle
        else ts.estimator))
    jd = JS.ScenarioDriver(js, JT.TransportConfig(
        channel=JCH.ChannelConfig(snr_db=10.0)))
    td = TS.ScenarioDriver(ts, TT.TransportConfig(
        channel=TCH.ChannelConfig(snr_db=10.0)), device="cpu")
    return jd, td


@pytest.mark.parametrize("name,oracle", [
    ("vehicular", False), ("vehicular", True), ("iot-flaky", False)])
def test_driver_rounds_vs_reference(name, oracle):
    """Five rounds of ``init`` / ``round`` / ``airtime``; the stats come
    from each package's own mixed-mode uplink of a small payload."""
    jd, td = _drivers(name, oracle)
    m = 48
    jst, jm, je = jd.init(jax.random.PRNGKey(7), m)
    tst, tm, te = td.init(P.PRNGKey(7), m)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    x = np.random.default_rng(1).uniform(-0.5, 0.5, (m, 64)).astype(
        np.float32)
    tm_j, tm_t = JL.PhyTimings(), TL.PhyTimings()
    tainted = np.zeros(m, bool)
    for r in range(5):
        jst, jr = jd.round(jst, jm, je, jax.random.PRNGKey(100 + r))
        tst, tr = td.round(tst, tm, te, P.PRNGKey(100 + r))
        jm, je, tm, te = jr.mode, jr.est_db, tr.mode, tr.est_db
        if oracle:
            np.testing.assert_allclose(tr.est_db.numpy(), np.asarray(jr.snr_db),
                                       rtol=0, atol=1e-4)
        else:
            tainted |= _edges_of(np.asarray(jr.est_db), jd.scenario.policy)
        np.testing.assert_array_equal(tr.active.numpy(),
                                      np.asarray(jr.active))
        np.testing.assert_array_equal(tr.straggler.numpy(),
                                      np.asarray(jr.straggler))
        calm = ~tainted
        np.testing.assert_array_equal(tr.mode.numpy()[calm],
                                      np.asarray(jr.mode)[calm])
        np.testing.assert_allclose(tr.snr_db.numpy(), np.asarray(jr.snr_db),
                                   rtol=0, atol=1e-4)
        # airtime of the round's own mixed-mode uplink
        _, sj = JT.transmit_batch_adaptive(
            jnp.asarray(x), jax.random.PRNGKey(r), jd.mode_cfgs, jr.mode,
            snr_db=jr.snr_db, dispatch="bucketed")
        _, st = TT.transmit_batch_adaptive(
            torch.from_numpy(x), P.PRNGKey(r), td.mode_cfgs, tr.mode,
            snr_db=tr.snr_db, device="cpu")
        aj = np.asarray(jd.airtime(sj, jr, tm_j))
        at = td.airtime(st, tr, tm_t).numpy()
        np.testing.assert_allclose(at[calm], aj[calm], rtol=AIR_RTOL)
        if not tainted.any():
            counts = np.bincount(np.asarray(jr.mode), minlength=4)
            np.testing.assert_array_equal(
                np.bincount(tr.mode.numpy(), minlength=4), counts)
    print(f"{name} (oracle={oracle}): edge clients {int(tainted.sum())}")


def test_driver_interpolated_ecrt_airtime():
    """The calibrated-ECRT airtime rescale, on a given curve (calibrating
    the curve in the reference takes tens of seconds): ECRT clients priced
    at E[tx] interpolated at their SNR over the anchor constant."""
    jd, td = _drivers("vehicular")
    grid = np.asarray([-5.0, 1.5, 6.0, 8.0], np.float32)
    vals = np.asarray([6.0, 3.0625, 1.4583334, 1.3125], np.float32)
    jd._interp_ecrt_airtime = td._interp_ecrt_airtime = True
    jd._ecrt_curve = (jnp.asarray(grid), jnp.asarray(vals))
    td._ecrt_curve = (torch.from_numpy(grid), torch.from_numpy(vals))
    m = 40
    snr = np.linspace(-5, 9, m).astype(np.float32)
    mode = np.tile(np.arange(4, dtype=np.int32), m // 4)
    x = np.zeros((m, 32), np.float32)
    _, sj = JT.transmit_batch_adaptive(jnp.asarray(x), jax.random.PRNGKey(0),
                                       jd.mode_cfgs, mode, snr_db=snr)
    _, st = TT.transmit_batch_adaptive(torch.from_numpy(x), P.PRNGKey(0),
                                       td.mode_cfgs, mode, snr_db=snr,
                                       device="cpu")
    act = (np.arange(m) % 7 != 3).astype(np.float32)
    strag = (np.arange(m) % 5 == 1).astype(np.float32)
    jr = JS.LinkRound(jnp.asarray(snr), jnp.asarray(snr), jnp.asarray(mode),
                      jnp.asarray(act), jnp.asarray(strag))
    tr = TS.LinkRound(*(torch.from_numpy(v) for v in
                        (snr, snr, mode, act, strag)))
    aj = np.asarray(jd.airtime(sj, jr, JL.PhyTimings()))
    at = td.airtime(st, tr, TL.PhyTimings()).numpy()
    np.testing.assert_allclose(at, aj, rtol=AIR_RTOL)
    assert (at[act == 0] == 0).all() and at[mode == 0].max() > at[
        mode == 1].max()
