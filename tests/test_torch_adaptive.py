"""The port's mixed-mode uplink against the reference's
(``transport.transmit_batch_adaptive[_aggregate]``).

* Exact — ``_bucket_capacity``; ``TxStats`` counters and ``mode_idx``
  (clamped); the layered and analytic-ECRT rows' words, except where a
  symbol's demod pre-round value lies within ``layered_edge(L)`` of a
  decision edge (``transport._word_margins``; the normals behind the
  channel are Bounded); kernel rows (the plain K1 on the CPU against the
  reference's Pallas kernel in interpret mode) except within ``EDGE`` of
  a half-integer, as in ``test_torch_transport.py``; inside the port,
  bucketed and select on the same table, bit for bit.
* The fused aggregate: Exact with power-of-two weights; with other weights
  XLA on the CPU fuses each client's multiply-add into an fma (ROADMAP
  Queue 3), so each client's step may round once more or less: a lane
  may differ by ``M * 2**-23`` times its ``sum_c |w_c x_c|``. Lanes where
  any client's word sits at a decision edge are left out.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import channel as JCH  # noqa: E402
from repro.core import latency as JL  # noqa: E402
from repro.core import transport as JT  # noqa: E402
from repro.link import policy as JP  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import latency as TL  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.core import transport as TT  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.link import policy as TP  # noqa: E402

EDGE = 1e-4
STAT_FIELDS = ("data_symbols", "transmissions", "n_bits", "bits_on_air")
M = 12
# every mode present, two clients out of mode order, one empty slot
MODES = np.asarray([1, 0, 2, 3, 1, 1, 0, 2, 3, 1, 2, 1], np.int32)


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


def _tables(use_kernel=False, wire="float32", snr_db=10.0):
    jb = JT.TransportConfig(use_kernel=use_kernel, wire_dtype=wire,
                            channel=JCH.ChannelConfig(snr_db=snr_db))
    tb = TT.TransportConfig(use_kernel=use_kernel, wire_dtype=wire,
                            channel=TCH.ChannelConfig(snr_db=snr_db))
    return (JP.build_mode_cfgs(jb, JP.PolicyConfig(), ecrt_expected_tx=2.0),
            TP.build_mode_cfgs(tb, TP.PolicyConfig(), ecrt_expected_tx=2.0,
                               device="cpu"))


def _payload(m=M, n=600, seed=0):
    return np.random.default_rng(seed).uniform(-0.9, 0.9, (m, n)).astype(
        np.float32)


def _snr(m=M):
    return np.linspace(4.0, 24.0, m).astype(np.float32)


def _margins(x, key, cfgs, modes, snr):
    """Per-word decision margins of each client's row under its mode:
    the layered PHY's (``_word_margins``, compared against
    ``layered_edge``) or the kernel's (compared against ``EDGE``); ECRT
    rows are exact (``inf``)."""
    keys = TT.client_keys(key, x.shape[0])
    out = np.full(x.shape, np.inf)
    for m, cfg in enumerate(cfgs):
        idx = np.nonzero(modes == m)[0]
        if idx.size == 0 or cfg.mode not in ("approx", "naive"):
            continue
        xs, ks = torch.from_numpy(x[idx]), keys[idx]
        ss = None if snr is None else torch.from_numpy(snr[idx])
        if cfg.use_kernel:
            n = x.shape[1]
            xp = torch.nn.functional.pad(xs, (0, (-n) % 1024))
            wb, mask, k = TT._transport_kernel_params(cfg)
            if wb == 16:
                xp = xp.to(torch.bfloat16)
            npow, gains = TT._link_params(cfg, idx.size, ss,
                                          torch.device("cpu"))
            _, _, edges = TR.approx_channel_batch_ref(
                xp, TO._seed_from_key(ks), npow, gains, bits_per_symbol=k,
                fading=cfg.channel.fading, fade_block=cfg.channel.block_len,
                clamp_mask=mask, word_bits=wb, with_edges=True)
            out[idx] = edges[:, :n].numpy() / EDGE
        else:
            mg = TT._word_margins(xs, ks, cfg, ss).numpy()
            out[idx] = mg / layered_edge(cfg.scheme.levels)
    return out  # < 1 where a word may flip


def _diff(ref, got):
    ref, got = np.asarray(ref), got.numpy()
    return (ref.view(np.uint32) != got.view(np.uint32)) & ~(
        np.isnan(ref) & np.isnan(got))


def _check_stats(js, ts, exact_errors):
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    np.testing.assert_array_equal(ts.mode_idx.numpy(),
                                  np.asarray(js.mode_idx))
    if exact_errors:
        np.testing.assert_array_equal(ts.bit_errors.numpy(),
                                      np.asarray(js.bit_errors))


def test_bucket_capacity_exact():
    for c in range(0, 301):
        assert TT._bucket_capacity(c) == JT._bucket_capacity(c), c
    assert TT._bucket_capacity(100) == 112 and TT._bucket_capacity(29) == 32


@pytest.mark.parametrize("with_snr", [False, True])
@pytest.mark.parametrize("dispatch", ["bucketed", "select"])
def test_adaptive_layered_vs_reference(dispatch, with_snr):
    jc, tc = _tables()
    x, snr = _payload(), (_snr() if with_snr else None)
    xj, sj = JT.transmit_batch_adaptive(
        jnp.asarray(x), jax.random.PRNGKey(3), jc, jnp.asarray(MODES),
        snr_db=None if snr is None else jnp.asarray(snr), dispatch=dispatch)
    xt, st = TT.transmit_batch_adaptive(
        torch.from_numpy(x), P.PRNGKey(3), tc, torch.from_numpy(MODES),
        snr_db=None if snr is None else torch.from_numpy(snr),
        dispatch=dispatch, device="cpu")
    diff = _diff(xj, xt)
    assert np.all(_margins(x, P.PRNGKey(3), tc, MODES, snr)[diff] < 1)
    _check_stats(sj, st, not diff.any())
    print(f"{dispatch} snr={with_snr}: words differing {int(diff.sum())}")


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_adaptive_kernel_rows_vs_pallas(wire):
    """Kernel rows: one plain-K1 batch per uncoded bucket, padded to its
    capacity with the tail masked, against the reference's bucketed
    dispatch through its Pallas kernel (interpret mode on the CPU)."""
    jc, tc = _tables(use_kernel=True, wire=wire)
    x, snr = _payload(n=1000, seed=1), _snr()
    xj, sj = JT.transmit_batch_adaptive(
        jnp.asarray(x), jax.random.PRNGKey(5), jc, jnp.asarray(MODES),
        snr_db=jnp.asarray(snr), dispatch="bucketed")
    xt, st = TT.transmit_batch_adaptive(
        torch.from_numpy(x), P.PRNGKey(5), tc, MODES,
        snr_db=torch.from_numpy(snr), device="cpu")
    diff = _diff(xj, xt)
    assert np.all(_margins(x, P.PRNGKey(5), tc, MODES, snr)[diff] < 1)
    _check_stats(sj, st, not diff.any())


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("pow2", [True, False])
def test_adaptive_aggregate_vs_reference(pow2, use_kernel):
    """Per-bucket partials added in mode order. Power-of-two weights:
    Exact. Other weights: one rounding per client step apart (XLA's
    fma)."""
    jc, tc = _tables(use_kernel=use_kernel)
    x, snr = _payload(n=1000, seed=2), _snr()
    if pow2:
        w = np.full(M, 1 / 16, np.float32)
    else:
        w = np.random.default_rng(3).uniform(0.2, 2.0, M).astype(np.float32)
        w = (w / w.sum()).astype(np.float32)
    aj, sj = JT.transmit_batch_adaptive_aggregate(
        jnp.asarray(x), jax.random.PRNGKey(6), jc, jnp.asarray(MODES),
        jnp.asarray(w), snr_db=jnp.asarray(snr))
    at, st = TT.transmit_batch_adaptive_aggregate(
        torch.from_numpy(x), P.PRNGKey(6), tc, torch.from_numpy(MODES),
        torch.from_numpy(w), snr_db=torch.from_numpy(snr), device="cpu")
    assert at.shape == (1000,) and at.dtype == torch.float32
    calm = np.all(_margins(x, P.PRNGKey(6), tc, MODES, snr) >= 1, axis=0)
    aj, at = np.asarray(aj)[calm], at.numpy()[calm]
    if pow2:
        np.testing.assert_array_equal(at.view(np.int32), aj.view(np.int32))
    else:
        rows, _ = TT.transmit_batch_adaptive(
            torch.from_numpy(x), P.PRNGKey(6), tc, MODES,
            snr_db=torch.from_numpy(snr), device="cpu")
        scale = np.abs(w[:, None] * rows.numpy()).sum(axis=0)[calm]
        err = np.abs(aj.astype(np.float64) - at)
        assert np.all(err <= M * 2.0**-23 * scale)
        print(f"kernel={use_kernel}: calm lanes {int(calm.sum())}, lanes "
              f"differing {int((err > 0).sum())}, largest relative to the "
              f"bound {float((err / (M * 2.0**-23 * scale)).max()):.3g}")
    _check_stats(sj, st, False)


def test_port_bucketed_equals_select_and_aggregate():
    """Inside the port: a row does not depend on its bucket's padding, so
    bucketed (kernel rows cleared) and select agree bit for bit; a
    one-mode cohort's adaptive aggregate is ``transmit_batch_aggregate``."""
    _, tc = _tables()
    x = torch.from_numpy(_payload(m=29, n=700, seed=4))
    modes = np.random.default_rng(5).integers(0, 4, 29)
    snr = torch.linspace(0.0, 26.0, 29)
    xb, sb = TT.transmit_batch_adaptive(x, P.PRNGKey(8), tc, modes,
                                        snr_db=snr, dispatch="bucketed",
                                        device="cpu")
    xs, ss = TT.transmit_batch_adaptive(x, P.PRNGKey(8), tc, modes,
                                        snr_db=snr, dispatch="select",
                                        device="cpu")
    assert torch.equal(xb.view(torch.int32), xs.view(torch.int32))
    for f in STAT_FIELDS + ("bit_errors", "mode_idx"):
        assert torch.equal(getattr(sb, f), getattr(ss, f))
    w = torch.full((29,), 0.25)
    one = np.ones(29, np.int64)
    agg, _ = TT.transmit_batch_adaptive_aggregate(x, P.PRNGKey(8), tc, one,
                                                  w, device="cpu")
    ref, _ = TT.transmit_batch_aggregate(x, P.PRNGKey(8), tc[1], w,
                                         device="cpu")
    assert torch.equal(agg.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("dispatch", ["bucketed", "select"])
def test_out_of_range_modes_clamp(dispatch):
    jc, tc = _tables()
    modes = np.asarray([-3, 0, 1, 9, 2, 3], np.int32)
    x = _payload(m=6, n=200, seed=6)
    xj, sj = JT.transmit_batch_adaptive(jnp.asarray(x), jax.random.PRNGKey(1),
                                        jc, jnp.asarray(modes),
                                        dispatch=dispatch)
    xt, st = TT.transmit_batch_adaptive(torch.from_numpy(x), P.PRNGKey(1),
                                        tc, modes, dispatch=dispatch,
                                        device="cpu")
    np.testing.assert_array_equal(st.mode_idx.numpy(), [0, 0, 1, 3, 2, 3])
    diff = _diff(xj, xt)
    assert np.all(_margins(x, P.PRNGKey(1), tc, np.clip(modes, 0, 3),
                           None)[diff] < 1)
    _check_stats(sj, st, not diff.any())


def test_empty_cohort():
    _, tc = _tables()
    x = torch.zeros((0, 64))
    for dispatch in ("bucketed", "select"):
        xh, st = TT.transmit_batch_adaptive(x, P.PRNGKey(0), tc,
                                            np.zeros(0, np.int32),
                                            dispatch=dispatch, device="cpu")
        assert xh.shape == (0, 64)
        assert all(getattr(st, f).shape == (0,) for f in STAT_FIELDS)
        assert st.mode_idx.shape == (0,)
    agg, st = TT.transmit_batch_adaptive_aggregate(
        x, P.PRNGKey(0), tc, np.zeros(0, np.int32), torch.zeros(0),
        device="cpu")
    assert torch.equal(agg, torch.zeros(64)) and st.n_bits.shape == (0,)


def test_round_airtime_adaptive_vs_reference():
    jc, tc = _tables()
    x = _payload(n=300, seed=7)
    _, sj = JT.transmit_batch_adaptive(jnp.asarray(x), jax.random.PRNGKey(2),
                                       jc, jnp.asarray(MODES))
    _, st = TT.transmit_batch_adaptive(torch.from_numpy(x), P.PRNGKey(2),
                                       tc, MODES, device="cpu")
    aj = np.asarray(JL.round_airtime_adaptive(sj, JL.PhyTimings(), jc))
    at = TL.round_airtime_adaptive(st, TL.PhyTimings(), tc).numpy()
    np.testing.assert_array_equal(at, aj)
    # ECRT rows pay the stall and E[tx] times the data
    assert at[MODES == 0].min() > 2 * at[MODES == 1].max()
    with pytest.raises(ValueError, match="mode_idx"):
        TL.round_airtime_adaptive(dataclasses.replace(st, mode_idx=None),
                                  TL.PhyTimings(), tc)


def test_adaptive_validation():
    jc, tc = _tables(use_kernel=True)
    x = torch.zeros((4, 64))
    modes = np.zeros(4, np.int32)
    with pytest.raises(ValueError, match="select"):
        JT.transmit_batch_adaptive(jnp.zeros((4, 64)), jax.random.PRNGKey(0),
                                   jc, jnp.asarray(modes), dispatch="select")
    with pytest.raises(ValueError, match="select"):
        TT.transmit_batch_adaptive(x, P.PRNGKey(0), tc, modes,
                                   dispatch="select", device="cpu")
    # clearing the kernel rows makes the table legal for select
    TT.transmit_batch_adaptive(x, P.PRNGKey(0), TT.clear_kernel_rows(tc),
                               modes, dispatch="select", device="cpu")
    assert [c.use_kernel for c in TT.clear_kernel_rows(tc)] == [False] * 4
    with pytest.raises(ValueError, match="dispatch"):
        TT.transmit_batch_adaptive(x, P.PRNGKey(0), tc, modes,
                                   dispatch="sideways", device="cpu")
    with pytest.raises(ValueError, match="mode_idx"):
        TT.transmit_batch_adaptive(x, P.PRNGKey(0), tc, modes[:3],
                                   device="cpu")
    with pytest.raises(ValueError, match="config table"):
        TT.transmit_batch_adaptive(x, P.PRNGKey(0), (), modes, device="cpu")
    other = dataclasses.replace(
        tc[1], channel=TCH.ChannelConfig(snr_db=3.0))
    with pytest.raises(ValueError, match="ChannelConfig"):
        TT.transmit_batch_adaptive(x, P.PRNGKey(0), (tc[0], other), modes,
                                   device="cpu")


def test_same_channel_normalizes_snr_shapes():
    for a, b, want in ((10.0, np.float32(10.0), True), (10.0, (10.0,), True),
                       ((1.0, 2.0), np.asarray([1.0, 2.0]), True),
                       ((1.0, 2.0), (1.0, 3.0), False),
                       ((1.0, 2.0), (1.0, 2.0, 3.0), False)):
        ja, jb = JCH.ChannelConfig(snr_db=a), JCH.ChannelConfig(snr_db=b)
        ta, tb = TCH.ChannelConfig(snr_db=a), TCH.ChannelConfig(snr_db=b)
        assert TT._same_channel(ta, tb) == JT._same_channel(ja, jb) == want
