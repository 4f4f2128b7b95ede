"""The port's downlink broadcast against the reference's
(``transport.transmit_broadcast[_adaptive]``, ``latency.broadcast_airtime``
and the engine's ``downlink=`` leg).

* Exact — ``broadcast_airtime`` (the same float32 numpy reductions);
  the key schedule (client ``i`` on ``fold_in(key, DOWNLINK_KEY_LANE +
  i)``) and so each broadcast row against ``transport_flat`` on that key;
  ``TxStats`` counters and ``mode_idx``; a ``perfect`` broadcast, the
  identity bit for bit on seeded float32 values, ``-0.0``, subnormals and
  +-1.9; the ``use_kernel`` broadcast (the plain K1 on the CPU against the
  reference's Pallas kernel in interpret mode) except within ``EDGE`` of a
  half-integer; inside the port, the adaptive broadcast's bucketed and
  select dispatches on one table, and ``downlink=DownlinkConfig(mode=
  "perfect")`` against ``downlink=None``, bit for bit.
* Layered-PHY broadcast words against the reference: equal except where a
  symbol's demod pre-round value lies within ``layered_edge(L)`` of a
  decision edge (``transport._word_margins``), as ``test_torch_phy.py``
  grades them.
* Engine runs: the link dicts in the reference's key order, downlink mode
  counts Exact, airtimes within ``rel=2**-20`` (float32 sums), round 0's
  downlink BER Exact (the same model through the same channel), accuracy
  within ``ACC_TOL`` (2 of 160 test images) at every eval point.

The reference's own identity test (``tests/test_downlink.py``) draws
``st.floats(min_value=-1.9, max_value=1.9, width=32)``, which hypothesis
rejects (-1.9 is not a float32); the seeded values here include the
float32 neighbours of +-1.9 instead.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.mnist_cnn import config as j_config  # noqa: E402
from repro.core import channel as JCH  # noqa: E402
from repro.core import latency as JL  # noqa: E402
from repro.core import transport as JT  # noqa: E402
from repro.data import synth_mnist as j_synth  # noqa: E402
from repro.fl import cnn as JC  # noqa: E402
from repro.fl import engine as JEN  # noqa: E402
from repro.fl import partition as j_partition  # noqa: E402
from repro.link import policy as JP  # noqa: E402
from repro.link import scenario as JS  # noqa: E402
from repro_torch.configs.mnist_cnn import config as t_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import latency as TL  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.core import transport as TT  # noqa: E402
from repro_torch.fl import cnn as TC  # noqa: E402
from repro_torch.fl import engine as TE  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.link import policy as TP  # noqa: E402
from repro_torch.link import scenario as TS  # noqa: E402

EDGE = 1e-4
ACC_TOL = 2 / 160 + 1e-6
STAT_FIELDS = ("data_symbols", "transmissions", "n_bits", "bits_on_air")


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


def _cfgs(mode="approx", use_kernel=False, snr_db=10.0, modulation="qpsk"):
    return (JT.TransportConfig(mode=mode, modulation=modulation,
                               use_kernel=use_kernel,
                               channel=JCH.ChannelConfig(snr_db=snr_db)),
            TT.TransportConfig(mode=mode, modulation=modulation,
                               use_kernel=use_kernel,
                               channel=TCH.ChannelConfig(snr_db=snr_db)))


def _payload(n, seed=0):
    return np.random.default_rng(seed).uniform(-0.9, 0.9, n).astype(
        np.float32)


def _diff(ref, got):
    ref, got = np.asarray(ref), got.numpy()
    return (ref.view(np.uint32) != got.view(np.uint32)) & ~(
        np.isnan(ref) & np.isnan(got))


def _downlink_keys(key, m):
    return TT.client_keys(key, m, TT.DOWNLINK_KEY_LANE)


def _kernel_edges(x, keys, cfg, snr):
    """The plain K1's demod edge distances (in units of ``EDGE``) of the
    tiled broadcast, ``(M, N)``."""
    m, n = x.shape
    xp = torch.nn.functional.pad(x, (0, (-n) % 1024))
    wb, mask, k = TT._transport_kernel_params(cfg)
    npow, gains = TT._link_params(cfg, m, snr, torch.device("cpu"))
    _, _, edges = TR.approx_channel_batch_ref(
        xp, TO._seed_from_key(keys), npow, gains, bits_per_symbol=k,
        fading=cfg.channel.fading, fade_block=cfg.channel.block_len,
        clamp_mask=mask, word_bits=wb, with_edges=True)
    return edges[:, :n].numpy() / EDGE


# ------------------------------------------------------------------ airtime


def test_broadcast_airtime_exact():
    rng = np.random.default_rng(0)
    for m in (1, 7, 100):
        air = rng.uniform(1e-3, 4e-2, m).astype(np.float32)
        modes = rng.integers(0, 4, m)
        assert TL.broadcast_airtime(air) == JL.broadcast_airtime(air)
        assert TL.broadcast_airtime(torch.from_numpy(air)) == \
            JL.broadcast_airtime(air)
        got = TL.broadcast_airtime(torch.from_numpy(air),
                                   torch.from_numpy(modes))
        assert got == JL.broadcast_airtime(air, modes)
        assert got == TL.broadcast_airtime(air, modes)
    air = np.array([3.0, 1.0, 2.0, 2.5], np.float32)
    assert TL.broadcast_airtime(air) == 3.0
    assert TL.broadcast_airtime(air, np.array([0, 1, 1, 0])) == 5.0
    assert TL.broadcast_airtime(np.zeros((0,))) == 0.0


# ------------------------------------------------------------ the broadcast


@pytest.mark.parametrize("per_client_snr", [False, True])
@pytest.mark.parametrize("mode", ["naive", "approx"])
def test_layered_broadcast_vs_reference(mode, per_client_snr):
    jc, tc = _cfgs(mode)
    m, x = 5, _payload(700, seed=1)
    snr = (np.linspace(4.0, 20.0, m).astype(np.float32) if per_client_snr
           else None)
    key = P.PRNGKey(4)
    xj, sj = JT.transmit_broadcast(
        jnp.asarray(x), jax.random.PRNGKey(4), jc, m,
        snr_db=None if snr is None else jnp.asarray(snr))
    xt, st = TT.transmit_broadcast(
        torch.from_numpy(x), key, tc, m,
        snr_db=None if snr is None else torch.from_numpy(snr), device="cpu")
    assert xt.shape == (m, 700) and xt.dtype == torch.float32
    diff = _diff(xj, xt)
    tiled = torch.from_numpy(np.tile(x, (m, 1)))
    margins = TT._word_margins(
        tiled, _downlink_keys(key, m), tc,
        None if snr is None else torch.from_numpy(snr)).numpy()
    assert np.all(margins[diff] < layered_edge(tc.scheme.levels))
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)))
    if not diff.any():
        np.testing.assert_array_equal(st.bit_errors.numpy(),
                                      np.asarray(sj.bit_errors))
    assert st.bit_errors.sum() > 0
    print(f"{mode} per-client SNR={per_client_snr}: words differing "
          f"{int(diff.sum())}")


@pytest.mark.parametrize("n", [2048, 1500])
def test_kernel_broadcast_vs_pallas(n):
    """``use_kernel``: the plain K1 on the tiled payload against the
    reference's Pallas kernel in interpret mode; ``n = 2048`` is a whole
    number of tiles, so the wrapper takes the tile as it is (no padding
    copy)."""
    jc, tc = _cfgs(use_kernel=True)
    m, x = 3, _payload(n, seed=2)
    snr = np.array([6.0, 12.0, 30.0], np.float32)
    xj, sj = JT.transmit_broadcast(jnp.asarray(x), jax.random.PRNGKey(7), jc,
                                   m, snr_db=jnp.asarray(snr))
    xt, st = TT.transmit_broadcast(torch.from_numpy(x), P.PRNGKey(7), tc, m,
                                   snr_db=torch.from_numpy(snr), device="cpu")
    diff = _diff(xj, xt)
    edges = _kernel_edges(torch.from_numpy(np.tile(x, (m, 1))),
                          _downlink_keys(P.PRNGKey(7), m), tc,
                          torch.from_numpy(snr))
    assert np.all(edges[diff] < 1)
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)))
    if not diff.any():
        np.testing.assert_array_equal(st.bit_errors.numpy(),
                                      np.asarray(sj.bit_errors))
    print(f"n={n}: words differing {int(diff.sum())}")


def test_broadcast_tile_is_dense_and_passed_whole():
    """The tile is one dense ``(M, N)`` copy on the payload's device; a
    whole number of tiles goes to the kernel wrapper without another copy,
    a ragged one is padded into a fresh dense tensor."""
    x = torch.from_numpy(_payload(2048))
    xb = TT._broadcast_payload(x, 4, "cpu")
    assert xb.shape == (4, 2048) and xb.is_contiguous()
    assert xb.stride() == (2048, 1) and xb.data_ptr() != x.data_ptr()
    assert TO._tiled(xb, 32, 1024).data_ptr() == xb.data_ptr()
    rag = TO._tiled(xb[:, :1500].contiguous(), 32, 1024)
    assert rag.shape == (4, 2048) and rag.is_contiguous()
    assert not rag[:, 1500:].any()
    # a stride-0 view is never handed on as it is
    view = x.expand(4, 2048)
    assert TO._tiled(view, 32, 1024).stride() == (2048, 1)


def _edge_values():
    """Seeded float32 values plus the cases a bit-exact path must keep:
    signed zeros, subnormals, +-1.9 and their float32 neighbours."""
    rng = np.random.default_rng(11)
    v = rng.uniform(-1.9, 1.9, 64).astype(np.float32)
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1.1754942e-38,
                        -1.1754942e-38, 1.9, -1.9], np.float32)
    nb = np.nextafter(np.float32([1.9, -1.9]), np.float32(0))
    return np.concatenate([v, special, nb.astype(np.float32)])


def test_perfect_broadcast_is_exact_identity():
    x = _edge_values()
    assert np.signbit(x[65]) and x[66] != 0  # -0.0 and a subnormal kept
    for m in (1, 3):
        xt, st = TT.transmit_broadcast(torch.from_numpy(x), P.PRNGKey(0),
                                       TT.TransportConfig(mode="perfect"), m,
                                       device="cpu")
        np.testing.assert_array_equal(xt.numpy().view(np.uint32),
                                      np.tile(x.view(np.uint32), (m, 1)))
        assert not st.bit_errors.any()
        xj, sj = JT.transmit_broadcast(jnp.asarray(x), jax.random.PRNGKey(0),
                                       JT.TransportConfig(mode="perfect"), m)
        np.testing.assert_array_equal(np.asarray(xj).view(np.uint32),
                                      xt.numpy().view(np.uint32))
        for f in STAT_FIELDS:
            np.testing.assert_array_equal(getattr(st, f).numpy(),
                                          np.asarray(getattr(sj, f)))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_broadcast_rides_the_downlink_key_lane(use_kernel):
    """Row ``i`` is ``transmit_flat`` on ``fold_in(key, LANE + i)``, bit
    for bit; the same key on the uplink lane draws another channel."""
    _, tc = _cfgs(use_kernel=use_kernel, snr_db=8.0)
    x = torch.from_numpy(_payload(1024, seed=3))
    key = P.PRNGKey(5)
    xb, sb = TT.transmit_broadcast(x, key, tc, 4, device="cpu")
    for i in range(4):
        ki = P.fold_in(key, TT.DOWNLINK_KEY_LANE + i)
        row, st = TT.transmit_flat(x, ki, tc, device="cpu")
        assert torch.equal(xb[i].view(torch.int32), row.view(torch.int32))
        assert float(sb.bit_errors[i]) == float(st.bit_errors)
    kj = JT.client_keys(jax.random.PRNGKey(5), 4, JT.DOWNLINK_KEY_LANE)
    np.testing.assert_array_equal(_downlink_keys(key, 4).numpy(),
                                  np.asarray(kj))
    up, _ = TT.transmit_batch(x.expand(4, -1), key, tc, device="cpu")
    assert not torch.equal(up, xb)


def _tables(use_kernel=False):
    jb, tb = _cfgs(use_kernel=use_kernel)
    return (JP.build_mode_cfgs(jb, JP.PolicyConfig(), ecrt_expected_tx=2.0),
            TP.build_mode_cfgs(tb, TP.PolicyConfig(), ecrt_expected_tx=2.0,
                               device="cpu"))


def test_adaptive_broadcast_bucketed_equals_select_and_reference():
    """Inside the port bucketed (kernel rows cleared) equals select bit for
    bit; the kernel table's bucketed dispatch (one plain K1 per uncoded
    bucket) equals the reference's (interpret-mode Pallas) up to the edge
    rule, and the layered table equals the reference's select up to the
    layered edge rule."""
    x = _payload(1024, seed=5)
    modes = np.array([0, 1, 2, 3, 1, 1, 2, 0], np.int32)
    snr = np.linspace(2.0, 28.0, 8).astype(np.float32)
    jk, tk = _tables(use_kernel=True)
    cleared = TT.clear_kernel_rows(tk)
    kw = dict(snr_db=torch.from_numpy(snr), device="cpu")
    a, sa = TT.transmit_broadcast_adaptive(torch.from_numpy(x), P.PRNGKey(0),
                                           cleared, modes,
                                           dispatch="bucketed", **kw)
    b, sb = TT.transmit_broadcast_adaptive(torch.from_numpy(x), P.PRNGKey(0),
                                           cleared, torch.from_numpy(modes),
                                           dispatch="select", **kw)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for f in STAT_FIELDS + ("bit_errors", "mode_idx"):
        assert torch.equal(getattr(sa, f), getattr(sb, f))
    # the kernel table's buckets against the reference's
    xj, sj = JT.transmit_broadcast_adaptive(
        jnp.asarray(x), jax.random.PRNGKey(0), jk, modes,
        snr_db=jnp.asarray(snr), dispatch="bucketed")
    xt, st = TT.transmit_broadcast_adaptive(torch.from_numpy(x),
                                            P.PRNGKey(0), tk, modes,
                                            dispatch="bucketed", **kw)
    diff = _diff(xj, xt)
    keys = _downlink_keys(P.PRNGKey(0), 8)
    tiled = torch.from_numpy(np.tile(x, (8, 1)))
    for m in range(1, 4):
        idx = np.nonzero(modes == m)[0]
        e = _kernel_edges(tiled[idx], keys[idx], tk[m],
                          torch.from_numpy(snr[idx]))
        assert np.all(e[diff[idx]] < 1)
    assert not diff[modes == 0].any()  # ECRT rows: exact bits
    np.testing.assert_array_equal(st.mode_idx.numpy(), modes)
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)))
    # the layered table against the reference's select
    jl, tl = _tables()
    xj, sj = JT.transmit_broadcast_adaptive(
        jnp.asarray(x), jax.random.PRNGKey(0), jl, jnp.asarray(modes),
        snr_db=jnp.asarray(snr), dispatch="select")
    diff = _diff(xj, b)
    for m in range(1, 4):
        idx = np.nonzero(modes == m)[0]
        mg = TT._word_margins(tiled[idx], keys[idx], tl[m],
                              torch.from_numpy(snr[idx])).numpy()
        assert np.all(mg[diff[idx]] < layered_edge(tl[m].scheme.levels))


def test_pytree_broadcast_front_ends():
    """Leaves grow a leading client dim in the tree's sorted-key order,
    dtypes kept; a perfect broadcast returns the model in every row."""
    params = TE.FedSGD(t_config()).init_params(P.PRNGKey(0), "cpu")
    params["a_half"] = torch.linspace(-1, 1, 6, dtype=torch.bfloat16)
    out, st = TT.transmit_pytree_broadcast(
        params, P.PRNGKey(1), TT.TransportConfig(mode="perfect"), 3,
        device="cpu")
    assert list(out) == sorted(params)  # jax.tree_util's dict order
    leaves, _ = TT.tree_flatten(params)
    flat, _ = TT.pack(leaves)
    assert flat.shape == (sum(l.numel() for l in leaves),)
    assert torch.equal(flat[:6], params["a_half"].float())  # sorted first
    for k, v in params.items():
        assert out[k].shape == (3,) + tuple(v.shape)
        assert out[k].dtype == v.dtype
        for i in range(3):
            assert torch.equal(out[k][i], v)
    assert st.data_symbols.shape == (3,)
    _, tk = _tables()
    modes = np.array([1, 3, 2], np.int32)
    out, st = TT.transmit_pytree_broadcast_adaptive(
        params, P.PRNGKey(1), tk, modes, dispatch="select", device="cpu")
    assert list(out) == sorted(params)
    assert all(out[k].shape == (3,) + tuple(v.shape) and
               out[k].dtype == v.dtype for k, v in params.items())
    np.testing.assert_array_equal(st.mode_idx.numpy(), modes)


def test_broadcast_validation():
    cfg = TT.TransportConfig(mode="perfect")
    with pytest.raises(ValueError, match="flat"):
        TT.transmit_broadcast(torch.zeros((2, 8)), P.PRNGKey(0), cfg, 2,
                              device="cpu")
    with pytest.raises(ValueError, match="num_clients"):
        TT.transmit_broadcast(torch.zeros((8,)), P.PRNGKey(0), cfg, 0,
                              device="cpu")
    with pytest.raises(ValueError, match="num_clients"):
        TT.transmit_broadcast(torch.zeros((8,)), P.PRNGKey(0), cfg,
                              TT.DOWNLINK_KEY_LANE.span + 1, device="cpu")
    with pytest.raises(ValueError, match="telepathy"):
        TT.transmit_broadcast(torch.zeros((8,)), P.PRNGKey(0),
                              TT.TransportConfig(mode="telepathy"), 2,
                              device="cpu")


def test_downlink_mode_vs_reference():
    est = np.linspace(-8.0, 34.0, 43).astype(np.float32)
    for off in (0.0, 3.0, -2.5):
        np.testing.assert_array_equal(
            TP.downlink_mode(torch.from_numpy(est), TP.PolicyConfig(),
                             off).numpy(),
            np.asarray(JP.downlink_mode(jnp.asarray(est), JP.PolicyConfig(),
                                        snr_offset_db=off)))


# ------------------------------------------------------------- FL rounds


@pytest.fixture(scope="module")
def world():
    (img, lab), (ti, tl) = j_synth.train_test(60, 16, seed=0)
    parts = j_partition.non_iid_partition(img, lab, n_clients=4)
    cx, cy = j_partition.stack_clients(parts, per_client=24)
    return cx, cy, ti, tl


def _engines(world, algo_j, algo_t, jc, tc, **kw):
    """A reference and a port engine on one world; the port starts from
    the reference's initial weights (the two inits differ by a few ULP)."""
    cx, cy, ti, tl = world
    tkw = dict(kw)
    for name, conv in (("downlink", _t_downlink), ("scenario", _t_scen)):
        if kw.get(name) is not None:
            tkw[name] = conv(kw[name])
    je = JEN.RoundEngine(algo_j, jc, cx, cy, ti, tl, **kw)
    te = TE.RoundEngine(algo_t, tc, cx, cy, ti, tl, device="cpu", **tkw)
    te.params = params_from_jax({k: np.asarray(v)
                                 for k, v in je.params.items()})
    return je, te


def _t_downlink(d):
    return TS.DownlinkConfig(**dataclasses.asdict(d))


def _t_scen(s):
    if isinstance(s, str):
        return s
    return dataclasses.replace(
        TS.get_scenario(s.name), ecrt_expected_tx=s.ecrt_expected_tx,
        dropout_prob=s.dropout_prob)


def check_runs(a, b, *, exact_first_ber=True):
    """Link dicts in one key order, integer fields and mode counts Exact,
    airtimes to float32 summation order, accuracy within ``ACC_TOL``."""
    assert a.rounds == b.rounds
    assert len(a.link) == len(b.link)
    for r, (lj, lt) in enumerate(zip(a.link, b.link)):
        assert list(lt) == list(lj)
        for f in ("round", "mode_counts", "n_active", "n_stragglers",
                  "downlink_mode_counts"):
            if f in lj:
                assert lt[f] == lj[f], (r, f)
        for f in ("mean_snr_db", "mean_est_db"):
            if f in lj:
                assert lt[f] == pytest.approx(lj[f], abs=1e-4), f
        for f in ("airtime_s", "downlink_airtime_s"):
            if f in lj:
                assert lt[f] == pytest.approx(lj[f], rel=2**-20), f
        if r == 0 and "downlink_ber" in lj:
            # the same model through the same channel; scenario rounds'
            # SNRs come from normals (Bounded), so words may flip there
            if exact_first_ber:
                assert lt["downlink_ber"] == lj["downlink_ber"]
            else:
                assert lt["downlink_ber"] == pytest.approx(
                    lj["downlink_ber"], abs=1e-4)
    np.testing.assert_allclose(b.accuracy, a.accuracy, rtol=0, atol=ACC_TOL)
    np.testing.assert_allclose(b.airtime_s, a.airtime_s, rtol=2**-20)


@pytest.mark.parametrize("fused", [False, True])
def test_fedsgd_driverless_downlink_vs_reference(world, fused):
    """FedSGD with an approx downlink on the kernel path (one K1 launch a
    round, at +3 dB), layered and fused uplink."""
    jc, tc = _cfgs(use_kernel=True)
    cfg_j = dataclasses.replace(j_config(), lr=0.1)
    cfg_t = dataclasses.replace(t_config(), lr=0.1)
    je, te = _engines(world, JEN.FedSGD(cfg_j, batch_per_round=8),
                      TE.FedSGD(cfg_t, batch_per_round=8), jc, tc,
                      n_rounds=3, eval_every=1, seed=1, fused_aggregate=fused,
                      downlink=JS.DownlinkConfig(mode="approx",
                                                 snr_offset_db=3.0))
    a, b = je.run(), te.run()
    assert [list(l) for l in b.link] == [
        ["round", "downlink_airtime_s", "downlink_ber"]] * 3
    check_runs(a, b)
    assert 0 < b.link[0]["downlink_ber"] < 0.5
    assert set(b.phase_s[0]) == {"key", "sample", "downlink",
                                 "downlink_keys", "downlink_kernel",
                                 "downlink_codec", "downlink_channel",
                                 "downlink_demod",
                                 "gradients", "uplink", "uplink_keys",
                                 "uplink_kernel", "uplink_codec",
                                 "uplink_channel", "uplink_demod",
                                 "uplink_mean", "telemetry", "apply", "eval"}
    print(f"fused={fused}: reference {a.accuracy}, port {b.accuracy}, "
          f"downlink BER {[l['downlink_ber'] for l in b.link]}")


@pytest.mark.parametrize("fused", [False, True])
def test_perfect_downlink_equals_no_downlink(world, fused):
    """A perfect broadcast is the identity and rides its own key lane, so
    the run equals ``downlink=None`` bit for bit; its airtime is the TDMA
    uplink plus one broadcast of the model a round."""
    cx, cy, ti, tl = world
    _, tc = _cfgs(use_kernel=True)
    cfg = dataclasses.replace(t_config(), lr=0.1)
    runs = []
    for dl in (None, TS.DownlinkConfig(mode="perfect")):
        eng = TE.RoundEngine(TE.FedSGD(cfg, batch_per_round=8), tc, cx, cy,
                             ti, tl, n_rounds=3, eval_every=1, seed=2,
                             fused_aggregate=fused, downlink=dl, device="cpu")
        runs.append((eng.run(), eng.params))
    (a, pa), (b, pb) = runs
    for k in pa:
        assert torch.equal(pa[k].view(torch.int32), pb[k].view(torch.int32))
    assert a.accuracy == b.accuracy and a.link == []
    bcast = 21840 * 32 / 2 / 13e6 + 200e-6
    for r, (ua, ub) in enumerate(zip(a.airtime_s, b.airtime_s)):
        assert ub == pytest.approx(ua + (r + 1) * bcast, rel=2**-20)
    assert [l["downlink_ber"] for l in b.link] == [0.0] * 3


def test_ecrt_downlink_prices_analytically_at_shifted_snr(world,
                                                          monkeypatch):
    """An ECRT downlink is never decoded in a round and its E[tx] is
    calibrated where the downlink operates: driverless at the shifted
    channel SNR (elementwise for a per-client vector, which also gives a
    per-client airtime scale), scenario runs at the fleet's mean SNR plus
    the offset; the uplink's own pricing is untouched."""
    cx, cy, ti, tl = world
    profiles, anchors = [], []

    def fake_profile(snr_vec, modulation, **kw):
        snr = np.asarray(snr_vec, np.float32).reshape(-1)
        profiles.append(snr.copy())
        return (1.7 + 0.1 * np.arange(snr.size)).astype(np.float32)

    def fake_calibrate(snr_db, modulation="qpsk", **kw):
        anchors.append(float(snr_db))
        return 1.7

    monkeypatch.setattr(TL, "ecrt_expected_tx_profile", fake_profile)
    monkeypatch.setattr(TL, "calibrate_ecrt", fake_calibrate)
    _, tc = _cfgs()
    dl = TS.DownlinkConfig(mode="ecrt", snr_offset_db=5.0)
    algo = TE.FedSGD(dataclasses.replace(t_config(), lr=0.1),
                     batch_per_round=8)
    eng = eng0 = TE.RoundEngine(algo, tc, cx, cy, ti, tl, n_rounds=1,
                                eval_every=1, downlink=dl, device="cpu")
    assert not eng.dl_cfg.simulate_fec and eng.dl_cfg.mode == "ecrt"
    assert eng.dl_cfg.ecrt_expected_tx == pytest.approx(1.7)
    np.testing.assert_array_equal(profiles[-1], [15.0])  # 10 + 5
    assert eng.transport_cfg.mode == "approx" and eng.dl_air_scale is None
    res = eng.run()
    assert res.link[0]["downlink_ber"] == 0.0
    e = np.float32(eng.dl_cfg.ecrt_expected_tx)
    want = 2 * 21840 * 32 / 2 * e / 13e6 * 1.05 + e * 200e-6
    assert res.link[0]["downlink_airtime_s"] == pytest.approx(want,
                                                              rel=2**-20)
    # per-client SNR: shifted elementwise, per-client E[tx] as a scale
    tch = dataclasses.replace(tc, channel=TCH.ChannelConfig(
        snr_db=(0.0, 4.0, 8.0, 12.0)))
    eng = TE.RoundEngine(algo, tch, cx, cy, ti, tl, n_rounds=1,
                         downlink=dl, device="cpu")
    np.testing.assert_array_equal(profiles[-1], [5.0, 9.0, 13.0, 17.0])
    assert eng.dl_cfg.channel.snr_db == (5.0, 9.0, 13.0, 17.0)
    assert eng.dl_air_scale is not None and eng.dl_air_scale.shape == (4,)
    # scenario: the anchor is the fleet operating point + offset
    scen = dataclasses.replace(TS.get_scenario("vehicular"),
                               ecrt_expected_tx=2.0)
    eng = TE.RoundEngine(algo, tc, cx, cy, ti, tl, n_rounds=1, scenario=scen,
                         downlink=dl, device="cpu")
    assert not eng.dl_cfg.simulate_fec
    assert anchors[-1] == pytest.approx(scen.dynamics.mean_snr_db + 5.0)
    assert eng.dl_cfg.channel == tc.channel  # rounds set the SNR
    res = eng.run()
    assert res.link[0]["downlink_ber"] == 0.0
    # the reference resolves the same configuration the same way
    monkeypatch.setattr(JL, "ecrt_expected_tx_profile", fake_profile)
    monkeypatch.setattr(JL, "calibrate_ecrt", fake_calibrate)
    jc, _ = _cfgs()
    je = JEN.RoundEngine(JEN.FedSGD(j_config(), batch_per_round=8), jc, cx,
                         cy, ti, tl, n_rounds=1,
                         downlink=JS.DownlinkConfig(mode="ecrt",
                                                    snr_offset_db=5.0))
    assert je.dl_cfg.mode == "ecrt" and not je.dl_cfg.simulate_fec
    assert je.dl_cfg.channel.snr_db == eng0.dl_cfg.channel.snr_db == 15.0
    assert je.dl_cfg.ecrt_expected_tx == eng0.dl_cfg.ecrt_expected_tx


@pytest.fixture(scope="module")
def world6():
    (img, lab), (ti, tl) = j_synth.train_test(60, 16, seed=0)
    parts = j_partition.non_iid_partition(img, lab, n_clients=6)
    cx, cy = j_partition.stack_clients(parts, per_client=16)
    return cx, cy, ti, tl


@pytest.mark.parametrize("preset", ["static-noisy-dl", "vehicular-noisy-dl"])
def test_fedsgd_downlink_presets_vs_reference(world6, preset):
    """FedSGD on the two downlink presets, bucketed over a ``use_kernel``
    base (K1 per uncoded downlink bucket and per uncoded uplink bucket)."""
    jc, tc = _cfgs(use_kernel=True)
    scen = dataclasses.replace(JS.get_scenario(preset), ecrt_expected_tx=2.0)
    cfg_j = dataclasses.replace(j_config(), lr=0.1)
    cfg_t = dataclasses.replace(t_config(), lr=0.1)
    je, te = _engines(world6, JEN.FedSGD(cfg_j, batch_per_round=8),
                      TE.FedSGD(cfg_t, batch_per_round=8), jc, tc,
                      n_rounds=2, eval_every=1, seed=4, scenario=scen)
    a, b = je.run(), te.run()
    check_runs(a, b, exact_first_ber=False)
    for rec in b.link:
        assert rec["downlink_airtime_s"] > 0
        if scen.downlink.adaptive:
            assert sum(rec["downlink_mode_counts"]) == 6
    print(f"{preset}: downlink modes "
          f"{[l.get('downlink_mode_counts') for l in b.link]}, reference "
          f"{a.accuracy}, port {b.accuracy}")



def test_non_finite_received_weights_propagate(world):
    """A naive downlink has no clamp, so a client's copy may hold NaN or
    inf weights. Neither package sanitizes them: that client's gradients
    come out non-finite in both, and every other client's are unchanged.
    The port's relu and max-pool carry the reference's derivatives
    (``fl/cnn.py``), so which entries are non-finite, and which are NaN,
    is the reference's in every leaf of every client."""
    cx, cy, _, _ = world
    with jax.threefry_partitionable(True):
        jp = JC.init_params(jax.random.PRNGKey(2), j_config())
    recv = {k: np.repeat(np.asarray(v)[None], 4, axis=0)
            for k, v in jp.items()}
    recv["fc1_w"][1, 3, 7] = np.nan
    recv["conv2_w"][2, 0, 0, 0, 0] = np.inf
    xb, yb = cx[:, :8], cy[:, :8]
    gj = JEN.FedSGD(j_config()).payload_from(
        {k: jnp.asarray(v) for k, v in recv.items()}, jnp.asarray(xb),
        jnp.asarray(yb))
    gt = TE.FedSGD(t_config()).payload_from(
        params_from_jax(recv), torch.from_numpy(xb),
        torch.from_numpy(yb.astype(np.int64)))
    for k in jp:
        a, b = np.asarray(gj[k]), gt[k].numpy()
        for c in range(4):
            np.testing.assert_array_equal(np.isfinite(b[c]),
                                          np.isfinite(a[c]), err_msg=k)
            np.testing.assert_array_equal(np.isnan(b[c]), np.isnan(a[c]),
                                          err_msg=k)
        for c in (0, 3):  # finite copies: finite, the reference's values
            assert np.isfinite(b[c]).all()
            np.testing.assert_allclose(b[c], a[c], rtol=1e-4, atol=1e-6)
    for c in (1, 2):
        assert not all(np.isfinite(gt[k][c].numpy()).all() for k in jp)


_NAN, _INF = np.float32(np.nan), np.float32(np.inf)


@pytest.mark.parametrize("window", [
    [_NAN, 1, 2, 3], [1, _NAN, 2, 3], [3, _NAN, 2, 1], [_INF, _NAN, 1, 2],
    [1, 1, 0, 0], [2, 3, 3, 1], [-_INF] * 4],
    ids=["nan-first", "nan-second", "nan-then-descending", "inf-nan",
         "tie", "tie-after-first", "all-neg-inf"])
def test_pool_derivative_matches_reference(window):
    """The 2x2 max-pool's forward value and gradient routing on one window:
    the port's ``cnn.pool2`` against the reference's ``_pool2``."""
    win = np.array(window, np.float32).reshape(1, 1, 2, 2)
    yj, vjp = jax.vjp(JC._pool2, jnp.asarray(win))
    gj = np.asarray(vjp(jnp.ones((1, 1, 1, 1)))[0]).reshape(-1)
    xt = torch.tensor(win, requires_grad=True)
    yt = TC.pool2(xt)
    yt.sum().backward()
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(yj))
    np.testing.assert_array_equal(xt.grad.numpy().reshape(-1), gj)


def test_relu_derivative_matches_reference():
    """``relu`` and its derivative at NaN, 0, 1, -1, +-inf: the port's
    ``cnn.relu`` against ``jax.nn.relu``."""
    x = np.array([_NAN, 0, 1, -1, _INF, -_INF], np.float32)
    yj, vjp = jax.vjp(jax.nn.relu, jnp.asarray(x))
    gj = np.asarray(vjp(jnp.ones(x.shape))[0])
    np.testing.assert_array_equal(gj, [0, 0, 1, 0, 1, 0])
    xt = torch.tensor(x, requires_grad=True)
    yt = TC.relu(xt)
    yt.sum().backward()
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(yj))
    np.testing.assert_array_equal(xt.grad.numpy(), gj)


@pytest.mark.parametrize("algo", ["fedsgd", "fedavg"])
def test_repair_keeps_finite_gradient_bits(monkeypatch, world, algo):
    """On finite weights the repaired relu and pool give PyTorch's own
    values and gradients bit for bit: the payload with ``cnn.relu`` /
    ``cnn.pool2`` equals the one with ``torch.relu`` / ``max_pool2d``
    (MNIST's zero background makes many exact-zero pre-activations)."""
    cx, cy, _, _ = world
    params = TE.FedSGD(t_config()).init_params(P.PRNGKey(3), "cpu")
    out = []
    for relu, pool in ((TC.relu, TC.pool2),
                       (torch.relu,
                        lambda x: torch.nn.functional.max_pool2d(x, 2))):
        monkeypatch.setattr(TC, "relu", relu)
        monkeypatch.setattr(TC, "pool2", pool)
        a = (TE.FedSGD(t_config(), batch_per_round=16) if algo == "fedsgd"
             else TE.FedAvg(t_config(), local_steps=2, batch_per_step=8))
        xb, yb = a.sample(np.random.default_rng(1), cx, cy, "cpu")
        out.append(a.payload(params, xb, yb))
    for k in params:
        assert torch.equal(out[0][k].view(torch.int32),
                           out[1][k].view(torch.int32)), k
    assert any(bool((out[0][k] == 0).any()) for k in params)
