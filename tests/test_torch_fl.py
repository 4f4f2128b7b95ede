"""The port's FL slice against the reference: CNN, one round, a short run.

* CNN logits and per-client gradients from identical parameters
  (``params_from_jax``): rtol 1e-4 / atol 1e-6 — conv and matmul sum in a
  different order in the two frameworks.
* One whole fused round, given the reference's own per-client gradients,
  at noise power 0: the aggregated update is Exact. The SGD step after it
  is pinned to each package's arithmetic: the port subtracts ``eta * g``
  as a separate multiply, XLA on the CPU fuses ``p - eta * g`` into an fma
  (ROADMAP Queue 3), so the new weights differ by at most 1 ULP.
* A 3-round ``run_fl`` of each package on the 4-client world of
  ``tests/test_fused_aggregate.py``: Trajectory grade. The two inits
  differ by a few ULP (``prng.normal``) and gradients by summation order,
  so accuracy may differ by at most ``ACC_TOL`` (2 of 160 test images)
  at each eval point; airtime is exact up to float32 summation order.
  The same holds for the paper's Fig. 3 arms — approx and naive on the
  layered PHY, ECRT resolved by the engine to its calibrated analytic
  model — given equal E[tx] (asserted).
* A 3-round scenario run (``vehicular`` at a fixed E[tx] with 10%
  dropout, 6 clients) under each round shape — bucketed layered (K1 per
  bucket), bucketed fused (K2 per bucket) and select (layered PHY): the
  per-round ``mode_counts``, ``n_active`` and ``n_stragglers`` Exact,
  ``mean_snr_db`` / ``mean_est_db`` Bounded (the normals), airtime and
  accuracy as above.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.mnist_cnn import config as j_config  # noqa: E402
from repro.core import channel as JCH  # noqa: E402
from repro.core import transport as JT  # noqa: E402
from repro.data import synth_mnist as j_synth  # noqa: E402
from repro.fl import cnn as JC  # noqa: E402
from repro.fl import engine as JEN  # noqa: E402
from repro.fl import partition as j_partition  # noqa: E402
from repro.fl.loop import run_fl as j_run_fl  # noqa: E402
from repro.link import scenario as JS  # noqa: E402
from repro.optim.sgd import sgd as j_sgd  # noqa: E402
from repro_torch.configs.mnist_cnn import config as t_config  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.core import transport as TT  # noqa: E402
from repro_torch.data import synth_mnist as t_synth  # noqa: E402
from repro_torch.fl import cnn as TC  # noqa: E402
from repro_torch.fl import engine as TE  # noqa: E402
from repro_torch.fl import partition as t_partition  # noqa: E402
from repro_torch.fl.loop import run_fl as t_run_fl  # noqa: E402
from repro_torch.link import scenario as TS  # noqa: E402

ACC_TOL = 2 / 160 + 1e-6


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
def world():
    (img, lab), (ti, tl) = j_synth.train_test(60, 16, seed=0)
    parts = j_partition.non_iid_partition(img, lab, n_clients=4)
    cx, cy = j_partition.stack_clients(parts, per_client=24)
    return cx, cy, ti, tl


def test_world_copies_exact(world):
    (img, lab), (ti, tl) = t_synth.train_test(60, 16, seed=0)
    parts = t_partition.non_iid_partition(img, lab, n_clients=4)
    cx, cy = t_partition.stack_clients(parts, per_client=24)
    for a, b in zip(world, (cx, cy, ti, tl)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def params():
    with jax.threefry_partitionable(True):
        jp = JC.init_params(jax.random.PRNGKey(1), j_config())
    return {k: np.asarray(v) for k, v in jp.items()}


def test_init_params_bounded(params):
    tp = TC.init_params(P.PRNGKey(1), t_config(), device="cpu")
    assert list(tp) == list(params)
    for k, v in params.items():
        assert tp[k].shape == v.shape and tp[k].dtype == torch.float32
        np.testing.assert_allclose(tp[k].numpy(), v, rtol=2e-5, atol=1e-6)


def test_params_from_jax_roundtrip(params):
    tp = params_from_jax(params)
    for k, v in params_to_numpy(tp).items():
        np.testing.assert_array_equal(v, params[k])


def test_cnn_logits_and_grads(params, world):
    cx, cy, _, _ = world
    xb, yb = cx[:, :8], cy[:, :8]
    tp = params_from_jax(params)
    lj = np.asarray(JC.logits_fn(params, jnp.asarray(xb[0])))
    lt = TC.logits_fn(tp, torch.from_numpy(xb[0])).numpy()
    np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-6)
    gj = jax.vmap(lambda x, y: jax.grad(JC.loss_fn)(params, x, y))(
        jnp.asarray(xb), jnp.asarray(yb))
    algo = TE.FedSGD(t_config())
    gt = algo.payload(tp, torch.from_numpy(xb),
                      torch.from_numpy(yb.astype(np.int64)))
    for k in params:
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(gj[k]),
                                   rtol=1e-4, atol=1e-6)
    acc_j = float(JC.accuracy(params, jnp.asarray(xb[0]), jnp.asarray(yb[0])))
    acc_t = float(TC.accuracy(tp, torch.from_numpy(xb[0]),
                              torch.from_numpy(yb[0].astype(np.int64))))
    assert acc_j == acc_t


def test_fused_round_update_exact(params, world):
    """The reference's per-client gradients through the port's fused round
    at noise power 0 (``snr_db = inf``)."""
    cx, cy, ti, tl = world
    cfg = dataclasses.replace(j_config(), lr=0.1)
    grads = jax.vmap(lambda x, y: jax.grad(JC.loss_fn)(params, x, y))(
        jnp.asarray(cx[:, :8]), jnp.asarray(cy[:, :8]))
    jc = JT.TransportConfig(mode="approx", use_kernel=True,
                            channel=JCH.ChannelConfig(snr_db=float("inf")))
    tc = TT.TransportConfig(mode="approx", use_kernel=True,
                            channel=TCH.ChannelConfig(snr_db=float("inf")))
    w = jnp.full((4,), 0.25, jnp.float32)
    agg_j, st_j = JT.transmit_pytree_batch_aggregate(
        grads, jax.random.PRNGKey(5), jc, w)

    eng = TE.RoundEngine(TE.FedSGD(cfg), tc, cx, cy, ti, tl, n_rounds=1,
                         fused_aggregate=True, device="cpu")
    eng.params = params_from_jax(params)
    tg = {k: torch.from_numpy(np.array(v)) for k, v in grads.items()}
    _, agg_t, st_t = eng._transmit(tg, P.PRNGKey(5), None)
    for k in params:
        np.testing.assert_array_equal(
            agg_t[k].numpy().view(np.uint32),
            np.asarray(agg_j[k]).view(np.uint32))
    np.testing.assert_array_equal(st_t.bit_errors.numpy(),
                                  np.asarray(st_j.bit_errors))
    assert not st_t.bit_errors.any()

    new_t, _ = eng.algo.apply(eng.params, eng.aux, agg_t)
    j_opt = j_sgd(cfg.lr)
    new_j, _ = jax.jit(j_opt.update)(agg_j, j_opt.init(params), params)
    eta = np.float32(cfg.lr)
    for k, p in params.items():
        g = np.asarray(agg_j[k])
        separate = p - eta * g
        fused = (p.astype(np.float64)
                 - np.float64(eta) * g.astype(np.float64)).astype(np.float32)
        np.testing.assert_array_equal(new_t[k].numpy(), separate)
        np.testing.assert_array_equal(np.asarray(new_j[k]), fused)


@pytest.mark.parametrize("fused", [False, True])
def test_run_fl_trajectory(world, fused):
    cx, cy, ti, tl = world
    kw = dict(n_rounds=3, batch_per_round=8, eval_every=1, seed=3,
              fused_aggregate=fused)
    jc = JT.TransportConfig(mode="approx", use_kernel=True,
                            channel=JCH.ChannelConfig(snr_db=10.0))
    tc = TT.TransportConfig(mode="approx", use_kernel=True,
                            channel=TCH.ChannelConfig(snr_db=10.0))
    a = j_run_fl(dataclasses.replace(j_config(), lr=0.1), jc, cx, cy, ti, tl,
                 **kw)
    b = t_run_fl(dataclasses.replace(t_config(), lr=0.1), tc, cx, cy, ti, tl,
                 device="cpu", **kw)
    assert a.rounds == b.rounds == [0, 1, 2]
    np.testing.assert_allclose(b.accuracy, a.accuracy, rtol=0, atol=ACC_TOL)
    np.testing.assert_allclose(b.airtime_s, a.airtime_s, rtol=1e-6)
    assert len(b.phase_s) == 3
    assert set(b.phase_s[0]) == {"key", "sample", "gradients", "uplink",
                                 "uplink_keys", "uplink_kernel",
                                 "uplink_codec", "uplink_channel",
                                 "uplink_demod", "uplink_mean", "telemetry",
                                 "apply", "eval"}


def test_fused_equals_layered_in_port(world):
    """Inside the port, fused and layered rounds agree to summation order
    (the layered round averages with a mean, as the reference does)."""
    cx, cy, ti, tl = world
    tc = TT.TransportConfig(mode="approx", use_kernel=True,
                            channel=TCH.ChannelConfig(snr_db=10.0))
    kw = dict(n_rounds=2, batch_per_round=8, eval_every=1, seed=7,
              device="cpu")
    cfg = dataclasses.replace(t_config(), lr=0.1)
    a = t_run_fl(cfg, tc, cx, cy, ti, tl, **kw)
    b = t_run_fl(cfg, tc, cx, cy, ti, tl, fused_aggregate=True, **kw)
    np.testing.assert_allclose(a.accuracy, b.accuracy, atol=ACC_TOL)
    assert a.airtime_s == b.airtime_s


@pytest.mark.parametrize("mode", ["approx", "naive", "ecrt"])
def test_fig3_arms_vs_reference(world, mode):
    """The paper's Fig. 3 comparison on the 4-client world: accuracy within
    ``ACC_TOL`` at every eval point, airtime to float32 rounding."""
    cx, cy, ti, tl = world
    kw = dict(n_rounds=3, batch_per_round=8, eval_every=1, seed=3)
    jc = JT.TransportConfig(mode=mode,
                            channel=JCH.ChannelConfig(snr_db=10.0))
    tc = TT.TransportConfig(mode=mode,
                            channel=TCH.ChannelConfig(snr_db=10.0))
    if mode == "ecrt":
        rj, _ = JEN.resolve_ecrt_analytic(jc, 4)
        rt, scale = TE.resolve_ecrt_analytic(tc, 4, "cpu")
        assert (rt.simulate_fec, scale) == (False, None)
        assert rt.ecrt_expected_tx == rj.ecrt_expected_tx > 1.0
    a = j_run_fl(dataclasses.replace(j_config(), lr=0.1), jc, cx, cy, ti, tl,
                 **kw)
    b = t_run_fl(dataclasses.replace(t_config(), lr=0.1), tc, cx, cy, ti, tl,
                 device="cpu", **kw)
    assert a.rounds == b.rounds == [0, 1, 2]
    print(f"{mode}: reference {a.accuracy}, port {b.accuracy}")
    np.testing.assert_allclose(b.accuracy, a.accuracy, rtol=0, atol=ACC_TOL)
    np.testing.assert_allclose(b.airtime_s, a.airtime_s, rtol=2**-20)


def test_heterogeneous_ecrt_airtime_scale():
    """Per-client SNR: E[tx] per client, the cohort mean in the transport,
    the ratio as each client's airtime scale — the reference's."""
    snr = (0.0, 0.0, 10.0, 10.0)
    jc = JT.TransportConfig(mode="ecrt",
                            channel=JCH.ChannelConfig(snr_db=snr))
    tc = TT.TransportConfig(mode="ecrt",
                            channel=TCH.ChannelConfig(snr_db=snr))
    rj, sj = JEN.resolve_ecrt_analytic(jc, 4)
    rt, st = TE.resolve_ecrt_analytic(tc, 4, "cpu")
    assert rt.ecrt_expected_tx == rj.ecrt_expected_tx
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert float(st[0]) > 1.0 > float(st[2])
    eng = TE.RoundEngine(TE.FedSGD(t_config()), tc, *_tiny_world(),
                         n_rounds=1, device="cpu")
    assert torch.equal(eng.ecrt_air_scale, st)
    res = eng.run()
    e = rt.ecrt_expected_tx
    base = 2 * 21840 * 32 / 2 * e / 13e6 * 1.05 + e * 200e-6
    want = float(np.sum(np.asarray(sj, np.float64))) * base
    assert res.airtime_s[0] == pytest.approx(want, rel=2**-20)


def _tiny_world():
    rng = np.random.default_rng(0)
    cx = rng.uniform(0, 1, (4, 8, 28, 28)).astype(np.float32)
    cy = rng.integers(0, 10, (4, 8)).astype(np.int32)
    return cx, cy, cx[0], cy[0]


@pytest.fixture(scope="module")
def world6():
    (img, lab), (ti, tl) = j_synth.train_test(60, 16, seed=0)
    parts = j_partition.non_iid_partition(img, lab, n_clients=6)
    cx, cy = j_partition.stack_clients(parts, per_client=16)
    return cx, cy, ti, tl


@pytest.mark.parametrize("dispatch,fused", [
    ("bucketed", False), ("bucketed", True), ("select", False)])
def test_scenario_run_vs_reference(world6, dispatch, fused):
    cx, cy, ti, tl = world6
    kw = dict(n_rounds=3, batch_per_round=8, eval_every=1, seed=3,
              adaptive_dispatch=dispatch, fused_aggregate=fused)
    js = dataclasses.replace(JS.get_scenario("vehicular"),
                             ecrt_expected_tx=2.0, dropout_prob=0.1)
    ts = dataclasses.replace(TS.get_scenario("vehicular"),
                             ecrt_expected_tx=2.0, dropout_prob=0.1)
    jc = JT.TransportConfig(mode="approx", use_kernel=True,
                            channel=JCH.ChannelConfig(snr_db=10.0))
    tc = TT.TransportConfig(mode="approx", use_kernel=True,
                            channel=TCH.ChannelConfig(snr_db=10.0))
    a = j_run_fl(dataclasses.replace(j_config(), lr=0.1), jc, cx, cy, ti, tl,
                 scenario=js, **kw)
    b = t_run_fl(dataclasses.replace(t_config(), lr=0.1), tc, cx, cy, ti, tl,
                 scenario=ts, device="cpu", **kw)
    assert a.rounds == b.rounds == [0, 1, 2]
    assert len(a.link) == len(b.link) == 3
    for lj, lt in zip(a.link, b.link):
        assert list(lt) == list(lj)
        for f in ("round", "mode_counts", "n_active", "n_stragglers"):
            assert lt[f] == lj[f], f
        for f in ("mean_snr_db", "mean_est_db"):
            assert lt[f] == pytest.approx(lj[f], abs=1e-4), f
        assert lt["airtime_s"] == pytest.approx(lj["airtime_s"],
                                                rel=2**-20)
    print(f"{dispatch} fused={fused}: modes "
          f"{[l['mode_counts'] for l in b.link]}, active "
          f"{[l['n_active'] for l in b.link]}; reference {a.accuracy}, "
          f"port {b.accuracy}")
    assert sum(l["n_active"] for l in b.link) < 18  # dropout happened
    np.testing.assert_allclose(b.accuracy, a.accuracy, rtol=0, atol=ACC_TOL)
    np.testing.assert_allclose(b.airtime_s, a.airtime_s, rtol=2**-20)
    assert set(b.phase_s[0]) == {"key", "sample", "link", "gradients",
                                 "uplink", "uplink_keys", "uplink_kernel",
                                 "uplink_codec", "uplink_channel",
                                 "uplink_demod", "uplink_mean", "telemetry",
                                 "apply", "eval"}
