"""The port's FedAvg (``fl/engine.py::FedAvg``, ``fl/fedavg.py::run_fedavg``)
against the reference's.

* Exact — ``FedAvg.sample`` (the same numpy draws); ``_scale_of``,
  ``_div`` and ``_mul`` on the same deltas. The reference's ``/ 0.9`` is
  compiled by XLA into a multiply by the float32 reciprocal 0x3F8E38E4
  (smallest input: ``max|delta| = 0.001`` gives 0.0011111112544313073,
  where the division gives 0.0011111111380159855); the port multiplies
  by the same constant (ROADMAP Queue 3).
* Bounded — one client's ``_local_delta`` from the reference's weights
  (``params_from_jax``): conv and matmul grads sum in another order, and
  the reference's SGD step ``p - lr * g`` is an fma on the CPU (ROADMAP
  Queue 3) where the port multiplies, then subtracts; each of the
  ``local_steps`` steps moves a weight by at most ``lr * |g|``, so the
  deltas agree to ``atol=1e-6`` at ``lr = 0.01``. ``payload_from`` (a
  vmap over per-client weights, whose convs become batched-weight convs)
  against a loop of ``_local_delta`` over the clients inside the port:
  ``rtol=1e-4, atol=1e-7``.
* Trajectory — ``run_fedavg`` against the reference's on the 4-client
  world, from the reference's initial weights: ``none``, ``max_abs`` and
  the fused round, each without and with an approx downlink at the
  uplink's 10 dB; and on ``static-noisy-dl`` / ``vehicular-noisy-dl``
  with 6 clients under bucketed, bucketed fused and select. Link dicts in
  the reference's key order; modes and ``downlink_mode_counts`` Exact;
  airtimes within ``rel=2**-20``; accuracy within ``ACC_TOL`` (2 of 160
  test images) at every eval point. The runs take the reference config's
  ``lr = 0.01``: at ``lr = 0.1`` a 10 dB approx downlink (BER about 4%)
  hands clients so corrupted a model that one-ULP differences in the
  first round's deltas grow and the two trajectories part within three
  rounds (ROADMAP Queue 3).
* Inside the port: a perfect downlink equals ``downlink=None`` bit for
  bit; with the kernel rows cleared, the bucketed ``max_abs`` round
  equals the select round bit for bit.
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
from repro.link import scenario as JS  # noqa: E402
from repro_torch.configs.mnist_cnn import config as t_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import transport as TT  # noqa: E402
from repro_torch.fl import cnn as TC  # noqa: E402
from repro_torch.fl import engine as TE  # noqa: E402
from repro_torch.fl.fedavg import run_fedavg as t_run_fedavg  # noqa: E402
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


@pytest.fixture(scope="module")
def params():
    with jax.threefry_partitionable(True):
        jp = JC.init_params(jax.random.PRNGKey(1), j_config())
    return {k: np.asarray(v) for k, v in jp.items()}


def _algos(**kw):
    return (JEN.FedAvg(j_config(), **kw), TE.FedAvg(t_config(), **kw))


def test_sample_exact(world):
    cx, cy, _, _ = world
    ja, ta = _algos(local_steps=3, batch_per_step=5)
    for seed in (0, 7):
        xj, yj = ja.sample(np.random.default_rng(seed), cx, cy)
        xt, yt = ta.sample(np.random.default_rng(seed), cx, cy, "cpu")
        xo, yo = _take_along(ta, np.random.default_rng(seed), cx, cy)
        assert xt.shape == (4, 3, 5, 28, 28) and yt.dtype == torch.int64
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        np.testing.assert_array_equal(xt.numpy(), xo)
        np.testing.assert_array_equal(yt.numpy(), yo)
    assert ta.staged_samples == 0


def _take_along(algo, rng, cx, cy):
    """The draws of ``algo.sample`` gathered by ``np.take_along_axis``, as
    the port's ``sample`` did before its whole-row gather: ``(xb, yb)``
    as numpy arrays, the labels int64."""
    M = cx.shape[0]
    if isinstance(algo, TE.FedAvg):
        shape = (M, algo.local_steps, algo.batch_per_step)
    else:
        shape = (M, algo.batch_per_round)
    take = rng.integers(0, cx.shape[1], shape).reshape(M, -1)
    xb = np.take_along_axis(cx, take[:, :, None, None], axis=1)
    yb = np.take_along_axis(cy, take, axis=1)
    return (xb.reshape(shape + cx.shape[2:]),
            yb.reshape(shape).astype(np.int64))


# (clients, samples a client, batch): the benchmark cell's world and a
# small odd one; "strided" is the odd one as a non-contiguous view.
SAMPLE_WORLDS = {"cell": (100, 96, 32), "odd": (3, 7, 5),
                 "strided": (3, 7, 5)}
SAMPLE_ALGOS = ("fedsgd", "fedavg-1", "fedavg-4")


def _sample_world(name):
    M, n, _ = SAMPLE_WORLDS[name]
    rng = np.random.default_rng(M * n)
    if name == "strided":
        cx = rng.uniform(0, 1, (M, 2 * n, 28, 28)).astype(np.float32)[:, ::2]
        cy = rng.integers(0, 10, (M, 2 * n)).astype(np.int32)[:, ::2]
        assert not cx.flags.c_contiguous
        return cx, cy
    return (rng.uniform(0, 1, (M, n, 28, 28)).astype(np.float32),
            rng.integers(0, 10, (M, n)).astype(np.int32))


def _sample_algos(name, batch):
    if name == "fedsgd":
        return (JEN.FedSGD(j_config(), batch_per_round=batch),
                TE.FedSGD(t_config(), batch_per_round=batch))
    return _algos(local_steps=int(name.split("-")[1]), batch_per_step=batch)


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 11])
@pytest.mark.parametrize("world_name", list(SAMPLE_WORLDS))
@pytest.mark.parametrize("algo", SAMPLE_ALGOS)
def test_sample_rows_exact(algo, world_name, seed):
    """The whole-row gather on the CPU equals the reference's ``sample``
    and the ``take_along_axis`` expression bit for bit, two rounds from
    one generator; it stages nothing off CUDA."""
    cx, cy = _sample_world(world_name)
    ja, ta = _sample_algos(algo, SAMPLE_WORLDS[world_name][2])
    rj, rt, ro = (np.random.default_rng(seed) for _ in range(3))
    for _ in range(2):
        xj, yj = ja.sample(rj, cx, cy)
        xt, yt = ta.sample(rt, cx, cy, "cpu")
        xo, yo = _take_along(ta, ro, cx, cy)
        assert xt.dtype == torch.float32 and yt.dtype == torch.int64
        assert xt.device.type == yt.device.type == "cpu"
        assert xt.shape == xo.shape and yt.shape == yo.shape
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        np.testing.assert_array_equal(xt.numpy(), xo)
        np.testing.assert_array_equal(yt.numpy(), yo)
    assert ta.staged_samples == 0


class _EdgeDraws:
    """A generator whose ``integers`` draws only 0 and ``high - 1``, in
    turn: each client's first and last rows, where a flat row index that
    left its client's rows would be clipped to another's."""

    def integers(self, low, high, size):
        return np.where(np.arange(int(np.prod(size))) % 2, high - 1,
                        low).reshape(size)


@pytest.mark.parametrize("algo", SAMPLE_ALGOS)
def test_sample_clip_never_engages(algo):
    """``mode="clip"`` never moves an index: at the extreme draws every
    row is the client's own row ``take`` by plain indexing."""
    cx, cy = _sample_world("odd")
    _, ta = _sample_algos(algo, 5)
    xt, yt = ta.sample(_EdgeDraws(), cx, cy, "cpu")
    take = _EdgeDraws().integers(0, cx.shape[1], yt.shape).reshape(
        cx.shape[0], -1)
    for c in range(cx.shape[0]):
        np.testing.assert_array_equal(
            xt[c].reshape((-1,) + cx.shape[2:]).numpy(), cx[c, take[c]])
        np.testing.assert_array_equal(yt[c].reshape(-1).numpy(),
                                      cy[c, take[c]])


@pytest.mark.parametrize("algo", SAMPLE_ALGOS)
def test_sample_keeps_earlier_rounds(algo):
    """A round's ``(xb, yb)`` stay as they were after the next rounds are
    sampled: no round's output aliases a buffer the gather reuses."""
    cx, cy = _sample_world("odd")
    _, ta = _sample_algos(algo, 5)
    rng = np.random.default_rng(3)
    xb, yb = ta.sample(rng, cx, cy, "cpu")
    x0, y0 = xb.clone(), yb.clone()
    later = [ta.sample(rng, cx, cy, "cpu") for _ in range(2)]
    assert not torch.equal(later[0][0], x0)
    assert torch.equal(xb, x0) and torch.equal(yb, y0)


def _deltas(seed=0):
    """Two leaves of per-client deltas over six decades, one client all
    zero (the 1e-8 floor) and one whose max is 0.001."""
    rng = np.random.default_rng(seed)
    scale = np.float32(10.0) ** rng.uniform(-6, 0, (6, 1)).astype(np.float32)
    a = (rng.standard_normal((6, 40)) * scale).astype(np.float32)
    b = (rng.standard_normal((6, 2, 3)) * scale[:, :, None]).astype(
        np.float32)
    a[2], b[2] = 0.0, 0.0
    a[3] = np.linspace(-0.001, 0.0005, 40, dtype=np.float32)
    b[3] = 0.0
    return {"a": a, "b": b}


def test_scale_div_mul_exact():
    ja, ta = _algos(scale_mode="max_abs")
    for seed in range(3):
        d = _deltas(seed)
        dj = {k: jnp.asarray(v) for k, v in d.items()}
        dt = {k: torch.from_numpy(v) for k, v in d.items()}
        sj = np.asarray(ja._compute_scale(dj))
        st = ta._scale_of(dt)
        np.testing.assert_array_equal(st.numpy(), sj)
        assert float(st[2]) == np.float32(1e-8) * np.float32(1 / 0.9)
        assert float(st[3]) == 0.0011111112544313073  # not the quotient
        for name, jf, tf in (("div", ja._div_scale, ta._div),
                             ("mul", ja._mul_scale, ta._mul)):
            oj = jf(dj, jnp.asarray(sj))
            ot = tf(dt, st)
            for k in d:
                np.testing.assert_array_equal(
                    ot[k].numpy().view(np.uint32),
                    np.asarray(oj[k]).view(np.uint32), err_msg=name)


def test_local_delta_bounded(params, world):
    cx, cy, _, _ = world
    ja, ta = _algos(local_steps=3, batch_per_step=8)
    xj, yj = ja.sample(np.random.default_rng(2), cx, cy)
    xt, yt = ta.sample(np.random.default_rng(2), cx, cy, "cpu")
    tp = params_from_jax(params)
    for c in (0, 3):
        dj = jax.jit(ja._local_delta)(params, xj[c], yj[c])
        dt = ta._local_delta(tp, xt[c], yt[c])
        for k in params:
            assert dt[k].shape == params[k].shape
            np.testing.assert_allclose(dt[k].numpy(), np.asarray(dj[k]),
                                       rtol=0, atol=1e-6, err_msg=k)
        assert max(float(dt[k].abs().max()) for k in dt) > 1e-4


@pytest.mark.parametrize("algo", ["fedsgd", "fedavg"])
def test_payload_from_equals_per_client_loop(params, world, algo):
    """vmap over per-client weights against a loop over the clients, each
    from its own (different) weights; and from identical copies, against
    the shared-weight ``payload``, to summation order."""
    cx, cy, _, _ = world
    tp = params_from_jax(params)
    rng = np.random.default_rng(4)
    recv = {k: v[None] * torch.from_numpy(
        rng.uniform(0.8, 1.2, (4,) + (1,) * v.ndim).astype(np.float32))
        for k, v in tp.items()}
    if algo == "fedsgd":
        a = TE.FedSGD(t_config(), batch_per_round=8)
        xb, yb = a.sample(np.random.default_rng(1), cx, cy, "cpu")
        one = torch.func.grad(TC.loss_fn)
    else:
        a = TE.FedAvg(t_config(), local_steps=2, batch_per_step=8)
        xb, yb = a.sample(np.random.default_rng(1), cx, cy, "cpu")
        one = a._local_delta
    got = a.payload_from(recv, xb, yb)
    for c in range(4):
        want = one({k: v[c] for k, v in recv.items()}, xb[c], yb[c])
        for k in tp:
            np.testing.assert_allclose(got[k][c].numpy(), want[k].numpy(),
                                       rtol=1e-4, atol=1e-7, err_msg=k)
    same = {k: v.expand((4,) + v.shape) for k, v in tp.items()}
    got, shared = a.payload_from(same, xb, yb), a.payload(tp, xb, yb)
    for k in tp:
        np.testing.assert_allclose(got[k].numpy(), shared[k].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


def _tcfg(use_kernel=True):
    return (JT.TransportConfig(mode="approx", use_kernel=use_kernel,
                               channel=JCH.ChannelConfig(snr_db=10.0)),
            TT.TransportConfig(mode="approx", use_kernel=use_kernel,
                               channel=TCH.ChannelConfig(snr_db=10.0)))


def _runs(world, scale_mode, fused, *, downlink=None, scenario=None,
          dispatch="bucketed", n_rounds=3, seed=3, use_kernel=True):
    """The reference's and the port's run, the port from the reference's
    initial weights."""
    cx, cy, ti, tl = world
    jc, tc = _tcfg(use_kernel)
    ja, ta = _algos(local_steps=2, batch_per_step=8, scale_mode=scale_mode)
    kw = dict(n_rounds=n_rounds, eval_every=1, seed=seed,
              fused_aggregate=fused, adaptive_dispatch=dispatch)
    jd = td = js = ts = None
    if downlink is not None:
        jd = JS.DownlinkConfig(**downlink)
        td = TS.DownlinkConfig(**downlink)
    if scenario is not None:
        js = dataclasses.replace(JS.get_scenario(scenario),
                                 ecrt_expected_tx=2.0)
        ts = dataclasses.replace(TS.get_scenario(scenario),
                                 ecrt_expected_tx=2.0)
    je = JEN.RoundEngine(ja, jc, cx, cy, ti, tl, downlink=jd, scenario=js,
                         **kw)
    te = TE.RoundEngine(ta, tc, cx, cy, ti, tl, downlink=td, scenario=ts,
                        device="cpu", **kw)
    te.params = params_from_jax({k: np.asarray(v)
                                 for k, v in je.params.items()})
    return je.run(), te.run()


def _check(a, b, first_ber_exact):
    assert a.rounds == b.rounds
    assert len(a.link) == len(b.link)
    for r, (lj, lt) in enumerate(zip(a.link, b.link)):
        assert list(lt) == list(lj)
        for f in ("round", "mode_counts", "n_active", "n_stragglers",
                  "downlink_mode_counts"):
            if f in lj:
                assert lt[f] == lj[f], (r, f)
        for f in ("airtime_s", "downlink_airtime_s"):
            if f in lj:
                assert lt[f] == pytest.approx(lj[f], rel=2**-20), f
        if r == 0 and "downlink_ber" in lj:
            if first_ber_exact:
                assert lt["downlink_ber"] == lj["downlink_ber"]
            else:  # scenario SNRs come from normals (Bounded)
                assert lt["downlink_ber"] == pytest.approx(
                    lj["downlink_ber"], abs=1e-4)
    np.testing.assert_allclose(b.accuracy, a.accuracy, rtol=0, atol=ACC_TOL)
    np.testing.assert_allclose(b.airtime_s, a.airtime_s, rtol=2**-20)


@pytest.mark.parametrize("downlink", [False, True])
@pytest.mark.parametrize("scale_mode,fused", [
    ("none", False), ("max_abs", False), ("none", True)])
def test_run_fedavg_driverless_vs_reference(world, scale_mode, fused,
                                            downlink):
    dl = dict(mode="approx") if downlink else None
    a, b = _runs(world, scale_mode, fused, downlink=dl)
    _check(a, b, first_ber_exact=True)
    if downlink:
        assert [list(l) for l in b.link] == [
            ["round", "downlink_airtime_s", "downlink_ber"]] * 3
        assert "downlink_kernel" in b.phase_s[0]
    else:
        assert b.link == []
    print(f"{scale_mode} fused={fused} downlink={downlink}: reference "
          f"{a.accuracy}, port {b.accuracy}")


@pytest.fixture(scope="module")
def world6():
    (img, lab), (ti, tl) = j_synth.train_test(60, 16, seed=0)
    parts = j_partition.non_iid_partition(img, lab, n_clients=6)
    cx, cy = j_partition.stack_clients(parts, per_client=16)
    return cx, cy, ti, tl


@pytest.mark.parametrize("dispatch,fused", [
    ("bucketed", False), ("bucketed", True), ("select", False)])
@pytest.mark.parametrize("preset", ["static-noisy-dl", "vehicular-noisy-dl"])
def test_run_fedavg_downlink_presets_vs_reference(world6, preset, dispatch,
                                                  fused):
    a, b = _runs(world6, "none", fused, scenario=preset, dispatch=dispatch,
                 n_rounds=2, seed=4)
    _check(a, b, first_ber_exact=False)
    adaptive = preset == "vehicular-noisy-dl"
    for rec in b.link:
        assert ("downlink_mode_counts" in rec) == adaptive
        if adaptive:
            assert sum(rec["downlink_mode_counts"]) == 6
    print(f"{preset} {dispatch} fused={fused}: modes "
          f"{[l['mode_counts'] for l in b.link]}, downlink "
          f"{[l.get('downlink_mode_counts') for l in b.link]}; reference "
          f"{a.accuracy}, port {b.accuracy}")


def test_max_abs_scenario_bucketed_equals_select(world6):
    """With the kernel rows cleared, the bucketed ``max_abs`` round (scale
    over the cohort, one batch per mode, descale) equals the select round
    bit for bit, downlink included."""
    cx, cy, ti, tl = world6
    _, tc = _tcfg(use_kernel=False)
    scen = dataclasses.replace(TS.get_scenario("vehicular-noisy-dl"),
                               ecrt_expected_tx=2.0, dropout_prob=0.1)
    kw = dict(n_rounds=2, local_steps=2, batch_per_step=6, eval_every=1,
              seed=6, scale_mode="max_abs", scenario=scen, device="cpu")
    a = t_run_fedavg(t_config(), tc, cx, cy, ti, tl,
                     adaptive_dispatch="bucketed", **kw)
    b = t_run_fedavg(t_config(), tc, cx, cy, ti, tl,
                     adaptive_dispatch="select", **kw)
    assert a.accuracy == b.accuracy and a.airtime_s == b.airtime_s
    assert a.link == b.link


def test_perfect_downlink_equals_no_downlink(world):
    cx, cy, ti, tl = world
    _, tc = _tcfg()
    out = []
    for dl in (None, TS.DownlinkConfig(mode="perfect")):
        eng = TE.RoundEngine(TE.FedAvg(t_config(), local_steps=2,
                                       batch_per_step=8,
                                       scale_mode="max_abs"),
                             tc, cx, cy, ti, tl, n_rounds=2, eval_every=1,
                             seed=5, downlink=dl, device="cpu")
        out.append((eng.run(), eng.params))
    (a, pa), (b, pb) = out
    for k in pa:
        assert torch.equal(pa[k].view(torch.int32), pb[k].view(torch.int32))
    assert a.accuracy == b.accuracy
    assert b.airtime_s[-1] > a.airtime_s[-1]
