"""The port's compressed FL rounds (``RoundEngine(compression=...)``,
``run_fl`` / ``run_fedavg`` with ``compression=``, the ``iot-lowrate``
preset) against the reference's.

* Trajectory — three rounds of each run, the port from the reference's
  initial weights: link dicts in the reference's key order
  (``comp_*`` between the scenario and the downlink fields); mode counts,
  ``n_active``, ``comp_ratio`` and ``comp_bits_on_air`` Exact at every
  round; round 0's accuracy Exact and its ``comp_residual_norm`` within
  ``rel=1e-6`` (the port reduces the residual in another order); later
  accuracies within ``ACC_TOL`` (2 of 160 test images) and residual norms
  within ``rel=1e-2``; airtimes within ``rel=2**-20``. Gradients agree to
  a few ULP (conv and matmul grads sum in another order), so round 0
  selects the same coordinates; from round 1 on the two trajectories may
  part at near-ties of the top-k.
* Inside the port: on a table without kernel rows, the bucketed round
  equals the select round bit for bit (one budget, an explicit ``k``);
  ``run_fl`` / ``run_fedavg`` equal the engine they wrap.
* The reference's refusals: ``fused_aggregate=True`` with compression,
  ``compress_ratios`` under the select dispatch, and ``sketches=`` without
  a scenario raise ``ValueError``; sketches on a compressed ``iot-lowrate``
  round observe its active clients.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.compress import sparsify as JSP  # noqa: E402
from repro.configs.mnist_cnn import config as j_config  # noqa: E402
from repro.core import channel as JCH  # noqa: E402
from repro.core import transport as JT  # noqa: E402
from repro.data import synth_mnist as j_synth  # noqa: E402
from repro.fl import engine as JEN  # noqa: E402
from repro.fl import partition as j_partition  # noqa: E402
from repro.link import scenario as JS  # noqa: E402
from repro_torch.compress import sparsify as TSP  # noqa: E402
from repro_torch.configs.mnist_cnn import config as t_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import transport as TT  # noqa: E402
from repro_torch.fl import engine as TE  # noqa: E402
from repro_torch.fl.fedavg import run_fedavg as t_run_fedavg  # noqa: E402
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


def _world(n_clients):
    (img, lab), (ti, tl) = j_synth.train_test(60, 16, seed=0)
    parts = j_partition.non_iid_partition(img, lab, n_clients=n_clients)
    cx, cy = j_partition.stack_clients(parts, per_client=24)
    return cx, cy, ti, tl


@pytest.fixture(scope="module")
def world():
    return _world(4)


@pytest.fixture(scope="module")
def world6():
    return _world(6)


def _cfgs(use_kernel=True, snr_db=10.0):
    return (JT.TransportConfig(mode="approx", use_kernel=use_kernel,
                               channel=JCH.ChannelConfig(snr_db=snr_db)),
            TT.TransportConfig(mode="approx", use_kernel=use_kernel,
                               channel=TCH.ChannelConfig(snr_db=snr_db)))


def _algos(algo, scale_mode="none"):
    if algo == "fedsgd":
        return (JEN.FedSGD(j_config(), batch_per_round=8),
                TE.FedSGD(t_config(), batch_per_round=8))
    kw = dict(local_steps=2, batch_per_step=8, scale_mode=scale_mode)
    return JEN.FedAvg(j_config(), **kw), TE.FedAvg(t_config(), **kw)


def _runs(world, algo="fedsgd", comp=None, *, scale_mode="none",
          scenario=None, dispatch="bucketed", use_kernel=True, downlink=None):
    """The reference's and the port's three-round run, the port from the
    reference's initial weights. ``comp`` is a dict of
    ``CompressionConfig`` fields (``None``: the scenario's own)."""
    cx, cy, ti, tl = world
    jc, tc = _cfgs(use_kernel)
    ja, ta = _algos(algo, scale_mode)
    kw = dict(n_rounds=3, eval_every=1, seed=3, adaptive_dispatch=dispatch)
    jk, tk = dict(kw), dict(kw)
    if comp is not None:
        jk["compression"] = JSP.CompressionConfig(**comp)
        tk["compression"] = TSP.CompressionConfig(**comp)
    if scenario is not None:
        jk["scenario"] = dataclasses.replace(JS.get_scenario(scenario),
                                             ecrt_expected_tx=2.0)
        tk["scenario"] = dataclasses.replace(TS.get_scenario(scenario),
                                             ecrt_expected_tx=2.0)
    if downlink is not None:
        jk["downlink"] = JS.DownlinkConfig(**downlink)
        tk["downlink"] = TS.DownlinkConfig(**downlink)
    je = JEN.RoundEngine(ja, jc, cx, cy, ti, tl, **jk)
    te = TE.RoundEngine(ta, tc, cx, cy, ti, tl, device="cpu", **tk)
    te.params = params_from_jax({k: np.asarray(v)
                                 for k, v in je.params.items()})
    return je.run(), te.run()


def _check(a, b):
    assert a.rounds == b.rounds == [0, 1, 2]
    assert len(a.link) == len(b.link) == 3
    for r, (lj, lt) in enumerate(zip(a.link, b.link)):
        assert list(lt) == list(lj)
        for f in ("round", "mode_counts", "n_active", "n_stragglers",
                  "downlink_mode_counts", "comp_ratio", "comp_bits_on_air"):
            if f in lj:
                assert lt[f] == lj[f], (r, f)
        for f in ("mean_snr_db", "mean_est_db"):
            if f in lj:
                assert lt[f] == pytest.approx(lj[f], abs=1e-4), f
        for f in ("airtime_s", "downlink_airtime_s"):
            if f in lj:
                assert lt[f] == pytest.approx(lj[f], rel=2**-20), f
        assert lt["comp_residual_norm"] == pytest.approx(
            lj["comp_residual_norm"], rel=1e-6 if r == 0 else 1e-2)
    assert b.accuracy[0] == a.accuracy[0]
    np.testing.assert_allclose(b.accuracy, a.accuracy, rtol=0, atol=ACC_TOL)
    np.testing.assert_allclose(b.airtime_s, a.airtime_s, rtol=2**-20)


@pytest.mark.parametrize("comp,use_kernel", [
    (dict(), True),
    (dict(method="randk", header="ecrt", header_ecrt_expected_tx=1.25), True),
    (dict(method="threshold", threshold=1e-3, header="perfect",
          error_feedback=False), False)],
    ids=["topk-gray-kernel", "randk-ecrt-kernel", "threshold-perfect-no-ef"])
def test_run_fl_driverless_compressed_vs_reference(world, comp, use_kernel):
    a, b = _runs(world, "fedsgd", comp, use_kernel=use_kernel)
    _check(a, b)
    assert [list(l) for l in b.link] == [
        ["round", "comp_ratio", "comp_bits_on_air", "comp_residual_norm"]] * 3
    if comp.get("error_feedback", True) is False:
        assert all(l["comp_residual_norm"] == 0.0 for l in b.link)
    print(f"{comp}: reference {a.accuracy}, port {b.accuracy}")


def test_run_fl_compressed_behind_downlink_vs_reference(world):
    """Two kernel legs a round: the approx broadcast at the uplink's SNR,
    then the compressed uplink; ``comp_*`` come before the downlink
    fields."""
    a, b = _runs(world, "fedsgd", dict(), downlink=dict(mode="approx"))
    _check(a, b)
    assert list(b.link[0]) == ["round", "comp_ratio", "comp_bits_on_air",
                               "comp_residual_norm", "downlink_airtime_s",
                               "downlink_ber"]
    assert b.link[0]["downlink_ber"] == a.link[0]["downlink_ber"]


@pytest.mark.parametrize("algo,scale_mode", [
    ("fedsgd", "none"), ("fedavg", "max_abs")])
def test_iot_lowrate_bucketed_vs_reference(world6, algo, scale_mode):
    """The preset's own compression (top-k 0.02, Gray header) with its
    per-mode budgets ``compress_ratios``, under the bucketed dispatch."""
    a, b = _runs(world6, algo, None, scale_mode=scale_mode,
                 scenario="iot-lowrate")
    _check(a, b)
    assert "comp_ratio" in b.link[0] and "mean_snr_db" in b.link[0]
    print(f"iot-lowrate {algo}: modes {[l['mode_counts'] for l in b.link]}, "
          f"reference {a.accuracy}, port {b.accuracy}")


def test_run_fedavg_max_abs_compressed_vs_reference(world):
    a, b = _runs(world, "fedavg", dict(), scale_mode="max_abs")
    _check(a, b)


def test_vehicular_select_explicit_k_vs_reference(world6):
    """An explicit ``k`` wins over the policy's ratios: one budget for
    every mode under the select dispatch (kernel rows cleared)."""
    a, b = _runs(world6, "fedsgd", dict(k=437), scenario="vehicular",
                 dispatch="select")
    _check(a, b)
    assert all(l["comp_ratio"] == 437 / 21840 for l in b.link)


def test_bucketed_equals_select_without_kernel_rows(world6):
    """One budget, no kernel rows: the bucketed compressed round and the
    select one give the same model, link dicts and residual, bit for bit."""
    cx, cy, ti, tl = world6
    _, tc = _cfgs(use_kernel=False)
    out = []
    for dispatch in ("bucketed", "select"):
        e = TE.RoundEngine(
            TE.FedAvg(t_config(), local_steps=2, batch_per_step=8,
                      scale_mode="max_abs"), tc, cx, cy, ti, tl,
            n_rounds=2, eval_every=1, seed=5, scenario="vehicular",
            adaptive_dispatch=dispatch,
            compression=TSP.CompressionConfig(method="randk", k=300),
            device="cpu")
        out.append((e.run(), e))
    (ra, ea), (rb, eb) = out
    assert ra.link == rb.link and ra.accuracy == rb.accuracy
    for k in ea.params:
        assert torch.equal(ea.params[k].view(torch.int32),
                           eb.params[k].view(torch.int32)), k
    assert torch.equal(ea._ef_residual.view(torch.int32),
                       eb._ef_residual.view(torch.int32))


def test_run_fl_and_run_fedavg_pass_compression_through(world):
    cx, cy, ti, tl = world
    _, tc = _cfgs(use_kernel=True)
    comp = TSP.CompressionConfig(ratio=0.01)
    kw = dict(n_rounds=2, eval_every=1, seed=2, compression=comp,
              device="cpu")
    a = t_run_fl(t_config(), tc, cx, cy, ti, tl, batch_per_round=8, **kw)
    b = TE.RoundEngine(TE.FedSGD(t_config(), batch_per_round=8), tc, cx, cy,
                       ti, tl, **kw).run()
    assert a.accuracy == b.accuracy and a.link == b.link
    assert a.link[0]["comp_ratio"] == 218 / 21840
    a = t_run_fedavg(t_config(), tc, cx, cy, ti, tl, local_steps=2,
                     batch_per_step=8, scale_mode="max_abs", **kw)
    b = TE.RoundEngine(TE.FedAvg(t_config(), local_steps=2, batch_per_step=8,
                                 scale_mode="max_abs"), tc, cx, cy, ti, tl,
                       **kw).run()
    assert a.accuracy == b.accuracy and a.link == b.link


def test_compression_refusals(world6):
    cx, cy, ti, tl = world6
    jc, tc = _cfgs()
    for eng, cfg, comp_lib, config, scen in (
            (JEN, jc, JSP, j_config, JS), (TE, tc, TSP, t_config, TS)):
        scen = dataclasses.replace(scen.get_scenario("iot-lowrate"),
                                   ecrt_expected_tx=2.0)
        kw = {} if eng is JEN else dict(device="cpu")
        with pytest.raises(ValueError, match="compress"):
            eng.RoundEngine(eng.FedSGD(config()), cfg, cx, cy, ti, tl,
                            n_rounds=1, compression=comp_lib.CompressionConfig(),
                            fused_aggregate=True, **kw)
        with pytest.raises(ValueError, match="bucketed"):
            eng.RoundEngine(eng.FedSGD(config()), cfg, cx, cy, ti, tl,
                            n_rounds=1, scenario=scen,
                            adaptive_dispatch="select", **kw)
    # Sketches need a scenario in both packages; on a compressed scenario
    # run they observe every round.
    for eng, cfg, config in ((JEN, jc, j_config), (TE, tc, t_config)):
        kw = {} if eng is JEN else dict(device="cpu")
        with pytest.raises(ValueError, match="needs a scenario"):
            eng.RoundEngine(eng.FedSGD(config()), cfg, cx, cy, ti, tl,
                            n_rounds=1, sketches=True, **kw)
    scen = dataclasses.replace(TS.get_scenario("iot-lowrate"),
                               ecrt_expected_tx=2.0)
    res = TE.RoundEngine(TE.FedSGD(t_config(), batch_per_round=4), tc, cx,
                         cy, ti, tl, n_rounds=1, device="cpu",
                         scenario=scen, sketches=True).run()
    assert res.records[0].sketches["ber"]["total"] == res.link[0]["n_active"]
