"""The port's buffered asynchronous engine (``repro_torch.fl.async_engine``)
against the port's own sync engine and against the reference.

* Port buffered == port sync, bit for bit — with simultaneous arrivals
  (the default compute model), ``buffer_k = None`` (the cohort) and
  constant weights every wave is one sync round: accuracy, airtime,
  ``FLResult.link``, the final params, and the launch counters, on every
  combination of ``tests/test_async_golden.py`` (FedSGD / FedAvg,
  driverless / ``vehicular`` with dropout, bucketed / select, compressed,
  behind a downlink) plus fused driverless (K2, weights
  ``normalize_weights(member)``) and bucketed fused (K2 per bucket,
  ``normalize_weights(member * active)``). ``event_s`` has one stamp per
  eval and ``phase_s`` one dict per round, shaped as the sync one's.
* ``buffer_k = M`` spelled out equals the default; a small buffer
  diverges from the sync run; the same seed gives the same run.
* Against the reference (4 clients, ``metro-rush`` ``buffer_k=2``
  polynomial; ``global-churn`` ``buffer_k=2`` inverse with top-k
  compression; the port from the reference's initial weights): the
  arrival schedule and each aggregation's membership Exact, except that
  two arrivals within ``T_RTOL`` of each other may swap; ``event_s`` and
  every event time Bounded (``T_RTOL``: compute times and gaps pass
  through ``exp`` / ``log1p`` / ``erfinv``); accuracy Trajectory
  (``ACC_TOL``, 2 of 160 test images); the manifest fingerprint Exact;
  the ledger's event stream and the trace equal in kinds, waves, clients
  and versions.
* Failure modes: the reference's ``ValueError``s, and the stall raises
  ``RuntimeError``.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.compress import sparsify as JSP  # noqa: E402
from repro.configs.mnist_cnn import config as j_config  # noqa: E402
from repro.core import channel as JCH  # noqa: E402
from repro.core import transport as JT  # noqa: E402
from repro.data import synth_mnist as j_synth  # noqa: E402
from repro.fl import async_engine as JA  # noqa: E402
from repro.fl import engine as JEN  # noqa: E402
from repro.fl import partition as j_partition  # noqa: E402
from repro.link import scenario as JS  # noqa: E402
from repro.obs import ledger as JL  # noqa: E402
from repro.obs import trace as JTR  # noqa: E402
from repro_torch.compress import sparsify as TSP  # noqa: E402
from repro_torch.configs.mnist_cnn import config as t_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import transport as TT  # noqa: E402
from repro_torch.fl import AsyncRoundEngine, run_fedavg_buffered  # noqa: E402
from repro_torch.fl import run_fl_buffered  # noqa: E402
from repro_torch.fl import engine as TE  # noqa: E402
from repro_torch.kernels import approx_channel as TAC  # noqa: E402
from repro_torch.link import dynamics as TD  # noqa: E402
from repro_torch.link import scenario as TS  # noqa: E402
from repro_torch.obs import PhaseTimers, RoundSketcher  # noqa: E402
from repro_torch.obs import ledger as TL  # noqa: E402
from repro_torch.obs import trace as TTR  # noqa: E402

ACC_TOL = 2 / 160 + 1e-6
T_RTOL = 1e-6


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
    return tuple(np.asarray(a) for a in (cx, cy, ti, tl))


def _tc(mode="approx", **kw):
    return TT.TransportConfig(mode=mode, use_kernel=True,
                              channel=TCH.ChannelConfig(snr_db=kw.pop(
                                  "snr_db", 10.0)), **kw)


def _jc():
    return JT.TransportConfig(mode="approx", use_kernel=True,
                              channel=JCH.ChannelConfig(snr_db=10.0))


def _vehicular():
    # Explicit E[tx] skips the LDPC calibration; dropout takes the
    # buffer's drain path (dropped clients never arrive).
    return dataclasses.replace(TS.get_scenario("vehicular"),
                               ecrt_expected_tx=2.0, dropout_prob=0.1)


KW = dict(n_rounds=3, batch_per_round=8, eval_every=2, seed=3)
AKW = dict(n_rounds=3, local_steps=2, batch_per_step=6,
           scale_mode="max_abs", eval_every=2, seed=5)


def _engine(buffered, algo, tc, world, **kw):
    cls = AsyncRoundEngine if buffered else TE.RoundEngine
    return cls(algo, tc, *world, device="cpu", **kw)


def _run_pair(world, fedavg, tc, **kw):
    """The sync and the buffered engine on the same arguments: ``((result,
    engine, launches), ...)``."""
    out = []
    for buffered in (False, True):
        run_kw = dict(AKW if fedavg else KW)
        if fedavg:
            algo = TE.FedAvg(t_config(), local_steps=run_kw.pop("local_steps"),
                             batch_per_step=run_kw.pop("batch_per_step"),
                             scale_mode=run_kw.pop("scale_mode"))
        else:
            algo = TE.FedSGD(dataclasses.replace(t_config(), lr=0.1),
                             batch_per_round=run_kw.pop("batch_per_round"))
        eng = _engine(buffered, algo, tc, world, **run_kw, **kw)
        TAC.reset_launch_counts()
        res = eng.run()
        out.append((res, eng, TAC.launch_counts()))
    return out


def _assert_identical(pair):
    (a, ea, la), (b, eb, lb) = pair
    assert a.rounds == b.rounds
    assert a.accuracy == b.accuracy
    assert a.airtime_s == b.airtime_s
    assert a.final_accuracy == b.final_accuracy
    assert a.link == b.link
    assert la == lb
    for k in ea.params:
        assert torch.equal(ea.params[k], eb.params[k]), k
    assert a.event_s == [] and len(b.event_s) == len(b.rounds)
    assert all(t2 >= t1 for t1, t2 in zip(b.event_s, b.event_s[1:]))
    assert len(b.phase_s) == len(a.phase_s)
    assert [list(p) for p in b.phase_s] == [list(p) for p in a.phase_s]
    assert [r.t_event is not None for r in b.records] == [True] * len(
        b.records)


COMBOS = {
    "fedsgd-driverless": (False, {}),
    "fedsgd-driverless-fused": (False, dict(fused_aggregate=True)),
    "fedavg-driverless-ecrt": (True, dict(tc=_tc(
        "ecrt", snr_db=6.0, simulate_fec=False, ecrt_expected_tx=1.3))),
    "fedsgd-bucketed": (False, dict(scenario="v")),
    "fedsgd-select": (False, dict(scenario="v",
                                  adaptive_dispatch="select")),
    "fedsgd-bucketed-fused": (False, dict(scenario="v",
                                          fused_aggregate=True)),
    "fedavg-bucketed": (True, dict(scenario="v")),
    "fedavg-select": (True, dict(scenario="v", adaptive_dispatch="select")),
    "compressed-driverless": (False, dict(compression=TSP.CompressionConfig(
        method="topk", ratio=0.25))),
    "compressed-bucketed": (False, dict(
        scenario="v", compression=TSP.CompressionConfig(method="randk",
                                                        ratio=0.25))),
    "compressed-select": (False, dict(
        scenario="v", adaptive_dispatch="select",
        compression=TSP.CompressionConfig(method="randk", ratio=0.25))),
    "downlink-driverless": (False, dict(downlink=TS.DownlinkConfig(
        mode="approx", snr_offset_db=6.0))),
    "downlink-driverless-fused": (False, dict(
        fused_aggregate=True,
        downlink=TS.DownlinkConfig(mode="approx", snr_offset_db=6.0))),
    "downlink-bucketed": (False, dict(scenario="v", downlink=TS.DownlinkConfig(
        mode="approx", snr_offset_db=6.0, adaptive=True))),
    "downlink-select": (False, dict(
        scenario="v", adaptive_dispatch="select",
        downlink=TS.DownlinkConfig(mode="approx", snr_offset_db=6.0,
                                   adaptive=True))),
}


@pytest.mark.parametrize("combo", list(COMBOS))
def test_degenerate_buffered_is_sync(world, combo):
    fedavg, kw = COMBOS[combo]
    kw = dict(kw)
    tc = kw.pop("tc", None) or _tc()
    if kw.get("scenario") == "v":
        kw["scenario"] = _vehicular()
    _assert_identical(_run_pair(world, fedavg, tc, **kw))


def test_explicit_buffer_k_equal_cohort_matches_default(world):
    a = run_fl_buffered(dataclasses.replace(t_config(), lr=0.1), _tc(),
                        *world, buffer_k=4, device="cpu", **KW)
    b = run_fl_buffered(dataclasses.replace(t_config(), lr=0.1), _tc(),
                        *world, device="cpu", **KW)
    assert (a.accuracy, a.airtime_s, a.event_s) == (b.accuracy, b.airtime_s,
                                                    b.event_s)


def test_small_buffer_diverges_from_sync(world):
    """The equality gate can fail: K < cohort under per-client airtime
    spread changes the trajectory."""
    from repro_torch.fl.loop import run_fl

    cfg = dataclasses.replace(t_config(), lr=0.1)
    s = run_fl(cfg, _tc(), *world, device="cpu", **KW)
    b = run_fl_buffered(cfg, _tc(), *world, buffer_k=1, device="cpu", **KW)
    assert b.rounds == s.rounds
    assert b.accuracy != s.accuracy or b.airtime_s != s.airtime_s


def test_buffered_fedavg_entry_point(world):
    a = run_fedavg_buffered(t_config(), _tc(), *world, device="cpu",
                            scenario=_vehicular(), buffer_k=2,
                            staleness="inverse", **AKW)
    assert len(a.event_s) == len(a.rounds) == 2
    assert all(np.isfinite(a.accuracy))


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

RUNS = {
    "metro-rush": dict(buffer_k=2, staleness="polynomial"),
    "global-churn": dict(buffer_k=2, staleness="inverse", comp=True),
}


def _pair(world, name, tmp_path_factory):
    kw = dict(RUNS[name])
    comp = kw.pop("comp", False)
    d = tmp_path_factory.mktemp(f"torch_async_{name}")
    jp, tp = str(d / "ref.jsonl"), str(d / "port.jsonl")
    jtr, ttr = JTR.TraceRecorder(), TTR.TraceRecorder(d / "port.trace.json")
    common = dict(n_rounds=4, eval_every=1, seed=11, **kw)
    jscen = dataclasses.replace(JS.get_scenario(name), ecrt_expected_tx=2.0)
    tscen = dataclasses.replace(TS.get_scenario(name), ecrt_expected_tx=2.0)
    jx, tx = {}, {}
    if comp:
        jx = dict(compression=JSP.CompressionConfig(method="topk",
                                                    ratio=0.05))
        tx = dict(compression=TSP.CompressionConfig(method="topk",
                                                    ratio=0.05))
    cfg = dict(lr=0.1)
    with jax.threefry_partitionable(True):
        je = JA.AsyncRoundEngine(
            JEN.FedSGD(dataclasses.replace(j_config(), **cfg),
                       batch_per_round=8), _jc(), *world, scenario=jscen,
            ledger=jp, trace=jtr, sketches=True, **common, **jx)
        te = AsyncRoundEngine(
            TE.FedSGD(dataclasses.replace(t_config(), **cfg),
                      batch_per_round=8), _tc(), *world, scenario=tscen,
            ledger=tp, trace=ttr, sketches=True, phase_timers=PhaseTimers(),
            device="cpu", **common, **tx)
        te.params = params_from_jax({k: np.asarray(v)
                                     for k, v in je.params.items()})
        return je.run(), te.run(), jp, tp, jtr, ttr


@pytest.fixture(scope="module")
def metro(world, tmp_path_factory):
    return _pair(world, "metro-rush", tmp_path_factory)


@pytest.fixture(scope="module")
def churn(world, tmp_path_factory):
    return _pair(world, "global-churn", tmp_path_factory)


def _arrivals(events):
    return [e for e in events if e.kind == "arrival"]


def _check_schedule(jevents, tevents):
    """Arrival order Exact up to near ties, every event time Bounded, the
    other events equal in kind, wave, client and version."""
    ja, ta = _arrivals(jevents), _arrivals(tevents)
    assert sorted((e.wave, e.client) for e in ja) == sorted(
        (e.wave, e.client) for e in ta)
    for a, b in zip(ja, ta):
        if (a.wave, a.client) != (b.wave, b.client):
            # a swap: the two arrivals lie within the bound of each other
            assert b.t == pytest.approx(a.t, rel=T_RTOL)
    key = [(e.kind, e.wave, e.client, e.version) for e in jevents
           if e.kind != "arrival"]
    assert key == [(e.kind, e.wave, e.client, e.version) for e in tevents
                   if e.kind != "arrival"]
    for a, b in zip(jevents, tevents):
        assert b.t == pytest.approx(a.t, rel=T_RTOL, abs=1e-12)
        if a.dur is not None:
            assert b.dur == pytest.approx(a.dur, rel=T_RTOL, abs=1e-12)


@pytest.mark.parametrize("name", list(RUNS))
def test_schedule_matches_reference(name, metro, churn):
    ja, ta, jp, tp, jtr, ttr = metro if name == "metro-rush" else churn
    _check_schedule(jtr.events, ttr.events)
    # each aggregation folds the same updates: the event stream's
    # aggregate values and the per-wave membership ("wave" values)
    for kind in ("aggregate", "wave"):
        assert [e.value for e in jtr.events if e.kind == kind] == [
            e.value for e in ttr.events if e.kind == kind]
    assert ta.rounds == ja.rounds == [0, 1, 2, 3]
    np.testing.assert_allclose(ta.event_s, ja.event_s, rtol=T_RTOL)
    np.testing.assert_allclose(ta.accuracy, ja.accuracy, rtol=0,
                               atol=ACC_TOL)
    np.testing.assert_allclose(ta.airtime_s, ja.airtime_s, rtol=1e-5)
    assert [l["mode_counts"] for l in ta.link] == [
        l["mode_counts"] for l in ja.link]
    assert [l["n_active"] for l in ta.link] == [
        l["n_active"] for l in ja.link]


@pytest.mark.parametrize("name", list(RUNS))
def test_ledger_and_trace_match_reference(name, metro, churn):
    ja, ta, jp, tp, jtr, ttr = metro if name == "metro-rush" else churn
    assert JL.validate_ledger(tp) == [] and TL.validate_ledger(tp) == []
    jd, td = JL.read_ledger(jp), JL.read_ledger(tp)
    jm, tm = jd.manifest, td.manifest
    assert list(tm) == list(jm)
    for k in ("fingerprint", "engine", "buffer_k", "staleness",
              "staleness_alpha", "n_rounds", "num_clients", "scenario"):
        assert tm[k] == jm[k], k
    assert tm["engine"] == "async"
    _check_schedule(jd.events, td.events)
    assert [list(e) for e in td.evals] == [list(e) for e in jd.evals]
    assert [r.round for r in td.rounds] == [r.round for r in jd.rounds]
    assert [r.t_event for r in td.rounds] == pytest.approx(
        [r.t_event for r in jd.rounds], rel=T_RTOL)
    # the trace the port exported equals its in-memory recorder's
    with open(ttr.path) as f:
        assert json.load(f) == ttr.to_chrome()
    assert ttr.track_types() == jtr.track_types()
    jt, tt = jtr.to_chrome()["traceEvents"], ttr.to_chrome()["traceEvents"]
    assert [(e["ph"], e["name"], e["pid"], e.get("tid")) for e in tt] == [
        (e["ph"], e["name"], e["pid"], e.get("tid")) for e in jt]
    # sketches: one staleness observation per folded update
    st = td.summary["sketches"]["staleness"]
    assert st["total"] == jd.summary["sketches"]["staleness"]["total"] > 0
    assert set(td.summary["phases"]) == {"sample", "wave", "telemetry",
                                         "eval"}


def test_compressed_residual_survives_gaps(churn):
    """``global-churn`` with top-k: the residual norm of every wave (EF
    state across participation gaps) agrees with the reference."""
    ja, ta = churn[0], churn[1]
    np.testing.assert_allclose(
        [l["comp_residual_norm"] for l in ta.link],
        [l["comp_residual_norm"] for l in ja.link], rtol=1e-3)
    assert [l["comp_bits_on_air"] for l in ta.link] == [
        l["comp_bits_on_air"] for l in ja.link]


def test_buffered_run_reproducible(world):
    cfg = dataclasses.replace(t_config(), lr=0.1)
    scen = dataclasses.replace(TS.get_scenario("metro-rush"),
                               ecrt_expected_tx=2.0)
    kw = dict(n_rounds=4, batch_per_round=8, eval_every=2, seed=11,
              scenario=scen, buffer_k=2, staleness="polynomial",
              device="cpu")
    a = run_fl_buffered(cfg, _tc(), *world, **kw)
    b = run_fl_buffered(cfg, _tc(), *world, **kw)
    assert (a.accuracy, a.airtime_s, a.event_s, a.link) == (
        b.accuracy, b.airtime_s, b.event_s, b.link)
    assert len(a.event_s) == len(a.rounds)
    assert all(t2 >= t1 for t1, t2 in zip(a.event_s, a.event_s[1:]))


def test_sketched_buffered_run_observes_members(world):
    """``round_group(member=...)`` sketches each wave over its members
    only; the staleness sketch counts every folded update."""
    sk, tr = RoundSketcher(4, device="cpu"), TTR.TraceRecorder()
    scen = dataclasses.replace(TS.get_scenario("metro-rush"),
                               ecrt_expected_tx=2.0)
    res = run_fl_buffered(dataclasses.replace(t_config(), lr=0.1), _tc(),
                          *world, scenario=scen, buffer_k=2, sketches=sk,
                          trace=tr, device="cpu", **KW)
    members = [e.value for e in tr.events if e.kind == "wave"]
    assert len(members) == len(res.records) and min(members) < 4
    assert [r.sketches["snr_db"]["total"] for r in res.records] == members
    folded = sum(e.value for e in tr.events if e.kind == "aggregate")
    assert sk.run["staleness"].total == folded > 0


def test_engine_rejects_bad_arguments(world):
    cfg = dataclasses.replace(t_config(), lr=0.1)
    kw = dict(n_rounds=1, batch_per_round=4, device="cpu")
    with pytest.raises(ValueError, match="buffer_k"):
        run_fl_buffered(cfg, _tc(), *world, buffer_k=5, **kw)
    with pytest.raises(ValueError, match="buffer_k == num_clients"):
        run_fl_buffered(cfg, _tc(), *world, buffer_k=2,
                        fused_aggregate=True, **kw)
    with pytest.raises(ValueError, match="staleness"):
        run_fl_buffered(cfg, _tc(), *world, staleness="exponential", **kw)


def test_stall_raises(world):
    """Every client leaves at the first attempt and none ever rejoins."""
    with pytest.raises(RuntimeError, match="stalled"):
        run_fl_buffered(dataclasses.replace(t_config(), lr=0.1), _tc(),
                        *world, arrival=TD.ArrivalConfig(p_leave=1.0,
                                                         p_rejoin=0.0),
                        n_rounds=2, batch_per_round=4, device="cpu")
