"""The port's observability layer (``repro_torch.obs``: records, ledger,
timers, trace) and its wiring into ``RoundEngine``, against the
reference's ``repro.obs``.

* Records — ``RoundRecord`` / ``EventRecord`` ``to_dict`` / ``from_dict``
  / ``to_link_dict`` and ``scenario_round_record`` equal the reference's
  on equal values (Exact); ``config_fingerprint`` of the port's
  ``TransportConfig``, ``Scenario`` (``vehicular``, ``iot-lowrate``,
  ``vehicular-noisy-dl``), ``DownlinkConfig`` and ``CompressionConfig``
  equals the reference's on the same arguments (Exact);
  ``TxStats.round_summary`` / ``client_metrics`` on equal stats (Exact).
* Sinks are neutral — every round shape the port has (FedSGD and FedAvg;
  driverless layered and fused; ``vehicular`` bucketed layered, fused and
  select; behind a downlink; compressed) run with a ledger, phase timers
  and (scenario runs) sketches equals the same run without them, bit for
  bit: params, accuracy, airtime, ``FLResult.link`` and launch counters.
  Each ledger passes both packages' ``validate_ledger`` and reads back
  (both readers) to ``FLResult.link``.
* Against a reference run — ``vehicular`` bucketed (K1), 6 clients, 3
  rounds, the port from the reference's initial weights: the reference's
  reader and ``tools/report.py`` read the port's ledger, the fingerprints
  join, round records have the same keys, the ``uplink_*`` fields that
  depend on the configuration only (symbols, bits, mean transmissions,
  bits on air) are Exact and the error counts Bounded (``ERR_RTOL``: the
  gradients differ by a few ULP, so the symbols that carry their low
  mantissa bits meet the same noise at another constellation point;
  0.14-0.16% apart in this run);
  the link view by the grades of ``test_torch_fl.py``.
* Failure modes: ``validate_ledger`` on broken ledgers and the v1/v2
  per-line rejection give the reference's messages; ``sketches=`` on a
  driverless run raises ``ValueError``.
* ``PhaseTimers`` unit behaviour, the engine's scope names, and
  ``TraceRecorder.to_chrome()`` equal to the reference's on the same
  ``EventRecord`` streams.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.compress import sparsify as JSP  # noqa: E402
from repro.configs.mnist_cnn import config as j_config  # noqa: E402
from repro.core import channel as JCH  # noqa: E402
from repro.core import transport as JT  # noqa: E402
from repro.data import synth_mnist as j_synth  # noqa: E402
from repro.fl import engine as JEN  # noqa: E402
from repro.fl import partition as j_partition  # noqa: E402
from repro.link import scenario as JS  # noqa: E402
from repro.obs import ledger as JL  # noqa: E402
from repro.obs import records as JR  # noqa: E402
from repro.obs import trace as JTR  # noqa: E402
from repro_torch.compress import sparsify as TSP  # noqa: E402
from repro_torch.configs.mnist_cnn import config as t_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import transport as TT  # noqa: E402
from repro_torch.fl import engine as TE  # noqa: E402
from repro_torch.fl.fedavg import run_fedavg  # noqa: E402
from repro_torch.fl.loop import run_fl  # noqa: E402
from repro_torch.kernels import approx_channel as TAC  # noqa: E402
from repro_torch.link import scenario as TS  # noqa: E402
from repro_torch.obs import PhaseTimers  # noqa: E402
from repro_torch.obs import ledger as TL  # noqa: E402
from repro_torch.obs import records as TR  # noqa: E402
from repro_torch.obs import timers as TTM  # noqa: E402
from repro_torch.obs import trace as TTR  # noqa: E402

ACC_TOL = 2 / 160 + 1e-6
ERR_RTOL = 1e-2
SCOPES = {"sample", "round", "telemetry", "eval"}


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


def _tc():
    return TT.TransportConfig(mode="approx", use_kernel=True,
                              channel=TCH.ChannelConfig(snr_db=10.0))


def _jc():
    return JT.TransportConfig(mode="approx", use_kernel=True,
                              channel=JCH.ChannelConfig(snr_db=10.0))


def _scen(lib, name):
    return dataclasses.replace(lib.get_scenario(name), ecrt_expected_tx=2.0)


# --------------------------------------------------------------------------
# records, fingerprints, stats
# --------------------------------------------------------------------------


def test_record_constants_match_reference():
    for name in ("SCHEMA_VERSION", "SUPPORTED_SCHEMAS", "V2_ROUND_FIELDS",
                 "LINK_FIELDS", "EVENT_KINDS"):
        assert getattr(TR, name) == getattr(JR, name), name
    for cls in ("RoundRecord", "EventRecord"):
        assert ([f.name for f in dataclasses.fields(getattr(TR, cls))]
                == [f.name for f in dataclasses.fields(getattr(JR, cls))])
    assert TL.MANIFEST_KEYS == JL.MANIFEST_KEYS
    assert TL.PROVENANCE_KEYS == JL.PROVENANCE_KEYS


@pytest.mark.parametrize("fields", [
    dict(round=0),
    dict(round=1, comp_ratio=0.02, comp_bits_on_air=2054000.0,
         comp_residual_norm=0.5, uplink_ber=0.01, uplink_bits=1.5e6),
    dict(round=2, mean_snr_db=9.5, mean_est_db=9.25, mode_counts=[1, 2, 1],
         n_active=3, n_stragglers=1, airtime_s=0.125,
         downlink_airtime_s=0.03125, downlink_ber=0.002,
         downlink_mode_counts=[0, 4, 0], t_event=3.5,
         sketches={"snr_db": {"total": 4}}),
], ids=["round-only", "compressed", "scenario-downlink"])
def test_round_record_matches_reference(fields):
    t, j = TR.RoundRecord(**fields), JR.RoundRecord(**fields)
    assert t.to_dict() == j.to_dict()
    assert json.dumps(t.to_dict()) == json.dumps(j.to_dict())
    assert list(t.to_link_dict().items()) == list(j.to_link_dict().items())
    assert t.has_link_fields() == j.has_link_fields()
    assert TR.RoundRecord.from_dict(j.to_dict()) == t
    with pytest.raises(ValueError, match="unknown field"):
        TR.RoundRecord.from_dict({"round": 0, "bogus": 1})
    with pytest.raises(ValueError, match="missing 'round'"):
        TR.RoundRecord.from_dict({"airtime_s": 1.0})


def test_event_record_matches_reference():
    for kind in TR.EVENT_KINDS:
        kw = dict(t=1.5, kind=kind, wave=2, client=7, dur=0.25)
        t, j = TR.EventRecord(**kw), JR.EventRecord(**kw)
        assert t.to_dict() == j.to_dict()
        assert TR.EventRecord.from_dict(j.to_dict()) == t
    with pytest.raises(ValueError, match="unknown event kind"):
        TR.EventRecord(t=0.0, kind="not-a-kind")
    with pytest.raises(ValueError, match="unknown field"):
        TR.EventRecord.from_dict({"t": 0.0, "kind": "wave", "x": 1})


def test_scenario_round_record_matches_reference():
    r = np.random.default_rng(0)
    n = 9
    arrs = dict(snr_db=r.normal(10, 5, n).astype(np.float32),
                est_db=r.normal(10, 5, n).astype(np.float32),
                mode=r.integers(0, 4, n).astype(np.int32),
                active=(r.random(n) > 0.2).astype(np.float32),
                straggler=(r.random(n) > 0.8).astype(np.float32))
    air = r.uniform(0, 0.05, n).astype(np.float32)
    jr = JR.scenario_round_record(
        3, JS.LinkRound(**{k: jnp.asarray(v) for k, v in arrs.items()}),
        jnp.asarray(air), 4)
    tr = TR.scenario_round_record(
        3, TS.LinkRound(**{k: torch.from_numpy(v) for k, v in arrs.items()}),
        torch.from_numpy(air), 4)
    assert tr.to_dict() == jr.to_dict()


@pytest.mark.parametrize("name", [
    "transport", "vehicular", "iot-lowrate", "vehicular-noisy-dl",
    "downlink", "compression", "engine-args"])
def test_config_fingerprint_matches_reference(name):
    if name == "transport":
        j, t = (_jc(),), (_tc(),)
    elif name == "downlink":
        j = (JS.DownlinkConfig(mode="approx", snr_offset_db=-3.0,
                               adaptive=True),)
        t = (TS.DownlinkConfig(mode="approx", snr_offset_db=-3.0,
                               adaptive=True),)
    elif name == "compression":
        j = (JSP.CompressionConfig(method="randk", header="ecrt"),)
        t = (TSP.CompressionConfig(method="randk", header="ecrt"),)
    elif name == "engine-args":
        j = ("FedSGD", _jc(), JS.get_scenario("vehicular"), None,
             JSP.CompressionConfig(), "bucketed", 3, 100, 0)
        t = ("FedSGD", _tc(), TS.get_scenario("vehicular"), None,
             TSP.CompressionConfig(), "bucketed", 3, 100, 0)
    else:
        j, t = (JS.get_scenario(name),), (TS.get_scenario(name),)
    assert TL._canonical(t) == JL._canonical(j)
    assert TL.config_fingerprint(*t) == JL.config_fingerprint(*j)
    assert len(TL.config_fingerprint(*t)) == 12


@pytest.mark.parametrize("shape,boa", [((7,), True), ((7,), False),
                                       ((), True)])
def test_tx_stats_summary_matches_reference(shape, boa):
    r = np.random.default_rng(1)

    def draw(lo, hi):
        return r.uniform(lo, hi, shape).astype(np.float32)

    arrs = dict(data_symbols=draw(1e4, 4e5), transmissions=draw(1, 3),
                bit_errors=np.floor(draw(0, 5e3)),
                n_bits=np.floor(draw(1e5, 7e5)))
    extra = dict(bits_on_air=draw(1e5, 2e6)) if boa else {}
    j = JT.TxStats(**{k: jnp.asarray(v) for k, v in arrs.items()},
                   **{k: jnp.asarray(v) for k, v in extra.items()})
    t = TT.TxStats(**{k: torch.tensor(np.asarray(v))
                      for k, v in arrs.items()},
                   **{k: torch.tensor(np.asarray(v))
                      for k, v in extra.items()})
    assert list(t.round_summary().items()) == list(
        j.round_summary().items())
    tm, jm = t.client_metrics(), j.client_metrics()
    assert list(tm) == list(jm)
    for k in tm:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))


def test_json_scalar_and_detail_sketch(tmp_path):
    led = TL.RunLedger(tmp_path / "d.jsonl", detail="sketch")
    assert led.events is False
    led.write_manifest({"fingerprint": "x", "algorithm": "y",
                        "v": torch.tensor(1.5), "w": np.float32(0.25),
                        "i": np.int64(3), "provenance": TL.provenance("cpu")})
    led.write_event(TR.EventRecord(t=0.0, kind="wave", dur=1.0))
    led.close()
    lines = (tmp_path / "d.jsonl").read_text().splitlines()
    assert len(lines) == 1
    man = json.loads(lines[0])
    assert man["detail"] == "sketch" and man["schema"] == 2
    assert (man["v"], man["w"], man["i"]) == (1.5, 0.25, 3)
    prov = man["provenance"]
    assert set(JL.PROVENANCE_KEYS) <= set(prov)
    assert prov["jax"] is None and prov["backend"] == "cpu"
    assert prov["device"] == "cpu" and prov["torch"] == torch.__version__
    with pytest.raises(TypeError, match="not JSON-serializable"):
        TL.RunLedger(tmp_path / "e.jsonl").write_round(
            TR.RoundRecord(round=0, airtime_s=torch.ones(2)))
    with pytest.raises(ValueError, match="detail"):
        TL.RunLedger(tmp_path / "f.jsonl", detail="medium")
    assert TL.as_ledger(None) is None and TL.as_ledger(led) is led


# --------------------------------------------------------------------------
# sinks are neutral, on every round shape
# --------------------------------------------------------------------------

_APPROX_DL = dict(mode="approx")
_ARMS = {
    # algo, scenario, dispatch, fused, compression, downlink, sketches
    "fedsgd-driverless-layered": ("fedsgd", None, "bucketed", False, None,
                                  None),
    "fedsgd-driverless-fused": ("fedsgd", None, "bucketed", True, None,
                                None),
    "fedavg-driverless-max_abs": ("fedavg_max_abs", None, "bucketed", False,
                                  None, None),
    "fedsgd-vehicular-bucketed": ("fedsgd", "vehicular", "bucketed", False,
                                  None, None),
    "fedsgd-vehicular-fused": ("fedsgd", "vehicular", "bucketed", True,
                               None, None),
    "fedavg-vehicular-select": ("fedavg", "vehicular", "select", False,
                                None, None),
    "fedavg-vehicular-noisy-dl": ("fedavg", "vehicular-noisy-dl",
                                  "bucketed", False, None, None),
    "fedsgd-topk-behind-downlink": ("fedsgd", None, "bucketed", False,
                                    dict(), _APPROX_DL),
    "fedsgd-iot-lowrate": ("fedsgd", "iot-lowrate", "bucketed", False, None,
                           None),
}


def _algo(name):
    if name == "fedsgd":
        return TE.FedSGD(t_config(), batch_per_round=8)
    return TE.FedAvg(t_config(), local_steps=2, batch_per_step=8,
                     scale_mode="max_abs" if name.endswith("max_abs")
                     else "none")


def _arm_run(world, arm, **sinks):
    algo, scen, dispatch, fused, comp, dl = _ARMS[arm]
    cx, cy, ti, tl = world
    kw = dict(n_rounds=2, eval_every=1, seed=3, adaptive_dispatch=dispatch,
              fused_aggregate=fused, device="cpu")
    if scen is not None:
        kw["scenario"] = _scen(TS, scen)
    if comp is not None:
        kw["compression"] = TSP.CompressionConfig(**comp)
    if dl is not None:
        kw["downlink"] = TS.DownlinkConfig(**dl)
    TAC.reset_launch_counts()
    eng = TE.RoundEngine(_algo(algo), _tc(), cx, cy, ti, tl, **kw, **sinks)
    res = eng.run()
    return eng, res, TAC.launch_counts()


@pytest.mark.parametrize("arm", list(_ARMS))
def test_sinks_are_neutral(world, arm, tmp_path):
    path = str(tmp_path / "run.jsonl")
    timers = PhaseTimers()
    scenario = _ARMS[arm][1] is not None
    sinks = dict(ledger=path, phase_timers=timers)
    if scenario:
        sinks["sketches"] = True
    eng, res, launches = _arm_run(world, arm, **sinks)
    bare_eng, bare, bare_launches = _arm_run(world, arm)
    for k in eng.params:
        assert torch.equal(eng.params[k], bare_eng.params[k]), k
    assert res.rounds == bare.rounds
    assert res.accuracy == bare.accuracy
    assert res.airtime_s == bare.airtime_s
    assert res.link == bare.link
    assert launches == bare_launches
    assert [list(p) for p in res.phase_s] == [list(p) for p in bare.phase_s]
    # Records: one a round; link is their view; extras only with sinks.
    assert len(res.records) == len(bare.records) == 2
    assert res.link == [r.to_link_dict() for r in res.records
                        if r.has_link_fields()]
    assert res.event_s == [] and bare.event_s == []
    for rec, bare_rec in zip(res.records, bare.records):
        assert rec.uplink_bits > 0 and rec.uplink_symbols > 0
        assert bare_rec.uplink_bits is None and bare_rec.sketches is None
        assert rec.to_link_dict() == bare_rec.to_link_dict()
        if scenario:
            assert rec.sketches["ber"]["total"] == rec.n_active
            assert rec.sketches["snr_db"]["total"] == eng.num_clients
    # The ledger, through both packages' readers.
    assert TL.validate_ledger(path) == []
    assert JL.validate_ledger(path) == []
    assert TL.read_ledger(path).link == res.link
    assert JL.read_ledger(path).link == res.link
    data = TL.read_ledger(path)
    assert [e["accuracy"] for e in data.evals] == res.accuracy
    assert data.summary["final_accuracy"] == res.final_accuracy
    assert set(data.summary["phases"]) == SCOPES
    assert ("sketches" in data.summary) == scenario
    summary = timers.summary()
    assert set(summary) == SCOPES
    assert all(summary[s]["calls"] == 2 for s in SCOPES)


def test_driverless_run_has_records_but_no_link(world, tmp_path):
    cx, cy, ti, tl = world
    res = run_fl(t_config(), _tc(), cx, cy, ti, tl, n_rounds=2,
                 batch_per_round=8, ledger=str(tmp_path / "d.jsonl"),
                 device="cpu")
    assert res.link == []
    assert len(res.records) == 2
    assert not any(r.has_link_fields() for r in res.records)
    assert [r.round for r in res.records] == [0, 1]


def test_sketches_require_a_scenario(world):
    cx, cy, ti, tl = world
    for run in (run_fl, run_fedavg):
        with pytest.raises(ValueError, match="scenario"):
            run(t_config(), _tc(), cx, cy, ti, tl, n_rounds=1,
                sketches=True, device="cpu")


# --------------------------------------------------------------------------
# against a reference run
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vehicular_pair(tmp_path_factory):
    """The reference's and the port's 3-round ``vehicular`` run (bucketed,
    K1, 6 clients) with ledger, timers and sketches, the port from the
    reference's initial weights: ``(ref result, port result, ref ledger,
    port ledger)``."""
    cx, cy, ti, tl = _world(6)
    d = tmp_path_factory.mktemp("torch_obs")
    jp, tp = str(d / "ref.jsonl"), str(d / "port.jsonl")
    kw = dict(n_rounds=3, eval_every=1, seed=3, sketches=True)
    with jax.threefry_partitionable(True):
        from repro.obs import PhaseTimers as JPhaseTimers

        je = JEN.RoundEngine(JEN.FedSGD(j_config(), batch_per_round=8),
                             _jc(), cx, cy, ti, tl, ledger=jp,
                             phase_timers=JPhaseTimers(),
                             scenario=_scen(JS, "vehicular"), **kw)
        te = TE.RoundEngine(TE.FedSGD(t_config(), batch_per_round=8),
                            _tc(), cx, cy, ti, tl, ledger=tp,
                            phase_timers=PhaseTimers(), device="cpu",
                            scenario=_scen(TS, "vehicular"), **kw)
        te.params = params_from_jax({k: np.asarray(v)
                                     for k, v in je.params.items()})
        return je.run(), te.run(), jp, tp


def test_reference_reads_port_ledger(vehicular_pair):
    ja, ta, jp, tp = vehicular_pair
    assert JL.validate_ledger(tp) == [] and TL.validate_ledger(jp) == []
    link = JL.read_ledger(tp).link
    assert link == ta.link
    assert len(link) == len(ja.link) == 3
    for lj, lt in zip(ja.link, link):
        assert list(lt) == list(lj)
        for f in ("round", "mode_counts", "n_active", "n_stragglers"):
            assert lt[f] == lj[f], f
        for f in ("mean_snr_db", "mean_est_db"):
            assert lt[f] == pytest.approx(lj[f], abs=1e-4), f
        assert lt["airtime_s"] == pytest.approx(lj["airtime_s"], rel=2**-20)
    np.testing.assert_allclose(ta.accuracy, ja.accuracy, rtol=0,
                               atol=ACC_TOL)


def test_round_records_match_reference(vehicular_pair):
    ja, ta, jp, tp = vehicular_pair
    jd, td = JL.read_ledger(jp), JL.read_ledger(tp)
    assert len(jd.rounds) == len(td.rounds) == 3
    for jr, tr in zip(jd.rounds, td.rounds):
        assert list(tr.to_dict()) == list(jr.to_dict())
        for f in ("uplink_symbols", "uplink_bits", "uplink_mean_tx",
                  "uplink_bits_on_air"):
            assert getattr(tr, f) == getattr(jr, f), f
        for f in ("uplink_bit_errors", "uplink_ber"):
            assert getattr(tr, f) == pytest.approx(getattr(jr, f),
                                                   rel=ERR_RTOL), f
        assert list(tr.sketches) == list(jr.sketches)
    assert [list(e) for e in td.evals] == [list(e) for e in jd.evals]
    assert list(td.summary) == list(jd.summary)
    assert list(td.summary["phases"]) == list(jd.summary["phases"])
    assert list(td.summary["sketches"]) == list(jd.summary["sketches"])


def test_manifest_matches_reference(vehicular_pair):
    _, _, jp, tp = vehicular_pair
    jm, tm = JL.read_ledger(jp).manifest, JL.read_ledger(tp).manifest
    assert list(tm) == list(jm)
    for k in jm:
        if k != "provenance":
            assert tm[k] == jm[k], k
    assert list(tm["provenance"])[:len(JL.PROVENANCE_KEYS)] == list(
        JL.PROVENANCE_KEYS)
    assert tm["provenance"]["jax"] is None
    assert tm["provenance"]["device"] == "cpu"


def test_report_joins_port_and_reference(vehicular_pair, capsys):
    from tools import report

    _, _, jp, tp = vehicular_pair
    report.summarize(tp)
    out = capsys.readouterr().out
    assert "fingerprint" in out and "mode histogram" in out
    assert "final accuracy" in out
    report.diff(tp, jp)
    out = capsys.readouterr().out
    assert "fingerprints match" in out


# --------------------------------------------------------------------------
# validator failure modes
# --------------------------------------------------------------------------


def _ok_manifest(schema=2):
    return {"kind": "manifest", "schema": schema, "fingerprint": "x",
            "engine": "sync", "algorithm": "a", "n_rounds": 1,
            "num_clients": 1, "seed": 0,
            "provenance": {k: None for k in JL.PROVENANCE_KEYS}}


@pytest.mark.parametrize("case", [
    "missing-keys", "no-manifest", "torn-tail", "torn-interior",
    "bad-schema", "unknown-kind", "unknown-field", "out-of-order",
    "span-without-dur", "eval-missing", "missing-file"])
def test_validate_ledger_failure_modes(tmp_path, case):
    p = tmp_path / "bad.jsonl"
    man = _ok_manifest()
    lines = {
        "missing-keys": [{"kind": "manifest", "schema": 1}],
        "no-manifest": [{"kind": "round", "round": 0}],
        "torn-tail": [man, {"kind": "round", "round": 0},
                      '{"kind": "round", "rou'],
        "torn-interior": [man, '{"kind": "round", "rou',
                          {"kind": "round", "round": 0}],
        "bad-schema": [dict(man, schema=9)],
        "unknown-kind": [man, {"kind": "mystery"}],
        "unknown-field": [man, {"kind": "round", "round": 0, "zap": 1}],
        "out-of-order": [man, {"kind": "round", "round": 1},
                         {"kind": "round", "round": 0}],
        "span-without-dur": [man, {"kind": "event", "t": 0.0,
                                   "event": "wave"}],
        "eval-missing": [man, {"kind": "eval", "round": 0}],
    }.get(case)
    if lines is not None:
        p.write_text("\n".join(x if isinstance(x, str) else json.dumps(x)
                               for x in lines))
    got, want = TL.validate_ledger(str(p)), JL.validate_ledger(str(p))
    assert got == want
    if case == "torn-tail":
        assert got == [] and len(TL.read_ledger(str(p)).rounds) == 1
    else:
        assert got != []


def test_v1_ledger_with_v2_field_rejected_per_line(vehicular_pair, tmp_path):
    _, _, _, tp = vehicular_pair
    lines = open(tp).read().splitlines()
    first = json.loads(lines[0])
    first["schema"] = 1
    mixed = tmp_path / "mixed.jsonl"
    mixed.write_text("\n".join([json.dumps(first)] + lines[1:]) + "\n")
    problems = TL.validate_ledger(str(mixed))
    assert problems == JL.validate_ledger(str(mixed))
    assert len(problems) == 1
    assert problems[0].startswith(f"{mixed}:2:")
    assert "mixed-version" in problems[0]
    v1_lines = [json.dumps(first)]
    for line in lines[1:]:
        obj = json.loads(line)
        obj.pop("sketches", None)
        v1_lines.append(json.dumps(obj))
    v1 = tmp_path / "v1.jsonl"
    v1.write_text("\n".join(v1_lines) + "\n")
    assert TL.validate_ledger(str(v1)) == [] == JL.validate_ledger(str(v1))


# --------------------------------------------------------------------------
# timers and trace
# --------------------------------------------------------------------------


def test_phase_timers_unit():
    tm = PhaseTimers()
    with tm.scope("p"):
        pass
    assert tm.summary()["p"]["calls"] == 1
    assert "p" in tm.report()
    stat = TTM.PhaseStat("q")
    for dt in (5.0, 1.0, 2.0, 3.0):
        stat.record(dt)
    assert stat.calls == 4 and stat.first_s == 5.0
    assert stat.steady_median_s() == 2.0 and stat.total_s == 11.0
    assert TTM.PhaseStat("e").steady_median_s() == 0.0
    with TTM.NULL_TIMERS.scope("x"):
        pass
    assert TTM.NULL_TIMERS.summary() == {}
    assert TTM.resolve_timers(tm) is tm
    assert TTM.resolve_timers(None) is TTM.NULL_TIMERS
    from repro.obs import timers as j_timers

    jt, tt = j_timers.PhaseTimers(), PhaseTimers()
    for timers, stat_cls in ((jt, j_timers.PhaseStat), (tt, TTM.PhaseStat)):
        for name, secs in (("round", (0.5, 0.1, 0.3)), ("eval", (0.01,))):
            st = timers.phases[name] = stat_cls(name)
            for s in secs:
                st.record(s)
    assert tt.summary() == jt.summary()
    assert tt.report() == jt.report()


def test_engine_scope_names(vehicular_pair):
    _, _, jp, tp = vehicular_pair
    phases = JL.read_ledger(tp).summary["phases"]
    assert set(phases) == SCOPES
    assert phases["round"]["calls"] == 3 and phases["eval"]["calls"] == 3
    assert phases["round"]["total_s"] >= phases["round"]["first_s"] > 0


def _streams():
    waves = []
    for w in range(3):
        t0 = 0.5 * w
        waves.append(("wave", dict(t=t0, wave=w, dur=0.75, value=2.0)))
        for c in (0, 2):
            waves.append(("compute", dict(t=t0, wave=w, client=c,
                                          dur=0.25)))
            waves.append(("uplink", dict(t=t0 + 0.25, wave=w, client=c,
                                         dur=0.125)))
            waves.append(("arrival", dict(t=t0 + 0.375, wave=w, client=c)))
            waves.append(("buffer", dict(t=t0 + 0.375, value=float(c))))
        waves.append(("aggregate", dict(t=t0 + 0.4, version=w + 1,
                                        value=2.0)))
    churn = [("leave", dict(t=0.1, client=3)), ("join", dict(t=0.9,
                                                             client=3)),
             ("buffer", dict(t=1.0, value=0.0))]
    return {"waves": waves, "churn": churn, "empty": [],
            "mixed": waves[:5] + churn + waves[5:9]}


@pytest.mark.parametrize("stream", ["waves", "churn", "empty", "mixed"])
def test_trace_matches_reference(stream, tmp_path):
    jt, tt = JTR.TraceRecorder(), TTR.TraceRecorder(tmp_path / "t.json")
    for kind, kw in _streams()[stream]:
        jt.add(JR.EventRecord(kind=kind, **kw))
        tt.add(TR.EventRecord(kind=kind, **kw))
    assert tt.to_chrome() == jt.to_chrome()
    assert json.dumps(tt.to_chrome()) == json.dumps(jt.to_chrome())
    assert tt.track_types() == jt.track_types()
    path = tt.export()
    with open(path) as f:
        assert json.load(f) == jt.to_chrome()
    with pytest.raises(ValueError, match="no path"):
        TTR.TraceRecorder().export()
    assert TTR.as_trace(None) is None and TTR.as_trace(tt) is tt
    assert isinstance(TTR.as_trace(tmp_path / "u.json"), TTR.TraceRecorder)
