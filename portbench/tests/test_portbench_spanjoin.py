"""The program's spans on the trace's clock (``core/spanjoin.py``) and the
per-layer readers of the spans: on a fabricated trace and span list, the
idle gaps' labels, the unspanned share, a gap under nested spans and the
clock check; on a real CPU profile, the mapping; every span reader on tiny
records, and ``None`` where a program reports no such span; a tiny CPU run
of ``spantrace.py`` through the FL driver."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from portbench.tests._tiny import ROOT, SEED, tiny_cell

MS = 1_000_000  # ns


def _spans(*rows):
    """Recording-like spans from ``(name, parent, t0_ms, t1_ms)``."""
    return [SimpleNamespace(name=n, parent=p, id=0, t0_ns=a * MS,
                            t1_ns=b * MS) for n, p, a, b in rows]


def test_idle_gaps_named_by_the_innermost_span():
    from portbench.core import spanjoin

    rows = spanjoin.span_rows(_spans(
        ("round", None, 0, 100),
        ("sample", 0, 1, 30),
        ("uplink", 0, 40, 60),
        ("kernel", 2, 45, 50),
        ("round", None, 110, 200)))
    assert [r[2] for r in rows] == ["round", "round/sample", "round/uplink",
                                    "round/uplink/kernel", "round"]
    # device busy 0-2, 20-24, 46-47, 58-61, 102-103, 104-108, 150-151
    device = [(a * MS, b * MS, "k", 0) for a, b in
              [(0, 2), (20, 24), (46, 47), (58, 61), (102, 103),
               (104, 108), (150, 151)]]
    out = spanjoin.idle_by_span(device, rows)
    # gaps: 2-20 (mid 11: sample), 24-46 (35: round), 47-58 (52.5: uplink),
    # 61-102 (81.5: round), 103-104 (103.5: none), 108-150 (129: round)
    assert [g[0] for g in out["gaps"]] == [
        "round", "round", "round", "round/sample", "round/uplink",
        spanjoin.UNSPANNED]
    assert [g[1] for g in out["gaps"]] == pytest.approx(
        [0.042, 0.041, 0.022, 0.018, 0.011, 0.001])
    assert out["by_span"] == pytest.approx(
        {"round": 0.105, "round/sample": 0.018, "round/uplink": 0.011,
         spanjoin.UNSPANNED: 0.001})
    assert out["unspanned_pct"] == pytest.approx(100 * 0.001 / 0.135)
    assert spanjoin.idle_by_span([], rows) is None
    assert spanjoin.idle_by_span(device[:1], rows)["unspanned_pct"] == 0.0


def test_a_gap_under_nested_spans_takes_the_deepest():
    from portbench.core import spanjoin

    rows = spanjoin.span_rows(_spans(
        ("step", None, 0, 100), ("uplink", 0, 10, 90),
        ("flatten", 1, 20, 30), ("kernel", 1, 31, 80)))
    device = [(0, 5 * MS, "k", 0), (60 * MS, 70 * MS, "k", 0)]
    (label, sec), = spanjoin.idle_by_span(device, rows)["gaps"]
    assert label == "step/uplink/kernel"  # 5-60 ms, middle at 32.5 ms
    assert sec == pytest.approx(0.055)


def test_clock_check_counts_launches_inside_kernel_spans():
    from portbench.core import spanjoin

    rows = spanjoin.span_rows(_spans(
        ("uplink", None, 0, 100), ("kernel", 0, 10, 20),
        ("kernel", 0, 50, 60), ("keys", 0, 30, 40)))
    device = [(21 * MS, 30 * MS, "void k2_approx_channel_aggregate<2>", 7),
              (61 * MS, 70 * MS, "void k2_approx_channel_aggregate<2>", 8),
              (71 * MS, 80 * MS, "void k2_approx_channel_aggregate<2>", 9),
              (81 * MS, 90 * MS, "elementwise", 10)]
    host = [(11 * MS, 12 * MS, "cudaLaunchKernel", 7),
            (52 * MS, 53 * MS, "cudaLaunchKernel", 8),
            (35 * MS, 36 * MS, "cudaLaunchKernel", 9),  # under keys
            (40 * MS, 41 * MS, "cudaLaunchKernel", 10)]
    out = spanjoin.clock_check(device, host, rows, ("k2_approx",))
    assert out == {"n": 3, "inside": 2, "share": pytest.approx(2 / 3),
                   "lead_us_median": 1500.0, "lead_us_max": 2000.0,
                   "margin_us_min": 1000.0}
    assert spanjoin.clock_check(device, host, rows, ("k0_approx",)) is None


def test_trace_events_share_the_spans_clock():
    """A CPU profile's ``aten::mm`` events, put on the Unix-epoch clock
    through ``trace_start_ns()``, lie inside the spans around them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.core import spanjoin
    from repro_torch.obs import spans

    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.record("cpu") as rec:
            for _ in range(3):
                with spans.span("round"):
                    with spans.span("mm"):
                        a @ a
                time.sleep(0.002)
    _, host = spanjoin.trace_events(prof)
    rows = [r for r in spanjoin.span_rows(rec.spans)
            if r[2] == "round/mm"]
    mms = sorted(h for h in host if h[2] == "aten::mm")
    assert len(mms) == len(rows) == 3
    for (t0, t1, _, _), (s0, s1, _, _) in zip(mms, rows):
        assert s0 - 300_000 <= t0 <= t1 <= s1 + 300_000


def _rounds(phase_keys=True, layered=False):
    ph = {"gradients": 0.009, "uplink": 0.005, "uplink_keys": 0.001,
          "uplink_kernel": 0.002, "apply": 0.0005, "eval": 0.002}
    if phase_keys:
        ph.update(key=0.0002, sample=0.003, telemetry=0.001)
    if layered:
        ph.update(uplink_codec=0.001, uplink_channel=0.002,
                  uplink_demod=0.0005)
    return {"rounds": [{"dur_s": 0.021, "phase_s": dict(ph)},
                       {"dur_s": 0.019, "phase_s": dict(ph, eval=0.0)}]}


def _steps(uplink=True):
    spans = {"grad": 0.3, "kernel": 0.25, "apply": 0.018}
    if uplink:
        spans.update(uplink=0.26, step=0.58, flatten=0.004)
    return {"steps": [{"dur_s": 0.585, "spans": dict(spans)},
                      {"dur_s": 0.587, "spans": dict(spans)}]}


@pytest.mark.parametrize("name,records,want", [
    ("fl.key_ms", _rounds(), 0.2),
    ("fl.sample_ms", _rounds(), 3.0),
    ("fl.apply_ms", _rounds(), 0.5),
    ("fl.telemetry_ms", _rounds(), 1.0),
    ("fl.eval_ms", _rounds(), 1.0),
    # 20 ms of round less 0.0002 + 0.003 + 0.009 + 0.005 + 0.0005 + 0.001
    # + eval (2 ms, then 0)
    ("fl.loop_self_ms", _rounds(), 0.3),
    ("fl.phy_codec_ms", _rounds(layered=True), 1.0),
    ("fl.phy_channel_ms", _rounds(layered=True), 2.0),
    ("fl.phy_demod_ms", _rounds(layered=True), 0.5),
    ("llm.uplink_other_ms", _steps(), 10.0),
    ("llm.step_self_ms", _steps(), 8.0),
], ids=lambda v: v if isinstance(v, str) else "")
def test_span_readers(name, records, want):
    from portbench.core import bench

    assert bench.read_metric(name, records, ROOT) == pytest.approx(want)


@pytest.mark.parametrize("name,records", [
    ("fl.key_ms", _rounds(phase_keys=False)),
    ("fl.sample_ms", _rounds(phase_keys=False)),
    ("fl.telemetry_ms", _rounds(phase_keys=False)),
    ("fl.loop_self_ms", _rounds(phase_keys=False)),
    ("fl.phy_codec_ms", _rounds()),
    ("fl.phy_channel_ms", _rounds()),
    ("fl.phy_demod_ms", _rounds()),
    ("llm.uplink_other_ms", _steps(uplink=False)),
    ("llm.step_self_ms", _steps(uplink=False)),
    ("fl.apply_ms", {"rounds": []}),
    ("fl.eval_ms", {"steps": []}),
], ids=lambda v: v if isinstance(v, str) else "")
def test_span_readers_find_nothing_where_no_span_reports(name, records):
    """A program without the span (the parent of the change that added
    it, or another cell's driver) gives ``None``, not a number."""
    from portbench.core import bench

    assert bench.read_metric(name, records, ROOT) is None


def test_loop_readers_on_a_real_cpu_run():
    """The FL span readers on rounds of a real CPU run (each round timed by
    its recorded ``round`` span): each reads a number, and the loop's spans
    with its self time make up the rest of the round beside gradients and
    uplink (``fl.loop_other_ms``)."""
    import numpy as np

    from portbench.core import bench
    from repro_torch.configs.mnist_cnn import config
    from repro_torch.core import channel, transport
    from repro_torch.fl.loop import run_fl
    from repro_torch.obs import spans

    rng = np.random.default_rng(0)
    cx = rng.uniform(0, 1, (2, 8, 28, 28)).astype(np.float32)
    cy = rng.integers(0, 10, (2, 8)).astype(np.int32)
    tc = transport.TransportConfig(
        mode="approx", use_kernel=False,
        channel=channel.ChannelConfig(snr_db=10.0))
    with spans.record("cpu") as rec:
        res = run_fl(config(), tc, cx, cy, cx[0], cy[0], n_rounds=2,
                     batch_per_round=4, eval_every=1, device="cpu")
    durs = [s.seconds for s in rec.spans if s.name == "round"]
    records = {"rounds": [{"dur_s": d, "phase_s": ph}
                          for d, ph in zip(durs, res.phase_s)]}
    pl = {name: bench.read_metric(name, records, ROOT) for name in (
        "fl.key_ms", "fl.sample_ms", "fl.apply_ms", "fl.telemetry_ms",
        "fl.eval_ms", "fl.loop_self_ms", "fl.loop_other_ms",
        "fl.phy_codec_ms", "fl.phy_channel_ms", "fl.phy_demod_ms",
        "fl.uplink_ms")}
    assert all(v > 0 for k, v in pl.items() if k != "fl.loop_self_ms"), pl
    loop = ("fl.key_ms", "fl.sample_ms", "fl.apply_ms", "fl.telemetry_ms",
            "fl.eval_ms", "fl.loop_self_ms")
    assert pl["fl.loop_other_ms"] == pytest.approx(sum(pl[k] for k in loop))
    assert 0 <= pl["fl.loop_self_ms"] < 0.5 * pl["fl.loop_other_ms"]
    phy = pl["fl.phy_codec_ms"] + pl["fl.phy_channel_ms"] + \
        pl["fl.phy_demod_ms"]
    assert 0.9 * pl["fl.uplink_ms"] <= phy <= pl["fl.uplink_ms"]


def test_spantrace_runs_a_tiny_cell_on_the_cpu():
    """``spantrace.trace_cell`` through the FL driver on the CPU: the run is
    judged, every per-layer metric of the cell is looked up (the window may
    close before a CPU round ends, so a reading may be ``None``), and there
    is no trace to join."""
    from portbench import spantrace

    cell = tiny_cell("cnn-approx-k2")
    res = spantrace.trace_cell(cell, seed=SEED, seconds=0.2, device="cpu",
                               record_window=True,
                               t_start=time.perf_counter())
    assert res["correct"] and res["record_window"] == 1
    assert set(res["per_layer"]) == {m["name"] for m in cell.per_layer}
    assert {"fl.key_ms", "fl.sample_ms", "fl.loop_self_ms"} <= set(
        res["per_layer"])
    assert "idle_by_span" not in res
