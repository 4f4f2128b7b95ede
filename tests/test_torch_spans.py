"""The port's span recorder (``repro_torch.obs.spans``) and the spans and
counters at its layer boundaries. The recorder has no counterpart in the
reference, so nothing here compares against it.

* The recorder: a span outside any scope is inert; ``collect`` sums each
  name as before, nested scopes included; a recording scope keeps each
  span whole (parent, round or step id, host start and end on the
  Unix-epoch clock) and a collect inside it hides nothing; device spans
  on a CUDA scope (CUDA events stubbed here) resolve only at ``settle``
  or a scope's end, and a pair still running when the outermost scope
  closes raises; the module calls no synchronise.
* The clock: under ``torch.profiler`` with CPU activity an ``aten::mm``
  run inside a span, mapped through ``kineto_results.trace_start_ns()``,
  lies inside the span's interval mapped through the scope's anchor.
* The FL round: tiny CPU runs on the kernel path (plain K1 and K2) and on
  the layered PHY report every span of the tree in ``phase_s``, one
  counter dict a round, and the round's top-level spans cover it.
* The LLM step: the approx step's spans, on the plain K0 and the layered
  PHY, with the uplink's parts inside it.
"""

import ast
import dataclasses
import pathlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.mnist_cnn import config  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.core import transport as TT  # noqa: E402
from repro_torch.fl import engine as TE  # noqa: E402
from repro_torch.fl.loop import run_fl  # noqa: E402
from repro_torch.launch import steps as TSTEPS  # noqa: E402
from repro_torch.launch import train as TTRAIN  # noqa: E402
from repro_torch.launch.mesh import world_mesh  # noqa: E402
from repro_torch.link import scenario as TS  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.obs import spans  # noqa: E402
from repro_torch.optim.sgd import sgd as make_sgd  # noqa: E402

SPANS_PY = (pathlib.Path(__file__).resolve().parents[1] / "src"
            / "repro_torch" / "obs" / "spans.py")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- recorder


def test_span_outside_a_scope_is_inert():
    with spans.span("keys"), spans.span("kernel", device=True, id=3):
        pass
    spans.settle()  # nothing pending, nothing raised
    with spans.collect("cpu") as seconds:
        pass
    assert seconds == {}


def test_collect_sums_each_name_nested_scopes_included():
    with spans.collect("cpu") as outer:
        with spans.span("uplink"):
            with spans.collect("cpu") as inner:
                for _ in range(3):
                    with spans.span("keys"):
                        time.sleep(0.001)
                with spans.span("kernel"):
                    pass
        with spans.span("apply"):
            pass
    assert set(inner) == {"keys", "kernel"}
    assert set(outer) == {"uplink", "keys", "kernel", "apply"}
    assert inner["keys"] == outer["keys"] >= 0.003
    assert outer["uplink"] >= inner["keys"] + inner["kernel"]


def test_record_keeps_parents_ids_and_the_clock():
    lo = time.time_ns()
    with spans.record("cpu") as rec:
        for r in range(2):
            with spans.span("round", id=r):
                with spans.span("uplink", device=True):
                    with spans.collect("cpu") as parts:
                        with spans.span("keys"):
                            pass
                        with spans.span("kernel", device=True):
                            pass
                with spans.span("apply", device=True):
                    pass
        with spans.span("loose"):
            pass
    hi = time.time_ns()
    names = [(s.name, s.parent, s.id) for s in rec.spans]
    assert names == [("round", None, 0), ("uplink", 0, 0), ("keys", 1, 0),
                     ("kernel", 1, 0), ("apply", 0, 0),
                     ("round", None, 1), ("uplink", 5, 1), ("keys", 6, 1),
                     ("kernel", 6, 1), ("apply", 5, 1),
                     ("loose", None, None)]
    assert set(parts) == {"keys", "kernel"}  # the collect saw its own
    for s in rec.spans:
        assert lo <= s.t0_ns <= s.t1_ns <= hi
        assert s.device_s is None  # the CPU: host time
        assert s.seconds == pytest.approx((s.t1_ns - s.t0_ns) * 1e-9)
        if s.parent is not None:
            p = rec.spans[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns


def test_a_recording_inside_a_span_starts_its_own_tree():
    with spans.collect("cpu") as seconds, spans.span("run", id=7):
        with spans.record("cpu") as rec:
            with spans.span("round"):
                with spans.span("sample"):
                    pass
    assert [(s.name, s.parent, s.id) for s in rec.spans] == [
        ("round", None, 7), ("sample", 0, 7)]
    assert set(seconds) == {"run", "round", "sample"}


class _FakeEvent:
    """A CUDA event stand-in: ``done`` says whether the device reached it;
    its time is the host's when recorded."""

    made: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t, self.done = None, False
        _FakeEvent.made.append(self)

    def record(self):
        self.t = time.perf_counter()

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done, "read before the device reached it"
        return (end.t - self.t) * 1e3 + 5.0  # ms, 5 ms of device time more

    def synchronize(self):  # pragma: no cover - must never be called
        raise AssertionError("a span waited for the device")


@pytest.fixture
def fake_cuda(monkeypatch):
    _FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", _FakeEvent.synchronize)
    return _FakeEvent


def _reach_all(fake):
    for e in fake.made:
        e.done = True


def test_device_pairs_resolve_at_settle_and_at_the_scope_end(fake_cuda):
    with spans.record("cuda") as rec, spans.collect("cuda") as seconds:
        with spans.span("kernel", device=True, id=1):
            pass
        with spans.span("keys"):  # host work keeps host time
            pass
        assert "kernel" not in seconds and "keys" in seconds
        spans.settle()  # the device has not reached the pair yet
        assert "kernel" not in seconds
        _reach_all(fake_cuda)  # a synchronise the program makes
        spans.settle()
        assert seconds["kernel"] >= 5e-3
        with spans.span("apply", device=True):
            pass
        _reach_all(fake_cuda)
    assert seconds["apply"] >= 5e-3  # resolved when the scope closed
    kernel, keys, apply = rec.spans
    assert kernel.device_s == seconds["kernel"] and keys.device_s is None
    assert apply.device_s == seconds["apply"]
    assert len(fake_cuda.made) == 4  # two pairs; host spans take none


def test_a_pair_still_running_at_the_outermost_end_raises(fake_cuda):
    with pytest.raises(RuntimeError, match="after a synchronise"):
        with spans.collect("cuda"):
            with spans.span("grad", device=True):
                pass
    # an error already on its way out is not masked
    with pytest.raises(KeyError):
        with spans.collect("cuda"):
            with spans.span("grad", device=True):
                raise KeyError("grad")
    # a nested scope may close before the synchronise: its pairs wait
    with spans.collect("cuda") as outer:
        with spans.collect("cuda") as inner:
            with spans.span("kernel", device=True):
                pass
        assert inner == {}
        _reach_all(fake_cuda)
        spans.settle()
    assert inner["kernel"] == outer["kernel"] >= 5e-3


def test_the_recorder_never_synchronises():
    """No call in ``obs/spans.py`` names a synchronise: the device pairs
    wait for the program's own."""
    tree = ast.parse(SPANS_PY.read_text())
    called = {n.func.attr if isinstance(n.func, ast.Attribute) else
              getattr(n.func, "id", "") for n in ast.walk(tree)
              if isinstance(n, ast.Call)}
    assert not {c for c in called if "synchron" in c.lower()}
    assert "torch.cuda.synchronize" not in SPANS_PY.read_text()


def test_a_span_maps_onto_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.record("cpu") as rec:
            for _ in range(3):
                with spans.span("mm"):
                    a @ a
                time.sleep(0.002)
    base = prof.profiler.kineto_results.trace_start_ns()
    mms = [(base + e.time_range.start * 1e3, base + e.time_range.end * 1e3)
           for e in prof.events() if e.name == "aten::mm"]
    assert len(mms) == 3
    for (t0, t1), s in zip(sorted(mms), rec.spans):
        # the marker's own resolution: the profiler's and the host's
        # clocks agree to well under the 2 ms between the spans
        assert s.t0_ns - 300_000 <= t0 <= t1 <= s.t1_ns + 300_000


# ------------------------------------------------------------- FL round


def _world():
    rng = np.random.default_rng(0)
    cx = rng.uniform(0, 1, (2, 8, 28, 28)).astype(np.float32)
    cy = rng.integers(0, 10, (2, 8)).astype(np.int32)
    return cx, cy, cx[0], cy[0]


# the round's top-level spans in the order they open
TOP = ("key", "sample", "gradients", "uplink", "apply", "telemetry",
       "eval")


@pytest.mark.parametrize("use_kernel,fused", [(True, True), (True, False),
                                              (False, False)],
                         ids=["k2", "k1-mean", "layered"])
def test_fl_round_spans_and_counters(use_kernel, fused):
    tc = TT.TransportConfig(mode="approx", use_kernel=use_kernel,
                            channel=TCH.ChannelConfig(snr_db=10.0))
    with spans.record("cpu") as rec:
        res = run_fl(config(), tc, *_world(), n_rounds=2, batch_per_round=4,
                     eval_every=1, device="cpu", fused_aggregate=fused)
    parts = {f"uplink_{p}" for p in TE.UPLINK_PARTS}
    assert [list(p) for p in res.phase_s] == [
        ["key", "sample", "gradients", "uplink", *sorted(
            parts, key=lambda k: TE.UPLINK_PARTS.index(k[7:])),
         "telemetry", "apply", "eval"]] * 2
    assert res.counters == [{"k0": 0, "k1": 0, "k2": 0}] * 2  # plain
    for ph in res.phase_s:
        ran = {k for k in parts if ph[k] > 0}
        if use_kernel:
            assert ran == {"uplink_keys", "uplink_kernel"} | (
                set() if fused else {"uplink_mean"})
        else:
            assert ran == parts - {"uplink_kernel"}
        assert sum(ph[k] for k in parts) <= ph["uplink"]
    rounds = [i for i, s in enumerate(rec.spans) if s.name == "round"]
    assert [rec.spans[i].id for i in rounds] == [0, 1]
    for i, ph in zip(rounds, res.phase_s):
        rnd = rec.spans[i]
        kids = [s for s in rec.spans if s.parent == i]
        assert [s.name for s in kids] == list(TOP)
        covered = sum(s.seconds for s in kids)
        assert 0.9 * rnd.seconds <= covered <= rnd.seconds
        for s in kids:
            assert ph[s.name] == pytest.approx(s.seconds)


def test_fl_downlink_round_names_both_legs():
    res = run_fl(config(), TT.TransportConfig(
        mode="approx", use_kernel=True,
        channel=TCH.ChannelConfig(snr_db=10.0)), *_world(), n_rounds=1,
        batch_per_round=4, device="cpu", downlink=TS.DownlinkConfig())
    ph = res.phase_s[0]
    assert list(ph)[:3 + len(TE.DOWNLINK_PARTS)] == [
        "key", "sample", "downlink", *(f"downlink_{p}" for p in TE.DOWNLINK_PARTS)]
    assert ph["downlink_keys"] > 0 and ph["downlink_kernel"] > 0
    assert ph["downlink_keys"] + ph["downlink_kernel"] <= ph["downlink"]
    assert len(res.counters) == 1


# ------------------------------------------------------------- LLM step


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["k0-plain", "layered"])
def test_llm_step_spans(use_kernel):
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(), n_layers=1,
                              d_model=32, n_heads=2, n_kv_heads=1,
                              head_dim=16, d_ff=48, vocab_size=64)
    tc = TT.TransportConfig(mode="approx", use_kernel=use_kernel,
                            channel=TCH.ChannelConfig(snr_db=10.0))
    opt = make_sgd(0.1)
    params = R.init_params(P.PRNGKey(0), cfg)
    step = TSTEPS.make_train_step_approx(cfg, opt, tc, world_mesh(None))
    tok = torch.randint(0, 64, (2, 8), dtype=torch.int32)
    batch = {"tokens": tok, "labels": tok}
    state = opt.init(params)
    for i in range(2):
        with spans.record("cpu") as rec, spans.collect("cpu") as parts:
            params, state, loss, _ = step(params, state, batch,
                                          P.PRNGKey(i))
            float(loss)
        want = {"step", "grad", "uplink", "flatten", "keys", "unflatten",
                "apply"} | ({"kernel"} if use_kernel
                            else {"codec", "channel", "demod"})
        assert set(parts) == want
        root = rec.spans[0]
        assert (root.name, root.parent, root.id) == ("step", None, i)
        up = next(j for j, s in enumerate(rec.spans) if s.name == "uplink")
        inside = {s.name for s in rec.spans if s.parent == up}
        assert inside == want - {"step", "grad", "uplink", "apply"}
        assert sum(parts[k] for k in ("grad", "uplink", "apply")) <= \
            parts["step"]
        line = TTRAIN.span_parts(parts)
        assert "uplink" in line and "(flatten" in line
