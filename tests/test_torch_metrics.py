"""The port's sketches and metrics (``repro_torch.obs.sketch`` /
``repro_torch.obs.metrics``) against the reference's (``repro.obs``).

Grades:

* Exact — ``bucket_counts`` on finite values, values exactly on an edge,
  +-0, +-inf and NaN (NaN in the slot ``jnp.searchsorted`` gives it, past
  the last inner edge), with and without a mask; ``reservoir_tags`` and
  ``reservoir_sample``; ``worst_k`` indices and values with ties, masks,
  +-0 and NaN (XLA's ``top_k`` order: IEEE total order, ties to the lower
  index); ``RoundSketcher.round_group`` on equal per-client arrays and
  round keys over several rounds (mode dwell carried), with a member mask
  and a downlink leg; ``Sketch`` quantiles and means on equal counts;
  ``MetricsRegistry.render`` and ``registry_from_ledger`` text on the
  same ledger file.
* Over a whole ``vehicular`` run (6 clients, 3 rounds, bucketed K1), the
  port from the reference's initial weights: every round's counts equal
  the reference's, except that a client may move to an adjacent bucket
  when its two values straddle the edge between them and differ by no
  more than the existing Bounded grades: the driver's SNR and CSI within
  ``SNR_ABS`` dB (the ``mean_snr_db`` grade of the FL tests, ``EDGE_DB``
  of ``test_torch_link.py``), airtime within ``AIR_RTOL`` relative
  (``test_torch_link.py``). BER and mode dwell allow no move.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.mnist_cnn import config as j_config  # noqa: E402
from repro.core import channel as JCH  # noqa: E402
from repro.core import transport as JT  # noqa: E402
from repro.data import synth_mnist as j_synth  # noqa: E402
from repro.fl import engine as JEN  # noqa: E402
from repro.fl import partition as j_partition  # noqa: E402
from repro.link import scenario as JS  # noqa: E402
from repro.obs import metrics as JM  # noqa: E402
from repro.obs import sketch as JK  # noqa: E402
from repro_torch.configs.mnist_cnn import config as t_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import transport as TT  # noqa: E402
from repro_torch.fl import engine as TE  # noqa: E402
from repro_torch.link import scenario as TS  # noqa: E402
from repro_torch.obs import ledger as TL  # noqa: E402
from repro_torch.obs import metrics as TM  # noqa: E402
from repro_torch.obs import sketch as TK  # noqa: E402

SNR_ABS = 1e-4
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


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _key(jkey):
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _special_values(layout):
    """Every inner and outer edge as float32, values a float32 ULP either
    side, +-0, +-inf, +-NaN, and 300 draws spread over the range."""
    e = layout.edges().astype(np.float32)
    up = np.nextafter(e, np.float32(np.inf))
    down = np.nextafter(e, np.float32(-np.inf))
    neg_nan = np.array([0xFFC00000], np.uint32).view(np.float32)
    r = np.random.default_rng(5)
    if layout.scale == "log":
        spread = np.exp(r.uniform(np.log(layout.lo) - 2,
                                  np.log(layout.hi) + 1, 300))
    else:
        width = layout.hi - layout.lo
        spread = r.uniform(layout.lo - 0.1 * width, layout.hi + 0.1 * width,
                           300)
    return np.concatenate([
        e, up, down, [0.0, -0.0, np.inf, -np.inf, np.nan], neg_nan,
        spread.astype(np.float32)]).astype(np.float32)


LAYOUTS = sorted(TM.DEFAULT_LAYOUTS) + ["tiny-log", "tiny-linear"]


def _layouts(name):
    if name == "tiny-log":
        return (JK.BucketLayout("x", "log", 1e-4, 1.0, 8),
                TK.BucketLayout("x", "log", 1e-4, 1.0, 8))
    if name == "tiny-linear":
        return (JK.BucketLayout("x", "linear", -1.0, 1.0, 4),
                TK.BucketLayout("x", "linear", -1.0, 1.0, 4))
    return JM.DEFAULT_LAYOUTS[name], TM.DEFAULT_LAYOUTS[name]


@pytest.mark.parametrize("name", LAYOUTS)
def test_bucket_counts_exact(name):
    jl, tl = _layouts(name)
    assert jl.to_dict() == tl.to_dict()
    np.testing.assert_array_equal(jl.edges(), tl.edges())
    vals = _special_values(jl)
    vals = vals[~_subnormal(vals)]
    mask = np.random.default_rng(1).random(vals.size) < 0.7
    for m in (None, mask):
        want = np.asarray(JK.bucket_counts(
            vals, jl, None if m is None else jnp.asarray(m)))
        got = TK.bucket_counts(_t(vals), tl, None if m is None else _t(m))
        assert got.dtype == torch.int32 and got.shape == (tl.n + 2,)
        np.testing.assert_array_equal(got.numpy(), want)
    # One value at a time: each lands in the reference's slot.
    for v in vals[np.r_[0:tl.n + 1, -306:-300]]:
        want = np.asarray(JK.bucket_counts(np.array([v]), jl))
        got = TK.bucket_counts(_t(np.array([v], np.float32)), tl).numpy()
        np.testing.assert_array_equal(got, want, err_msg=repr(v))


def _subnormal(v):
    a = np.abs(v)
    return (a > 0) & (a < np.finfo(np.float32).tiny)


def test_subnormals_compare_as_ieee():
    """XLA on the CPU treats subnormal inputs as zero (DAZ; ROADMAP Queue
    3), the port compares them as IEEE numbers: -1e-45 on a layout with
    lo = 0.0 is underflow in the port and bucket 0 in the reference. This
    is the one input class the exact tests above leave out."""
    lay_j, lay_t = _layouts("dwell_rounds")
    v = np.nextafter(np.float32(0), np.float32(-1))
    want = np.asarray(JK.bucket_counts(np.array([v]), lay_j))
    got = TK.bucket_counts(_t(np.array([v], np.float32)), lay_t).numpy()
    assert want[0] == 1 and got[lay_t.n] == 1


def test_nan_and_zero_slots():
    """NaN takes bucket n - 1 (``searchsorted`` puts it past every inner
    edge; it is neither below lo nor above hi); an exact 0 on a log layout
    is underflow; -0.0 on a linear layout whose inner edge is 0.0 sits in
    the bucket above it, as +0.0 does (IEEE compare, not total order)."""
    lay = TK.BucketLayout("x", "log", 1e-4, 1.0, 8)
    c = TK.bucket_counts(_t(np.array([np.nan, 0.0], np.float32)), lay)
    assert c[lay.n - 1] == 1 and c[lay.n] == 1
    lin = TM.DEFAULT_LAYOUTS["snr_db"]
    zero = int(np.flatnonzero(lin.edges()[1:-1] == 0.0)[0])
    c = TK.bucket_counts(_t(np.array([-0.0, 0.0], np.float32)), lin)
    assert c[zero + 1] == 2


@pytest.mark.parametrize("seed,n", [(7, 16), (11, 100)])
def test_reservoir_tags_and_sample_exact(seed, n):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    want = np.asarray(JK.reservoir_tags(jkey, n))
    got = TK.reservoir_tags(_key(jkey), n)
    np.testing.assert_array_equal(got.numpy(), want)
    for k in (1, 4, n):
        jt, ji = JK.reservoir_sample(jnp.asarray(want), k)
        tt, ti = TK.reservoir_sample(got, k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    with pytest.raises(ValueError, match="num_clients"):
        TK.reservoir_tags(_key(jkey), 0)


def test_reservoir_sample_ties_and_inf():
    tags = np.array([0.5, np.inf, 0.25, 0.5, np.inf, 0.25, -0.0, 0.0],
                    np.float32)
    for k in (3, 8):
        jt, ji = JK.reservoir_sample(jnp.asarray(tags), k)
        tt, ti = TK.reservoir_sample(_t(tags), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(
            tt.numpy().view(np.uint32), np.asarray(jt).view(np.uint32))


@pytest.mark.parametrize("case", ["ties", "zeros", "nan", "masked"])
def test_worst_k_exact(case):
    neg_nan = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
    vals = {
        "ties": np.array([0.1, 0.3, 0.1, 0.3, 0.0, 0.0, 0.2, 0.3]),
        "zeros": np.array([-0.0, 0.0, -0.0, 0.0, 1.0, -1.0, 0.0, -0.0]),
        "nan": np.array([1.0, np.nan, -np.inf, 0.0, 2.0, neg_nan, np.inf,
                         np.nan]),
        "masked": np.array([0.0, 0.5, 0.0, 0.5, 0.25, 0.0, 0.5, 0.0]),
    }[case].astype(np.float32)
    mask = (np.array([1, 0, 1, 1, 0, 1, 1, 1], bool) if case == "masked"
            else None)
    for k in (1, 4, 8):
        jv, ji = JK.worst_k(vals, k, None if mask is None
                            else jnp.asarray(mask))
        tv, ti = TK.worst_k(_t(vals), k, None if mask is None else _t(mask))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(
            tv.numpy().view(np.uint32), np.asarray(jv).view(np.uint32))


def test_sketch_merge_quantile_roundtrip():
    lay_j, lay_t = JM.DEFAULT_LAYOUTS["ber"], TM.DEFAULT_LAYOUTS["ber"]
    r = np.random.default_rng(0)
    vals = np.clip(np.exp(r.normal(-6.0, 2.5, 600)), 2e-8, 0.9).astype(
        np.float32)
    parts = [TK.Sketch(lay_t).observe(_t(c)) for c in np.split(vals, 3)]
    whole = TK.Sketch(lay_t).observe(_t(vals))
    assert (parts[0].merge(parts[1]).merge(parts[2])
            == parts[2].merge(parts[1].merge(parts[0])) == whole)
    ref = JK.Sketch(lay_j).observe(vals)
    np.testing.assert_array_equal(whole.counts, ref.counts)
    for q in (0.0, 0.05, 0.5, 0.95, 0.99, 1.0):
        assert whole.quantile(q) == ref.quantile(q)
        exact = float(np.quantile(vals, q, method="lower"))
        assert abs(whole.quantile(q) - exact) / exact <= (
            lay_t.error_bound() + 1e-5)
    assert whole.mean() == ref.mean()
    again = TK.Sketch.from_dict(json.loads(json.dumps(whole.to_dict())))
    assert again == whole and whole.to_dict() == ref.to_dict()
    with pytest.raises(ValueError, match="layouts differ"):
        whole.merge(TK.Sketch(TM.DEFAULT_LAYOUTS["snr_db"]))
    with pytest.raises(ValueError, match="counts length"):
        TK.Sketch(lay_t, [0, 1])


def _synthetic_rounds(n, rounds, seed=0):
    """Per-round per-client arrays with modes that switch (dwell), zero
    BERs (log underflow), values on edges and out of range, dropouts."""
    r = np.random.default_rng(seed)
    snr_edges = TM.DEFAULT_LAYOUTS["snr_db"].edges().astype(np.float32)
    out = []
    mode = r.integers(0, 4, n)
    for _ in range(rounds):
        snr = r.uniform(-25.0, 65.0, n).astype(np.float32)
        snr[:3] = snr_edges[[5, 16, 40]]
        ber = (10.0 ** r.uniform(-10, 0.3, n)).astype(np.float32)
        ber[r.random(n) < 0.3] = 0.0
        switch = r.random(n) < 0.3
        mode = np.where(switch, r.integers(0, 4, n), mode)
        out.append(dict(
            snr_db=snr, est_db=(snr + r.normal(0, 2, n)).astype(np.float32),
            ber=ber,
            airtime_s=(10.0 ** r.uniform(-8, 3.5, n)).astype(np.float32),
            mode=mode.astype(np.int32),
            active=(r.random(n) > 0.2).astype(np.float32),
            downlink_ber=(10.0 ** r.uniform(-9, 0, n)).astype(np.float32)))
    return out


@pytest.mark.parametrize("n,k,member,downlink", [
    (40, 4, False, False), (40, 6, True, True), (5, 8, False, True)])
def test_round_group_exact(n, k, member, downlink):
    """Five rounds through both sketchers: every group (counts, totals,
    exemplars) and the run summary equal the reference's."""
    js = JM.RoundSketcher(n, exemplar_k=k)
    ts = TM.RoundSketcher(n, exemplar_k=k, device="cpu")
    mem = (np.random.default_rng(3).random(n) > 0.25).astype(np.float32)
    base = jax.random.PRNGKey(9)
    for r, arrs in enumerate(_synthetic_rounds(n, 5)):
        jkey = jax.random.fold_in(base, r)
        kw = dict(arrs)
        if not downlink:
            kw.pop("downlink_ber")
        if member:
            kw["member"] = mem
        want = js.round_group(jkey, **{k_: jnp.asarray(v)
                                       for k_, v in kw.items()})
        got = ts.round_group(_key(jkey), **{k_: _t(v)
                                            for k_, v in kw.items()})
        assert got == want, r
        assert json.dumps(got) == json.dumps(want)
    assert ts.summary() == js.summary()


def test_resolve_sketches():
    assert TM.resolve_sketches(None, 4, "cpu") is None
    assert TM.resolve_sketches(False, 4, "cpu") is None
    sk = TM.resolve_sketches(True, 4, "cpu")
    assert isinstance(sk, TM.RoundSketcher) and sk.num_clients == 4
    assert TM.resolve_sketches(sk, 4, "cpu") is sk
    lay = TK.BucketLayout("ber", "log", 1e-6, 1.0, 12)
    assert TM.resolve_sketches({"ber": lay}, 4, "cpu").layouts["ber"] == lay
    with pytest.raises(ValueError, match="sketches="):
        TM.resolve_sketches(object(), 4, "cpu")


def test_openmetrics_render_matches_reference():
    vals = np.clip(np.exp(np.random.default_rng(2).normal(-6, 2.5, 128)),
                   2e-8, 0.9).astype(np.float32)
    regs = []
    for lib, sk in ((JM, JK.Sketch(JM.DEFAULT_LAYOUTS["ber"]).observe(vals)),
                    (TM, TK.Sketch(TM.DEFAULT_LAYOUTS["ber"]).observe(
                        _t(vals)))):
        reg = lib.MetricsRegistry()
        reg.counter("repro_rounds", "rounds run")
        reg.inc("repro_rounds", 5)
        reg.gauge("repro_final_accuracy", 0.91, "final accuracy")
        reg.histogram("repro_ber", sk, "per-client BER")
        regs.append(reg.render())
    assert regs[1] == regs[0]
    assert regs[1].endswith("# EOF\n") and "repro_rounds_total 5" in regs[1]
    with pytest.raises(ValueError, match="metric name"):
        TM.MetricsRegistry().counter("9bad")
    reg = TM.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x", 1.0)


# --------------------------------------------------------------------------
# a whole scenario run against the reference
# --------------------------------------------------------------------------


def _world6():
    (img, lab), (ti, tl) = j_synth.train_test(60, 16, seed=0)
    parts = j_partition.non_iid_partition(img, lab, n_clients=6)
    cx, cy = j_partition.stack_clients(parts, per_client=24)
    return cx, cy, ti, tl


def _capture(sketcher, into):
    inner = sketcher.round_group

    def round_group(key, **kw):
        into.append({k: np.asarray(v.cpu() if isinstance(v, torch.Tensor)
                                   else v) for k, v in kw.items()
                     if v is not None})
        return inner(key, **kw)

    sketcher.round_group = round_group


@pytest.fixture(scope="module")
def vehicular_runs(tmp_path_factory):
    """The reference's and the port's 3-round ``vehicular`` run (bucketed,
    K1), sketches and a ledger on; the port from the reference's initial
    weights. Returns ``(ref result, port result, ref inputs, port inputs,
    ref ledger, port ledger)`` with each round's sketch inputs."""
    cx, cy, ti, tl = _world6()
    d = tmp_path_factory.mktemp("torch_metrics")
    kw = dict(n_rounds=3, eval_every=1, seed=3, sketches=True)
    with jax.threefry_partitionable(True):
        je = JEN.RoundEngine(
            JEN.FedSGD(j_config(), batch_per_round=8),
            JT.TransportConfig(mode="approx", use_kernel=True,
                               channel=JCH.ChannelConfig(snr_db=10.0)),
            cx, cy, ti, tl, ledger=str(d / "ref.jsonl"),
            scenario=dataclasses.replace(JS.get_scenario("vehicular"),
                                         ecrt_expected_tx=2.0), **kw)
        te = TE.RoundEngine(
            TE.FedSGD(t_config(), batch_per_round=8),
            TT.TransportConfig(mode="approx", use_kernel=True,
                               channel=TCH.ChannelConfig(snr_db=10.0)),
            cx, cy, ti, tl, ledger=str(d / "port.jsonl"), device="cpu",
            scenario=dataclasses.replace(TS.get_scenario("vehicular"),
                                         ecrt_expected_tx=2.0), **kw)
        te.params = params_from_jax({k: np.asarray(v)
                                     for k, v in je.params.items()})
        j_in, t_in = [], []
        _capture(je.sketcher, j_in)
        _capture(te.sketcher, t_in)
        ja, ta = je.run(), te.run()
    return ja, ta, j_in, t_in, str(d / "ref.jsonl"), str(d / "port.jsonl")


def _client_slots(values, layout):
    """Per-client slot of ``bucket_counts`` (mask ignored)."""
    v = np.asarray(values, np.float32).reshape(-1)
    edges = layout.edges()[1:-1].astype(np.float32)
    inner = np.searchsorted(edges, v, side="right")
    inner = np.where(np.isnan(v), layout.n - 1, inner)
    return np.where(v < np.float32(layout.lo), layout.n,
                    np.where(v > np.float32(layout.hi), layout.n + 1, inner))


_WITHIN = {
    "snr_db": lambda a, b: abs(float(a) - float(b)) <= SNR_ABS,
    "est_db": lambda a, b: abs(float(a) - float(b)) <= SNR_ABS,
    "airtime_s": lambda a, b: abs(float(a) - float(b))
    <= AIR_RTOL * abs(float(a)),
}


def test_whole_run_counts_match_reference(vehicular_runs):
    ja, ta, j_in, t_in, _, _ = vehicular_runs
    assert len(ja.records) == len(ta.records) == 3
    assert [r.mode_counts for r in ta.records] == [
        r.mode_counts for r in ja.records]
    moved = 0
    for r, (jr, tr) in enumerate(zip(ja.records, ta.records)):
        js, ts = jr.sketches, tr.sketches
        assert set(ts) == set(js)
        for m in ("snr_db", "est_db", "ber", "airtime_s", "dwell_rounds"):
            assert ts[m]["layout"] == js[m]["layout"]
            assert ts[m]["total"] == js[m]["total"], (r, m)
            if ts[m]["counts"] == js[m]["counts"]:
                continue
            assert m in _WITHIN, f"round {r}: {m} counts differ"
            lay = TM.DEFAULT_LAYOUTS[m]
            sj = _client_slots(j_in[r][m], lay)
            st = _client_slots(t_in[r][m], lay)
            edges = lay.edges()
            for c in np.flatnonzero(sj != st):
                a, b = j_in[r][m][c], t_in[r][m][c]
                assert abs(int(sj[c]) - int(st[c])) == 1, (r, m, c)
                edge = edges[max(sj[c], st[c])]
                assert min(a, b) <= np.float32(edge) <= max(a, b), (r, m, c)
                assert _WITHIN[m](a, b), (r, m, c, a, b)
                moved += 1
    print(f"clients that moved to an adjacent bucket: {moved}")


def test_whole_run_registry_text_matches_reference_reader(vehicular_runs):
    """The port's ``registry_from_ledger`` on the port's ledger renders
    the text the reference's renders on the same file."""
    _, _, _, _, _, port_path = vehicular_runs
    assert TL.validate_ledger(port_path) == []
    want = JM.registry_from_ledger(port_path).render()
    got = TM.registry_from_ledger(port_path).render()
    assert got == want and got.endswith("# EOF\n")
    data = TL.read_ledger(port_path)
    per_round = sum(r.sketches["snr_db"]["total"] for r in data.rounds)
    assert f"repro_client_snr_db_count {per_round}" in got
    assert data.summary["sketches"]["snr_db"]["total"] == per_round
