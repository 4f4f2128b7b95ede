"""The buffered engine's building blocks in the port against the reference:
staleness weights, the buffer mean, ``prng.exponential``, the event layer
of ``link/dynamics`` and the event-clock pricing of ``core/latency``.

Grades (ROADMAP):

* Exact — ``staleness_weight`` ``constant`` and ``inverse``; ``churn_step``
  (uniforms compared with ``p_leave`` / ``p_rejoin``); ``arrival_times``
  and ``sync_round_duration`` (host float64); every degenerate config
  (``mean_s``, 1.0, 0.0 exactly); batching independence inside the port
  (a sub-cohort's draws are the full cohort's first rows).
* Bounded — ``staleness_weight`` ``polynomial`` (``pow``: ``POW_ULP``);
  ``prng.exponential`` and ``idle_gaps`` (``log1p``: ``EXP_ULP``);
  ``client_speed_factors`` and ``compute_times`` (``exp`` of a normal:
  ``EXP_NORMAL_ULP``, the normal's own bound widened by the ``exp``;
  measured 100 over 12,800 draws at jitter 0.3, spread 0.5);
  ``weighted_buffer_mean`` (a tensordot in another order: ``BUF_RTOL`` of
  the largest output).

The buffer algebra of ``tests/test_async_properties.py`` holds in the
port: arrival-order invariance (bit for bit), staleness weights
non-negative / 1 at zero / non-increasing, identical payloads aggregate to
themselves, zero weights give zeros.
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import latency as JLAT  # noqa: E402
from repro.fl import async_engine as JA  # noqa: E402
from repro.link import dynamics as JD  # noqa: E402
from repro_torch.core import latency as TLAT  # noqa: E402
from repro_torch.core import prng as P  # noqa: E402
from repro_torch.fl import async_engine as TA  # noqa: E402
from repro_torch.link import dynamics as TD  # noqa: E402

POW_ULP = 2
EXP_ULP = 2
EXP_NORMAL_ULP = 512
BUF_RTOL = 1e-6


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


def _ulp(a, b):
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


def _bounded(ref, got, max_ulp):
    u = _ulp(np.asarray(ref), got.numpy())
    assert u.max() <= max_ulp, u.max()


_COMPUTE = dict(mean_s=1.0, speed_spread=0.5, jitter=0.3,
                straggler_prob=0.2, straggler_factor=5.0)
_ARRIVAL = dict(mean_idle_s=0.25, p_leave=0.3, p_rejoin=0.4)

# ------------------------------------------------------------ staleness


@pytest.mark.parametrize("kind", ["constant", "inverse", "polynomial"])
def test_staleness_weight_matches_reference(kind):
    s = np.arange(0, 1001)
    for alpha in (0.1, 0.5, 1.0, 2.0):
        ref = np.asarray(JA.staleness_weight(s, kind, alpha))
        got = TA.staleness_weight(torch.from_numpy(s), kind, alpha)
        assert got.dtype == torch.float32
        if kind == "polynomial":
            _bounded(ref, got, POW_ULP)
        else:
            np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kind", ["constant", "polynomial", "inverse"])
def test_staleness_weight_contract(kind):
    """Non-negative, exactly 1 at s=0, non-increasing in s; constant is 1
    everywhere."""
    for alpha in (0.1, 0.5, 2.0):
        w = TA.staleness_weight(torch.arange(0, 101), kind, alpha).numpy()
        assert (w >= 0).all() and w[0] == 1.0
        assert (np.diff(w) <= 0).all()
        if kind == "constant":
            assert (w == 1.0).all()
    assert TA.STALENESS_KINDS == JA.STALENESS_KINDS


def test_staleness_weight_rejects_unknown_kind():
    with pytest.raises(ValueError, match="staleness kind"):
        TA.staleness_weight(1, "exponential")


# ---------------------------------------------------------- buffer mean


def _entries(seed, n_waves, m=6, d=37):
    rng = np.random.default_rng(seed)
    out = []
    for w in range(n_waves):
        g = rng.standard_normal((m, d)).astype(np.float32)
        wv = (rng.random(m) * (rng.random(m) < 0.7)).astype(np.float32)
        out.append((w, g, wv))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_weighted_buffer_mean_matches_reference(seed):
    ents = _entries(seed, 1 + seed % 5)
    ref = np.asarray(JA.weighted_buffer_mean(
        [(w, {"g": jnp.asarray(g)}, jnp.asarray(wv))
         for w, g, wv in ents])["g"])
    got = TA.weighted_buffer_mean(
        [(w, {"g": torch.from_numpy(g)}, torch.from_numpy(wv))
         for w, g, wv in ents])["g"].numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=BUF_RTOL * np.abs(ref).max())


@pytest.mark.parametrize("seed", range(4))
def test_weighted_buffer_mean_permutation_invariant(seed):
    """Arrival order does not change the aggregate, bit for bit."""
    ents = [(w, {"g": torch.from_numpy(g)}, torch.from_numpy(wv))
            for w, g, wv in _entries(100 + seed, 2 + seed)]
    ref = TA.weighted_buffer_mean(ents)["g"]
    shuffled = list(ents)
    random.Random(seed).shuffle(shuffled)
    assert torch.equal(TA.weighted_buffer_mean(shuffled)["g"], ref)


@pytest.mark.parametrize("kind", ["constant", "polynomial", "inverse"])
@pytest.mark.parametrize("full_mask", [False, True])
def test_identical_updates_aggregate_to_identity(kind, full_mask):
    """Waves all carrying payload X aggregate to X under any weighting."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 8)).astype(np.float32))
    hat = x.repeat(4, 1)
    entries = []
    for w in range(3):
        mask = np.ones(4, np.float32)
        if not full_mask:
            mask[rng.integers(0, 4)] = 0.0
        om = float(TA.staleness_weight(w, kind, 0.5))
        entries.append((w, {"g": hat}, torch.from_numpy(mask * np.float32(om))))
    out = TA.weighted_buffer_mean(entries)
    np.testing.assert_allclose(out["g"].numpy(), x[0].numpy(), rtol=1e-5,
                               atol=1e-6)


def test_weighted_buffer_mean_zero_weights_is_zero():
    """An all-dropped buffer leaves the model where it is (zeros, not
    NaN); an empty buffer is an error."""
    hat = {"g": torch.ones((3, 5))}
    out = TA.weighted_buffer_mean([(0, hat, torch.zeros(3))])
    assert torch.equal(out["g"], torch.zeros(5))
    assert torch.equal(TA._weighted_mean(hat, np.zeros(3, np.float32))["g"],
                       torch.zeros(5))
    with pytest.raises(ValueError, match="at least one"):
        TA.weighted_buffer_mean([])


def test_single_entry_mean_is_dropout_weighted_mean():
    """For 0/1 weights the where-form denominator of a one-wave buffer is
    the sync engine's ``max(total, 1)``: equal bits."""
    from repro_torch.fl import engine as TE

    rng = np.random.default_rng(5)
    hat = {"a": torch.from_numpy(rng.standard_normal((5, 3, 4)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal((5, 7)).astype(
            np.float32))}
    for mask in ([1, 0, 1, 1, 0], [0] * 5, [1] * 5):
        w = np.asarray(mask, np.float32)
        a = TA._weighted_mean(hat, w)
        b = TE.dropout_weighted_mean(hat, torch.from_numpy(w))
        for k in hat:
            assert torch.equal(a[k], b[k])


# --------------------------------------------------------------- draws


def test_exponential_bounded():
    for seed in range(3):
        ref = np.asarray(jax.random.exponential(jax.random.PRNGKey(seed),
                                                (8192,), jnp.float32))
        got = P.exponential(P.PRNGKey(seed), (8192,))
        _bounded(ref, got, EXP_ULP)
        assert bool((got >= 0).all())
    # batched keys: one scalar draw a key, as the reference's vmap
    keys = P.split(P.PRNGKey(4), 16)
    ref = np.asarray(jax.vmap(lambda k: jax.random.exponential(k, ()))(
        jax.random.split(jax.random.PRNGKey(4), 16)))
    _bounded(ref, P.exponential(keys, ()), EXP_ULP)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_event_layer_matches_reference(seed):
    kj, kt = jax.random.PRNGKey(seed), P.PRNGKey(seed)
    jc, tc = JD.ComputeTimeConfig(**_COMPUTE), TD.ComputeTimeConfig(**_COMPUTE)
    ja, ta = JD.ArrivalConfig(**_ARRIVAL), TD.ArrivalConfig(**_ARRIVAL)
    m = 100
    sj = JD.client_speed_factors(kj, m, jc)
    st = TD.client_speed_factors(kt, m, tc)
    _bounded(sj, st, EXP_NORMAL_ULP)
    # compute times with the reference's speed factors, so the comparison
    # holds compute_times alone
    ct = TD.compute_times(kt, tc, m, torch.from_numpy(np.array(sj)))
    _bounded(JD.compute_times(kj, jc, m, sj), ct, EXP_NORMAL_ULP)
    joined = (np.arange(m) % 3 > 0).astype(np.float32)
    np.testing.assert_array_equal(
        TD.churn_step(kt, torch.from_numpy(joined), ta).numpy(),
        np.asarray(JD.churn_step(kj, jnp.asarray(joined), ja)))
    _bounded(JD.idle_gaps(kj, m, ja), TD.idle_gaps(kt, m, ta), EXP_ULP)
    for t in (st, ct, TD.idle_gaps(kt, m, ta)):
        assert t.dtype == torch.float32 and t.shape == (m,)
        assert t.device == kt.device


def test_event_layer_degenerate_is_exact():
    """Default configs: compute time exactly ``mean_s``, speed exactly 1,
    idle gaps exactly 0, no churn; the synchronous-equivalence setting."""
    key = P.PRNGKey(7)
    for mean_s in (1.0, 0.5, 3.25):
        t = TD.compute_times(key, TD.ComputeTimeConfig(mean_s=mean_s), 6)
        assert torch.equal(t, torch.full((6,), mean_s))
    speed = TD.client_speed_factors(key, 8, TD.ComputeTimeConfig())
    assert torch.equal(speed, torch.ones(8))
    assert torch.equal(TD.compute_times(key, TD.ComputeTimeConfig(), 8,
                                        speed), torch.ones(8))
    gaps = TD.idle_gaps(key, 9, TD.ArrivalConfig())
    assert torch.equal(gaps, torch.zeros(9)) and not torch.signbit(gaps).any()
    assert torch.equal(TD.churn_step(key, torch.ones(5), TD.ArrivalConfig()),
                       torch.ones(5))


@pytest.mark.parametrize("m", [1, 5, 12])
def test_event_draws_batching_independent(m):
    """A client's draws depend on (key, client index) only."""
    key = P.PRNGKey(12345)
    tc, ta = TD.ComputeTimeConfig(**_COMPUTE), TD.ArrivalConfig(**_ARRIVAL)
    assert torch.equal(TD.compute_times(key, tc, 12)[:m],
                       TD.compute_times(key, tc, m))
    assert torch.equal(TD.client_speed_factors(key, 12, tc)[:m],
                       TD.client_speed_factors(key, m, tc))
    assert torch.equal(TD.idle_gaps(key, 12, ta)[:m],
                       TD.idle_gaps(key, m, ta))
    joined = (torch.arange(m) % 2).to(torch.float32)
    padded = torch.cat([joined, torch.zeros(3)])
    assert torch.equal(TD.churn_step(key, padded, ta)[:m],
                       TD.churn_step(key, joined, ta))


def test_event_draws_check_the_cohort():
    with pytest.raises(ValueError, match="num_clients"):
        TD.compute_times(P.PRNGKey(0), TD.ComputeTimeConfig(), 0)
    with pytest.raises(ValueError, match="num_clients"):
        TD.idle_gaps(P.PRNGKey(0), (1 << 20) + 1, TD.ArrivalConfig())


# -------------------------------------------------------------- latency


def test_arrival_times_exact():
    rng = np.random.default_rng(0)
    comp = rng.random(50).astype(np.float32) * 3
    air = (rng.random(50) * (rng.random(50) < 0.8)).astype(np.float32)
    for t0, dl in ((0.0, 0.0), (12.345678901234, 0.0625), (1e6, 3.3)):
        ref = JLAT.arrival_times(t0, comp, air, dl)
        got = TLAT.arrival_times(t0, torch.from_numpy(comp),
                                 torch.from_numpy(air), dl)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(
            TLAT.arrival_times(t0, comp, air, dl), ref)


def test_sync_round_duration_exact():
    rng = np.random.default_rng(1)
    comp = rng.random(20).astype(np.float32)
    air = rng.random(20).astype(np.float32) * 0.1
    act = rng.random(20) < 0.6
    for a in (None, act, np.zeros(20, bool)):
        ref = JLAT.sync_round_duration(comp, air, a)
        assert TLAT.sync_round_duration(comp, air, a) == ref
        ta = None if a is None else torch.from_numpy(a.astype(np.float32))
        assert TLAT.sync_round_duration(torch.from_numpy(comp),
                                        torch.from_numpy(air), ta) == ref
    assert TLAT.sync_round_duration([], []) == 0.0
