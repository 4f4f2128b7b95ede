"""The port's plain K1/K2 (``repro_torch.kernels.ref``) against the JAX
Pallas kernels, run as the JAX tests run them (interpret mode on the CPU).

Grades (ROADMAP): Exact on the ``hash_u32``/``uniform01`` streams and, at
``noise_power = 0``, on payload bits and error counts. With noise the
draws pass through ``log``/``cos``/``sin``/``sqrt``, whose CPU routines
differ by up to 1 ULP between XLA and PyTorch, so they are Bounded: a
received word may differ only if one of its symbols' demod pre-round
values ``(y*inv + (L-1))*0.5`` lies within ``EDGE`` of a half-integer.
Inside the port, K2's plain version equals K1's plus the client-order
aggregate bit for bit. The CUDA kernels themselves are held against these
plain versions on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as JO  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro_torch.core import aggregation as TA  # noqa: E402
from repro_torch.kernels import approx_channel as TAC  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

JAC = importlib.import_module("repro.kernels.approx_channel")

G0 = 1e-3  # tx_power * d^-alpha at d=10, alpha=3
EDGE = 1e-4  # half-integer proximity that may flip a decision (Bounded)
C, N, BW = 3, 1024, 512
SEEDS = np.array([7, 123456789, 4000000000], np.uint32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    tensor ops split over every core stall each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _payload(word_bits, seed=0, c=C, n=N):
    x = np.random.default_rng(seed).uniform(-1, 1, (c, n)).astype(np.float32)
    if word_bits == 16:
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
            torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _link(snr_db):
    """Row 0 noiseless (the Exact grade), the other rows at ``snr_db``."""
    npow = np.full(C, G0 / 10 ** (snr_db / 10), np.float32)
    npow[0] = 0.0
    return npow, np.full(C, G0, np.float32)


def _bits(a, word_bits):
    a = np.asarray(a.float() if isinstance(a, torch.Tensor)
                   and a.dtype == torch.bfloat16 else a)
    if word_bits == 16:
        return np.asarray(jnp.asarray(a, jnp.bfloat16).view(jnp.uint16))
    return a.view(np.uint32)


def _t(a, dtype=None):
    return torch.from_numpy(np.asarray(a).astype(dtype or np.asarray(a).dtype))


def test_hash_and_uniform_streams_exact():
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 2**32, 50000, dtype=np.uint64).astype(np.uint32)
    idx[:3] = [0, 1, 2**32 - 1]
    for seed in (0, 7, 2**32 - 1):
        for stream in (0x9E3779B9, 0x7FEB352D, 0x68E31DA4):
            h_ref = np.asarray(JR.hash_u32(jnp.uint32(seed), jnp.asarray(idx),
                                           stream))
            h = TR.hash_u32(torch.tensor(seed), _t(idx, np.int64), stream)
            np.testing.assert_array_equal(h_ref.astype(np.int64), h.numpy())
            np.testing.assert_array_equal(
                np.asarray(JR.uniform01(jnp.asarray(h_ref))),
                TR.uniform01(h).numpy())


def _edge_rule(ref_bits, got_bits, edges):
    """Every differing word traces to a symbol within EDGE of a decision."""
    diff = ref_bits != got_bits
    assert np.all(edges[diff] < EDGE), edges[diff].max()
    return int(diff.sum())


@pytest.mark.parametrize("word_bits", [32, 16])
@pytest.mark.parametrize("fading", ["rayleigh", "awgn", "block_rayleigh"])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_k1_plain_vs_pallas(k, fading, word_bits):
    xj, xt = _payload(word_bits, seed=k)
    npow, gains = _link(10.0)
    mask = 0xBFFF if word_bits == 16 else 0xBFFFFFFF
    kw = dict(bits_per_symbol=k, fading=fading, fade_block=64,
              clamp_mask=mask, block_words=BW, word_bits=word_bits)
    xr, er = JAC.approx_channel_batch_pallas(
        xj, jnp.asarray(SEEDS), jnp.asarray(npow), jnp.asarray(gains),
        interpret=True, **kw)
    xp, ep, edges = TR.approx_channel_batch_ref(
        xt, _t(SEEDS, np.int64), _t(npow), _t(gains), with_edges=True, **kw)
    assert xp.dtype == (torch.bfloat16 if word_bits == 16 else torch.float32)
    rb, pb = _bits(xr, word_bits), _bits(xp, word_bits)
    np.testing.assert_array_equal(rb[0], pb[0])  # noiseless row: Exact
    assert int(er[0]) == int(ep[0]) == 0
    n_diff = _edge_rule(rb, pb, edges.numpy())
    if n_diff == 0:
        np.testing.assert_array_equal(np.asarray(er), ep.numpy())
    # the CPU wrapper of K1 is the plain version
    xw, ew = TAC.approx_channel_batch_kernel(
        xt, _t(SEEDS, np.int64), _t(npow), _t(gains), **kw)
    np.testing.assert_array_equal(_bits(xw, word_bits), pb)
    np.testing.assert_array_equal(ew.numpy(), ep.numpy())


def _sum_separate(rows, w):
    """Client-order sum, one float32 multiply then one add (the port's and
    the documented reference arithmetic)."""
    acc = np.zeros(rows.shape[1], np.float32)
    for c in range(rows.shape[0]):
        acc = acc + np.float32(w[c]) * rows[c]
    return acc


def _sum_fma(rows, w):
    """Client-order sum with each step fused, ``fma(w, x, acc)``: the
    product of two float32 is exact in float64, and float64 holds every
    sum here exactly enough that one rounding to float32 remains."""
    acc = np.zeros(rows.shape[1], np.float32)
    for c in range(rows.shape[0]):
        acc = (acc.astype(np.float64)
               + np.float64(w[c]) * rows[c].astype(np.float64)).astype(
                   np.float32)
    return acc


@pytest.mark.parametrize("word_bits", [32, 16])
@pytest.mark.parametrize("k", [2, 8])
def test_k2_plain_vs_pallas_and_layered(k, word_bits):
    """K2's plain version against the Pallas K2.

    With weights that are powers of two every product ``w * x`` is exact,
    so the sums match bit for bit wherever no client's word sat on a
    decision edge. With general weights they do not: XLA on the CPU fuses
    the Pallas body's ``agg + w * x`` (and ``fedsgd_aggregate_batch``'s
    scan) into an fma, against the reference's own "never an fma"
    contract, while the port keeps the separate multiply and add (ROADMAP
    Queue 3). Both are pinned to their arithmetic here.
    """
    xj, xt = _payload(word_bits, seed=10 + k)
    npow, gains = _link(10.0)
    mask = 0xBFFF if word_bits == 16 else 0xBFFFFFFF
    kw = dict(bits_per_symbol=k, fading="rayleigh", fade_block=64,
              clamp_mask=mask, block_words=BW, word_bits=word_bits)
    xr, _ = JAC.approx_channel_batch_pallas(
        xj, jnp.asarray(SEEDS), jnp.asarray(npow), jnp.asarray(gains),
        interpret=True, **kw)
    xp, _, edges = TR.approx_channel_batch_ref(
        xt, _t(SEEDS, np.int64), _t(npow), _t(gains), with_edges=True, **kw)
    calm = np.all(edges.numpy() >= EDGE, axis=0)
    rows_r = np.asarray(jnp.asarray(xr, jnp.float32))
    rows_p = xp.to(torch.float32).numpy()
    for w in (np.array([0.25, 2.0, 0.5], np.float32),
              np.random.default_rng(3).uniform(0.2, 2.0, C).astype(np.float32)):
        ar, er = JAC.approx_channel_batch_aggregate_pallas(
            xj, jnp.asarray(SEEDS), jnp.asarray(npow), jnp.asarray(gains),
            jnp.asarray(w), valid_words=N - 100, interpret=True, **kw)
        ap, ep = TR.approx_channel_batch_aggregate_ref(
            xt, _t(SEEDS, np.int64), _t(npow), _t(gains), _t(w),
            valid_words=N - 100, **kw)
        ar, ap = np.asarray(ar), ap.numpy()
        np.testing.assert_array_equal(ap.view(np.uint32),
                                      _sum_separate(rows_p, w).view(np.uint32))
        np.testing.assert_array_equal(ar.view(np.uint32),
                                      _sum_fma(rows_r, w).view(np.uint32))
        if w[1] == 2.0:  # exact products: fused or not, one result
            np.testing.assert_array_equal(ar.view(np.uint32)[calm],
                                          ap.view(np.uint32)[calm])
        if calm.all():
            np.testing.assert_array_equal(np.asarray(er), ep.numpy())
    # K2 plain == K1 plain + client-order aggregate (bit for bit).
    wn = TA.normalize_weights(_t(w))
    agg = TA.fedsgd_aggregate_batch(xp.to(torch.float32), wn)
    ap_n, _ = TR.approx_channel_batch_aggregate_ref(
        xt, _t(SEEDS, np.int64), _t(npow), _t(gains), wn, **kw)
    np.testing.assert_array_equal(agg.numpy().view(np.uint32),
                                  ap_n.numpy().view(np.uint32))


def test_k2_plain_sums_in_client_order():
    """The contract K2 is held to on the card: at C = 37 (more than one of
    the kernel's client chunks of 32, no multiple of its 8 slots) with
    weights drawn in [0.2, 2], the plain K2 equals a float32 numpy loop of
    one multiply then one add per client, in client order, bit for bit."""
    c = 37
    x = np.random.default_rng(37).uniform(-1, 1, (c, N)).astype(np.float32)
    seeds = np.random.default_rng(38).integers(0, 2**32, c, dtype=np.int64)
    npow = np.full(c, G0 / 10, np.float32)
    gains = np.full(c, G0, np.float32)
    w = np.random.default_rng(39).uniform(0.2, 2.0, c).astype(np.float32)
    kw = dict(bits_per_symbol=2, fading="rayleigh", block_words=BW)
    rows, _ = TR.approx_channel_batch_ref(
        torch.from_numpy(x), torch.from_numpy(seeds), _t(npow), _t(gains),
        **kw)
    agg, _ = TR.approx_channel_batch_aggregate_ref(
        torch.from_numpy(x), torch.from_numpy(seeds), _t(npow), _t(gains),
        _t(w), **kw)
    want = _sum_separate(rows.numpy(), w)
    np.testing.assert_array_equal(agg.numpy().view(np.uint32),
                                  want.view(np.uint32))
    # another order gives other bits: the test can see a reordered sum
    back = _sum_separate(rows.numpy()[::-1], w[::-1])
    assert np.any(back.view(np.uint32) != want.view(np.uint32))


@pytest.mark.parametrize("num_active", [0, 1, 2])
def test_masked_rows(num_active):
    xj, xt = _payload(32, seed=5)
    npow, gains = _link(0.0)
    w = np.array([0.25, 0.5, 0.125], np.float32)  # exact products
    kw = dict(bits_per_symbol=2, block_words=BW)
    xr, er = JAC.approx_channel_batch_pallas(
        xj, jnp.asarray(SEEDS), jnp.asarray(npow), jnp.asarray(gains),
        interpret=True, num_active=jnp.int32(num_active), **kw)
    xp, ep = TR.approx_channel_batch_ref(
        xt, _t(SEEDS, np.int64), _t(npow), _t(gains), num_active=num_active,
        **kw)
    np.testing.assert_array_equal(np.asarray(xr).view(np.uint32),
                                  xp.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(er), ep.numpy())
    assert not xp[num_active:].any() and not ep[num_active:].any()
    ar, er2 = JAC.approx_channel_batch_aggregate_pallas(
        xj, jnp.asarray(SEEDS), jnp.asarray(npow), jnp.asarray(gains),
        jnp.asarray(w), interpret=True, num_active=jnp.int32(num_active),
        **kw)
    ap, ep2 = TR.approx_channel_batch_aggregate_ref(
        xt, _t(SEEDS, np.int64), _t(npow), _t(gains), _t(w),
        num_active=num_active, **kw)
    np.testing.assert_array_equal(np.asarray(ar).view(np.uint32),
                                  ap.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(er2), ep2.numpy())


@pytest.mark.parametrize("n", [700, 1500])
def test_padding_errors_subtracted(n):
    x = np.random.default_rng(n).uniform(-1, 1, (C, n)).astype(np.float32)
    npow, gains = _link(0.0)
    kw = dict(bits_per_symbol=4, fading="rayleigh", block_words=BW,
              clamp_mask=0xBFFFFFFF)
    xr, er = JO.approx_channel_batch(
        jnp.asarray(x), jnp.asarray(SEEDS), jnp.asarray(npow),
        jnp.asarray(gains), interpret=True, **kw)
    xp, ep = TO.approx_channel_batch(
        torch.from_numpy(x), _t(SEEDS, np.int64), _t(npow), _t(gains), **kw)
    assert xp.shape == (C, n)
    np.testing.assert_array_equal(np.asarray(xr).view(np.uint32),
                                  xp.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(er), ep.numpy())
    x1, e1 = JO.approx_channel(
        jnp.asarray(x[1]), jnp.uint32(SEEDS[1]), float(npow[1]), G0,
        interpret=True, **kw)
    t1, f1 = TO.approx_channel(torch.from_numpy(x[1]), int(SEEDS[1]),
                               float(npow[1]), G0, **kw)
    np.testing.assert_array_equal(np.asarray(x1).view(np.uint32),
                                  t1.numpy().view(np.uint32))
    assert int(e1) == int(f1)
    # the single-client plain versions (padded payload, noiseless row 0)
    xr0, er0 = JR.ref_approx_channel(
        jnp.asarray(np.pad(x[0], (0, (-n) % BW))), jnp.uint32(SEEDS[0]),
        jnp.float32(0.0), jnp.float32(G0), **kw)
    xp0, ep0 = TR.ref_approx_channel(
        torch.from_numpy(np.pad(x[0], (0, (-n) % BW))), int(SEEDS[0]), 0.0,
        G0, **kw)
    np.testing.assert_array_equal(np.asarray(xr0).view(np.uint32),
                                  xp0.numpy().view(np.uint32))
    assert int(er0) == int(ep0) == 0


def test_naive_mode_nan_contract():
    """No clamp at 0 dB: received words hit NaN/Inf exponents. The
    aggregate matches bitwise on finite lanes with the same NaN positions."""
    xj, xt = _payload(32, seed=9)
    npow = np.full(C, G0, np.float32)  # 0 dB on every row
    gains = np.full(C, G0, np.float32)
    w = np.array([0.25, 0.5, 0.125], np.float32)  # exact products
    kw = dict(bits_per_symbol=2, fading="rayleigh", clamp_mask=0xFFFFFFFF,
              block_words=BW)
    xr, _ = JAC.approx_channel_batch_pallas(
        xj, jnp.asarray(SEEDS), jnp.asarray(npow), jnp.asarray(gains),
        interpret=True, **kw)
    xp, _, edges = TR.approx_channel_batch_ref(
        xt, _t(SEEDS, np.int64), _t(npow), _t(gains), with_edges=True, **kw)
    assert np.isnan(xp.numpy()).any()
    _edge_rule(np.asarray(xr).view(np.uint32), xp.numpy().view(np.uint32),
               edges.numpy())
    ar, _ = JAC.approx_channel_batch_aggregate_pallas(
        xj, jnp.asarray(SEEDS), jnp.asarray(npow), jnp.asarray(gains),
        jnp.asarray(w), interpret=True, **kw)
    ap, _ = TR.approx_channel_batch_aggregate_ref(
        xt, _t(SEEDS, np.int64), _t(npow), _t(gains), _t(w), **kw)
    ar, ap = np.asarray(ar), ap.numpy()
    calm = np.all(edges.numpy() >= EDGE, axis=0)
    np.testing.assert_array_equal(np.isnan(ar)[calm], np.isnan(ap)[calm])
    fin = calm & ~np.isnan(ap)
    np.testing.assert_array_equal(ar.view(np.uint32)[fin],
                                  ap.view(np.uint32)[fin])


def test_cpu_wrapper_counts_no_launch():
    """CPU tensors run the plain version and are not counted as launches."""
    TAC.reset_launch_counts()
    _, xt = _payload(32)
    npow, gains = _link(10.0)
    TAC.approx_channel_batch_kernel(xt, _t(SEEDS, np.int64), _t(npow),
                                    _t(gains), block_words=BW)
    TAC.approx_channel_batch_aggregate_kernel(
        xt, _t(SEEDS, np.int64), _t(npow), _t(gains),
        torch.full((C,), 1.0 / C), block_words=BW)
    assert TAC.launch_counts() == {"k0": 0, "k1": 0, "k2": 0}


def _extern_c_signatures():
    """``{name: [parameter types]}`` of the ``extern "C"`` entries of the
    kernels' CUDA source, read from the text (no compiler here)."""
    import pathlib
    import re

    src = (pathlib.Path(TAC.__file__).parent / "csrc" /
           "approx_channel.cu").read_text()
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        out[name] = [" ".join(p.split()[:-1]) + ("*" if "*" in p else "")
                     for p in params.split(",")]
    return out


@pytest.mark.parametrize("name", sorted(TAC.SIGNATURES))
def test_binding_matches_cuda_source(name):
    """Each entry's ctypes ``argtypes`` has one type per parameter of its
    ``extern "C"`` declaration: ``c_void_p`` for every pointer (and the
    stream), ``c_int`` / ``c_int64`` / ``c_uint32`` / ``c_float`` for the
    scalars (K0's row length is an ``int64_t``)."""
    import ctypes

    decl = _extern_c_signatures()
    assert set(decl) == set(TAC.SIGNATURES)
    params, argtypes = decl[name], TAC.SIGNATURES[name]
    assert len(params) == len(argtypes)
    scalar = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
              "uint32_t": ctypes.c_uint32, "float": ctypes.c_float}
    for p, t in zip(params, argtypes):
        want = ctypes.c_void_p if p.endswith("*") else scalar[p]
        assert t is want, (name, p, t)


@pytest.mark.parametrize("word_bits", [32, 16])
@pytest.mark.parametrize("row", [0, 1])
def test_cpu_k0_wrapper_vs_pallas(row, word_bits):
    """On CPU tensors ``approx_channel_kernel`` is the plain version: row
    0 noiseless equals the reference's ``approx_channel_pallas`` exactly,
    row 1 at 10 dB under the edge rule; both equal the port's plain K1 on
    the same row as a C=1 batch bit for bit, and no counter moves."""
    xj, xt = _payload(word_bits, seed=20)
    npow, gains = _link(10.0)
    kw = dict(bits_per_symbol=4, fading="block_rayleigh", fade_block=48,
              block_words=BW, word_bits=word_bits,
              clamp_mask=0xBFFF if word_bits == 16 else 0xBFFFFFFF)
    seed, p = int(SEEDS[row]), float(npow[row])
    TAC.reset_launch_counts()
    got, errs = TAC.approx_channel_kernel(xt[row], seed, p, G0, **kw)
    assert TAC.launch_counts() == {"k0": 0, "k1": 0, "k2": 0}
    batch, berrs, edges = TR.approx_channel_batch_ref(
        xt[row:row + 1], _t(SEEDS[row:row + 1], np.int64),
        _t(npow[row:row + 1]), _t(gains[row:row + 1]), with_edges=True,
        **kw)
    gb = _bits(got, word_bits)
    np.testing.assert_array_equal(gb, _bits(batch[0], word_bits))
    assert errs.dtype == torch.int32 and int(errs) == int(berrs[0])
    xr, er = JAC.approx_channel_pallas(
        xj[row], jnp.uint32(SEEDS[row]), jnp.float32(p), jnp.float32(G0),
        interpret=True, **kw)
    rb = _bits(xr, word_bits)
    if row == 0:
        np.testing.assert_array_equal(rb, gb)
        assert int(er) == int(errs) == 0
    elif _edge_rule(rb, gb, edges.numpy()[0]) == 0:
        assert int(er) == int(errs) > 0
