"""The CUDA kernels on the card against their plain PyTorch versions.

Card-only: every test takes the ``cuda_device`` fixture, which skips
without a GPU, and carries the ``cuda`` marker. This file imports neither
``jax`` nor the reference package, so it also runs on a GPU machine
without JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py``; ``tests/conftest.py`` imports JAX).

K1 and K2 must match their plain versions bit for bit: payload words,
error counts and the aggregate. Words may differ only where a demod
pre-round value lies within ``EDGE`` of a half-integer; the noiseless row
must match exactly.

The mixed-mode uplink of link adaptation runs one K1 launch (K2 when
fused) per non-empty uncoded mode bucket, at the bucket's capacity with
its tail masked and per-client SNR: on the card it equals the CPU plain
path under the same edge rule (the noise powers are computed on each
device), and the launch counters move once per bucket.

The downlink broadcast tiles the global model into one dense ``(M, N)``
batch and runs it through K1 on the downlink key lane: at the main-path
shape (100 clients, the paper CNN's 21,840 floats, and 22,528, a whole
number of tiles) it equals the plain K1 on the same tile bit for bit,
and a FedAvg round behind a downlink launches K1 twice (layered) or K1
and K2 once each (fused) and tracks the CPU plain path.

The sparse uplink sends each client's ``k`` selected values as one K1
batch, one zero-padded tile per client: at the main path's ``(100, 437)``
shape it equals the plain K1 on the same tile bit for bit (errors on the
padding subtracted), a compressed round launches K1 once, and error
feedback keeps ``scatter(values) + residual == acc`` bit for bit on the
card, with the CPU's selection on NaN, +-inf, +-0 and ties.

K0's row length is 64-bit: a row of 2**31 + 1,024 words (past K1's and
K2's int limit) matches the plain version on tiles either side of the
counter wrap and of word 2**31, and its flipped bits equal K0's int32
count modulo 2**32.

The layered PHY's channel stage (Gray QAM, the threefry fading and noise,
zero-forcing) is one launch of its own kernel on the card, outside
``launch_counts()``: it equals the eager chain run on the card bit for bit
(``y`` and the gain ``c``, NaN payloads taken as equal) at every
modulation and fading, a scalar or per-row SNR with an inf row, rows of 1,
7 and 349,440 symbols and the FL cell's full ``(100, 349,440)``, and a
layered round launches it once. Its normal of 32 random bits equals
``prng.normal``'s torch ops on every one of the 2**23 mantissas.

The layered PHY and the ECRT chain, which launch none of K0, K1 and K2,
are held against themselves on the CPU: the layered batch under the same edge rule
with the tolerance of ``layered_edge`` (its normals, ``torch.erfinv``, are
the one step that may round differently on the card), a batch row against
the single-client call bit for bit on the card, and LDPC encode, syndrome
and min-sum posteriors bit for bit (integer work, and float work whose
every step is one IEEE operation in a fixed order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import aggregation as TA  # noqa: E402
from repro_torch.core import channel as TCH  # noqa: E402
from repro_torch.core import transport as TT  # noqa: E402
from repro_torch.kernels import approx_channel as TAC  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from test_torch_k0_settle import (  # noqa: E402
    row_symbol_indices, settled_symbols)

G0 = 1e-3
EDGE = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, word_bits=32, c=4, n=4096, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand((c, n), generator=g) * 1.8 - 0.9)
    x = x.to(torch.bfloat16 if word_bits == 16 else torch.float32)
    seeds = torch.tensor([1, 2, 3, 2**32 - 1][:c], dtype=torch.int64)
    npow = torch.tensor([0.0, G0 / 10, G0 / 100, G0][:c])
    gains = torch.full((c,), G0)
    w = torch.tensor([0.25, 0.5, 0.125, 0.125][:c])
    return [t.to(device) for t in (x, seeds, npow, gains, w)]


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("word_bits", [32, 16])
@pytest.mark.parametrize("fading", ["rayleigh", "awgn", "block_rayleigh"])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_kernels_match_plain(cuda_device, k, fading, word_bits):
    x, seeds, npow, gains, w = _inputs(cuda_device, word_bits, seed=k)
    mask = 0xBFFF if word_bits == 16 else 0xBFFFFFFF
    kw = dict(bits_per_symbol=k, fading=fading, clamp_mask=mask,
              word_bits=word_bits)
    xk, ek = TAC.approx_channel_batch_kernel(x, seeds, npow, gains, **kw)
    xp, ep, edges = TR.approx_channel_batch_ref(x, seeds, npow, gains,
                                                with_edges=True, **kw)
    diff = _bits(xk) != _bits(xp)
    assert not diff[0].any()
    assert bool((edges[diff] < EDGE).all())
    ak, ek2 = TAC.approx_channel_batch_aggregate_kernel(
        x, seeds, npow, gains, w, **kw)
    ap, ep2 = TR.approx_channel_batch_aggregate_ref(x, seeds, npow, gains,
                                                    w, **kw)
    calm = (edges >= EDGE).all(dim=0)
    assert torch.equal(_bits(ak)[calm], _bits(ap)[calm])
    if not diff.any():
        assert torch.equal(ek, ep) and torch.equal(ek2, ep2)
    # K2 with normalized weights == K1's rows through the PS aggregate
    wn = TA.normalize_weights(w)
    ak_n, _ = TAC.approx_channel_batch_aggregate_kernel(
        x, seeds, npow, gains, wn, **kw)
    lay = TA.fedsgd_aggregate_batch(xk.float(), w)
    assert torch.equal(_bits(ak_n), _bits(lay))


def _general_inputs(device, c, word_bits, n=2048, seed=0):
    """C clients at 10 dB (row 0 noiseless) with weights drawn in
    [0.2, 2]: unlike powers of two, their products round, so a sum taken
    in another client order shows."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-0.9, 0.9, (c, n)).astype(np.float32))
    x = x.to(torch.bfloat16) if word_bits == 16 else x
    seeds = torch.from_numpy(rng.integers(0, 2**32, c, dtype=np.int64))
    npow = torch.full((c,), G0 / 10)
    npow[0] = 0.0
    gains = torch.full((c,), G0)
    w = torch.from_numpy(rng.uniform(0.2, 2.0, c).astype(np.float32))
    return [t.to(device) for t in (x, seeds, npow, gains, w)]


def _check_k1_k2(x, seeds, npow, gains, w, kw, num_active=None,
                 valid_words=None):
    """K1 and K2 against their plain versions (bit for bit up to the edge
    rule, the noiseless row exact) and K2 against K1's rows summed in
    client order, bit for bit."""
    c = x.shape[0]
    rows = c if num_active is None else min(c, num_active)
    xk, ek = TAC.approx_channel_batch_kernel(x, seeds, npow, gains,
                                             num_active=num_active, **kw)
    xp, ep, edges = TR.approx_channel_batch_ref(
        x, seeds, npow, gains, num_active=num_active, with_edges=True, **kw)
    diff = _bits(xk) != _bits(xp)
    assert not diff[0].any()
    assert bool((edges[diff] < EDGE).all())
    assert not xk[rows:].any() and not ek[rows:].any()
    if not diff.any():
        assert torch.equal(ek, ep)
    ak, ek2 = TAC.approx_channel_batch_aggregate_kernel(
        x, seeds, npow, gains, w, num_active=num_active,
        valid_words=valid_words, **kw)
    ap, ep2 = TR.approx_channel_batch_aggregate_ref(
        x, seeds, npow, gains, w, num_active=num_active,
        valid_words=valid_words, **kw)
    calm = (edges[:rows] >= EDGE).all(dim=0)
    assert torch.equal(_bits(ak)[calm], _bits(ap)[calm])
    if bool(calm.all()):
        assert torch.equal(ek2, ep2)
    assert not ek2[rows:].any()
    # the same rows, summed in client order outside the kernel
    lay = TT._scan_weighted_sum(xk, w, num_active)
    assert torch.equal(_bits(ak), _bits(lay))
    if num_active is None:
        wn = TA.normalize_weights(w)
        ak_n, _ = TAC.approx_channel_batch_aggregate_kernel(
            x, seeds, npow, gains, wn, valid_words=valid_words, **kw)
        lay_n = TA.fedsgd_aggregate_batch(xk.float(), w)
        assert torch.equal(_bits(ak_n), _bits(lay_n))


# Both kernels take clients in chunks of 32, 8 slots of 4 clients each
# (K1 one chunk a block, K2 every chunk in turn): C = 31, 32, 33 straddle
# a chunk, 6 and 37 are no multiple of the 8 slots.
@pytest.mark.cuda
@pytest.mark.parametrize("word_bits", [32, 16])
@pytest.mark.parametrize("c", [1, 6, 31, 32, 33, 37, 100])
def test_client_counts_around_chunks(cuda_device, c, word_bits):
    x, seeds, npow, gains, w = _general_inputs(cuda_device, c, word_bits,
                                               seed=c)
    mask = 0xBFFF if word_bits == 16 else 0xBFFFFFFF
    _check_k1_k2(x, seeds, npow, gains, w,
                 dict(bits_per_symbol=2, clamp_mask=mask,
                      word_bits=word_bits))


@pytest.mark.cuda
@pytest.mark.parametrize("word_bits", [32, 16])
@pytest.mark.parametrize("fading", ["rayleigh", "block_rayleigh"])
@pytest.mark.parametrize("k", [2, 8])
def test_chunk_straddling_sweep(cuda_device, k, fading, word_bits):
    x, seeds, npow, gains, w = _general_inputs(cuda_device, 37, word_bits,
                                               seed=k + word_bits)
    mask = 0xBFFF if word_bits == 16 else 0xBFFFFFFF
    _check_k1_k2(x, seeds, npow, gains, w,
                 dict(bits_per_symbol=k, fading=fading, clamp_mask=mask,
                      word_bits=word_bits))


# num_active = 2 and 6 end inside the first round of the 8 slots, 45 and
# 70 inside a later chunk.
@pytest.mark.cuda
@pytest.mark.parametrize("num_active", [2, 6, 45, 70])
def test_num_active_inside_groups_and_chunks(cuda_device, num_active):
    x, seeds, npow, gains, w = _general_inputs(cuda_device, 100, 32,
                                               seed=num_active)
    _check_k1_k2(x, seeds, npow, gains, w, dict(bits_per_symbol=4),
                 num_active=num_active)


@pytest.mark.cuda
@pytest.mark.parametrize("word_bits", [32, 16])
def test_valid_words_and_ragged_rows(cuda_device, word_bits):
    """Rows of 7 x 300 words (no multiple of a 32-word block) and bit
    errors counted on the first 2,000 only."""
    x, seeds, npow, gains, w = _general_inputs(cuda_device, 37, word_bits,
                                               n=2100, seed=5)
    mask = 0xBFFF if word_bits == 16 else 0xBFFFFFFF
    _check_k1_k2(x, seeds, npow, gains, w,
                 dict(bits_per_symbol=2, fading="block_rayleigh",
                      clamp_mask=mask, block_words=300,
                      word_bits=word_bits),
                 valid_words=2000)


@pytest.mark.cuda
@pytest.mark.parametrize("num_active", [0, 1, 3])
def test_masked_rows_on_card(cuda_device, num_active):
    x, seeds, npow, gains, w = _inputs(cuda_device)
    xk, ek = TAC.approx_channel_batch_kernel(x, seeds, npow, gains,
                                             num_active=num_active)
    xp, ep = TR.approx_channel_batch_ref(x, seeds, npow, gains,
                                         num_active=num_active)
    assert not xk[num_active:].any() and not ek[num_active:].any()
    assert torch.equal(_bits(xk[:1]), _bits(xp[:1]))
    ak, _ = TAC.approx_channel_batch_aggregate_kernel(
        x, seeds, npow, gains, w, num_active=num_active)
    lay = TT._scan_weighted_sum(xk, w, num_active)
    assert torch.equal(_bits(ak), _bits(lay))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [700, 3000])
def test_padding_and_k0_noiseless_match_cpu(cuda_device, n):
    """At noise power 0 no float routine is involved in a decision, so the
    card matches the CPU plain path bit for bit, padding included."""
    x = torch.from_numpy(
        np.random.default_rng(n).uniform(-1, 1, (3, n)).astype(np.float32))
    seeds = torch.tensor([5, 6, 7])
    npow = torch.zeros(3)
    gains = torch.full((3,), G0)
    kw = dict(bits_per_symbol=4, fading="rayleigh")
    xc, ec = TO.approx_channel_batch(x, seeds, npow, gains, **kw)
    xg, eg = TO.approx_channel_batch(x.to(cuda_device), seeds.to(cuda_device),
                                     npow.to(cuda_device),
                                     gains.to(cuda_device), **kw)
    assert torch.equal(_bits(xg.cpu()), _bits(xc))
    assert torch.equal(eg.cpu(), ec)
    x0, e0 = TO.approx_channel(x[1].to(cuda_device), 6, 0.0, G0, **kw)
    assert torch.equal(_bits(x0.cpu()), _bits(xc[1]))
    assert int(e0) == int(ec[1])


@pytest.mark.cuda
def test_launch_counters_move_once_per_launch(cuda_device):
    x, seeds, npow, gains, w = _inputs(cuda_device)
    TAC.reset_launch_counts()
    TAC.approx_channel_batch_kernel(x, seeds, npow, gains)
    TAC.approx_channel_batch_aggregate_kernel(x, seeds, npow, gains, w)
    TAC.approx_channel_batch_kernel(x.cpu(), seeds.cpu(), npow.cpu(),
                                    gains.cpu())
    assert TAC.launch_counts() == {"k0": 0, "k1": 1, "k2": 1}
    # K0 launches its own row kernel: its counter moves, K1's does not
    TAC.approx_channel_kernel(x[1].contiguous(), 7, float(npow[1]), G0)
    assert TAC.launch_counts() == {"k0": 1, "k1": 1, "k2": 1}


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda_device):
    x, seeds, npow, gains, w = _inputs(cuda_device)
    with pytest.raises(ValueError, match="float32"):
        TAC.approx_channel_batch_kernel(x.double(), seeds, npow, gains)
    with pytest.raises(ValueError, match="contiguous"):
        TAC.approx_channel_batch_kernel(x.t(), seeds, npow, gains)
    with pytest.raises(ValueError, match="block_words"):
        TAC.approx_channel_batch_kernel(x[:, :1000].contiguous(), seeds,
                                        npow, gains)
    with pytest.raises(ValueError, match="weights"):
        TAC.approx_channel_batch_aggregate_kernel(x, seeds, npow, gains,
                                                  w[:2])
    TAC.reset_launch_counts()
    with pytest.raises(ValueError, match="float32"):
        TAC.approx_channel_kernel(x[0].double(), 7, 0.0, G0)
    with pytest.raises(ValueError, match="block_words"):
        TAC.approx_channel_kernel(x[0, :1000].contiguous(), 7, 0.0, G0)
    assert TAC.launch_counts() == {"k0": 0, "k1": 0, "k2": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_run_fl_launches_once_per_round(cuda_device, fused):
    from repro_torch.configs.mnist_cnn import config
    from repro_torch.fl.loop import run_fl

    rng = np.random.default_rng(0)
    cx = rng.uniform(0, 1, (4, 16, 28, 28)).astype(np.float32)
    cy = rng.integers(0, 10, (4, 16)).astype(np.int32)
    cfg = TT.TransportConfig(mode="approx", use_kernel=True,
                             channel=TCH.ChannelConfig(snr_db=10.0))
    TAC.reset_launch_counts()
    res = run_fl(config(), cfg, cx, cy, cx[0], cy[0], n_rounds=2,
                 batch_per_round=8, eval_every=1, fused_aggregate=fused)
    want = ({"k0": 0, "k1": 0, "k2": 2} if fused
            else {"k0": 0, "k1": 2, "k2": 0})
    assert TAC.launch_counts() == want
    assert all(np.isfinite(res.accuracy))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 100])
def test_key_schedule_on_card_equals_cpu(cuda_device, c):
    from repro_torch.core import prng as P

    for dev in ("cpu", cuda_device):
        key = P.split(P.PRNGKey(11, device=dev))[1]
        keys = TT.client_keys(key, c, offset=3)
        seeds = TO._seed_from_key(keys)
        assert keys.device.type == seeds.device.type == torch.device(dev).type
        if dev == "cpu":
            want = (keys, seeds)
    assert torch.equal(keys.cpu(), want[0])
    assert torch.equal(seeds.cpu(), want[1])


def layered_edge(levels):
    """Decision margin within which a layered-PHY word may differ between
    devices: normals agree to 128 ULP, so a pre-round value inside the
    grid (``|y/a| <= 2L``) moves by at most ``L * 3.1e-5``; this doubles
    it."""
    return levels * 2.0**-14


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["naive", "approx"])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("fading", ["rayleigh", "awgn", "block_rayleigh"])
@pytest.mark.parametrize("mod", ["qpsk", "16qam", "256qam"])
def test_layered_batch_card_vs_cpu(cuda_device, mod, fading, wire, mode):
    from repro_torch.core import prng as P

    c, n = 4, 1024
    x = torch.rand((c, n), generator=torch.Generator().manual_seed(3))
    x = x * 1.8 - 0.9
    snr = (float("inf"), 10.0, 20.0, 5.0)  # row 0 noiseless: Exact
    cfg = TT.TransportConfig(
        mode=mode, modulation=mod, wire_dtype=wire,
        channel=TCH.ChannelConfig(snr_db=snr, fading=fading))
    key = P.PRNGKey(21)
    xg, sg = TT.transmit_batch(x, key, cfg, device=cuda_device)
    xc, sc = TT.transmit_batch(x, key, cfg, device="cpu")
    xg = xg.cpu()
    diff = (_bits(xg) != _bits(xc)) & ~(torch.isnan(xg) & torch.isnan(xc))
    assert not diff[0].any()
    for f in ("data_symbols", "transmissions", "n_bits", "bits_on_air"):
        assert torch.equal(getattr(sg, f).cpu(), getattr(sc, f))
    if diff.any():
        margins = TT._word_margins(x, TT.client_keys(key, c), cfg,
                                   TCH.snr_db_vector(snr, c))
        levels = TT.TransportConfig(modulation=mod).scheme.levels
        assert float(margins[diff].max()) < layered_edge(levels)
    else:
        assert torch.equal(sg.bit_errors.cpu(), sc.bit_errors)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [0, 300])
@pytest.mark.parametrize("mode", ["approx", "ecrt"])
def test_batch_row_equals_flat_on_card(cuda_device, mode, chunk):
    from repro_torch.core import prng as P

    x = torch.rand((3, 700), generator=torch.Generator().manual_seed(4)) - 0.5
    cfg = TT.TransportConfig(mode=mode, chunk_elems=chunk,
                             channel=TCH.ChannelConfig(snr_db=3.0))
    key = P.PRNGKey(22)
    xb, sb = TT.transmit_batch(x, key, cfg, device=cuda_device)
    for c in range(3):
        xf, sf = TT.transmit_flat(x[c], P.fold_in(key, c), cfg,
                                  device=cuda_device)
        assert torch.equal(_bits(xf), _bits(xb[c]))
        for f in ("data_symbols", "transmissions", "bit_errors", "n_bits",
                  "bits_on_air"):
            assert torch.equal(getattr(sf, f), getattr(sb, f)[c])


@pytest.mark.cuda
def test_ecrt_encode_decode_card_vs_cpu(cuda_device):
    from repro_torch.core import ecrt as TE
    from repro_torch.core import prng as P

    code = TE.LdpcCode()
    msgs = P.randint(P.PRNGKey(23), (6, code.k), 0, 2)
    cw = TE.encode(msgs, code)
    cw_g = TE.encode(msgs.to(cuda_device), code)
    assert torch.equal(cw_g.cpu(), cw)
    assert bool(TE.syndrome_ok(cw_g, code).all())
    rng = np.random.default_rng(5)
    llr = (1.0 - 2.0 * cw.numpy()) * 2.0 + rng.standard_normal(cw.shape) * 2
    llr = torch.from_numpy(llr.astype(np.float32))
    post = TE._minsum_posterior(llr, code)
    post_g = TE._minsum_posterior(llr.to(cuda_device), code).cpu()
    assert torch.equal(_bits(post_g), _bits(post))
    hard_g, ok_g = TE.decode(llr.to(cuda_device), code)
    hard, ok = TE.decode(llr, code)
    assert torch.equal(hard_g.cpu(), hard) and torch.equal(ok_g.cpu(), ok)


@pytest.mark.cuda
def test_ecrt_real_on_card_returns_payload(cuda_device):
    from repro_torch.core import prng as P

    x = torch.randn((2, 300), generator=torch.Generator().manual_seed(6))
    cfg = TT.TransportConfig(mode="ecrt", channel=TCH.ChannelConfig(
        snr_db=3.0, fading="block_rayleigh"))
    xg, sg = TT.transmit_batch(x, P.PRNGKey(24), cfg, device=cuda_device)
    xc, sc = TT.transmit_batch(x, P.PRNGKey(24), cfg, device="cpu")
    assert torch.equal(xg.cpu(), x) and torch.equal(xc, x)
    assert bool((sg.transmissions >= 1).all())
    assert not sg.bit_errors.any()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["approx", "naive", "ecrt"])
def test_fig3_arms_launch_no_kernel(cuda_device, mode):
    from repro_torch.configs.mnist_cnn import config
    from repro_torch.fl.loop import run_fl

    rng = np.random.default_rng(0)
    cx = rng.uniform(0, 1, (4, 16, 28, 28)).astype(np.float32)
    cy = rng.integers(0, 10, (4, 16)).astype(np.int32)
    cfg = TT.TransportConfig(mode=mode, channel=TCH.ChannelConfig(snr_db=10.0))
    TAC.reset_launch_counts()
    res = run_fl(config(), cfg, cx, cy, cx[0], cy[0], n_rounds=2,
                 batch_per_round=8, eval_every=1)
    assert TAC.launch_counts() == {"k0": 0, "k1": 0, "k2": 0}
    assert all(np.isfinite(res.accuracy))
    assert all(np.isfinite(res.airtime_s))


def _adaptive_world(m=37, n=3000, seed=0):
    """A kernel mode table (ECRT row at a fixed E[tx]), per-client SNR,
    modes with every row present and an empty ECRT-free stretch."""
    from repro_torch.link import policy as TP

    base = TT.TransportConfig(mode="approx", use_kernel=True,
                              channel=TCH.ChannelConfig(snr_db=10.0))
    cfgs = TP.build_mode_cfgs(base, TP.PolicyConfig(), ecrt_expected_tx=2.0,
                              device="cpu")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-0.9, 0.9, (m, n)).astype(np.float32))
    modes = rng.integers(0, 4, m)
    snr = torch.from_numpy(rng.uniform(0, 30, m).astype(np.float32))
    return cfgs, x, modes, snr


def _uncoded_buckets(cfgs, modes):
    return sum(1 for mm, c in enumerate(cfgs)
               if c.mode in ("approx", "naive") and (modes == mm).any())


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_adaptive_bucketed_card_vs_cpu(cuda_device, fused):
    from repro_torch.core import aggregation as TAG
    from repro_torch.core import prng as P

    cfgs, x, modes, snr = _adaptive_world(seed=int(fused))
    key = P.PRNGKey(21)
    TAC.reset_launch_counts()
    if fused:
        w = TAG.normalize_weights(torch.ones(x.shape[0]))
        ag, sg = TT.transmit_batch_adaptive_aggregate(
            x, key, cfgs, modes, w.to(cuda_device), snr_db=snr)
    else:
        xg, sg = TT.transmit_batch_adaptive(x, key, cfgs, modes, snr_db=snr)
    counts = TAC.launch_counts()
    want = _uncoded_buckets(cfgs, modes)
    assert counts == {"k0": 0, "k1": 0 if fused else want,
                      "k2": want if fused else 0}
    xc, sc = TT.transmit_batch_adaptive(x, key, cfgs, modes, snr_db=snr,
                                        device="cpu")
    keys = TT.client_keys(key, x.shape[0])
    edges = torch.full(x.shape, float("inf"))
    for mm, cfg in enumerate(cfgs):
        idx = torch.from_numpy(np.nonzero(modes == mm)[0])
        if idx.numel() == 0 or cfg.mode == "ecrt":
            continue
        n = x.shape[1]
        xp = torch.nn.functional.pad(x[idx], (0, (-n) % 1024))
        wb, mask, k = TT._transport_kernel_params(cfg)
        npow, gains = TT._link_params(cfg, idx.numel(), snr[idx],
                                      torch.device("cpu"))
        _, _, e = TR.approx_channel_batch_ref(
            xp, TO._seed_from_key(keys[idx]), npow, gains, bits_per_symbol=k,
            clamp_mask=mask, with_edges=True)
        edges[idx] = e[:, :n]
    for f in ("data_symbols", "transmissions", "n_bits", "bits_on_air",
              "mode_idx"):
        assert torch.equal(getattr(sg, f).cpu(), getattr(sc, f))
    if fused:
        calm = (edges >= EDGE).all(dim=0)
        lay = TT._bucketed_adaptive_aggregate(
            x, keys, cfgs, modes, TCH.snr_db_vector(snr, x.shape[0]),
            w)[0]
        assert torch.equal(_bits(ag.cpu())[calm], _bits(lay)[calm])
    else:
        diff = _bits(xg.cpu()) != _bits(xc)
        assert bool((edges[diff] < EDGE).all())
        if not bool(diff.any()):
            assert torch.equal(sg.bit_errors.cpu(), sc.bit_errors)


@pytest.mark.cuda
def test_adaptive_select_launches_nothing_and_equals_bucketed(cuda_device):
    from repro_torch.core import prng as P

    cfgs, x, modes, snr = _adaptive_world(m=20, n=1500, seed=3)
    cleared = TT.clear_kernel_rows(cfgs)
    TAC.reset_launch_counts()
    xs, ss = TT.transmit_batch_adaptive(x, P.PRNGKey(2), cleared, modes,
                                        snr_db=snr, dispatch="select")
    assert TAC.launch_counts() == {"k0": 0, "k1": 0, "k2": 0}
    xb, sb = TT.transmit_batch_adaptive(x, P.PRNGKey(2), cleared, modes,
                                        snr_db=snr, dispatch="bucketed")
    assert torch.equal(_bits(xs), _bits(xb))
    assert torch.equal(ss.bit_errors, sb.bit_errors)
    with pytest.raises(ValueError, match="select"):
        TT.transmit_batch_adaptive(x, P.PRNGKey(2), cfgs, modes,
                                   dispatch="select")


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_scenario_run_fl_launches_once_per_bucket(cuda_device, fused):
    import dataclasses

    from repro_torch.configs.mnist_cnn import config
    from repro_torch.fl.loop import run_fl
    from repro_torch.link import scenario as TS

    rng = np.random.default_rng(0)
    cx = rng.uniform(0, 1, (12, 16, 28, 28)).astype(np.float32)
    cy = rng.integers(0, 10, (12, 16)).astype(np.int32)
    cfg = TT.TransportConfig(mode="approx", use_kernel=True,
                             channel=TCH.ChannelConfig(snr_db=10.0))
    scen = dataclasses.replace(TS.get_scenario("vehicular"),
                               ecrt_expected_tx=2.0)
    TAC.reset_launch_counts()
    res = run_fl(config(), cfg, cx, cy, cx[0], cy[0], n_rounds=3,
                 batch_per_round=8, eval_every=1, scenario=scen,
                 fused_aggregate=fused)
    buckets = sum(sum(1 for c in r["mode_counts"][1:] if c)
                  for r in res.link)
    want = ({"k0": 0, "k1": 0, "k2": buckets} if fused
            else {"k0": 0, "k1": buckets, "k2": 0})
    assert buckets > 0 and TAC.launch_counts() == want
    b = run_fl(config(), cfg, cx, cy, cx[0], cy[0], n_rounds=3,
               batch_per_round=8, eval_every=1, scenario=scen,
               fused_aggregate=fused, device="cpu")
    assert [r["mode_counts"] for r in res.link] == [
        r["mode_counts"] for r in b.link]
    assert all(abs(p - q) <= 2 / 16 + 1e-6
               for p, q in zip(res.accuracy, b.accuracy))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [21840, 22528])
def test_broadcast_k1_matches_plain(cuda_device, n):
    from repro_torch.core import prng as P

    c = 100
    x = (torch.randn((n,), generator=torch.Generator().manual_seed(n))
         * 1e-2).to(cuda_device)
    cfg = TT.TransportConfig(mode="approx", use_kernel=True,
                             channel=TCH.ChannelConfig(snr_db=10.0))
    key = P.PRNGKey(3)
    TAC.reset_launch_counts()
    xg, sg = TT.transmit_broadcast(x, key, cfg, c)
    assert TAC.launch_counts() == {"k0": 0, "k1": 1, "k2": 0}
    keys = TT.client_keys(key, c, TT.DOWNLINK_KEY_LANE)
    seeds = TO._seed_from_key(keys).to(cuda_device)
    npow, gains = TT._link_params(cfg, c, None, cuda_device)
    tile = torch.nn.functional.pad(x.expand(c, n), (0, (-n) % 1024))
    xp, ep, edges = TR.approx_channel_batch_ref(
        tile, seeds, npow, gains, with_edges=True)
    diff = _bits(xg) != _bits(xp[:, :n])
    assert bool((edges[:, :n][diff] < EDGE).all())
    if not bool(diff.any()):
        pad = TO._padding_errors(xp[:, n:], 32)
        assert torch.equal(sg.bit_errors.to(torch.int32),
                           (ep - pad).to(torch.int32))
    # the card against the CPU plain path, under the same edge rule
    xc, sc = TT.transmit_broadcast(x.cpu(), key, cfg, c, device="cpu")
    assert torch.equal(sg.n_bits.cpu(), sc.n_bits)
    diff_cpu = _bits(xg.cpu()) != _bits(xc)
    assert bool((edges.cpu()[:, :n][diff_cpu] < EDGE).all())


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_fedavg_downlink_round_card_vs_cpu(cuda_device, fused):
    from repro_torch.configs.mnist_cnn import config
    from repro_torch.fl.fedavg import run_fedavg
    from repro_torch.link import scenario as TS

    rng = np.random.default_rng(1)
    cx = rng.uniform(0, 1, (4, 16, 28, 28)).astype(np.float32)
    cy = rng.integers(0, 10, (4, 16)).astype(np.int32)
    cfg = TT.TransportConfig(mode="approx", use_kernel=True,
                             channel=TCH.ChannelConfig(snr_db=10.0))
    kw = dict(n_rounds=2, local_steps=2, batch_per_step=8, eval_every=1,
              fused_aggregate=fused,
              downlink=TS.DownlinkConfig(mode="approx", snr_offset_db=3.0))
    TAC.reset_launch_counts()
    a = run_fedavg(config(), cfg, cx, cy, cx[0], cy[0], **kw)
    want = ({"k0": 0, "k1": 2, "k2": 2} if fused
            else {"k0": 0, "k1": 4, "k2": 0})
    assert TAC.launch_counts() == want
    b = run_fedavg(config(), cfg, cx, cy, cx[0], cy[0], device="cpu", **kw)
    assert [list(r) for r in a.link] == [list(r) for r in b.link]
    # round 0 broadcasts the same model through K1 and its plain version
    assert a.link[0]["downlink_ber"] == pytest.approx(
        b.link[0]["downlink_ber"], abs=1e-4)
    assert all(abs(p - q) <= 2 / 16 + 1e-6
               for p, q in zip(a.accuracy, b.accuracy))
    assert a.airtime_s == pytest.approx(b.airtime_s, rel=1e-6)
    assert set(a.phase_s[0]) >= {"downlink", "downlink_keys",
                                 "downlink_kernel"}


@pytest.mark.cuda
@pytest.mark.parametrize("k", [437, 218, 2184])
def test_sparse_value_leg_k1_matches_plain(cuda_device, k):
    """``(100, k)`` values on the clients' keys through the sparse batch
    (one K1 launch): the plain K1 on the zero-padded tile, bit for bit."""
    from repro_torch.compress import framing as TF
    from repro_torch.core import prng as P

    c, dim = 100, 21840
    g = torch.Generator().manual_seed(k)
    vals = (torch.randn((c, k), generator=g) * 1e-2).to(cuda_device)
    idx = torch.sort(torch.rand((c, dim), generator=g).argsort(dim=1)[:, :k],
                     dim=1).values.to(cuda_device)
    cfg = TT.TransportConfig(mode="approx", use_kernel=True,
                             channel=TCH.ChannelConfig(snr_db=10.0))
    key = P.PRNGKey(5)
    TAC.reset_launch_counts()
    dense, st = TF.transmit_sparse_batch(
        vals, idx, dim, key, cfg, TF.sparsify_lib.CompressionConfig(
            header="perfect"))
    assert TAC.launch_counts() == {"k0": 0, "k1": 1, "k2": 0}
    keys = TT.client_keys(key, c)
    xg, sg = TT._batch_with_keys(vals, keys, cfg, None)
    seeds = TO._seed_from_key(keys).to(cuda_device)
    npow, gains = TT._link_params(cfg, c, None, cuda_device)
    tile = torch.nn.functional.pad(vals, (0, (-k) % 1024))
    xp, ep = TR.approx_channel_batch_ref(tile, seeds, npow, gains)
    assert torch.equal(_bits(xg), _bits(xp[:, :k]))
    assert torch.equal(sg.bit_errors.to(torch.int32),
                       (ep - TO._padding_errors(xp[:, k:], 32)).to(
                           torch.int32))
    # the dense rows hold the received values at the sent indices
    assert torch.equal(_bits(dense.gather(1, idx)), _bits(xg))
    assert int(st.bits_on_air[0]) == 32 * k + -(-15 * k // 2) * 2


@pytest.mark.cuda
def test_error_feedback_identity_on_card(cuda_device):
    from repro_torch.compress import sparsify as TS

    m, d, k = 100, 21840, 437
    g = torch.Generator().manual_seed(3)
    res = (torch.randn((m, d), generator=g) * 1e-2).to(cuda_device)
    grads = (torch.round(torch.randn((m, d), generator=g) * 64)
             / 2**12).to(cuda_device)
    active = (torch.arange(m) % 7 != 3).float().to(cuda_device)
    for method in ("topk", "randk", "threshold"):
        cfg = TS.CompressionConfig(method=method, k=k, threshold=0.01)
        keys = TS.selection_keys(torch.tensor([0, 9]), m)
        vals, idx, new = TS.ef_select_batch(res, grads, k, cfg, keys,
                                            active=active)
        acc = res + grads
        sent = TS.scatter_dense_batch(vals, idx, d)
        on = active.bool()
        assert torch.equal(_bits((sent + new)[on]), _bits(acc[on]))
        assert torch.equal(_bits(new[~on]), _bits(acc[~on]))
        vc, ic, nc = TS.ef_select_batch(res.cpu(), grads.cpu(), k, cfg, keys,
                                        active=active.cpu())
        assert torch.equal(idx.cpu(), ic)
        assert torch.equal(_bits(new.cpu()), _bits(nc))
    special = grads.clone()
    special[:, :6] = torch.tensor([float("nan"), float("inf"),
                                   float("-inf"), 0.0, -0.0, float("nan")])
    assert torch.equal(TS.select_topk(special, k)[1].cpu(),
                       TS.select_topk(special.cpu(), k)[1])


@pytest.mark.cuda
def test_compressed_round_launches_k1_once(cuda_device):
    from repro_torch.compress import sparsify as TS
    from repro_torch.configs.mnist_cnn import config
    from repro_torch.fl.loop import run_fl

    rng = np.random.default_rng(2)
    cx = rng.uniform(0, 1, (4, 16, 28, 28)).astype(np.float32)
    cy = rng.integers(0, 10, (4, 16)).astype(np.int32)
    cfg = TT.TransportConfig(mode="approx", use_kernel=True,
                             channel=TCH.ChannelConfig(snr_db=10.0))
    kw = dict(n_rounds=2, batch_per_round=8, eval_every=1,
              compression=TS.CompressionConfig())
    TAC.reset_launch_counts()
    a = run_fl(config(), cfg, cx, cy, cx[0], cy[0], **kw)
    assert TAC.launch_counts() == {"k0": 0, "k1": 2, "k2": 0}
    b = run_fl(config(), cfg, cx, cy, cx[0], cy[0], device="cpu", **kw)
    assert [r["comp_bits_on_air"] for r in a.link] == [
        r["comp_bits_on_air"] for r in b.link] == [4 * 20540.0] * 2
    assert all(abs(p - q) <= 2 / 16 + 1e-6
               for p, q in zip(a.accuracy, b.accuracy))


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_sinks_are_neutral_on_card(cuda_device, fused, tmp_path):
    """A 6-client ``vehicular`` bucketed run on the card with a ledger,
    phase timers and sketches equals the run without them bit for bit:
    params, accuracy, airtime, link and K1/K2 launches; the ledger
    validates and its provenance names the card."""
    import dataclasses

    from repro_torch.configs.mnist_cnn import config
    from repro_torch.fl import engine as TE
    from repro_torch.link import scenario as TS
    from repro_torch.obs import PhaseTimers
    from repro_torch.obs import ledger as TL

    rng = np.random.default_rng(0)
    cx = rng.uniform(0, 1, (6, 16, 28, 28)).astype(np.float32)
    cy = rng.integers(0, 10, (6, 16)).astype(np.int32)
    cfg = TT.TransportConfig(mode="approx", use_kernel=True,
                             channel=TCH.ChannelConfig(snr_db=10.0))
    scen = dataclasses.replace(TS.get_scenario("vehicular"),
                               ecrt_expected_tx=2.0)
    path = str(tmp_path / "card.jsonl")
    runs = []
    for sinks in (dict(ledger=path, phase_timers=PhaseTimers(),
                       sketches=True), {}):
        TAC.reset_launch_counts()
        eng = TE.RoundEngine(TE.FedSGD(config(), batch_per_round=8), cfg,
                             cx, cy, cx[0], cy[0], n_rounds=3, eval_every=1,
                             scenario=scen, fused_aggregate=fused, **sinks)
        runs.append((eng, eng.run(), TAC.launch_counts()))
    (ea, a, la), (eb, b, lb) = runs
    assert la == lb and la["k2" if fused else "k1"] > 0
    for k in ea.params:
        assert torch.equal(ea.params[k], eb.params[k]), k
    assert (a.accuracy, a.airtime_s, a.link) == (b.accuracy, b.airtime_s,
                                                 b.link)
    for rec in a.records:
        assert rec.sketches["ber"]["total"] == rec.n_active
        assert rec.sketches["snr_db"]["total"] == 6
    assert TL.validate_ledger(path) == []
    assert TL.read_ledger(path).link == a.link
    prov = TL.read_ledger(path).manifest["provenance"]
    assert prov["backend"] == "cuda"
    assert prov["device"] == torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_round_group_card_equals_cpu(cuda_device):
    """The sketch reduction on the card equals the CPU's on the same
    per-client arrays and round keys, over rounds that carry the mode
    dwell: counts, exemplars, NaN / +-inf / +-0 / edge values and ties."""
    import json

    from repro_torch.core import prng as P
    from repro_torch.obs import metrics as TM

    n, r = 100, np.random.default_rng(4)
    edges = TM.DEFAULT_LAYOUTS["snr_db"].edges().astype(np.float32)
    card = TM.RoundSketcher(n, exemplar_k=6, device=cuda_device)
    host = TM.RoundSketcher(n, exemplar_k=6, device="cpu")
    mode = r.integers(0, 4, n)
    for rnd in range(4):
        snr = r.uniform(-25, 65, n).astype(np.float32)
        snr[:8] = [np.nan, np.inf, -np.inf, 0.0, -0.0, edges[3], edges[20],
                   edges[-1]]
        ber = (10.0 ** r.uniform(-10, 0.3, n)).astype(np.float32)
        ber[r.random(n) < 0.4] = 0.0
        ber[8:12] = [np.nan, 1.0, 0.5, 0.5]
        mode = np.where(r.random(n) < 0.3, r.integers(0, 4, n), mode)
        arrs = dict(snr_db=snr, est_db=snr + 0.5, ber=ber,
                    airtime_s=(10.0 ** r.uniform(-8, 3.5, n)).astype(
                        np.float32),
                    mode=mode.astype(np.int32),
                    active=(r.random(n) > 0.2).astype(np.float32),
                    downlink_ber=ber[::-1].copy())
        key = P.fold_in(P.PRNGKey(5), rnd)
        got = card.round_group(
            key.to(cuda_device),
            **{k: torch.from_numpy(v).to(cuda_device)
               for k, v in arrs.items()})
        want = host.round_group(key, **{k: torch.from_numpy(v)
                                        for k, v in arrs.items()})
        assert json.dumps(got) == json.dumps(want), rnd
    assert card.summary() == host.summary()


def _buffered_world(n, seed=0):
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, 1, (n, 16, 28, 28)).astype(np.float32)
    cy = rng.integers(0, 10, (n, 16)).astype(np.int32)
    return cx, cy, cx[0], cy[0]


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_degenerate_buffered_equals_sync_on_card(cuda_device, fused):
    """``buffer_k = None``, the default compute model and constant weights:
    the buffered run on the card is the sync run on the card bit for bit
    (params, accuracy, airtime, launches), driverless and ``vehicular``
    bucketed, layered (K1) and fused (K2)."""
    import dataclasses

    from repro_torch.configs.mnist_cnn import config
    from repro_torch.fl import AsyncRoundEngine
    from repro_torch.fl import engine as TE
    from repro_torch.link import scenario as TS

    world = _buffered_world(6)
    cfg = TT.TransportConfig(mode="approx", use_kernel=True,
                             channel=TCH.ChannelConfig(snr_db=10.0))
    scen = dataclasses.replace(TS.get_scenario("vehicular"),
                               ecrt_expected_tx=2.0)
    for sc in (None, scen):
        runs = []
        for cls in (TE.RoundEngine, AsyncRoundEngine):
            TAC.reset_launch_counts()
            eng = cls(TE.FedSGD(config(), batch_per_round=8), cfg, *world,
                      n_rounds=3, eval_every=1, scenario=sc,
                      fused_aggregate=fused)
            runs.append((eng, eng.run(), TAC.launch_counts()))
        (ea, a, la), (eb, b, lb) = runs
        assert la == lb and la["k2" if fused else "k1"] >= 3
        for k in ea.params:
            assert torch.equal(ea.params[k], eb.params[k]), k
        assert (a.accuracy, a.airtime_s, a.link) == (b.accuracy, b.airtime_s,
                                                     b.link)
        assert len(b.event_s) == 3 and len(b.phase_s) == 3


@pytest.mark.cuda
def test_metro_rush_buffered_card_vs_cpu(cuda_device):
    """A 6-client ``metro-rush`` buffered run (``buffer_k=2``, polynomial):
    the event schedule lives on the host, so the card's schedule,
    ``event_s`` and link records equal the CPU's; accuracy within 2 of 16
    test images."""
    import dataclasses

    from repro_torch.configs.mnist_cnn import config
    from repro_torch.fl import run_fl_buffered
    from repro_torch.link import scenario as TS
    from repro_torch.obs import trace as TTR

    world = _buffered_world(6, seed=2)
    cfg = TT.TransportConfig(mode="approx", use_kernel=True,
                             channel=TCH.ChannelConfig(snr_db=10.0))
    scen = dataclasses.replace(TS.get_scenario("metro-rush"),
                               ecrt_expected_tx=2.0)
    kw = dict(n_rounds=4, batch_per_round=8, eval_every=1, seed=11,
              scenario=scen, buffer_k=2, staleness="polynomial")
    runs = []
    for dev in (cuda_device, "cpu"):
        tr = TTR.TraceRecorder()
        TAC.reset_launch_counts()
        res = run_fl_buffered(config(), cfg, *world, trace=tr, device=dev,
                              **kw)
        runs.append((res, tr, TAC.launch_counts()))
    (a, ta, la), (b, tb, lb) = runs
    assert la["k1"] > 0 and lb == {"k0": 0, "k1": 0, "k2": 0}
    assert [(e.kind, e.wave, e.client, e.version) for e in ta.events] == [
        (e.kind, e.wave, e.client, e.version) for e in tb.events]
    assert a.event_s == pytest.approx(b.event_s, rel=1e-6)
    assert [list(r) for r in a.link] == [list(r) for r in b.link]
    for f in ("mode_counts", "n_active", "n_stragglers"):
        assert [r[f] for r in a.link] == [r[f] for r in b.link], f
    assert all(abs(p - q) <= 2 / 16 + 1e-6
               for p, q in zip(a.accuracy, b.accuracy))


# ------------------------------------------- the LLM trainer and server


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 2048 + 700])
def test_k0_short_rows_match_plain(cuda_device, n):
    """K0 on a two-tile row and a padded three-tile row, with noise: the
    plain version's words and errors bit for bit."""
    g = torch.Generator().manual_seed(n)
    x = (torch.rand(n, generator=g) * 1.8 - 0.9).to(cuda_device)
    seed = torch.tensor(123456789, dtype=torch.int64)
    npow = torch.tensor(1e-4)
    before = TAC.launch_counts()["k0"]
    got, errs = TO.approx_channel(x, seed.to(cuda_device),
                                  npow.to(cuda_device), G0)
    assert TAC.launch_counts()["k0"] == before + 1
    pad = (-n) % 1024
    want, werrs = TR.ref_approx_channel(
        torch.nn.functional.pad(x.cpu(), (0, pad)), seed, npow,
        torch.tensor(G0))
    assert torch.equal(_bits(got.cpu()), _bits(want[:n]))
    assert int(errs) == int(werrs) - int(TO._padding_errors(
        want[None, n:], 32)[0]) and int(errs) > 0


def _k0_row(device, n, word_bits=32, seed=0, snr_db=10):
    """A noisy link at ``snr_db`` and an ``(n,)`` payload in [-0.9, 0.9]
    on ``device``."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand(n, generator=g) * 1.8 - 0.9).to(
        torch.bfloat16 if word_bits == 16 else torch.float32)
    return (x.to(device), torch.tensor(2**32 - 12345, dtype=torch.int64),
            torch.tensor(G0 / 10 ** (snr_db / 10), device=device),
            torch.tensor(G0, device=device))


def _k0_against_plain(x, seed, npow, gain, some_errors=True, **kw):
    """K0's row kernel on ``x`` and the plain version on the card: one K0
    launch, no K1 launch, the same words bit for bit, the same int32
    errors (some, unless ``some_errors`` is False: a link so clean that
    the plain version flips no bit)."""
    before = TAC.launch_counts()
    got, errs = TAC.approx_channel_kernel(x, seed, npow, gain, **kw)
    after = TAC.launch_counts()
    assert after == dict(before, k0=before["k0"] + 1)
    want, werrs = TR.ref_approx_channel(x, seed.to(x.device), npow, gain,
                                        **kw)
    assert torch.equal(_bits(got), _bits(want))
    assert errs.dtype == torch.int32 and int(errs) == int(werrs)
    assert (int(errs) > 0) == some_errors
    return got


def _k0_counted(device, launch):
    """``launch()`` inside a ``spans.counting`` scope: its result, and
    whether K0 ran the full chain on every symbol (``row_full``: the
    link's settling test off, as at QPSK 3 dB, rho 0.81)."""
    from repro_torch.obs import spans

    with spans.counting(device) as counts:
        out = launch()
        torch.cuda.synchronize()
    return out, counts["k0_symbols_slow"] == counts["k0_symbols"]


@pytest.mark.cuda
@pytest.mark.parametrize("snr_db", [-10, 0, 10, 30])
@pytest.mark.parametrize("word_bits", [32, 16])
@pytest.mark.parametrize("fading", ["rayleigh", "awgn", "block_rayleigh"])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_k0_row_kernel_matches_plain(cuda_device, k, fading, word_bits,
                                     snr_db):
    """Every (k, fading, word_bits) instance of K0's row kernel on a
    three-tile row against the plain version, and against K1's row 0 of
    the same payload as a C=1 batch: at -10 and 0 dB the settling test is
    off for every k (the full chain on every symbol), at 10 dB on for
    QPSK (m = 4), at 30 dB on for every k (m = 16, 16 and 4), where AWGN
    QPSK and 16-QAM flip no bit in the plain version either."""
    x, seed, npow, gain = _k0_row(cuda_device, 3 * 1024, word_bits, seed=k,
                                  snr_db=snr_db)
    kw = dict(bits_per_symbol=k, fading=fading, word_bits=word_bits,
              fade_block=48,
              clamp_mask=0xBFFF if word_bits == 16 else 0xBFFFFFFF)
    clean = fading == "awgn" and snr_db == 30 and k < 8
    got = _k0_against_plain(x, seed, npow, gain, some_errors=not clean, **kw)
    via_k1, _ = TAC.approx_channel_batch_kernel(
        x[None], seed.reshape(1).to(cuda_device), npow.reshape(1),
        gain.reshape(1), **kw)
    assert torch.equal(_bits(got), _bits(via_k1[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("snr_db", [3, 10])
@pytest.mark.parametrize("tiles,block_words", [(1, 1024), (7, 1024),
                                               (7, 100), (5, 300),
                                               (22, 1024)])
def test_k0_row_lengths_around_the_grid(cuda_device, tiles, block_words,
                                        snr_db):
    """Rows of 1, 7 and 22 tiles and rows of tiles of 100 and 300 words:
    short rows get blocks of fewer than 256 threads (one warp at 1 tile,
    six at 22 tiles of 1,024 words, the main path's width), and the last
    block is partial where the words are no multiple of it; every word is
    reached once, by the full chain at 3 dB and the settled pass at 10."""
    x, seed, npow, gain = _k0_row(cuda_device, tiles * block_words,
                                  seed=tiles, snr_db=snr_db)
    _, full = _k0_counted(cuda_device, lambda: _k0_against_plain(
        x, seed, npow, gain, block_words=block_words))
    assert full == (snr_db == 3)


@pytest.mark.cuda
@pytest.mark.parametrize("snr_db", [3, 10])
def test_k0_long_padded_row_through_ops(cuda_device, snr_db):
    """1,000 tiles plus a 300-word tail through ``ops.approx_channel``:
    more blocks than the persistent grid holds, so every block walks the
    row in grid strides and the last stride is ragged, by the full chain
    at 3 dB and the settled pass at 10; the padding's errors are
    subtracted as on the CPU."""
    n = 1000 * 1024 + 300
    x, seed, npow, gain = _k0_row(cuda_device, n, seed=1000, snr_db=snr_db)
    before = TAC.launch_counts()
    (got, errs), full = _k0_counted(cuda_device, lambda: TO.approx_channel(
        x, seed.to(cuda_device), npow, gain))
    assert full == (snr_db == 3)
    assert TAC.launch_counts() == dict(before, k0=before["k0"] + 1)
    want, werrs = TR.ref_approx_channel(
        torch.nn.functional.pad(x, (0, 1024 - 300)), seed.to(cuda_device),
        npow, gain)
    assert torch.equal(_bits(got), _bits(want[:n]))
    assert int(errs) == int(werrs) - int(TO._padding_errors(
        want[None, n:], 32)[0])


@pytest.mark.cuda
def test_transmit_pytree_k0_holds_two_rows(cuda_device):
    """``transmit_pytree`` on K0 packs its tree once, straight into whole
    tiles: above the tree's own memory the peak holds the packed row and
    K0's output (64 MiB of slack), not a concatenation and a padded copy
    of it besides. A tree of about 2**27 words, not whole tiles; its
    words, errors and stats equal ``ops.approx_channel`` on the
    concatenated row."""
    from repro_torch.core import prng as P

    g = torch.Generator(device=cuda_device).manual_seed(33)
    tree = {"b": torch.randn((4096, 16383), generator=g, device=cuda_device),
            "a": torch.randn((8192, 8192), generator=g, device=cuda_device),
            "c": [torch.randn((1000,), generator=g, device=cuda_device)]}
    cfg = TT.TransportConfig(mode="approx", use_kernel=True,
                             channel=TCH.ChannelConfig(snr_db=10.0))
    key = P.PRNGKey(7, device=cuda_device)
    leaves, _ = TT.tree_flatten(tree)
    n = sum(l.numel() for l in leaves)
    assert n % 1024 and abs(n - 2**27) < 2**13
    row_bytes = 4 * (n + (-n) % 1024)
    torch.cuda.synchronize(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    before = TAC.launch_counts()
    got, st = TT.transmit_pytree(tree, key, cfg, device=cuda_device)
    torch.cuda.synchronize(cuda_device)
    rise = torch.cuda.max_memory_allocated(cuda_device) - base
    assert TAC.launch_counts() == dict(before, k0=before["k0"] + 1)
    assert rise <= 2 * row_bytes + 64 * 2**20, (rise, row_bytes)
    wb, mask, k = TT._transport_kernel_params(cfg)
    want, werrs = TO.approx_channel(
        torch.cat([l.reshape(-1) for l in leaves]),
        TO._seed_from_key(key), cfg.channel.noise_power,
        cfg.channel.large_scale_gain, bits_per_symbol=k, clamp_mask=mask)
    off = 0
    for leaf in TT.tree_flatten(got)[0]:
        assert leaf.dtype == torch.float32
        assert torch.equal(_bits(leaf.reshape(-1)),
                           _bits(want[off:off + leaf.numel()]))
        off += leaf.numel()
    assert off == n and int(werrs) > 0
    assert float(st.bit_errors) == float(werrs.to(torch.float32))
    assert float(st.n_bits) == np.float32(n * wb)
    assert float(st.data_symbols) == np.float32(n * (wb // k))


@pytest.mark.cuda
def test_k0_queue_drains_many_times_a_warp(cuda_device):
    """QPSK at 5 dB (rho 1.28, m = 1): half the symbols stay open, so each
    warp's queue fills and drains about eight times a page of 32 words,
    over five pages a warp on 1,000 tiles; every word equals the plain
    version's, and so does the error count."""
    x, seed, npow, gain = _k0_row(cuda_device, 1000 * 1024, seed=55,
                                  snr_db=5)
    _k0_against_plain(x, seed, npow, gain)


@pytest.mark.cuda
@pytest.mark.parametrize("snr_db", [0, 5, 10, 30])
@pytest.mark.parametrize("fading", ["rayleigh", "awgn", "block_rayleigh"])
def test_k0_open_symbol_counter(cuda_device, fading, snr_db):
    """K0's 64-bit counter of open symbols equals the settling test's
    mirror (``test_torch_k0_settle.settled_symbols``) on the plain draws:
    every symbol at 0 dB (the test off), about half at 5 dB, a fifth at
    10 dB (Rayleigh); ``k0_symbols`` is the row's symbols. 300 tiles, so
    that symbols whose two bounds sit one step apart occur."""
    from repro_torch.obs import spans

    n = 300 * 1024
    x, seed, npow, gain = _k0_row(cuda_device, n, seed=snr_db, snr_db=snr_db)
    kw = dict(fading=fading, fade_block=48)
    with spans.counting(cuda_device) as counts:
        TAC.approx_channel_kernel(x, seed, npow, gain, **kw)
        torch.cuda.synchronize()
    gidx = row_symbol_indices(n, 2, device=cuda_device)
    open_ = ~settled_symbols(int(seed), gidx, float(npow), float(gain),
                             bits_per_symbol=2, fading=fading, fade_block=48)
    assert counts == {"k0_symbols_slow": [float(open_.sum())],
                      "k0_symbols": [float(n * 16)]}
    if snr_db == 0:
        assert bool(open_.all())


@pytest.mark.cuda
@pytest.mark.parametrize("snr_db", [3, 10])
def test_k0_row_across_the_counter_wrap(cuda_device, snr_db):
    """A row of 262,145 tiles: its symbol counter wraps to 0 at tile
    262,144 (uint32, as the reference's). Tiles 262,143 and 262,144
    against the plain version given ``first_tile``, and tile 262,144 with
    tile 0's payload receives tile 0's words; the full chain at 3 dB, the
    settled pass at 10."""
    tiles = 262_145
    wrap = 262_144
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(tiles * 1024, generator=g, device=cuda_device) * 1e-3
    x[wrap * 1024:] = x[:1024]
    seed = torch.tensor(987654321, dtype=torch.int64, device=cuda_device)
    npow = torch.tensor(G0 / 10 ** (snr_db / 10), device=cuda_device)
    gain = torch.tensor(G0, device=cuda_device)
    (got, _), full = _k0_counted(cuda_device, lambda: (
        TAC.approx_channel_kernel(x, seed, npow, gain)))
    assert full == (snr_db == 3)
    lo = (wrap - 1) * 1024
    want, _ = TR.ref_approx_channel(x[lo:], seed, npow, gain,
                                    first_tile=wrap - 1)
    assert torch.equal(_bits(got[lo:]), _bits(want))
    assert torch.equal(_bits(got[wrap * 1024:]), _bits(got[:1024]))


@pytest.mark.cuda
@pytest.mark.parametrize("snr_db", [3, 10])
def test_k0_row_past_word_2_31(cuda_device, snr_db):
    """A row of 2,097,153 tiles, 2**31 + 1,024 words, one past K1's and
    K2's int row index: K0 takes it, by the full chain at 3 dB (its
    counter adds the row's 2**35 + 16,384 symbols at once) and the
    settled pass at 10. Tiles 0, 262,143, 262,144 (the counter wrap),
    2,097,151 and 2,097,152 (either side of word 2**31) against the plain
    version given ``first_tile``; the row's flipped bits equal K0's int32
    count modulo 2**32."""
    tiles = 2_097_153
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(tiles * 1024, generator=g, device=cuda_device) * 1e-3
    seed = torch.tensor(123456789, dtype=torch.int64, device=cuda_device)
    npow = torch.tensor(G0 / 10 ** (snr_db / 10), device=cuda_device)
    gain = torch.tensor(G0, device=cuda_device)
    (got, errs), full = _k0_counted(cuda_device, lambda: (
        TAC.approx_channel_kernel(x, seed, npow, gain)))
    assert full == (snr_db == 3)
    for t in (0, 262_143, 262_144, 2_097_151, 2_097_152):
        sl = slice(t * 1024, (t + 1) * 1024)
        want, _ = TR.ref_approx_channel(x[sl], seed, npow, gain,
                                        first_tile=t)
        assert torch.equal(_bits(got[sl]), _bits(want)), t
    flips = 0
    for lo in range(0, x.numel(), 1 << 28):
        d = _bits(x[lo:lo + (1 << 28)]) ^ _bits(got[lo:lo + (1 << 28)])
        flips += int(TR._popcount(d.to(torch.int64) & 0xFFFFFFFF).sum())
    assert flips > 2**31
    assert (flips - int(errs)) % 2**32 == 0


def _small_llm(dtype="float32"):
    from repro_torch.configs import get_config

    return get_config("qwen2-1.5b").reduced(
        n_layers=2, d_model=64, d_ff=128, vocab_size=128, dtype=dtype)


@pytest.mark.cuda
def test_trainer_reduced_card_vs_cpu(cuda_device):
    """Three approx steps of ``make_train_step_approx`` on the kernel path
    (K0 once a step on the card, its plain version on the CPU), float32,
    the same weights: step 0's loss within 1e-5, the rest within 0.25
    (the CPU and cuBLAS sum in other orders, and the channel's flips
    amplify it), the same bits on the air."""
    from repro_torch.core import prng as P
    from repro_torch.launch import steps as TST
    from repro_torch.models import registry as R
    from repro_torch.optim.sgd import sgd

    cfg = _small_llm()
    tcfg = TT.TransportConfig(mode="approx", use_kernel=True,
                              channel=TCH.ChannelConfig(snr_db=20.0))
    rng = np.random.default_rng(0)
    batches = [{k: rng.integers(0, 128, (4, 32)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(3)]
    losses = {}
    for dev in (cuda_device, torch.device("cpu")):
        params = R.init_params(P.PRNGKey(0, device=dev), cfg)
        opt = sgd(0.5)
        state = opt.init(params)
        step = TST.make_train_step_approx(cfg, opt, tcfg)
        key = P.PRNGKey(0, device=dev)
        out = []
        for b in batches:
            ks = P.split(key)
            key = ks[0]
            before = TAC.launch_counts()["k0"]
            params, state, loss, st = step(params, state, b, ks[1])
            assert TAC.launch_counts()["k0"] == before + (
                1 if dev.type == "cuda" else 0)
            out.append((float(loss), float(st.n_bits), float(st.bit_errors)))
        losses[dev.type] = out
    card, cpu = losses["cuda"], losses["cpu"]
    assert abs(card[0][0] - cpu[0][0]) <= 1e-5
    assert all(abs(a[0] - b[0]) <= 0.25 for a, b in zip(card, cpu))
    assert [a[1] for a in card] == [b[1] for b in cpu]
    assert all(a[2] > 0 for a in card)


@pytest.mark.cuda
@pytest.mark.parametrize("ring", [False, True])
def test_server_reduced_card_vs_cpu(cuda_device, ring):
    """Greedy decode at reduced width, float32: the card's logits within
    1e-4 (relative to the largest) of the CPU's at every step, the same
    tokens."""
    import dataclasses

    from repro_torch.core import prng as P
    from repro_torch.launch import steps as TST
    from repro_torch.models import registry as R

    cfg = dataclasses.replace(_small_llm(), decode_window=8)
    tokens = {}
    for dev in (cuda_device, torch.device("cpu")):
        params = R.init_params(P.PRNGKey(0, device=dev), cfg)
        cache = R.init_cache(cfg, 2, 8 if ring else 16, device=dev)
        tok = P.randint(P.PRNGKey(1, device=dev), (2, 1), 0, 128).to(
            torch.int32)
        step = TST.make_serve_step(cfg, ring=ring)
        seq, logits = [], []
        for pos in range(14):
            lg, _ = R.decode_step(params, cache, tok, pos, cfg, ring=ring)
            tok, cache = step(params, cache, tok, pos)
            seq.append(tok.cpu())
            logits.append(lg.cpu())
        tokens[dev.type] = (torch.cat(seq, 1), torch.cat(logits, 1))
    (ta, la), (tb, lb) = tokens["cuda"], tokens["cpu"]
    assert torch.equal(ta, tb)
    assert float((la - lb).abs().max()) <= 1e-4 * float(lb.abs().max())


# ------------------------------------------------------------ moe family


def _small_moe(dtype="float32", **kw):
    from repro_torch.configs import get_config

    return get_config("phi3.5-moe-42b-a6.6b").reduced(dtype=dtype, **kw)


def _moe_inputs(cfg, device, t=256, seed=0):
    from repro_torch.core import prng as P
    from repro_torch.models import moe

    p = moe.init_moe(P.PRNGKey(seed), cfg, getattr(torch, cfg.dtype))
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((t, cfg.d_model), generator=g).to(getattr(torch,
                                                              cfg.dtype))
    return ({k: v.to(device) for k, v in p.items()}, x.to(device), p, x)


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [1.5, 0.25])
def test_moe_ffn_card_vs_cpu(cuda_device, factor):
    """``moe_ffn`` at ``cfg.reduced()`` widths in float32, 256 tokens
    (with drops at capacity factor 0.25): the routing of
    ``_local_dispatch`` (``se``, ``st``, ``slot_c``) equal on the card and
    the CPU, the output within 2e-6 of the largest, aux within 1e-6. (The
    router's products round differently; the inputs have no token whose
    K-th and K+1-th probabilities lie within 1e-6, which is checked.)"""
    import dataclasses

    from repro_torch.models import moe

    cfg = dataclasses.replace(_small_moe(), capacity_factor=factor)
    pd, xd, pc, xc = _moe_inputs(cfg, cuda_device)
    probs = torch.softmax(xc @ pc["router"], -1).sort(-1, descending=True)[0]
    gap = probs[:, cfg.top_k - 1] - probs[:, cfg.top_k]
    assert not bool((gap <= 1e-6 * probs[:, cfg.top_k - 1]).any())
    c = moe.capacity(xc.shape[0], cfg)
    rd = moe._local_dispatch(xd, pd, cfg, c)
    rc = moe._local_dispatch(xc, pc, cfg, c)
    for i in (1, 2, 3):
        assert torch.equal(rd[i].cpu(), rc[i])
    assert torch.equal(rd[0].cpu(), rc[0])
    od, ad = moe.moe_ffn(xd, pd, cfg)
    oc, ac_ = moe.moe_ffn(xc, pc, cfg)
    assert float((od.cpu() - oc).abs().max()) <= 2e-6 * float(oc.abs().max())
    assert abs(float(ad) - float(ac_)) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_combine_deterministic(cuda_device, dtype):
    """Under deterministic algorithms, ``moe_ffn``'s output, aux and the
    gradients of input and weights (the combine's gathers and sum, the
    backward's accumulate into the ``x2[st]`` gather and the dispatch
    scatter) are equal bit for bit across two runs, 1,024 tokens at top-2
    with drops."""
    from repro_torch.core.transport import tree_flatten, tree_unflatten
    from repro_torch.models import moe

    cfg = _small_moe(dtype)
    pd, xd, _, _ = _moe_inputs(cfg, cuda_device, t=1024, seed=3)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for _ in range(2):
            leaves, spec = tree_flatten(pd)
            req = [t.clone().requires_grad_() for t in [xd] + leaves]
            out, aux = moe.moe_ffn(req[0], tree_unflatten(spec, req[1:]), cfg)
            grads = torch.autograd.grad(out.float().square().sum() + aux, req)
            runs.append([out.detach(), aux.detach(), *grads])
    finally:
        torch.use_deterministic_algorithms(was)
    for a, b in zip(*runs):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
def test_moe_trainer_step_launches_k0_once(cuda_device):
    """One approx step of the reduced phi3.5-moe (``make_train_step_approx``
    on the kernel path): K0 once, K1 and K2 never; finite loss, bit errors
    counted."""
    from repro_torch.core import prng as P
    from repro_torch.launch import steps as TST
    from repro_torch.models import registry as R
    from repro_torch.optim.sgd import sgd

    cfg = _small_moe("bfloat16")
    tcfg = TT.TransportConfig(mode="approx", use_kernel=True,
                              channel=TCH.ChannelConfig(snr_db=10.0))
    params = R.init_params(P.PRNGKey(0, device=cuda_device), cfg)
    opt = sgd(0.1)
    step = TST.make_train_step_approx(cfg, opt, tcfg)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    TAC.reset_launch_counts()
    params, _, loss, st = step(params, opt.init(params), batch,
                               P.PRNGKey(1, device=cuda_device))
    assert TAC.launch_counts() == {"k0": 1, "k1": 0, "k2": 0}
    assert np.isfinite(float(loss)) and float(st.bit_errors) > 0


def _small_family(arch, **kw):
    from repro_torch.configs import get_config

    return get_config(arch).reduced(dtype="float32", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kw", [
    ("recurrentgemma-2b", {}), ("recurrentgemma-2b", dict(n_layers=5)),
    ("pixtral-12b", {})])
def test_hybrid_and_vlm_reduced_card_vs_cpu(cuda_device, arch, kw):
    """The hybrid family (no group and a tail of 2; one group and a tail
    of 2) and the vlm family (16 patches) at ``cfg.reduced()`` widths,
    float32, the same weights on the card and the CPU: the loss within
    2e-6, the gradients within 1e-5 of each leaf's largest (the CPU tests'
    bounds against the reference), the logits within 2e-6 of the largest
    for vlm and 1e-5 for hybrid, whose RG-LRU state carries each
    position's rounding down the sequence (five layers measured 2.4e-6 on
    the H100; the CPU tests bound the hybrid's decode so)."""
    from repro_torch.core import prng as P
    from repro_torch.launch import steps as TST
    from repro_torch.models import registry as R

    cfg = _small_family(arch, **kw)
    p_cpu = R.init_params(P.PRNGKey(0), cfg)
    g = torch.Generator().manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 24), generator=g,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (2, cfg.n_patches, cfg.vision_dim), generator=g)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        p = TT.tree_map(lambda t: t.to(dev), p_cpu)
        b = {k: v.to(dev) for k, v in batch.items()}
        with torch.no_grad():
            logits, _ = R.forward(p, b, cfg)
        loss, grads = TST.value_and_grad(cfg, p, b)
        out.append((float(loss), logits.cpu(),
                    [t.cpu() for t in TT.tree_flatten(grads)[0]]))
    (la, ga, gra), (lb, gb, grb) = out
    assert ga.shape == (2, 24, cfg.vocab_size)
    assert abs(la - lb) <= 2e-6
    rel = 1e-5 if cfg.family == "hybrid" else 2e-6
    assert float((ga - gb).abs().max()) <= rel * float(gb.abs().max())
    assert len(gra) == len(grb)
    for x, y in zip(gra, grb):
        if y.numel():
            assert float((x - y).abs().max()) <= 1e-5 * (
                float(y.abs().max()) or 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "whisper-large-v3"])
def test_ssm_and_audio_reduced_card_vs_cpu(cuda_device, arch):
    """The ssm family (the selective scan) and the audio family (float32
    frames into the encoder, cross-attention, the tied head) at
    ``cfg.reduced()`` widths, float32, the same weights on the card and the
    CPU: the loss within 2e-6, the gradients within 1e-5 of each leaf's
    largest, the logits and 6 decode steps' logits within 2e-6 of their
    largest for audio and 1e-5 for the ssm, whose state carries each
    position's rounding down the sequence (the CPU tests bound its decode
    so)."""
    from repro_torch.core import prng as P
    from repro_torch.launch import steps as TST
    from repro_torch.models import registry as R

    cfg = _small_family(arch)
    p_cpu = R.init_params(P.PRNGKey(0), cfg)
    g = torch.Generator().manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 24), generator=g,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((2, cfg.encoder_seq, cfg.d_model),
                                      generator=g)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        p = TT.tree_map(lambda t: t.to(dev), p_cpu)
        b = {k: v.to(dev) for k, v in batch.items()}
        with torch.no_grad():
            logits, _ = R.forward(p, b, cfg)
        loss, grads = TST.value_and_grad(cfg, p, b)
        cache, dec = R.init_cache(cfg, 2, 6, device=dev), []
        for t in range(6):
            lg, cache = R.decode_step(p, cache, b["tokens"][:, t:t + 1], t,
                                      cfg)
            dec.append(lg.cpu())
        out.append((float(loss), logits.cpu(),
                    [t.cpu() for t in TT.tree_flatten(grads)[0]], dec))
    (la, ga, gra, da), (lb, gb, grb, db) = out
    assert ga.shape == (2, 24, cfg.vocab_size)
    assert abs(la - lb) <= 2e-6
    rel = 1e-5 if cfg.family == "ssm" else 2e-6
    assert float((ga - gb).abs().max()) <= rel * float(gb.abs().max())
    for x, y in zip(da, db):
        assert float((x - y).abs().max()) <= rel * float(y.abs().max())
    assert len(gra) == len(grb)
    for x, y in zip(gra, grb):
        assert float((x - y).abs().max()) <= 1e-5 * (
            float(y.abs().max()) or 1.0)


@pytest.mark.cuda
def test_k0_on_a_hybrid_row_matches_plain(cuda_device):
    """``transmit_pytree`` of a hybrid param tree (5 layers: one group and
    a list tail of 2 rec blocks) on the kernel path: one K0 launch over
    the whole row, the row in ``tree_flatten`` order equal to the plain
    version of the same padded row on the card bit for bit, the tail
    back as a list, the errors the plain version's less its padding's."""
    from repro_torch.core import prng as P
    from repro_torch.models import registry as R

    cfg = _small_family("recurrentgemma-2b", n_layers=5)
    tree = R.init_params(P.PRNGKey(0, device=cuda_device), cfg)
    tcfg = TT.TransportConfig(mode="approx", use_kernel=True,
                              channel=TCH.ChannelConfig(snr_db=10.0))
    key = P.PRNGKey(7, device=cuda_device)
    TAC.reset_launch_counts()
    hat, st = TT.transmit_pytree(tree, key, tcfg, device=cuda_device)
    assert TAC.launch_counts() == {"k0": 1, "k1": 0, "k2": 0}
    assert isinstance(hat["tail"], list) and len(hat["tail"]) == 2
    leaves = TT.tree_flatten(tree)[0]
    row = torch.cat([t.reshape(-1) for t in leaves])
    n = row.numel()
    xp = torch.nn.functional.pad(row, (0, (-n) % 1024))
    want, werrs = TR.ref_approx_channel(
        xp, TO._seed_from_key(key).to(cuda_device),
        torch.tensor(tcfg.channel.noise_power, device=cuda_device),
        torch.tensor(tcfg.channel.large_scale_gain, device=cuda_device))
    got = torch.cat([t.reshape(-1) for t in TT.tree_flatten(hat)[0]])
    assert torch.equal(_bits(got), _bits(want[:n]))
    pad_errs = int(TO._padding_errors(want[None, n:], 32)[0])
    assert float(st.bit_errors) == float(int(werrs) - pad_errs) > 0


def _sample_algo(name, batch=8):
    from repro_torch.configs.mnist_cnn import config
    from repro_torch.fl import engine as E

    if name == "fedsgd":
        return E.FedSGD(config(), batch_per_round=batch)
    return E.FedAvg(config(), local_steps=2, batch_per_step=batch)


def _take_along_sample(algo):
    """``algo`` with the ``sample`` the port had before its whole-row
    gather: ``np.take_along_axis`` and a pageable copy."""

    def sample(rng, cx, cy, device=None):
        M = cx.shape[0]
        shape = ((M, algo.local_steps, algo.batch_per_step)
                 if hasattr(algo, "local_steps")
                 else (M, algo.batch_per_round))
        take = rng.integers(0, cx.shape[1], shape).reshape(M, -1)
        xb = np.take_along_axis(cx, take[:, :, None, None], axis=1)
        yb = np.take_along_axis(cy, take, axis=1)
        return (torch.from_numpy(np.ascontiguousarray(
                    xb.reshape(shape + cx.shape[2:]))).to(device),
                torch.from_numpy(yb.reshape(shape).astype(np.int64)).to(
                    device))

    algo.sample = sample
    return algo


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["fedsgd", "fedavg"])
def test_staged_samples_equal_cpu(cuda_device, algo):
    """Three rounds sampled on the card through pinned staging, the
    earlier ones kept alive, equal the CPU's rounds bit for bit; each
    counts one staged sample, and the CPU stages none."""
    rng = np.random.default_rng(2)
    cx = rng.uniform(0, 1, (6, 40, 28, 28)).astype(np.float32)
    cy = rng.integers(0, 10, (6, 40)).astype(np.int32)
    on_card, on_cpu = _sample_algo(algo), _sample_algo(algo)
    r_card, r_cpu = np.random.default_rng(9), np.random.default_rng(9)
    kept = [on_card.sample(r_card, cx, cy, cuda_device) for _ in range(3)]
    want = [on_cpu.sample(r_cpu, cx, cy, "cpu") for _ in range(3)]
    torch.cuda.synchronize()
    assert on_card.staged_samples == 3 and on_cpu.staged_samples == 0
    for (xg, yg), (xc, yc) in zip(kept, want):
        assert xg.device.type == yg.device.type == "cuda"
        assert xg.dtype == xc.dtype and yg.dtype == yc.dtype == torch.int64
        assert xg.shape == xc.shape and yg.shape == yc.shape
        assert torch.equal(xg.cpu(), xc) and torch.equal(yg.cpu(), yc)
    assert not torch.equal(kept[0][0], kept[2][0])


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["fedsgd", "fedavg"])
def test_round_engine_staged_equals_take_along(cuda_device, algo):
    """A short ``RoundEngine.run`` on the card (K2 rounds) gives the same
    final parameters and accuracies with the staged sample as with the
    ``take_along_axis`` sample and its pageable copy, and stages one
    sample a round."""
    from repro_torch.fl import engine as E

    rng = np.random.default_rng(0)
    cx = rng.uniform(0, 1, (4, 16, 28, 28)).astype(np.float32)
    cy = rng.integers(0, 10, (4, 16)).astype(np.int32)
    cfg = TT.TransportConfig(mode="approx", use_kernel=True,
                             channel=TCH.ChannelConfig(snr_db=10.0))
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for a in (_sample_algo(algo), _take_along_sample(_sample_algo(algo))):
            eng = E.RoundEngine(a, cfg, cx, cy, cx[0], cy[0], n_rounds=3,
                                seed=5, eval_every=1, fused_aggregate=True,
                                device=cuda_device)
            runs.append((eng.run(), eng.params, a.staged_samples))
    finally:
        torch.backends.cudnn.deterministic = was
    (res, params, staged), (res_p, params_p, staged_p) = runs
    assert staged == 3 and staged_p == 0
    assert res.accuracy == res_p.accuracy
    for k in params:
        assert torch.equal(_bits(params[k]), _bits(params_p[k])), k


def _eager_stage(sym, keys, cfg, snr_vec):
    """The layered channel stage as eager tensor operations on the
    symbols' device: ``(y, c)``."""
    from repro_torch.core import modulation as TM

    r, c = TCH.transmit(TM.modulate(sym, cfg.scheme), keys, cfg.channel,
                        snr_db=snr_vec)
    return TCH.equalize(r, c), c


def _same_complex(a, b):
    """Bit for bit, any NaN equal to any NaN."""
    ra, rb = torch.view_as_real(a), torch.view_as_real(b)
    diff = (_bits(ra) != _bits(rb)) & ~(torch.isnan(ra) & torch.isnan(rb))
    return not bool(diff.any())


def _stage_case(device, mod, fading, snr, c, s, block_len=11):
    from repro_torch.core import prng as P

    cfg = TT.TransportConfig(modulation=mod, channel=TCH.ChannelConfig(
        snr_db=snr, fading=fading, block_len=block_len))
    k = cfg.scheme.bits_per_symbol
    sym = P.randint(P.PRNGKey(s + k, device=device), (c, s), 0, 1 << k)
    keys = TT.client_keys(P.PRNGKey(31, device=device), c)
    snr_vec = (None if isinstance(snr, float)
               else TCH.snr_db_vector(snr, c, device))
    return sym, keys, cfg, snr_vec


@pytest.mark.cuda
@pytest.mark.parametrize("snr", ["scalar", "per_row"])
@pytest.mark.parametrize("s", [1, 7, 349440])
@pytest.mark.parametrize("fading", ["rayleigh", "awgn", "block_rayleigh"])
@pytest.mark.parametrize("mod", ["qpsk", "16qam", "64qam", "256qam"])
def test_channel_stage_kernel_equals_eager_chain(cuda_device, mod, fading, s,
                                                 snr):
    """The kernel's ``y`` and ``c`` equal the eager chain's on the card bit
    for bit; block_rayleigh's blocks of 11 divide none of the rows; the
    per-row SNR's inf row has zero noise with its signed zeros."""
    snr_db = (float("inf"), 10.0, -3.0, 30.0) if snr == "per_row" else 7.0
    sym, keys, cfg, snr_vec = _stage_case(cuda_device, mod, fading, snr_db,
                                          4, s)
    y, c = TT._through_channel(sym, keys, cfg, snr_vec, gain=True)
    want_y, want_c = _eager_stage(sym, keys, cfg, snr_vec)
    assert y.dtype == c.dtype == torch.complex64 and y.shape == (4, s)
    assert _same_complex(y, want_y) and _same_complex(c, want_c)


@pytest.mark.cuda
def test_channel_stage_kernel_at_the_cells_shape(cuda_device):
    """The FL cell's stage, 100 rows of 21,840 words x 16 QPSK symbols at
    10 dB over Rayleigh fading, equals the eager chain bit for bit."""
    sym, keys, cfg, _ = _stage_case(cuda_device, "qpsk", "rayleigh", 10.0,
                                    100, 349440, block_len=64)
    y, c = TT._through_channel(sym, keys, cfg, None, gain=True)
    want_y, want_c = _eager_stage(sym, keys, cfg, None)
    assert _same_complex(y, want_y) and _same_complex(c, want_c)


@pytest.mark.cuda
@pytest.mark.parametrize("gain", [False, True])
def test_through_channel_launches_the_stage_once(cuda_device, gain):
    from repro_torch.kernels import phy_channel as PK

    sym, keys, cfg, _ = _stage_case(cuda_device, "16qam", "rayleigh", 10.0,
                                    3, 5000)
    TAC.reset_launch_counts()
    before = PK.channel_stage.launches
    y, c = TT._through_channel(sym, keys, cfg, None, gain=gain)
    assert PK.channel_stage.launches == before + 1
    assert TAC.launch_counts() == {"k0": 0, "k1": 0, "k2": 0}
    assert (c is not None) == gain
    assert _same_complex(y, _eager_stage(sym, keys, cfg, None)[0])


@pytest.mark.cuda
def test_layered_round_launches_the_stage_once_a_round(cuda_device):
    from repro_torch.configs.mnist_cnn import config
    from repro_torch.fl.loop import run_fl
    from repro_torch.kernels import phy_channel as PK

    rng = np.random.default_rng(0)
    cx = rng.uniform(0, 1, (4, 16, 28, 28)).astype(np.float32)
    cy = rng.integers(0, 10, (4, 16)).astype(np.int32)
    cfg = TT.TransportConfig(mode="approx",
                             channel=TCH.ChannelConfig(snr_db=10.0))
    TAC.reset_launch_counts()
    before = PK.channel_stage.launches
    res = run_fl(config(), cfg, cx, cy, cx[0], cy[0], n_rounds=3,
                 batch_per_round=8, eval_every=1)
    assert PK.channel_stage.launches == before + 3
    assert TAC.launch_counts() == {"k0": 0, "k1": 0, "k2": 0}
    assert all(np.isfinite(res.accuracy))


@pytest.mark.cuda
def test_kernel_normal_equals_prng_normal_on_every_mantissa(cuda_device,
                                                            monkeypatch):
    """The kernel's normal of 32 random bits equals ``prng.normal``'s torch
    ops on the card (uniform's float64 fma, ``torch.erfinv``, ``* sqrt 2``)
    on all 2**23 values of the top 23 bits, the only ones either reads:
    the stage's bit-for-bit contract rests on CUDA's ``erfinvf`` being
    torch's CUDA ``erfinv`` on each of them."""
    from repro_torch.core import prng as P
    from repro_torch.kernels import phy_channel as PK

    m = torch.arange(1 << 23, dtype=torch.int64, device=cuda_device)
    bits = (m << 9) | (m * 37 & 511)  # low bits that both must drop
    monkeypatch.setattr(P, "random_bits", lambda key, shape=(): bits)
    want = P.normal(P.PRNGKey(0, device=cuda_device), bits.shape)
    got = PK.normal_of_bits(
        torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
