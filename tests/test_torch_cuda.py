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
    assert TAC.launch_counts() == {"k1": 1, "k2": 1}


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
    want = {"k1": 0, "k2": 2} if fused else {"k1": 2, "k2": 0}
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
