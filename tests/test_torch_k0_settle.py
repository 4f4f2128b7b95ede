"""K0's settling test (``csrc/approx_channel.cu::settled``) in plain
PyTorch, and the lemma it rests on, held against the plain chain.

K0 decides most symbols from their two magnitude draws alone: with
``rho = (0.9 amp sg kSqrtHalf / nscale)**2`` (float32, as the kernel
derives it from its link), a Rayleigh or block-Rayleigh symbol whose
noise and fading uniforms satisfy ``u1n > u1f**m`` (``m = 2**j <= rho``,
the power rounded upward) has ``|n / c| < 0.9 amp`` in exact arithmetic,
so the full chain, whatever its phases, decodes it to itself; an AWGN
symbol the same with ``u1n > 2**-q``, ``q = floor(rho log2 e)``. The
kernel runs the full chain only on the symbols the test leaves open, and
counts them.

``settled_symbols`` mirrors the kernel's test bit for bit, on the CPU and
on the card (``tests/test_torch_cuda.py`` holds K0's counter to it). The
lemma is checked here on the CPU: every settled symbol, at seeded
indices and at indices built by inverting ``fmix32`` so that the
extreme uniforms occur, comes out of ``ref.channel_tile`` as it went in,
over k in {2, 4, 8}, the three fadings and SNRs from -10 to 40 dB.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import approx_channel as TAC  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

G0 = 1e-3
M32 = 0xFFFFFFFF
PHI = 0x9E3779B9
STREAM_NOISE = 0x9E3779B9
STREAM_FADE = 0x7FEB352D
SQRT_HALF = float.fromhex("0x1.6a09e6p-1")  # the kernel's kSqrtHalf
MAX_SQUARINGS = 4  # the kernel's kMaxSquarings
FADE_BLOCK = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def settle_params(noise_power: float, gain: float, bits_per_symbol: int):
    """The kernel's ``settle_params`` in float32: ``(on, squarings,
    awgn_floor)``."""
    f = np.float32
    with np.errstate(all="ignore"):
        nscale = np.sqrt(f(noise_power) * f(0.5))
        sg = np.sqrt(f(gain))
        amp = f(TAC._constellation(bits_per_symbol)[0])
        t = (f(0.9) * amp) * (sg * f(SQRT_HALF)) / nscale
        rho = t * t
    on = bool(f(1.0) <= rho <= f(1e30) and f(1e-5) <= sg <= f(1e15)
              and nscale <= f(1e15))
    if not on:
        return False, 0, 1.0
    squarings = min(int(np.array(rho, np.float32).view(np.int32) >> 23) - 127,
                    MAX_SQUARINGS)
    q = int(min(np.floor(rho * f(1.44269502)), f(30.0)))
    return True, squarings, float(f(2.0) ** f(-q))


def _uniform_bounds(h: torch.Tensor):
    """The kernel's ``uniform_below`` / ``uniform_above``: ``b * 2**-23``
    and ``(b + 1) * 2**-23`` with ``b = h >> 9``, which bound
    ``ref.uniform01(h)`` (exact float32 values)."""
    b = h >> 9
    return (b.to(torch.float32) * 2.0**-23,
            (b + 1).to(torch.float32) * 2.0**-23)


def _square_up(a: torch.Tensor) -> torch.Tensor:
    """``__fmul_ru(a, a)``: the float32 square rounded upward (the double
    product is exact; a float32 below it moves up one step)."""
    p = a.double() * a.double()
    r = p.float()
    return torch.where(r.double() < p,
                       torch.nextafter(r, torch.full_like(r, float("inf"))), r)


def settled_symbols(seed, gidx, noise_power, gain, *, bits_per_symbol,
                    fading, fade_block=FADE_BLOCK):
    """Which symbols (``int64`` indices holding ``uint32`` values, on any
    device) K0's settling test settles on this link: a bool tensor, all
    False when the test is off (``rho < 1``)."""
    on, squarings, floor = settle_params(noise_power, gain, bits_per_symbol)
    if not on:
        return torch.zeros(gidx.shape, dtype=torch.bool, device=gidx.device)
    s = torch.as_tensor(int(seed) & M32, dtype=torch.int64, device=gidx.device)
    u1n = _uniform_bounds(TR.hash_u32(s, gidx, STREAM_NOISE))[0]
    if fading == "awgn":
        return u1n > floor
    fidx = gidx // fade_block if fading == "block_rayleigh" else gidx
    pw = _uniform_bounds(TR.hash_u32(s, fidx, STREAM_FADE))[1]
    for _ in range(squarings):
        pw = _square_up(pw)
    return u1n > pw


def row_symbol_indices(n: int, bits_per_symbol: int, device="cpu"):
    """``(n, S)`` global symbol indices of the first ``n`` float32 words of
    a row in tiles of 1,024, as K0 interleaves them (``uint32``)."""
    s_per = 32 // bits_per_symbol
    i = torch.arange(n, dtype=torch.int64, device=device)
    tile, w = i // 1024, i % 1024
    s = torch.arange(s_per, dtype=torch.int64, device=device)
    return (tile[:, None] * (1024 * s_per) + s * 1024 + w[:, None]) & M32


def _fmix32_inv(h: int) -> int:
    h ^= h >> 16
    h = (h * pow(0xC2B2AE35, -1, 1 << 32)) & M32
    h ^= (h >> 13) ^ (h >> 26)
    h = (h * pow(0x85EBCA6B, -1, 1 << 32)) & M32
    h ^= h >> 16
    return h


def _index_for_hash(seed: int, stream: int, h: int) -> int:
    """The index whose ``hash_u32(seed, index, stream)`` is ``h``."""
    inner = _fmix32_inv(h) ^ seed
    return ((_fmix32_inv(inner) - stream) * pow(PHI, -1, 1 << 32)) & M32


def test_uniform_bounds_hold():
    """``b 2**-23 <= uniform01(h) <= (b + 1) 2**-23`` for every ``b``
    class, at both ends of each (the rounding of ``uniform01`` ties to even
    from ``h >> 8 = 2**23`` up)."""
    b = torch.arange(2**23, dtype=torch.int64)
    for low in (0, 0x100, 0x1FF):
        h = b << 9 | low
        below, above = _uniform_bounds(h)
        u = TR.uniform01(h)
        assert bool((below <= u).all()) and bool((u <= above).all())
    assert float(TR.uniform01(torch.tensor(M32))) == 1.0


def test_fmix32_inverse():
    rng = np.random.default_rng(3)
    seed = 2**32 - 12345
    hs = [int(v) for v in rng.integers(0, 2**32, 64, dtype=np.uint64)]
    idx = torch.tensor([_index_for_hash(seed, STREAM_FADE, h) for h in hs])
    got = TR.hash_u32(torch.tensor(seed), idx, STREAM_FADE)
    assert got.tolist() == hs


def _extreme_indices(seed: int, fading: str) -> list:
    """Symbol indices whose noise uniform is 2**-25 or a neighbour, and
    whose fading uniform is 1 - 2**-25 (1.0 in float32), a neighbour, or
    at the binade edge 0.5; block fading by the block's index."""
    out = []
    for top in (0, 1, 2, 3):
        for low in (0, 0x5A, 0xFF):
            out.append(_index_for_hash(seed, STREAM_NOISE, top << 8 | low))
    if fading == "awgn":
        return out
    for top in (2**24 - 1, 2**24 - 2, 2**24 - 3, 2**24 - 4, 2**23, 2**23 - 1):
        for low in range(256):
            f = _index_for_hash(seed, STREAM_FADE, top << 8 | low)
            if fading == "rayleigh":
                if low in (0, 0x5A, 0xFF):
                    out.append(f)
            elif f < (2**32) // FADE_BLOCK:
                out += [f * FADE_BLOCK, f * FADE_BLOCK + FADE_BLOCK - 1]
    return out


@pytest.mark.parametrize("snr_db", [-10, 0, 10, 20, 40])
@pytest.mark.parametrize("fading", ["rayleigh", "awgn", "block_rayleigh"])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_settled_symbols_decode_to_themselves(k, fading, snr_db):
    """The lemma: every symbol the test settles leaves the plain chain
    (``ref.channel_tile``, every phase and rounding) as it went in. Each
    word carries its S symbols at consecutive indices from a base: 4,096
    seeded bases, and the inverted extremes (``_extreme_indices``)."""
    seed = 2**32 - 12345
    s_per = 32 // k
    rng = np.random.default_rng(k * 100 + snr_db + 50)
    bases = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.int64)
    bases = np.concatenate([bases, np.array(_extreme_indices(seed, fading),
                                            np.int64)])
    base = torch.from_numpy(bases)[:, None]
    words = torch.from_numpy(
        rng.integers(0, 2**32, bases.size, dtype=np.uint64).astype(np.int64))
    npow = G0 / 10 ** (snr_db / 10)
    npow32 = float(np.float32(npow))
    u_hat = TR.channel_tile(
        words[:, None], torch.tensor(seed), base, torch.tensor(npow32),
        torch.tensor(G0, dtype=torch.float32), bits_per_symbol=k,
        fading=fading, fade_block=FADE_BLOCK, block_words=1)[:, 0]
    shifts = 32 - k * (torch.arange(s_per) + 1)
    sent = (words[:, None] >> shifts) & ((1 << k) - 1)
    got = (u_hat[:, None] >> shifts) & ((1 << k) - 1)
    gidx = (base + torch.arange(s_per)) & M32
    done = settled_symbols(seed, gidx, npow32, G0, bits_per_symbol=k,
                           fading=fading)
    on = settle_params(npow32, G0, k)[0]
    assert bool(done.any()) == on
    assert torch.equal(got[done], sent[done])


def test_settled_share_qpsk_10db_rayleigh():
    """The LLM cells' link (QPSK, 10 dB, Rayleigh): rho = 4.05, m = 4,
    so 4/5 of the symbols settle; the log test would settle 80.2%."""
    gidx = row_symbol_indices(65536, 2)
    done = settled_symbols(2**32 - 12345, gidx, G0 / 10, G0,
                           bits_per_symbol=2, fading="rayleigh")
    assert 0.79 <= float(done.float().mean()) <= 0.81
    assert settle_params(G0 / 10, G0, 2)[:2] == (True, 2)


def test_settle_params_off_where_the_test_cannot_pay():
    """Off (the full chain on every symbol) below rho = 1 (256-QAM at
    10 dB, QPSK at 0 dB), for a noiseless link (rho = inf), for NaN, and
    for a gain whose |c|**2 could reach the 1e-20 clamp."""
    assert not settle_params(G0 / 10, G0, 8)[0]
    assert not settle_params(G0, G0, 2)[0]
    assert not settle_params(0.0, G0, 2)[0]
    assert not settle_params(float("nan"), G0, 2)[0]
    assert not settle_params(1e-13, 1e-12, 2)[0]
    assert settle_params(G0 / 10, G0, 4)[:2] == (False, 0)
    assert settle_params(G0 / 100, G0, 4)[:2] == (True, 3)
    assert settle_params(G0 / 10, G0, 2, )[2] == 2.0**-5
