// Approximate-channel uplink kernels for Hopper (sm_90a).
//
// Replaces the three TPU kernels of src/repro/kernels/approx_channel.py:
//   K1  k1_approx_channel_batch   <- approx_channel_batch_pallas (:405)
//       (client, tile) grid over a (C, N) payload: bitcast -> MSB-first
//       k-bit symbols -> in-tile interleave -> Gray QAM -> counter-RNG
//       noise + fading -> zero-forcing equalise -> per-axis ML demod ->
//       words -> & clamp_mask -> popcount errors.
//   K2  k2_approx_channel_aggregate <- approx_channel_batch_aggregate_pallas
//       (:294): K1's chain, then agg += w[c] * x_hat[c] in client order;
//       the (C, N) received payload never reaches device memory.
//   K0  k0_approx_channel_row     <- approx_channel_pallas (:52)
//       K1's chain over one client's (N,) row. The reference computes it
//       as K1 at C = 1; here it has a kernel of its own (below).
//
// What bounds them on an H100 SXM. At the main-path shape (C = 100
// clients, N = 22,528 words, QPSK, f32 wire) K1 reads 9.0 MB and writes
// 9.0 MB: 5.4 us at 3.35 TB/s. It runs 36.0 M symbols through the chain:
// four hashes, two logf, two sqrtf, a sine and a cosine of two angles and
// two divides each; 185 operations a symbol with each libdevice call
// counted as one, 0.10 ms at the 67 TFLOP/s float32 peak. But each call
// is tens of instructions, so the card is bound by its issue rate, one
// warp instruction per clock per scheduler: the main-path instance ran
// 346 instructions a symbol in the SASS of the earlier design (one thread
// per word and client, every hash whole; 0.37 ms at 1,980 MHz) and runs
// 267 in this one (0.29 ms); both kernels reach about half to 3/5 of that
// rate. K2 does the same arithmetic and moves half the bytes. Cheaper
// math is not an option (--use_fast_math, __logf, __sinf, fma
// contraction: each changes bits), so the design removes instructions
// that leave the bits alone, and keeps the card full.
//
// Fewer instructions, the same bits:
// - hash_u32(seed, idx, stream) = fmix32(seed ^ fmix32(idx * phi +
//   stream)). The inner fmix32 does not depend on the client, so a block
//   computes the four inner halves (noise, noise ^ phase, fade, fade ^
//   phase) of every symbol of its 32 words once, into shared memory
//   (hs, 8 KB), and every client reads them with two 8-byte loads: 8
//   fmix32 per symbol-client become 4, plus 4 per block and symbol.
// - level_value and axis_level build the Gray and demod levels with exact
//   bit arithmetic in place of int <-> float conversions and rintf.
// - one sincosf replaces cosf and sinf of the same angle (nvcc already
//   shared their fast-path reduction, not the large-argument one).
//
// Layout. K1 and K2 run blocks of 32 words (threadIdx.x) x 8 client
// slots (threadIdx.y): a warp is one slot, so it lies in one client row
// at a time, and each client's error count is warp-reduced, then added
// with an integer atomicAdd (exact in any order). Slot g takes clients
// c0 + m * 8 + g, m = 0..3, of a chunk of 32, one after another.
// - K1: blockIdx.y picks one chunk (grid 704 x ceil(C / 32)).
// - K2: the earlier design gave each thread one word and all C clients
//   in turn: 352 blocks of 64 threads, 8% of the card's 270,336 thread
//   slots, too few warps to hide the chain's latency. Now a
//   block walks all active clients chunk by chunk (grid 704). Each slot
//   writes its clients' received floats into a shared tile xs[32][32];
//   after a barrier, slot 0 adds the chunk into its register accumulator,
//   acc = acc + w[c] * xs[c - c0] for c = c0, c0 + 1, ... in order, and a
//   second barrier guards the tile. So the sum runs c = 0 .. active - 1
//   in order, one multiply and one add each, exactly as the plain version.
// __launch_bounds__(256, 6) caps both at 40 registers. Measured (-Xptxas
// -v, main-path instances): K1 34, K2 40 registers, no spills; 8 KB
// (K1) and 12 KB (K2) of shared memory. 40 registers x 256 threads is
// 10,240 of the SM's 65,536, so 6 blocks (1,536 threads, 75% of the SM's
// 2,048 slots) are resident per SM, and K2's 704 blocks (180,224 threads,
// 67% of the card's slots) are all resident at once. They spread 6 or 5
// to an SM, so K2 takes about 6 / 5.33 of the time its work needs.
//
// K0, one long row. The LLM trainer sends its whole gradient as one row:
// qwen2-1.5b's 1,777,088,000 words, recurrentgemma-2b's 3,549,795,840 at
// its published 26 layers (past 2**31 - 1, so K0's row length is an
// int64_t; K1 and K2 keep an int row length). At qwen2-1.5b's row K0
// reads and writes 14.22 GB, 4.24 ms at 3.35 TB/s, and runs 2.84e10
// symbols, 5.27 T operations, 78.59 ms at the float32 peak: operations
// bound it, and in practice the issue rate of its SASS. Run as K1 at
// C = 1, it wasted most of the card: a block filled the shared hash table
// for its 32 words (a store, a barrier, two 8-byte loads a symbol), then
// slots 1-7 found no client and one warp of eight ran the chain, so an SM
// held 6 working warps, 1.5 a scheduler, to hide a chain of logf,
// sincosf, sqrt and divide; 55.5 M blocks each added one atomic to the
// same word. With one client there is nothing to share, so the row
// kernel drops the table and the slots:
// - one thread per word, every warp working: blocks of 256 consecutive
//   words, each thread runs its word's WB / K symbols through
//   channel_symbol with the four inner hash halves computed in registers
//   (symbol_hash); the symbol index is BlockWords' uint32 formula on the
//   word's tile (its 64-bit index over bw, as uint32), so it wraps at
//   tile 262,144 as the reference's does;
// - a persistent grid of min(ceil(N / 256), SMs x resident blocks)
//   blocks walks the row in grid strides, with a 64-bit word index; a
//   row of fewer than 8 warps an SM gets blocks of fewer warps, so that
//   it still reaches every SM (at N = 22,528, 118 blocks of 6 warps, not
//   88 of 8);
// - each thread sums its words' flips in a uint32, the block reduces
//   them (warp reduce, then shared memory) and adds one atomic: uint32
//   addition is exact modulo 2**32, so the int32 count equals K1's and
//   the plain version's, wrapped or not;
// - __launch_bounds__(256, 6) caps it at 40 registers. Measured (-Xptxas
//   -v, with the settled pass below): 40 registers in each of the 18
//   instances, 16-36 bytes of spill stores (16 in the main-path one), 8,256
//   bytes of shared memory (8 warps' queues); so 6 blocks, 48 working
//   warps (12 a scheduler), sit on each SM. K1's and K2's lines are the
//   same as before it (K1 32-35 registers, K2 40, no spills).
// The full chain's symbol loop (row_full) is 302 SASS instructions (267
// for K1: the four inner fmix32s and their index are in the loop, the two
// shared loads gone), an issue-rate floor of 256.7 ms at the untied LLM
// row, where it ran at 86% of that rate: 297.7 ms against 347.9 ms for K1
// at C = 1 (chip_smoke phase 5i, H100 80GB HBM3 at 700 W). A row shorter
// than the card is bound by one thread's chain of symbols instead, which
// K1's shared table shortens: at N = 22,528 (phase 6) neither is
// reliably faster, 0.12-0.21 ms each.
//
// K0's settled pass: the same bits from fewer instructions. Lemma: a
// symbol decodes to itself whenever the equalised error e = n / c has |e|
// < amp, half the distance between levels, for every Gray-QAM point,
// inner or edge. |n|^2 = 2 a nscale^2 and |c|^2 = 2 b (sg kSqrtHalf)^2
// (awgn: sg^2), a = -ln u1n, b = -ln u1f: the magnitudes come from the two
// magnitude uniforms alone, and the phases only turn n and c. With rho =
// (0.9 amp sg kSqrtHalf / nscale)^2 (float32, from the link as load_link
// gives it), a < rho b (awgn: a < rho) gives |e| < 0.9 amp. The kernel
// tests u1n > u1f^m, m = 2^j <= rho (j = floor(log2 rho), at most 4), so a
// < m b; it tests it on the lower bound b 2^-23 of u1n and the upper
// bound (b + 1) 2^-23 of u1f (b the hash's top 23 bits), each squaring
// rounded upward, so the float test implies the exact one. Awgn: u1n >
// 2^-q, q = floor(rho log2 e) <= 30, so a < q ln 2 <= rho (1 + 2u).
// The margin covers the chain's rounding (u = 2^-24): libdevice's logf
// (1 ulp) and the rounded sqrt give r = sqrt(2 a) (1 + 2.5u); sincosf (2
// ulp) leaves |(cos, sin)| within 1 +- 2^-21.5; the r cos, nscale, sg and
// kSqrtHalf products add u each: |n_f| <= sqrt(2a) nscale (1 + 2^-19),
// |c_f| >= sqrt(2b) sg kSqrtHalf (1 - 2^-19). c2 = |c_f|^2 (1 + 2u); each
// numerator's products and sum are within 3u |n_f| |c_f|; the divide adds
// u: |e_f| <= |n_f| / |c_f| (1 + 9u). rho's own roundings add 5u. So |e_f|
// < 0.9 amp (1 + 2^-17). The demod adds y's rounding, the level's, inv's,
// y * inv's and + (L - 1)'s, at most 6 L u in v: |v - level| < 0.45 (1 +
// 2^-17) + 96 u < 0.4501 for L <= 16, and round(v) is the sent level. The
// test is on only for rho in [1, 1e30], sg in [1e-5, 1e15] and nscale <=
// 1e15 (NaN: off). A settled symbol has u1f <= 1 - 2^-24 (u1f = 1 never
// passes), so b >= 2^-24 and |c|^2 >= 2^-24 sg^2 >= 5.9e-18: no clamp at
// 1e-20, an underflowed product moves e by at most 2^-149 / 5.9e-18, and
// nothing overflows below 3.5e31. tests/test_torch_k0_settle.py holds the
// lemma against the plain chain and mirrors the test bit for bit.
// Two passes a page (a warp's 32 words; row_settled):
// - settle: each lane tests its word's S symbols, two magnitude hashes
//   each, into a mask of open ones: 798 SASS instructions for the main
//   instance's 16 symbols, 49.9 a symbol, 485 of them on the integer
//   pipe, which issues half a warp a clock, so the pass is bound there;
// - drain: the warp queues the open symbols, a round of one a lane by
//   ballot (37 instructions a round, about 7 rounds a page at 20% open),
//   into its queue of 64 entries in shared memory (at most 31 waiting and
//   32 pushed; 8 bytes each: the index times kPhi and the word's page,
//   lane and shift), and runs 32 at a time through the unchanged
//   channel_symbol, 321 instructions a round (302 of them the chain's).
//   A symbol received otherwise ORs its flips into its word's diff; a
//   page's words are written once the queue holds none of its symbols.
// On the LLM cells' link (QPSK, 10 dB, Rayleigh: rho 4.05, m = 4), 80.0%
// of the symbols settle, so a symbol costs 49.9 + 0.2 * 321 = 114 issue
// slots, an issue-rate floor of 84.6 ms at the tied qwen2-1.5b row (N =
// 1,543,714,816); it runs in 120.7 ms there against 255.2 for the full
// chain on every symbol (the kernel without this pass, in the same run),
// and in 218.1 ms against 461.5 at kimi-k2's 2,792,119,296 words (H100
// 80GB HBM3 at 700 W). The test pays where rho >= 1 (QPSK at 4 dB: m = 1,
// 213.2 ms); below, the launch runs row_full on every symbol (QPSK at 3
// dB: 250.2 ms, 16-QAM at 10 dB: 140.2 against 142.9). row_full is kept
// for that side because it is faster there: row_settled with every
// symbol open (the test skipped, each symbol queued and drained) took
// 336.2 ms at QPSK 3 dB, 183.2 at 16-QAM 10 dB and 101.4 at 256-QAM 10
// dB against row_full's 250.3, 140.2 and 75.8, and 297.4, 163.1 and 89.5
// with a round in which each lane runs its own symbol when all 32 hold
// one (same run). The kernel counts the open symbols in a 64-bit
// counter, one atomic a block.
//
// Arithmetic matches the plain PyTorch version (kernels/ref.py) bit for
// bit: every multiply, add and divide is an explicit round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn), which the compiler never
// fuses into an fma; sqrt is __fsqrt_rn; logf and sincosf are libdevice's
// (PyTorch's cos and sin on the card are libdevice's cosf and sinf, which
// compute what sincosf computes); hashes and symbol indices are uint32 so
// they wrap as the reference's do. Never build with --use_fast_math.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPhi = 0x9E3779B9u;
constexpr uint32_t kPhiInverse = 0x144CBC89u;  // kPhi * kPhiInverse = 1 mod 2**32
constexpr uint32_t kStreamNoise = 0x9E3779B9u;
constexpr uint32_t kStreamFade = 0x7FEB352Du;
constexpr uint32_t kStreamPhase = 0x68E31DA4u;
constexpr float kSqrtHalf = 0x1.6a09e6p-1f;  // float32(sqrt(0.5))

enum Fading { kRayleigh = 0, kAwgn = 1, kBlockRayleigh = 2 };

// K1 and K2: a block is kWords words x kSlots client slots; each slot
// runs kPerSlot clients of a chunk of kChunk, one after another.
constexpr int kWords = 32;   // threadIdx.x: one warp per slot
constexpr int kSlots = 8;    // threadIdx.y
constexpr int kPerSlot = 4;
constexpr int kChunk = kSlots * kPerSlot;
constexpr int kThreads = kWords * kSlots;
constexpr int kMinBlocks = 6;     // per SM: caps registers at 40
constexpr int kMaxSymbols = 16;   // symbols per word: 32 / k, k >= 2
// K0: a block is up to kRowThreads consecutive words of the row, one a
// thread.
constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowMinBlocks = 6;  // per SM: caps registers at 40
// K0's settled pass: a warp's queue of symbols the test leaves open (at
// most 31 waiting and 32 pushed), and the most squarings of the fading
// test (m = 2^j <= 16, 94% settled at any rho >= 16).
constexpr int kQueue = 64;
constexpr int kMaxSquarings = 4;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The seed-free inner halves of one symbol's four hashes:
// fmix32(idx * phi + stream) for the noise and fading streams and their
// phase companions. The fading half is unused (and not computed) for awgn.
struct alignas(16) SymbolHash {
  uint32_t noise, noise_phase, fade, fade_phase;
};

template <int FADING>
__device__ __forceinline__ SymbolHash symbol_hash(uint32_t gidx,
                                                  uint32_t fade_block) {
  SymbolHash h;
  const uint32_t ni = gidx * kPhi;
  h.noise = fmix32(ni + kStreamNoise);
  h.noise_phase = fmix32(ni + (kStreamNoise ^ kStreamPhase));
  h.fade = h.fade_phase = 0;
  if (FADING != kAwgn) {
    const uint32_t fi =
        (FADING == kBlockRayleigh ? gidx / fade_block : gidx) * kPhi;
    h.fade = fmix32(fi + kStreamFade);
    h.fade_phase = fmix32(fi + (kStreamFade ^ kStreamPhase));
  }
  return h;
}

// uint32 hash -> uniform float in (0, 1].
__device__ __forceinline__ float uniform01(uint32_t h) {
  return __fadd_rn(__fmul_rn(static_cast<float>(h >> 8), 0x1p-24f), 0x1p-25f);
}

// Two iid N(0, 1) floats via Box-Muller on counter-RNG uniforms; inner and
// inner_phase are the seed-free halves of the two hashes.
__device__ __forceinline__ void gauss_pair(uint32_t seed, uint32_t inner,
                                           uint32_t inner_phase, float& a,
                                           float& b) {
  const float u1 = uniform01(fmix32(seed ^ inner));
  const float u2 = uniform01(fmix32(seed ^ inner_phase));
  const float r = __fsqrt_rn(__fmul_rn(-2.0f, logf(u1)));
  const float ang = __fmul_rn(u2, 6.283185307179586f);  // float32(2*pi)
  float sn, cs;
  sincosf(ang, &sn, &cs);
  a = __fmul_rn(r, cs);
  b = __fmul_rn(r, sn);
}

__device__ __forceinline__ uint32_t gray_decode(uint32_t g) {
  g ^= g >> 1;
  g ^= g >> 2;
  g ^= g >> 4;
  return g;
}

// Constellation coordinate (2 * lvl - (L - 1)) * amp. 2^23 + 2 * lvl is
// built from its bits and (2^23 + L - 1) subtracted, both exact, so this
// equals the plain version's float(2 * lvl) - (L - 1) without a
// conversion.
template <int L>
__device__ __forceinline__ float level_value(uint32_t lvl, float amp) {
  const float t = __uint_as_float(0x4B000000u | (lvl << 1));
  return __fmul_rn(__fsub_rn(t, 8388608.0f + static_cast<float>(L - 1)), amp);
}

// Closed-form ML demod of one axis: round((y * inv + (L - 1)) * 0.5),
// clipped to [0, L - 1]. Clipping first changes nothing (0 and L - 1 are
// integers and rounding is monotone; a NaN clips to 0 either way), and a
// value in [0, L - 1] plus 1.5 * 2^23 rounds half to even onto an integer
// whose low mantissa bits are the level: rintf and the float -> int
// conversion without the conversion unit.
template <int L>
__device__ __forceinline__ uint32_t axis_level(float y, float inv) {
  const float v =
      __fmul_rn(__fadd_rn(__fmul_rn(y, inv), static_cast<float>(L - 1)), 0.5f);
  const float c = fminf(fmaxf(v, 0.0f), static_cast<float>(L - 1));
  return __float_as_uint(__fadd_rn(c, 12582912.0f)) & (L - 1);
}

// One symbol of one client through the channel: its k received bits.
template <int K, int FADING>
__device__ __forceinline__ uint32_t channel_symbol(uint32_t sym, uint32_t seed,
                                                   const SymbolHash& h,
                                                   float nscale, float sg,
                                                   float amp, float inv) {
  constexpr int P = K / 2;
  constexpr int L = 1 << P;
  uint32_t gi = 0, gq = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    gi |= ((sym >> (K - 1 - 2 * j)) & 1u) << (P - 1 - j);
    gq |= ((sym >> (K - 2 - 2 * j)) & 1u) << (P - 1 - j);
  }
  const float s_re = level_value<L>(gray_decode(gi), amp);
  const float s_im = level_value<L>(gray_decode(gq), amp);

  float n_re, n_im;
  gauss_pair(seed, h.noise, h.noise_phase, n_re, n_im);
  n_re = __fmul_rn(n_re, nscale);
  n_im = __fmul_rn(n_im, nscale);
  float c_re, c_im;
  if (FADING == kAwgn) {
    c_re = __fmul_rn(sg, 1.0f);
    c_im = 0.0f;
  } else {
    float h_re, h_im;
    gauss_pair(seed, h.fade, h.fade_phase, h_re, h_im);
    c_re = __fmul_rn(__fmul_rn(sg, h_re), kSqrtHalf);
    c_im = __fmul_rn(__fmul_rn(sg, h_im), kSqrtHalf);
  }
  const float c2 =
      fmaxf(__fadd_rn(__fmul_rn(c_re, c_re), __fmul_rn(c_im, c_im)), 1e-20f);
  // n / c = n * conj(c) / |c|^2
  const float y_re = __fadd_rn(
      s_re,
      __fdiv_rn(__fadd_rn(__fmul_rn(n_re, c_re), __fmul_rn(n_im, c_im)), c2));
  const float y_im = __fadd_rn(
      s_im,
      __fdiv_rn(__fsub_rn(__fmul_rn(n_im, c_re), __fmul_rn(n_re, c_im)), c2));

  uint32_t gi_hat = axis_level<L>(y_re, inv);
  uint32_t gq_hat = axis_level<L>(y_im, inv);
  gi_hat ^= gi_hat >> 1;  // Gray encode
  gq_hat ^= gq_hat >> 1;
  uint32_t rx = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    rx |= ((gi_hat >> (P - 1 - j)) & 1u) << (K - 1 - 2 * j);
    rx |= ((gq_hat >> (P - 1 - j)) & 1u) << (K - 2 - 2 * j);
  }
  return rx;
}

// One client's link: its seed and the scales of its noise and fading.
struct Link {
  uint32_t seed;
  float nscale;  // sqrt(noise_power * 0.5)
  float sg;      // sqrt(large_scale_gain)
};

__device__ __forceinline__ Link load_link(const uint32_t* seeds,
                                          const float* npow,
                                          const float* gains, int c) {
  return Link{seeds[c], __fsqrt_rn(__fmul_rn(npow[c], 0.5f)),
              __fsqrt_rn(gains[c])};
}

template <int WB>
struct Wire;
template <>
struct Wire<32> {
  using T = uint32_t;
  __device__ static float to_f32(uint32_t u) { return __uint_as_float(u); }
};
template <>
struct Wire<16> {
  using T = uint16_t;
  __device__ static float to_f32(uint32_t u) { return __uint_as_float(u << 16); }
};

struct Params {
  int n;              // words per client row (a multiple of bw); K0 takes
                      // its row length apart, as an int64_t
  int bw;             // block_words: interleave tile of the wire format
  int fade_block;     // symbols per fading block (block_rayleigh)
  uint32_t clamp;     // receiver AND-mask
  int num_active;     // rows at or beyond it are masked
  float amp;          // float32(sqrt(3 / (2 (L^2 - 1))))
  float inv;          // float32(1 / amp)
};

// The block's words: thread (lane, slot) owns word i = blockIdx.x * 32 +
// lane of the clients its slot runs. hs holds the seed-free hash halves
// of every symbol of the block's 32 words, computed once per block.
template <int K, int FADING, int WB>
struct BlockWords {
  static constexpr int S = WB / K;
  int lane, slot, i;
  bool in_row;

  // Fills hs (each thread a share of the symbols) and waits for it.
  __device__ __forceinline__ BlockWords(const Params& p,
                                        SymbolHash (&hs)[kMaxSymbols][kWords]) {
    lane = threadIdx.x;
    slot = threadIdx.y;
    i = blockIdx.x * kWords + lane;
    in_row = i < p.n;
    // interleave: symbol s of word i has index base + s * bw + w
    const uint32_t tile = static_cast<uint32_t>(i) / p.bw;
    const uint32_t w = static_cast<uint32_t>(i) % p.bw;
    const uint32_t base = tile * (static_cast<uint32_t>(p.bw) * S);
    for (int s = slot; s < S; s += kSlots) {
      hs[s][lane] = symbol_hash<FADING>(
          base + static_cast<uint32_t>(s) * p.bw + w, p.fade_block);
    }
    __syncthreads();
  }

  // Word u of one client through the channel: the received word, before
  // the clamp.
  __device__ __forceinline__ uint32_t channel_word(
      uint32_t u, const Link& link, const SymbolHash (&hs)[kMaxSymbols][kWords],
      const Params& p) const {
    uint32_t u_hat = 0;
    // Not unrolled: each symbol inlines four libdevice calls with their
    // slow paths, and unrolling by two saved few instructions and no time
    // on the card.
#pragma unroll 1
    for (int s = 0; s < S; ++s) {
      const int shift = WB - K * (s + 1);
      const uint32_t sym = (u >> shift) & ((1u << K) - 1u);
      u_hat |= channel_symbol<K, FADING>(sym, link.seed, hs[s][lane],
                                         link.nscale, link.sg, p.amp, p.inv)
               << shift;
    }
    return u_hat;
  }
};

// Adds a warp's error counts for client c into errs[c]. Every lane of the
// warp must call it.
__device__ __forceinline__ void add_errors(int* errs, int c, uint32_t flips) {
  flips = __reduce_add_sync(0xffffffffu, flips);
  if ((threadIdx.x & 31) == 0 && flips != 0) {
    atomicAdd(&errs[c], static_cast<int>(flips));
  }
}

// K1: a block is 32 words (threadIdx.x) x 8 client slots (threadIdx.y) of
// one group of kChunk clients (blockIdx.y); slot g runs clients
// group + m * 8 + g, m < kPerSlot, one after another.
template <int K, int FADING, int WB>
__global__ void __launch_bounds__(kThreads, kMinBlocks) k1_approx_channel_batch(
    const typename Wire<WB>::T* __restrict__ x,
    typename Wire<WB>::T* __restrict__ out, int* __restrict__ errs,
    const uint32_t* __restrict__ seeds, const float* __restrict__ npow,
    const float* __restrict__ gains, int clients, Params p) {
  __shared__ SymbolHash hs[kMaxSymbols][kWords];
  const BlockWords<K, FADING, WB> blk(p, hs);
  const int group = blockIdx.y * kChunk;
#pragma unroll 1
  for (int m = 0; m < kPerSlot; ++m) {
    const int c = group + m * kSlots + blk.slot;
    if (c >= clients) break;  // uniform across the warp
    // Masked rows (c >= num_active) are written as 0 and count 0 errors.
    uint32_t u = 0, u_hat = 0;
    if (blk.in_row && c < p.num_active) {
      const size_t off = static_cast<size_t>(c) * p.n + blk.i;
      u = x[off];
      u_hat = blk.channel_word(u, load_link(seeds, npow, gains, c), hs, p) &
              p.clamp;
    }
    if (blk.in_row) {
      out[static_cast<size_t>(c) * p.n + blk.i] =
          static_cast<typename Wire<WB>::T>(u_hat);
    }
    add_errors(errs, c, __popc(u ^ u_hat));
  }
}

// K2: the same block of 32 words x 8 slots walks all active clients in
// chunks of kChunk; see the note at the top for the order of the sum.
// Out-of-range threads are masked by predicates, never by a return,
// because every thread reaches the barriers.
template <int K, int FADING, int WB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    k2_approx_channel_aggregate(
        const typename Wire<WB>::T* __restrict__ x, float* __restrict__ agg,
        int* __restrict__ errs, const uint32_t* __restrict__ seeds,
        const float* __restrict__ npow, const float* __restrict__ gains,
        const float* __restrict__ weights, int clients, int valid_words,
        Params p) {
  __shared__ SymbolHash hs[kMaxSymbols][kWords];
  __shared__ float xs[kChunk][kWords];
  const BlockWords<K, FADING, WB> blk(p, hs);
  const bool counted = blk.in_row && blk.i < valid_words;
  const int active = min(clients, p.num_active);
  float acc = 0.0f;
  for (int c0 = 0; c0 < active; c0 += kChunk) {
#pragma unroll 1
    for (int m = 0; m < kPerSlot; ++m) {
      const int row = m * kSlots + blk.slot;
      const int c = c0 + row;
      if (c >= active) break;  // uniform across the warp
      uint32_t u = 0, u_hat = 0;
      if (blk.in_row) {
        u = x[static_cast<size_t>(c) * p.n + blk.i];
        u_hat = blk.channel_word(u, load_link(seeds, npow, gains, c), hs, p) &
                p.clamp;
      }
      xs[row][blk.lane] = Wire<WB>::to_f32(u_hat);
      add_errors(errs, c, counted ? __popc(u ^ u_hat) : 0u);
    }
    __syncthreads();
    if (blk.slot == 0 && blk.in_row) {
      const int rows = min(kChunk, active - c0);
      for (int j = 0; j < rows; ++j) {
        acc = __fadd_rn(acc, __fmul_rn(weights[c0 + j], xs[j][blk.lane]));
      }
    }
    __syncthreads();
  }
  if (blk.slot == 0 && blk.in_row) agg[blk.i] = acc;
}

// K0's settling test, uniform over a launch. rho = (0.9 amp sg kSqrtHalf
// / nscale)^2, so that -ln u1n < rho * -ln u1f gives |n / c| < 0.9 amp
// (fading), and -ln u1n < rho gives it for awgn; see the note at the top.
struct Settle {
  bool on;           // rho >= 1 and the link's scales in range (NaN: off)
  int squarings;     // fading: m = 2^squarings <= rho
  float awgn_floor;  // awgn: 2^-q, q = floor(rho log2 e) <= 30
};

__device__ __forceinline__ Settle settle_params(const Link& link, float amp) {
  const float t = __fdiv_rn(
      __fmul_rn(__fmul_rn(0.9f, amp), __fmul_rn(link.sg, kSqrtHalf)),
      link.nscale);
  const float rho = __fmul_rn(t, t);
  Settle st;
  st.on = rho >= 1.0f && rho <= 1e30f && link.sg >= 1e-5f &&
          link.sg <= 1e15f && link.nscale <= 1e15f;
  // floor(log2 rho), exact for a normal rho >= 1
  st.squarings = min((__float_as_int(rho) >> 23) - 127, kMaxSquarings);
  const int q = static_cast<int>(
      fminf(floorf(__fmul_rn(rho, 1.44269502f)), 30.0f));  // float32(log2 e)
  st.awgn_floor = __int_as_float((127 - q) << 23);
  return st;
}

// Exact bounds on uniform01(h) from its top 23 bits b = h >> 9:
// b 2^-23 <= uniform01(h) <= (b + 1) 2^-23 (both representable, and
// rounding is monotone), each one subtraction from the float 1 + b 2^-23.
__device__ __forceinline__ float uniform_below(uint32_t h) {
  return __fsub_rn(__uint_as_float(0x3F800000u | (h >> 9)), 1.0f);
}
__device__ __forceinline__ float uniform_above(uint32_t h) {
  return __fsub_rn(__uint_as_float(0x3F800000u | (h >> 9)), 0x1.fffffcp-1f);
}

// Whether the symbol whose index times kPhi is ni (its hashes' input) is
// settled: its two magnitude uniforms alone prove that it decodes to
// itself. Fading: u1n > u1f^m, m = 2^squarings, tested on a lower bound
// of u1n and an upper bound of u1f with the power rounded upward, so that
// it holds in exact arithmetic; u1f = 1 (c = 0) never passes. Awgn: u1n
// > 2^-q.
template <int FADING>
__device__ __forceinline__ bool settled(uint32_t ni, uint32_t seed,
                                        const Settle& st,
                                        uint32_t fade_block) {
  const float u1n = uniform_below(fmix32(seed ^ fmix32(ni + kStreamNoise)));
  if (FADING == kAwgn) return u1n > st.awgn_floor;
  const uint32_t fi =
      FADING == kBlockRayleigh ? ni * kPhiInverse / fade_block * kPhi : ni;
  float pw = uniform_above(fmix32(seed ^ fmix32(fi + kStreamFade)));
#pragma unroll
  for (int j = 0; j < kMaxSquarings; ++j) {
    if (j < st.squarings) pw = __fmul_ru(pw, pw);
  }
  return u1n > pw;
}

// A warp's queue of open symbols, and per page (the warp's current and
// previous 32 words) and lane the sent word and the flips found in it.
struct RowQueue {
  uint2 q[kQueue];  // (symbol index * kPhi, page lane | shift << 6)
  uint32_t word[2 * 32];
  uint32_t diff[2 * 32];
};

// count (<= 32) open symbols from queue position head, one a lane,
// through the full chain; a symbol received otherwise ORs its flips into
// its word's diff. Every lane of the warp calls it.
template <int K, int FADING>
__device__ __forceinline__ void drain(RowQueue& rq, uint32_t head,
                                      uint32_t count, const Link& link,
                                      const Params& p) {
  const uint32_t lane = threadIdx.x & 31;
  __syncwarp();
  if (lane < count) {
    const uint2 e = rq.q[(head + lane) % kQueue];
    const uint32_t owner = e.y & 63u, shift = e.y >> 6;
    const uint32_t sym = (rq.word[owner] >> shift) & ((1u << K) - 1u);
    const uint32_t rx = channel_symbol<K, FADING>(
        sym, link.seed, symbol_hash<FADING>(e.x * kPhiInverse, p.fade_block),
        link.nscale, link.sg, p.amp, p.inv);
    if (rx != sym) atomicOr(&rq.diff[owner], (rx ^ sym) << shift);
  }
  __syncwarp();
}

// The full chain on every symbol of the thread's words (the row kernel
// before the settling test): its words' flips.
template <int K, int FADING, int WB>
__device__ __forceinline__ uint32_t row_full(
    const typename Wire<WB>::T* __restrict__ x,
    typename Wire<WB>::T* __restrict__ out, int64_t n, const Params& p,
    const Link& link) {
  constexpr int S = WB / K;
  const uint32_t bw = static_cast<uint32_t>(p.bw);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // the stride in whole tiles (mod 2**32) and the words left over
  const uint32_t stride_tiles = static_cast<uint32_t>(stride / bw);
  const uint32_t stride_words = static_cast<uint32_t>(stride % bw);
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint32_t tile = static_cast<uint32_t>(i / bw);
  uint32_t w = static_cast<uint32_t>(i % bw);
  uint32_t flips = 0;  // wraps modulo 2**32, as the int32 count does
  for (; i < n; i += stride) {
    // interleave: symbol s of word i has index base + s * bw + w (uint32,
    // so it wraps at tile 262,144 as the reference's does)
    const uint32_t base = tile * (bw * S) + w;
    const uint32_t u = x[i];
    uint32_t u_hat = 0;
#pragma unroll 1
    for (int s = 0; s < S; ++s) {
      const int shift = WB - K * (s + 1);
      const uint32_t sym = (u >> shift) & ((1u << K) - 1u);
      u_hat |= channel_symbol<K, FADING>(
                   sym, link.seed,
                   symbol_hash<FADING>(base + static_cast<uint32_t>(s) * bw,
                                       p.fade_block),
                   link.nscale, link.sg, p.amp, p.inv)
               << shift;
    }
    u_hat &= p.clamp;
    out[i] = static_cast<typename Wire<WB>::T>(u_hat);
    flips += __popc(u ^ u_hat);
    tile += stride_tiles;
    w += stride_words;
    if (w >= bw) {
      w -= bw;
      ++tile;
    }
  }
  return flips;
}

// The settled pass: the same walk as row_full, a warp's 32 consecutive
// words at a time (a page). Each lane tests its word's S symbols into a
// mask of open ones; the warp then queues them, each lane its lowest open
// symbol a round, by ballot, and runs them 32 at a time through the full
// chain (drain). A page's words are written once the queue holds none of
// its symbols: at the end of the next page, where one short drain
// finishes any that are left. A last page past the row, with nothing
// open, finishes the row's last. Returns the thread's flips and, on lane
// 0, the warp's open symbols.
template <int K, int FADING, int WB>
__device__ __forceinline__ uint2 row_settled(
    const typename Wire<WB>::T* __restrict__ x,
    typename Wire<WB>::T* __restrict__ out, int64_t n, const Params& p,
    const Link& link, const Settle& st, RowQueue& rq) {
  constexpr int S = WB / K;
  const uint32_t lane = threadIdx.x & 31;
  const uint32_t bw = static_cast<uint32_t>(p.bw);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const uint32_t stride_tiles = static_cast<uint32_t>(stride / bw);
  const uint32_t stride_words = static_cast<uint32_t>(stride % bw);
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint32_t tile = static_cast<uint32_t>(i / bw);
  uint32_t w = static_cast<uint32_t>(i % bw);
  uint32_t flips = 0;
  // queue positions (uint32, mod 2**32), the same on every lane: entries
  // [head, tail) wait; the previous page's end at prev_end
  uint32_t head = 0, tail = 0, prev_end = 0;
  uint32_t page = 0;
  // the warp's words are consecutive: it walks while its first is in the
  // row, and one page more
  for (; i - lane < n + stride; i += stride) {
    const bool in_row = i < n;
    rq.word[page * 32 + lane] = in_row ? static_cast<uint32_t>(x[i]) : 0u;
    rq.diff[page * 32 + lane] = 0;
    // interleave: symbol s of word i has index base + s * bw + w (uint32,
    // so it wraps at tile 262,144 as the reference's does); ni is it
    // times kPhi, the hashes' input
    const uint32_t ni = (tile * (bw * S) + w) * kPhi;
    uint32_t open = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (!settled<FADING>(ni + s * (bw * kPhi), link.seed, st, p.fade_block)) {
        open |= 1u << s;
      }
    }
    if (!in_row) open = 0;
    for (;;) {  // uniform: a round queues each lane's lowest open symbol
      const uint32_t have = __ballot_sync(0xffffffffu, open != 0);
      if (have == 0) break;
      if (open != 0) {
        const uint32_t s = __ffs(open) - 1;
        rq.q[(tail + __popc(have & ((1u << lane) - 1u))) % kQueue] =
            make_uint2(ni + s * (bw * kPhi),
                       (page * 32 + lane) | (WB - K * (s + 1)) << 6);
        open &= open - 1;
      }
      tail += __popc(have);
      if (tail - head >= 32) {
        drain<K, FADING>(rq, head, 32, link, p);
        head += 32;
      }
    }
    if (i >= stride) {  // uniform: every page but the first has one before it
      if (static_cast<int32_t>(prev_end - head) > 0) {
        drain<K, FADING>(rq, head, tail - head, link, p);
        head = tail;
      }
      // the previous page's words: all their symbols' flips are in diff
      const uint32_t prev = (page ^ 1) * 32 + lane;
      if (i - stride < n) {
        const uint32_t u = rq.word[prev];
        const uint32_t u_hat = (u ^ rq.diff[prev]) & p.clamp;
        out[i - stride] = static_cast<typename Wire<WB>::T>(u_hat);
        flips += __popc(u ^ u_hat);
      }
    }
    prev_end = tail;
    page ^= 1;
    tile += stride_tiles;
    w += stride_words;
    if (w >= bw) {
      w -= bw;
      ++tile;
    }
  }
  return make_uint2(flips, lane == 0 ? tail : 0u);
}

// K0: one client's row, one thread per word. A block is blockDim.x
// (at most kRowThreads) consecutive words and walks the row in steps of
// the whole grid. With the settling test on (rho >= 1), the warps run
// row_settled; otherwise each thread runs the full chain on its words
// (row_full), computing its symbols' hash halves in registers. Threads
// sum their words' flips and the block adds its total with one
// atomicAdd; the block's open symbols go to the 64-bit counter slow the
// same way (off: one thread adds the row's n * S). The row length and
// the word index are 64-bit, so a row may hold any number of words the
// card can: the word's tile is its 64-bit index over bw, cast to uint32
// as the reference casts program_id, kept with the word's place in the
// tile and stepped by the grid stride's whole tiles and remainder, so no
// 64-bit division runs in the loop and nothing assumes that bw divides
// 2**32.
template <int K, int FADING, int WB>
__global__ void __launch_bounds__(kRowThreads, kRowMinBlocks)
    k0_approx_channel_row(const typename Wire<WB>::T* __restrict__ x,
                          typename Wire<WB>::T* __restrict__ out,
                          int* __restrict__ errs,
                          unsigned long long* __restrict__ slow,
                          const uint32_t* __restrict__ seed,
                          const float* __restrict__ npow,
                          const float* __restrict__ gain, int64_t n,
                          Params p) {
  __shared__ uint32_t warp_flips[kRowWarps];
  __shared__ uint32_t warp_open[kRowWarps];
  __shared__ RowQueue queues[kRowWarps];
  const Link link = load_link(seed, npow, gain, 0);
  const Settle st = settle_params(link, p.amp);
  uint2 c;  // (flips, open symbols)
  RowQueue& rq = queues[threadIdx.x >> 5];
  if (st.on) {
    c = row_settled<K, FADING, WB>(x, out, n, p, link, st, rq);
  } else {
    c = make_uint2(row_full<K, FADING, WB>(x, out, n, p, link), 0u);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      atomicAdd(slow, static_cast<unsigned long long>(n) * (WB / K));
    }
  }
  c.x = __reduce_add_sync(0xffffffffu, c.x);
  if ((threadIdx.x & 31) == 0) {
    warp_flips[threadIdx.x >> 5] = c.x;
    warp_open[threadIdx.x >> 5] = c.y;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t total = 0;
    unsigned long long open = 0;
    for (unsigned j = 0; j < blockDim.x / 32; ++j) {
      total += warp_flips[j];
      open += warp_open[j];
    }
    if (total != 0) atomicAdd(reinterpret_cast<unsigned int*>(errs), total);
    if (open != 0) atomicAdd(slow, open);
  }
}

// The card's SMs and the kRowThreads-thread blocks of one K0 instance an
// SM holds, queried at the instance's first launch and kept (the cards of
// one host are alike).
struct RowOccupancy {
  int sms, per_sm;
};

template <int K, int FADING, int WB>
RowOccupancy row_occupancy() {
  static const RowOccupancy occ = [] {
    RowOccupancy o{0, 0};
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &o.per_sm, k0_approx_channel_row<K, FADING, WB>, kRowThreads, 0);
    return o;
  }();
  return occ;
}

// A persistent grid of min(blocks, SMs x blocks an SM). A row of fewer
// than kRowThreads / 32 warps an SM gets blocks of fewer warps, so that it
// still spreads over every SM.
template <int K, int FADING, int WB>
void launch_k0(const void* x, void* out, int* errs, unsigned long long* slow,
               const uint32_t* seed, const float* npow, const float* gain,
               int64_t n, const Params& p, cudaStream_t stream) {
  using T = typename Wire<WB>::T;
  const RowOccupancy occ = row_occupancy<K, FADING, WB>();
  const int64_t sms = std::max(occ.sms, 1);
  const int64_t warps = (n + 31) / 32;
  const int threads = 32 * static_cast<int>(std::clamp<int64_t>(
                               (warps + sms - 1) / sms, 1, kRowThreads / 32));
  const int64_t blocks = (n + threads - 1) / threads;
  const int grid = static_cast<int>(
      std::min<int64_t>(blocks, static_cast<int64_t>(occ.sms) * occ.per_sm));
  k0_approx_channel_row<K, FADING, WB><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), errs, slow, seed, npow,
      gain, n, p);
}

template <int K, int FADING, int WB>
void launch_k1(const void* x, void* out, int* errs, const uint32_t* seeds,
               const float* npow, const float* gains, int clients,
               const Params& p, cudaStream_t stream) {
  using T = typename Wire<WB>::T;
  const dim3 grid((p.n + kWords - 1) / kWords, (clients + kChunk - 1) / kChunk);
  const dim3 block(kWords, kSlots);
  k1_approx_channel_batch<K, FADING, WB><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), errs, seeds, npow, gains,
      clients, p);
}

template <int K, int FADING, int WB>
void launch_k2(const void* x, float* agg, int* errs, const uint32_t* seeds,
               const float* npow, const float* gains, const float* weights,
               int clients, int valid_words, const Params& p,
               cudaStream_t stream) {
  using T = typename Wire<WB>::T;
  const dim3 grid((p.n + kWords - 1) / kWords);
  const dim3 block(kWords, kSlots);
  k2_approx_channel_aggregate<K, FADING, WB><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), agg, errs, seeds, npow, gains, weights,
      clients, valid_words, p);
}

// Runtime (k, fading, word_bits) -> template instance. Returns false on an
// unsupported combination.
template <template <int, int, int> class Launcher, typename... Args>
bool dispatch(int k, int fading, int word_bits, Args&&... args) {
#define REPRO_CASE(KK, FF, WW)                                  \
  if (k == KK && fading == FF && word_bits == WW) {             \
    Launcher<KK, FF, WW>::run(static_cast<Args&&>(args)...);    \
    return true;                                                \
  }
#define REPRO_FADINGS(KK, WW)     \
  REPRO_CASE(KK, kRayleigh, WW)   \
  REPRO_CASE(KK, kAwgn, WW)       \
  REPRO_CASE(KK, kBlockRayleigh, WW)
  REPRO_FADINGS(2, 32)
  REPRO_FADINGS(4, 32)
  REPRO_FADINGS(8, 32)
  REPRO_FADINGS(2, 16)
  REPRO_FADINGS(4, 16)
  REPRO_FADINGS(8, 16)
#undef REPRO_FADINGS
#undef REPRO_CASE
  return false;
}

template <int K, int FADING, int WB>
struct K0Launcher {
  template <typename... Args>
  static void run(Args&&... args) {
    launch_k0<K, FADING, WB>(static_cast<Args&&>(args)...);
  }
};

template <int K, int FADING, int WB>
struct K1Launcher {
  template <typename... Args>
  static void run(Args&&... args) {
    launch_k1<K, FADING, WB>(static_cast<Args&&>(args)...);
  }
};

template <int K, int FADING, int WB>
struct K2Launcher {
  template <typename... Args>
  static void run(Args&&... args) {
    launch_k2<K, FADING, WB>(static_cast<Args&&>(args)...);
  }
};

}  // namespace

// Plain C interface, loaded with ctypes. Each launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for an unsupported
// k / fading / word_bits). Outputs are allocated by the caller; errs (and
// K0's slow) must be zeroed, since blocks add their counts into them.
extern "C" int repro_k0_approx_channel_row(
    const void* x, void* out, int* errs, unsigned long long* slow,
    const uint32_t* seed, const float* npow, const float* gain, int64_t n,
    int k, int fading, int word_bits, int bw, int fade_block, uint32_t clamp,
    float amp, float inv, void* stream) {
  // Params::n is K1's and K2's int row length; K0 reads n instead.
  const Params p{0, bw, fade_block, clamp, 1, amp, inv};
  if (!dispatch<K0Launcher>(k, fading, word_bits, x, out, errs, slow, seed,
                            npow, gain, n, p,
                            static_cast<cudaStream_t>(stream))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_k1_approx_channel_batch(
    const void* x, void* out, int* errs, const uint32_t* seeds,
    const float* npow, const float* gains, int clients, int n, int k,
    int fading, int word_bits, int bw, int fade_block, uint32_t clamp,
    int num_active, float amp, float inv, void* stream) {
  const Params p{n, bw, fade_block, clamp, num_active, amp, inv};
  if (!dispatch<K1Launcher>(k, fading, word_bits, x, out, errs, seeds, npow,
                            gains, clients, p,
                            static_cast<cudaStream_t>(stream))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_k2_approx_channel_aggregate(
    const void* x, float* agg, int* errs, const uint32_t* seeds,
    const float* npow, const float* gains, const float* weights, int clients,
    int n, int k, int fading, int word_bits, int bw, int fade_block,
    uint32_t clamp, int num_active, int valid_words, float amp, float inv,
    void* stream) {
  const Params p{n, bw, fade_block, clamp, num_active, amp, inv};
  if (!dispatch<K2Launcher>(k, fading, word_bits, x, agg, errs, seeds, npow,
                            gains, weights, clients, valid_words, p,
                            static_cast<cudaStream_t>(stream))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
