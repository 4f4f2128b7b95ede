// Approximate-channel uplink kernels for Hopper (sm_90a).
//
// Replaces the two TPU kernels of src/repro/kernels/approx_channel.py:
//   K1  k1_approx_channel_batch   <- approx_channel_batch_pallas (:405)
//       (client, tile) grid over a (C, N) payload: bitcast -> MSB-first
//       k-bit symbols -> in-tile interleave -> Gray QAM -> counter-RNG
//       noise + fading -> zero-forcing equalise -> per-axis ML demod ->
//       words -> & clamp_mask -> popcount errors.
//   K2  k2_approx_channel_aggregate <- approx_channel_batch_aggregate_pallas
//       (:294): K1's chain, then agg += w[c] * x_hat[c] in client order;
//       the (C, N) received payload never reaches device memory.
// (approx_channel_pallas, :52, is K1 at C = 1; the wrapper calls K1.)
//
// What bounds them on an H100 SXM. At the main-path shape (C = 100
// clients, N = 22,528 words, QPSK, f32 wire) K1 reads 9.0 MB and writes
// 9.0 MB: 5.4 us at 3.35 TB/s. Every symbol (16 per word at QPSK) costs
// four hash evaluations plus two logf, two sqrtf, two cosf, two sinf and
// two divides: 66 float and 119 integer operations when each libdevice
// call counts as one (chip_smoke.py::_k1_ops_per_symbol), 6.7e9 in all,
// 0.10 ms even at the 67 TFLOP/s float32 peak. The arithmetic, not the
// bytes, sets the bound. K2 does the same arithmetic and moves half the
// bytes.
//
// Design. One thread owns one word and loops over its S = word_bits / k
// symbols; a symbol's global index comes from the interleave formula
// base + s * block_words + w, so nothing is transposed. block_words is
// part of the wire format (it fixes the interleave and the RNG indices),
// not the CUDA block size. K1 reduces per-client error counts in a warp
// (every block lies in one client row), then with an integer atomicAdd:
// exact in any order. K2 keeps the accumulator in a register and loops
// over clients c = 0..C-1 in order, so its sum has the plain version's
// order exactly.
//
// Arithmetic matches the plain PyTorch version (kernels/ref.py) bit for
// bit: every multiply, add and divide is an explicit round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn), which the compiler never
// fuses into an fma; sqrt is __fsqrt_rn; logf, cosf, sinf are the
// libdevice routines PyTorch's own CUDA elementwise ops call; rintf is
// round half to even (jnp.round); hashes and symbol indices are uint32 so
// they wrap as the reference's do. Never build with --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kStreamNoise = 0x9E3779B9u;
constexpr uint32_t kStreamFade = 0x7FEB352Du;
constexpr uint32_t kStreamPhase = 0x68E31DA4u;

enum Fading { kRayleigh = 0, kAwgn = 1, kBlockRayleigh = 2 };

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t seed, uint32_t idx,
                                             uint32_t stream) {
  return fmix32(seed ^ fmix32(idx * 0x9E3779B9u + stream));
}

// uint32 hash -> uniform float in (0, 1].
__device__ __forceinline__ float uniform01(uint32_t h) {
  return __fadd_rn(__fmul_rn(static_cast<float>(h >> 8), 0x1p-24f), 0x1p-25f);
}

// Two iid N(0, 1) floats via Box-Muller on counter-RNG uniforms.
__device__ __forceinline__ void gauss_pair(uint32_t seed, uint32_t idx,
                                           uint32_t stream, float& a,
                                           float& b) {
  const float u1 = uniform01(hash_u32(seed, idx, stream));
  const float u2 = uniform01(hash_u32(seed, idx, stream ^ kStreamPhase));
  const float r = __fsqrt_rn(__fmul_rn(-2.0f, logf(u1)));
  const float ang = __fmul_rn(u2, 6.283185307179586f);  // float32(2*pi)
  a = __fmul_rn(r, cosf(ang));
  b = __fmul_rn(r, sinf(ang));
}

__device__ __forceinline__ uint32_t gray_decode(uint32_t g) {
  g ^= g >> 1;
  g ^= g >> 2;
  g ^= g >> 4;
  return g;
}

// Closed-form ML demod of one axis: round((y * inv + (L - 1)) * 0.5),
// clipped to [0, L - 1].
template <int L>
__device__ __forceinline__ uint32_t axis_level(float y, float inv) {
  const float v =
      __fmul_rn(__fadd_rn(__fmul_rn(y, inv), static_cast<float>(L - 1)), 0.5f);
  const float lvl =
      fminf(fmaxf(rintf(v), 0.0f), static_cast<float>(L - 1));
  return static_cast<uint32_t>(lvl);
}

// One word through the channel: the received word, before the clamp.
template <int K, int FADING, int WB>
__device__ __forceinline__ uint32_t channel_word(
    uint32_t u, uint32_t seed, uint32_t base, uint32_t w, uint32_t bw,
    uint32_t fade_block, float nscale, float sg, float amp, float inv) {
  constexpr int P = K / 2;
  constexpr int L = 1 << P;
  constexpr int S = WB / K;
  const float hs = __fsqrt_rn(0.5f);
  uint32_t u_hat = 0;
  // Not unrolled: each symbol inlines four libdevice calls with their slow
  // paths, and 18 instances of each kernel would compile for minutes.
#pragma unroll 1
  for (int s = 0; s < S; ++s) {
    const int shift = WB - K * (s + 1);
    const uint32_t sym = (u >> shift) & ((1u << K) - 1u);
    uint32_t gi = 0, gq = 0;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      gi |= ((sym >> (K - 1 - 2 * j)) & 1u) << (P - 1 - j);
      gq |= ((sym >> (K - 2 - 2 * j)) & 1u) << (P - 1 - j);
    }
    const float s_re = __fmul_rn(
        __fadd_rn(__fmul_rn(2.0f, static_cast<float>(gray_decode(gi))),
                  -static_cast<float>(L - 1)),
        amp);
    const float s_im = __fmul_rn(
        __fadd_rn(__fmul_rn(2.0f, static_cast<float>(gray_decode(gq))),
                  -static_cast<float>(L - 1)),
        amp);

    const uint32_t gidx = base + static_cast<uint32_t>(s) * bw + w;
    float n_re, n_im;
    gauss_pair(seed, gidx, kStreamNoise, n_re, n_im);
    n_re = __fmul_rn(n_re, nscale);
    n_im = __fmul_rn(n_im, nscale);
    float c_re, c_im;
    if (FADING == kAwgn) {
      c_re = __fmul_rn(sg, 1.0f);
      c_im = 0.0f;
    } else {
      const uint32_t fidx = FADING == kBlockRayleigh ? gidx / fade_block : gidx;
      float h_re, h_im;
      gauss_pair(seed, fidx, kStreamFade, h_re, h_im);
      c_re = __fmul_rn(__fmul_rn(sg, h_re), hs);
      c_im = __fmul_rn(__fmul_rn(sg, h_im), hs);
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
    u_hat |= rx << shift;
  }
  return u_hat;
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
  int n;              // words per client row (a multiple of bw)
  int bw;             // block_words: interleave tile of the wire format
  int fade_block;     // symbols per fading block (block_rayleigh)
  uint32_t clamp;     // receiver AND-mask
  int num_active;     // rows at or beyond it are masked
  float amp;          // float32(sqrt(3 / (2 (L^2 - 1))))
  float inv;          // float32(1 / amp)
};

// K1: blockIdx.y = client row, one thread per word of the row.
template <int K, int FADING, int WB>
__global__ void k1_approx_channel_batch(
    const typename Wire<WB>::T* __restrict__ x,
    typename Wire<WB>::T* __restrict__ out, int* __restrict__ errs,
    const uint32_t* __restrict__ seeds, const float* __restrict__ npow,
    const float* __restrict__ gains, Params p) {
  constexpr uint32_t S = WB / K;
  const int c = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t flips = 0;
  if (i < p.n) {
    const size_t off = static_cast<size_t>(c) * p.n + i;
    if (c < p.num_active) {
      const uint32_t u = x[off];
      const uint32_t tile = static_cast<uint32_t>(i) / p.bw;
      const uint32_t w = static_cast<uint32_t>(i) % p.bw;
      const uint32_t base = tile * (static_cast<uint32_t>(p.bw) * S);
      const float nscale = __fsqrt_rn(__fmul_rn(npow[c], 0.5f));
      const float sg = __fsqrt_rn(gains[c]);
      const uint32_t u_hat =
          channel_word<K, FADING, WB>(u, seeds[c], base, w, p.bw,
                                      p.fade_block, nscale, sg, p.amp, p.inv) &
          p.clamp;
      out[off] = static_cast<typename Wire<WB>::T>(u_hat);
      flips = __popc(u ^ u_hat);
    } else {
      out[off] = 0;
    }
  }
  flips = __reduce_add_sync(0xffffffffu, flips);
  if ((threadIdx.x & 31) == 0 && flips != 0) {
    atomicAdd(&errs[c], static_cast<int>(flips));
  }
}

// K2: one thread per word; the thread walks the clients in order.
template <int K, int FADING, int WB>
__global__ void k2_approx_channel_aggregate(
    const typename Wire<WB>::T* __restrict__ x, float* __restrict__ agg,
    int* __restrict__ errs, const uint32_t* __restrict__ seeds,
    const float* __restrict__ npow, const float* __restrict__ gains,
    const float* __restrict__ weights, int clients, int valid_words,
    Params p) {
  constexpr uint32_t S = WB / K;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_row = i < p.n;
  const uint32_t tile = static_cast<uint32_t>(i) / p.bw;
  const uint32_t w = static_cast<uint32_t>(i) % p.bw;
  const uint32_t base = tile * (static_cast<uint32_t>(p.bw) * S);
  const int active = min(clients, p.num_active);
  float acc = 0.0f;
  for (int c = 0; c < active; ++c) {
    uint32_t flips = 0;
    if (in_row) {
      const uint32_t u = x[static_cast<size_t>(c) * p.n + i];
      const float nscale = __fsqrt_rn(__fmul_rn(npow[c], 0.5f));
      const float sg = __fsqrt_rn(gains[c]);
      const uint32_t u_hat =
          channel_word<K, FADING, WB>(u, seeds[c], base, w, p.bw,
                                      p.fade_block, nscale, sg, p.amp, p.inv) &
          p.clamp;
      acc = __fadd_rn(acc, __fmul_rn(weights[c], Wire<WB>::to_f32(u_hat)));
      if (i < valid_words) flips = __popc(u ^ u_hat);
    }
    flips = __reduce_add_sync(0xffffffffu, flips);
    if ((threadIdx.x & 31) == 0 && flips != 0) {
      atomicAdd(&errs[c], static_cast<int>(flips));
    }
  }
  if (in_row) agg[i] = acc;
}

constexpr int kK1Threads = 256;
constexpr int kK2Threads = 64;

template <int K, int FADING, int WB>
void launch_k1(const void* x, void* out, int* errs, const uint32_t* seeds,
               const float* npow, const float* gains, int clients,
               const Params& p, cudaStream_t stream) {
  using T = typename Wire<WB>::T;
  const dim3 grid((p.n + kK1Threads - 1) / kK1Threads, clients);
  k1_approx_channel_batch<K, FADING, WB><<<grid, kK1Threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), errs, seeds, npow, gains,
      p);
}

template <int K, int FADING, int WB>
void launch_k2(const void* x, float* agg, int* errs, const uint32_t* seeds,
               const float* npow, const float* gains, const float* weights,
               int clients, int valid_words, const Params& p,
               cudaStream_t stream) {
  using T = typename Wire<WB>::T;
  const dim3 grid((p.n + kK2Threads - 1) / kK2Threads);
  k2_approx_channel_aggregate<K, FADING, WB><<<grid, kK2Threads, 0, stream>>>(
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
// k / fading / word_bits). Outputs are allocated by the caller; errs must
// be zeroed, since blocks add their counts into it.
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
