// The layered PHY's channel stage for Hopper (sm_90a), in one launch.
//
// What it computes: src/repro_torch/core/transport.py::_through_channel on
// the card, that is modulation.modulate -> channel.transmit ->
// channel.equalize on a (C, S) stream of symbol indices with one threefry
// key a row: Gray square-QAM points, the row's keys split as
// key -> (k_h, k_n), each -> (re, im), four threefry normals a symbol
// (fading re / im, noise re / im; none for AWGN's fading, one pair a
// fading block for block_rayleigh), the composite gain c = amp h, r = c s +
// n, and zero-forcing y = r / c by Smith's algorithm. It writes y, and c
// where the caller asks; no normal, key or r reaches device memory.
//
// It replaces no Pallas kernel. The JAX package's layered channel
// (src/repro/core/channel.py, modulation.py) is plain jnp, which XLA fuses
// into a few loops. The port ran it as eager PyTorch, where prng.normal's
// threefry is int64 tensor passes masked to 32 bits: about 160 passes a
// draw, four draws a symbol, then uniform's float64 fma, erfinv and some
// 25 float32 passes of the channel product and the division, and about
// 480 launches of key splits before any of it. At the paper's FedSGD round
// on the layered PHY (100 clients x 21,840 words x 16 QPSK symbols =
// 34,944,000 symbols) that stage took 172.7 ms of a 197.5 ms round on an
// H100 (the benchmark's cnn-approx-layered cell, span round/uplink/channel).
//
// What bounds it. Each symbol runs four threefry-2x32 hashes of 20 rounds
// (add, rotate, xor: about 75 integer instructions a hash), so 139.8 M
// hashes a round, about 10.5 G instructions on the integer pipe, which
// issues half a warp a clock: 0.65 ms at 132 SMs x 64 lanes x 1.98 GHz.
// erfinvf and the channel arithmetic add about 0.2-0.3 ms on the float32
// pipe; 280 MB of int64 indices in and 280 MB of complex64 out take 0.17
// ms at 3.35 TB/s. The floor is about 1 ms, set by the integer pipe first
// and the bytes second. The design keeps all four hashes of a symbol in
// one thread (four independent chains to interleave) and derives the
// row's keys once a tile: threads 0-3 of a block hash split(key) and then
// split(k_h) / split(k_n) (two hashes each) into shared memory, one
// barrier, and every thread reads the four keys. A tile is 2,048
// consecutive symbols of one row, 8 a thread at a stride of 256, so each
// load of an index and each store of y is coalesced.
//
// Bit for bit the eager chain on the card. Every multiply, add, subtract
// and divide is an explicit round-to-nearest intrinsic (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn), which the compiler never fuses into an
// fma, in the eager chain's order; never build with --use_fast_math. The
// lines each rounding copies:
// - modulation.py::_points: (2.0 * li - (L - 1)) * amp is an exact integer
//   times the float32 amplitude, one rounding (level_point);
// - prng.py::_bits_to_unit_f32: the top 23 bits as the mantissa of [1, 2),
//   minus 1.0, exact;
// - prng.py::uniform: floats * (hi - lo) + lo in float64, cast to float32,
//   with lo = nextafter(-1, 0) and hi - lo rounded in float32 to 2.0: the
//   float64 sum is exact (a multiple of 2**-24 below 2), so the cast is one
//   rounding of the exact value, which __fmaf_rn also gives; then
//   torch.maximum(lo, .) as fmaxf;
// - prng.py::normal: torch.erfinv, which on the card calls CUDA's erfinvf,
//   then * float32(sqrt 2);
// - channel.py::_cn: * s, s = sqrt(float32(var / 2)) computed by the
//   wrapper with the same torch expressions (0.5 for the fading, the noise
//   power's per row or once);
// - channel.py::transmit: cr, ci = hr * amp, hi * amp (AWGN: 1 * amp and
//   0 * amp, kept as products so a signed zero stays signed), then
//   rr = (cr * sr - ci * si) + nr and ri = (cr * si + ci * sr) + ni;
// - channel.py::equalize: big = |cr| >= |ci|; rat, den, yr and yi as its
//   four torch.where lines, the taken side of each.
// Threefry and the key schedule are prng.py's threefry2x32, split and
// random_bits: counter (0, j) for symbol j of a row, (0, j / block_len)
// for block_rayleigh's fading. A row holds fewer than 2**32 symbols (the
// wrapper raises otherwise, as random_bits does), so j is a uint32.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;  // symbols of one row a tile
constexpr int64_t kMaxGrid = 1 << 20;         // more tiles: grid-stride

constexpr float kLo = -0x1.fffffep-1f;    // prng._LO_NORMAL = nextafter(-1, 0)
constexpr float kSpan = 2.0f;             // float32(1.0 - kLo), ties to even
constexpr float kSqrt2 = 0x1.6a09e6p+0f;  // prng._SQRT2_F32

enum Fading { kRayleigh = 0, kAwgn = 1, kBlockRayleigh = 2 };

__host__ __device__ constexpr int rotation(int i, int r) {
  return (i % 2 == 0) ? (r == 0 ? 13 : r == 1 ? 15 : r == 2 ? 26 : 6)
                      : (r == 0 ? 17 : r == 1 ? 29 : r == 2 ? 16 : 24);
}

// prng.py::threefry2x32 of the counter (hi, lo) under (k0, k1).
__device__ __forceinline__ uint2 threefry(uint32_t k0, uint32_t k1,
                                          uint32_t hi, uint32_t lo) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t a = hi + ks[0];
  uint32_t b = lo + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a += b;
      b = __funnelshift_l(b, b, rotation(i, r)) ^ a;
    }
    a += ks[(i + 1) % 3];
    b += ks[(i + 2) % 3] + uint32_t(i + 1);
  }
  return make_uint2(a, b);
}

// prng.py::normal of one hash: random_bits' a ^ b, uniform, erfinv.
__device__ __forceinline__ float normal_of(uint2 h) {
  const uint32_t bits = h.x ^ h.y;
  const float f =
      __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(kLo, __fmaf_rn(f, kSpan, kLo));
  return __fmul_rn(erfinvf(u), kSqrt2);
}

// modulation.py::_points on one axis's Gray bits (at most 4 of them).
__device__ __forceinline__ float level_point(uint32_t g, int levels,
                                             float amp) {
  uint32_t l = g ^ (g >> 1);
  l ^= l >> 2;
  return __fmul_rn(float(int(2 * l) - (levels - 1)), amp);
}

template <int kFading>
__global__ void __launch_bounds__(kThreads)
phy_channel_stage(const int64_t* __restrict__ sym,
                  const int64_t* __restrict__ keys, float2* __restrict__ y,
                  float2* __restrict__ c_out,
                  const float* __restrict__ nscale, int nscale_step,
                  int64_t rows, int64_t n, int64_t tiles_per_row, int k,
                  uint32_t block_len, float hscale, float gain_amp,
                  float point_amp) {
  // (re, im) of k_h, then of k_n
  __shared__ uint32_t row_keys[4][2];
  const int p = k / 2;
  const int levels = 1 << p;
  const int64_t total = rows * tiles_per_row;
  for (int64_t t = blockIdx.x; t < total; t += gridDim.x) {
    const int64_t row = t / tiles_per_row;
    const int64_t start = (t - row * tiles_per_row) * kTile;
    if (threadIdx.x < 4) {
      // split(key) -> (k_h, k_n), then split of each -> (re, im)
      const uint2 half = threefry(uint32_t(keys[2 * row]),
                                  uint32_t(keys[2 * row + 1]), 0u,
                                  threadIdx.x >> 1);
      const uint2 key = threefry(half.x, half.y, 0u, threadIdx.x & 1u);
      row_keys[threadIdx.x][0] = key.x;
      row_keys[threadIdx.x][1] = key.y;
    }
    __syncthreads();
    const uint32_t khr0 = row_keys[0][0], khr1 = row_keys[0][1];
    const uint32_t khi0 = row_keys[1][0], khi1 = row_keys[1][1];
    const uint32_t knr0 = row_keys[2][0], knr1 = row_keys[2][1];
    const uint32_t kni0 = row_keys[3][0], kni1 = row_keys[3][1];
    const float ns = nscale[row * nscale_step];
    const int64_t base = row * n;
#pragma unroll 1
    for (int i = 0; i < kPerThread; ++i) {
      const int64_t j = start + threadIdx.x + int64_t(i) * kThreads;
      if (j >= n) break;
      const uint32_t jj = uint32_t(j);
      const uint32_t s = uint32_t(sym[base + j]);
      // modulation.py::_split_axes: bits alternate I, Q, MSB first
      uint32_t gi = 0, gq = 0;
      for (int b = 0; b < p; ++b) {
        gi |= ((s >> (k - 1 - 2 * b)) & 1u) << (p - 1 - b);
        gq |= ((s >> (k - 2 - 2 * b)) & 1u) << (p - 1 - b);
      }
      const float sr = level_point(gi, levels, point_amp);
      const float si = level_point(gq, levels, point_amp);
      float hr, hi;
      if (kFading == kAwgn) {
        hr = 1.0f;
        hi = 0.0f;
      } else {
        const uint32_t fc = kFading == kBlockRayleigh ? jj / block_len : jj;
        hr = __fmul_rn(normal_of(threefry(khr0, khr1, 0u, fc)), hscale);
        hi = __fmul_rn(normal_of(threefry(khi0, khi1, 0u, fc)), hscale);
      }
      const float cr = __fmul_rn(hr, gain_amp);
      const float ci = __fmul_rn(hi, gain_amp);
      const float nr = __fmul_rn(normal_of(threefry(knr0, knr1, 0u, jj)), ns);
      const float ni = __fmul_rn(normal_of(threefry(kni0, kni1, 0u, jj)), ns);
      const float rr =
          __fadd_rn(__fsub_rn(__fmul_rn(cr, sr), __fmul_rn(ci, si)), nr);
      const float ri =
          __fadd_rn(__fadd_rn(__fmul_rn(cr, si), __fmul_rn(ci, sr)), ni);
      float yr, yi;
      if (fabsf(cr) >= fabsf(ci)) {
        const float rat = __fdiv_rn(ci, cr);
        const float den = __fadd_rn(cr, __fmul_rn(ci, rat));
        yr = __fdiv_rn(__fadd_rn(rr, __fmul_rn(ri, rat)), den);
        yi = __fdiv_rn(__fsub_rn(ri, __fmul_rn(rr, rat)), den);
      } else {
        const float rat = __fdiv_rn(cr, ci);
        const float den = __fadd_rn(ci, __fmul_rn(cr, rat));
        yr = __fdiv_rn(__fadd_rn(__fmul_rn(rr, rat), ri), den);
        yi = __fdiv_rn(__fsub_rn(__fmul_rn(ri, rat), rr), den);
      }
      y[base + j] = make_float2(yr, yi);
      if (c_out != nullptr) c_out[base + j] = make_float2(cr, ci);
    }
    __syncthreads();  // the next tile rewrites row_keys
  }
}

// normal_of on given bits, one thread a value: the test hook that holds
// the draws' uniform and erfinvf against prng.normal's torch ops on every
// one of the 2**23 mantissas random_bits can give.
__global__ void phy_normal_of_bits(const int32_t* __restrict__ bits,
                                   float* __restrict__ out, int64_t n) {
  const int64_t m = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (m < n) out[m] = normal_of(make_uint2(uint32_t(bits[m]), 0u));
}

}  // namespace

extern "C" {

// One launch over a contiguous (rows, n) int64 stream of symbol indices,
// keys (rows, 2) int64 holding uint32 values; y and c_out (rows, n)
// complex64 as float2, c_out may be null; nscale one float a row
// (nscale_step 1) or one for all (nscale_step 0). Returns
// cudaGetLastError().
int repro_phy_channel_stage(const void* sym, const void* keys, void* y,
                            void* c_out, const void* nscale, int nscale_step,
                            int64_t rows, int64_t n, int k, int fading,
                            int64_t block_len, float hscale, float gain_amp,
                            float point_amp, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const int64_t tiles_per_row = (n + kTile - 1) / kTile;
  const unsigned grid =
      unsigned(std::min<int64_t>(rows * tiles_per_row, kMaxGrid));
  // j < 2**32 - 1, so a block longer than that holds the whole row
  const uint32_t bl = uint32_t(std::min<int64_t>(block_len, 0xFFFFFFFFll));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* sy = static_cast<const int64_t*>(sym);
  const auto* ky = static_cast<const int64_t*>(keys);
  auto* yo = static_cast<float2*>(y);
  auto* co = static_cast<float2*>(c_out);
  const auto* ns = static_cast<const float*>(nscale);
  switch (fading) {
    case kRayleigh:
      phy_channel_stage<kRayleigh><<<grid, kThreads, 0, s>>>(
          sy, ky, yo, co, ns, nscale_step, rows, n, tiles_per_row, k, bl,
          hscale, gain_amp, point_amp);
      break;
    case kAwgn:
      phy_channel_stage<kAwgn><<<grid, kThreads, 0, s>>>(
          sy, ky, yo, co, ns, nscale_step, rows, n, tiles_per_row, k, bl,
          hscale, gain_amp, point_amp);
      break;
    case kBlockRayleigh:
      phy_channel_stage<kBlockRayleigh><<<grid, kThreads, 0, s>>>(
          sy, ky, yo, co, ns, nscale_step, rows, n, tiles_per_row, k, bl,
          hscale, gain_amp, point_amp);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// normal_of of n uint32 values held as int32; returns cudaGetLastError().
int repro_phy_normal_of_bits(const void* bits, void* out, int64_t n,
                             void* stream) {
  if (n <= 0) return 0;
  const unsigned grid = unsigned((n + kThreads - 1) / kThreads);
  phy_normal_of_bits<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bits), static_cast<float*>(out), n);
  return int(cudaGetLastError());
}

}  // extern "C"
