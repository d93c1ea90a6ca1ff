// The shaped Gaussian noise spectrum of every plane of an event, drawn in
// one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The reference draws its noise through
// jax.random (src/repro/core/noise.py simulate_noise), which XLA fuses into
// one pass over the spectrum. The port's eager version of the same draw
// (core/prng.py: threefry2x32 on int64 tensors masked to 32 bits, then the
// uniform, erfinv and the shaping) runs ~185 elementwise ops a normal, each
// carrying the (W, nfreq) block through device memory; this kernel keeps
// every intermediate in registers.
//
// What it computes. For plane p of P, row w of n_rows and rfft bin f of
// nfreq, with the plane's keys k1 (real parts) and k2 (imaginary parts), the
// 64-bit counter c = w * nfreq + f (hi and lo words) and
//   bits(k)   = x0 ^ x1 of threefry2x32(k, (hi(c), lo(c))): 20 rounds, the
//               rotations (13, 15, 26, 6) and (17, 29, 16, 24), a key
//               injection every 4 rounds (core/prng.py threefry2x32 and
//               random_bits, jax.random's partitionable mode),
//   u         = max(fma(float((bits >> 9) | 0x3F800000) - 1, span, lo), lo),
//   normal(k) = erfinv(u) * sqrt2,
// it writes out[p, w, f] = ((normal(k1) * amp[f]) * scale,
//                           (im * amp[f]) * scale),
// im = normal(k2), or 0 at f = 0 and, for an even number of ticks, at
// f = nfreq - 1 (a Hermitian spectrum's self-conjugate bins). With a null
// `amp` it writes the unit normals (normal(k1), im) unshaped: the
// calibration path shapes them with autograd. lo, span, sqrt2 and scale are
// the caller's float32 constants (core/prng.py NORMAL_LO, the float32
// difference 1 - NORMAL_LO, SQRT2_F32; 1/sqrt(2)).
//
// Numerics. The reference's XLA contracts the uniform's `u * span + lo`
// into one FMA, which the port's plain version reproduces in float64 (the
// product and the sum are exact there); fmaf rounds the same exact value
// once. erfinvf is the function torch's CUDA erfinv calls for float32, and
// the products are __fmul_rn in the plain version's order. No
// --use_fast_math, so the kernel equals the plain version on the card bit
// for bit.
//
// Design. A thread draws kPerThread consecutive complex elements of the
// flat (P, n_rows, nfreq) output (both parts of each: 2 x kPerThread
// independent threefry chains for the scheduler to interleave) and stores
// them as float4 pairs, consecutive threads on consecutive 32 bytes. Row,
// bin and plane advance with the element, so a run may cross a row or a
// plane. The plane keys travel by value in a __grid_constant__ parameter,
// read in place (no device copy, no host-to-device transfer).
//
// What bounds it on an H100. Not the bytes: the output is written once (3 x
// 2400 x 4801 x 8 bytes = 277 MB at MicroBooNE width, ~83 us at 3.35 TB/s)
// and amp (19 KB) stays in L1. The integer ALU: a threefry is ~77 32-bit
// integer operations (2 key adds, 20 rounds of add, funnel shift and xor,
// 5 injections of 2 adds, the parity, the fold and the uniform's shift and
// or), two a bin: 3 x 2400 x 4801 x 154 = 5.3 G operations, 0.32 ms at 132
// SMs x 64 INT32 lanes x 1.98 GHz; the two erfinvf a bin go to the float
// pipes beside them. Measured on an H100 80GB HBM3 at 700 W: 0.33 ms for
// that event, against 84 ms for the eager draw.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;       // consecutive complex elements a thread
constexpr int kMaxPlanes = 16;      // planes one launch takes
constexpr uint32_t kParity = 0x1BD11BDAu;

// Per plane: the real parts' key words, then the imaginary parts'.
struct PlaneKeys {
  uint32_t words[4 * kMaxPlanes];
};

struct Constants {
  float lo;      // the uniform's lower bound, nextafter(-1, 0)
  float span;    // float32(1 - lo)
  float sqrt2;   // float32(sqrt(2))
  float scale;   // float32(1 / sqrt(2))
};

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1,
                                            int r0, int r1, int r2, int r3) {
  mix(x0, x1, r0);
  mix(x0, x1, r1);
  mix(x0, x1, r2);
  mix(x0, x1, r3);
}

// threefry2x32 (20 rounds) of the counter (x0, x1) under key (k0, k1),
// folded to 32 bits as core/prng.py random_bits folds it: b0 ^ b1.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
  four_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k1;
  x1 += k2 + 1u;
  four_rounds(x0, x1, 17, 29, 16, 24);
  x0 += k2;
  x1 += k0 + 2u;
  four_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k0;
  x1 += k1 + 3u;
  four_rounds(x0, x1, 17, 29, 16, 24);
  x0 += k1;
  x1 += k2 + 4u;
  four_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k2;
  x1 += k0 + 5u;
  return x0 ^ x1;
}

// A float32 normal from 32 random bits: core/prng.py normal's arithmetic.
__device__ __forceinline__ float normal_of(uint32_t bits, const Constants& c) {
  const float unit = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float u = fmaxf(fmaf(unit, c.span, c.lo), c.lo);
  return __fmul_rn(erfinvf(u), c.sqrt2);
}

__global__ void __launch_bounds__(kThreads)
noise_spectrum_kernel(const __grid_constant__ PlaneKeys keys,
                      const Constants c, const float* __restrict__ amp,
                      int nfreq, int zero_last, long long plane_size,
                      long long total, float2* __restrict__ out) {
  const long long first =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) *
      kPerThread;
  if (first >= total) return;
  int plane = static_cast<int>(first / plane_size);
  long long count = first - plane * plane_size;  // w * nfreq + f
  int f = static_cast<int>(count % nfreq);
  float2 v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (first + j >= total) break;  // the last thread's run ends early
    const uint32_t hi = static_cast<uint32_t>(count >> 32);
    const uint32_t lo = static_cast<uint32_t>(count);
    const uint32_t* k = keys.words + 4 * plane;
    float re = normal_of(threefry_bits(k[0], k[1], hi, lo), c);
    float im = normal_of(threefry_bits(k[2], k[3], hi, lo), c);
    if (f == 0 || (zero_last && f == nfreq - 1)) im = 0.0f;
    if (amp != nullptr) {
      const float a = __ldg(amp + f);
      re = __fmul_rn(__fmul_rn(re, a), c.scale);
      im = __fmul_rn(__fmul_rn(im, a), c.scale);
    }
    v[j] = make_float2(re, im);
    if (++f == nfreq) f = 0;
    if (++count == plane_size) {
      count = 0;
      ++plane;
    }
  }
  if (first + kPerThread <= total) {
    float4* dst = reinterpret_cast<float4*>(out + first);
#pragma unroll
    for (int j = 0; j < kPerThread / 2; ++j)
      dst[j] = make_float4(v[2 * j].x, v[2 * j].y, v[2 * j + 1].x,
                           v[2 * j + 1].y);
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (first + j < total) out[first + j] = v[j];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). `key_words` is a HOST array of 4
// words a plane (real parts' key, then imaginary parts'); `amp` is nfreq
// floats on the card, or null for unit normals; `out` is the
// (num_planes, n_rows, nfreq) complex64 output, 16-byte aligned. Launches
// on `stream` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int noise_spectrum(const uint32_t* key_words, int num_planes,
                              int n_rows, int nfreq, int zero_last,
                              const float* amp, float lo, float span,
                              float sqrt2, float scale, void* out,
                              void* stream) {
  if (num_planes < 1 || num_planes > kMaxPlanes || n_rows < 1 || nfreq < 1 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  PlaneKeys keys{};
  for (int i = 0; i < 4 * num_planes; ++i) keys.words[i] = key_words[i];
  const Constants c{lo, span, sqrt2, scale};
  const long long plane_size = static_cast<long long>(n_rows) * nfreq;
  const long long total = plane_size * num_planes;
  const long long threads = (total + kPerThread - 1) / kPerThread;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  noise_spectrum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      keys, c, amp, nfreq, zero_last, plane_size, total,
      static_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}
