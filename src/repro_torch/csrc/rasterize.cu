// Batched depo rasterization with Box-Muller fluctuation from uniform pools,
// for Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernel
//   src/repro/kernels/rasterize/kernel.py:78  rasterize_pallas
// (body _rasterize_kernel, :31), the paper's fig4 rasterization.
//
// What it computes. Each depo d gets a (pw_pad, pt_pad) block whose
// (pw, pt) corner is its bin-integrated Gaussian patch,
//   patch[r, c] = (q * ww[r]) * wt[c],
//   ww[r] = max(0.5 * (erf((w0 + r + 1 - wire) / (sigma_w * sqrt2))
//                      - erf((w0 + r - wire) / (sigma_w * sqrt2))), 0)
// (wt likewise along ticks), and whose padding is zero. With `fluctuate`
// each pixel is replaced by the binomial normal approximation
//   normal = sqrt(-2 log(max(u1, 1e-12))) * cos(2 pi u2),
//   p = clip(patch / max(q, 1), 0, 1), var = max(patch * (1 - p), 0),
//   patch = max(patch + sqrt(var) * normal, 0),
// with u1, u2 read from the (N, pw_pad, pt_pad) uniform pools.
//
// Design. One CTA per depo. Its threads first compute the pw + pt axis
// weights once (two erf each) into shared memory, then walk the block's
// pixels with consecutive threads on consecutive addresses, so every read
// of the pools and every write of the output is coalesced. Padding pixels
// are written as 0 without reading the pools: there the mean is 0, so the
// reference's result is 0 whatever the normal.
//
// Numerics. IEEE erff, logf, cosf, sqrtf and division (no --use_fast_math),
// the same functions torch's CUDA ops call, so the kernel equals the plain
// PyTorch version bit for bit. The reference's XLA on the CPU contracts
// patch + sqrt(var) * normal into one FMA (measured: all pixels of a
// 256-depo probe match an FMA, 1.2 % differ from two roundings), so that
// step is __fmaf_rn; every other product and sum is __fmul_rn / __fadd_rn /
// __fsub_rn, which the compiler never contracts.
//
// What bounds it on an H100. Bytes: the output is written once (N x 24 x
// 128 x 4 bytes = 1.23 GB at 100 096 padded depos) and, with `fluctuate`,
// the in-support part of both pools read (2 x N x 20 x 20 x 4 bytes = 0.32
// GB); the depo parameters are 2.8 MB: ~1.55 GB, about 0.46 ms at 3.35 TB/s.
// The operations (log, cos, two sqrt, a division and ~12 others per
// in-support pixel, 40 M pixels) are ~0.8 G, about 12 us at the float32
// rate: bytes bound it. Most of the written bytes are the padding the
// reference's (N, pw_pad, pt_pad) contract asks for.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kSqrt2 = 1.41421353816986083984375f;  // float32(sqrt(2))
constexpr float kTwoPi = 6.283185482025146484375f;    // float32(2*pi)

struct RasterParams {
  const float* wire;
  const float* tick;
  const float* sigma_w;
  const float* sigma_t;
  const float* charge;
  const int* w0;
  const int* t0;
  const float* u1;  // (N, pw_pad, pt_pad), read only with fluctuate
  const float* u2;
  float* out;       // (N, pw_pad, pt_pad)
  int pw;
  int pt;
  int pw_pad;
  int pt_pad;
  int fluctuate;
};

// max(0.5 * (erf((origin + i + 1 - center) / den) - erf((origin + i -
// center) / den)), 0), in the reference's operation order
__device__ __forceinline__ float axis_weight(float origin, int i,
                                             float center, float den) {
  const float edge = __fadd_rn(origin, static_cast<float>(i));
  const float lo = erff(__fsub_rn(edge, center) / den);
  const float hi = erff(__fsub_rn(__fadd_rn(edge, 1.0f), center) / den);
  return fmaxf(__fmul_rn(0.5f, __fsub_rn(hi, lo)), 0.0f);
}

__global__ void __launch_bounds__(kThreads) rasterize_kernel(RasterParams p) {
  extern __shared__ float weights[];  // ww[pw], then wt[pt]
  float* ww = weights;
  float* wt = weights + p.pw;
  const int d = blockIdx.x;
  const float q = p.charge[d];
  for (int i = threadIdx.x; i < p.pw + p.pt; i += blockDim.x) {
    if (i < p.pw)
      ww[i] = axis_weight(static_cast<float>(p.w0[d]), i, p.wire[d],
                          __fmul_rn(p.sigma_w[d], kSqrt2));
    else
      wt[i - p.pw] = axis_weight(static_cast<float>(p.t0[d]), i - p.pw,
                                 p.tick[d], __fmul_rn(p.sigma_t[d], kSqrt2));
  }
  __syncthreads();

  const int npix = p.pw_pad * p.pt_pad;
  const long long base = static_cast<long long>(d) * npix;
  const float qq = fmaxf(q, 1.0f);
  for (int i = threadIdx.x; i < npix; i += blockDim.x) {
    const int r = i / p.pt_pad, c = i - r * p.pt_pad;
    float v = 0.0f;
    if (r < p.pw && c < p.pt) {
      v = __fmul_rn(__fmul_rn(q, ww[r]), wt[c]);
      if (p.fluctuate) {
        const float u1 = fmaxf(p.u1[base + i], 1e-12f);
        const float u2 = p.u2[base + i];
        const float normal = __fmul_rn(sqrtf(__fmul_rn(-2.0f, logf(u1))),
                                       cosf(__fmul_rn(kTwoPi, u2)));
        const float pr = fminf(fmaxf(v / qq, 0.0f), 1.0f);
        const float var = fmaxf(__fmul_rn(v, __fsub_rn(1.0f, pr)), 0.0f);
        v = fmaxf(__fmaf_rn(sqrtf(var), normal, v), 0.0f);
      }
    }
    p.out[base + i] = v;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int rasterize(const float* wire, const float* tick,
                         const float* sigma_w, const float* sigma_t,
                         const float* charge, const int* w0, const int* t0,
                         const float* u1, const float* u2, int n, int pw,
                         int pt, int pw_pad, int pt_pad, int fluctuate,
                         float* out, void* stream) {
  if (n < 0 || pw <= 0 || pt <= 0 || pw > pw_pad || pt > pt_pad ||
      (fluctuate && (u1 == nullptr || u2 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const RasterParams p{wire, tick, sigma_w, sigma_t, charge, w0, t0, u1, u2,
                       out,  pw,   pt,      pw_pad,  pt_pad, fluctuate};
  const int smem = (pw + pt) * static_cast<int>(sizeof(float));
  rasterize_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
