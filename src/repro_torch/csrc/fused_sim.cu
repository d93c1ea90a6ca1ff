// Fused rasterize + fluctuate + scatter-add of depos into the charge grid,
// for Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernels
//   src/repro/kernels/fused_sim/kernel.py:262  fused_rasterize_scatter
//   src/repro/kernels/fused_sim/kernel.py:300  fused_rasterize_scatter_compact
//   src/repro/kernels/fused_sim/kernel.py:340  fused_rasterize_scatter_multiplane
//   src/repro/kernels/fused_sim/kernel.py:392
//                                 fused_rasterize_scatter_multiplane_compact
// (bodies _fused_kernel, _fused_kernel_compact, _fused_kernel_multiplane,
// _fused_kernel_multiplane_compact, _depo_tile_contrib and the portable
// counter-hash branch of _tile_normals).
//
// What it computes. The readout grid is cut into tw x tt tiles (64 x 256 by
// default). Each tile has a list of the depos whose pw x pt patch touches it
// (ascending depo order, -1 padded; see kernels/scatter_add/ops.py). For
// every depo of the list, in list order, the tile adds the depo's
// bin-integrated Gaussian (an erf difference per axis, masked to the patch
// support) fluctuated by the binomial normal approximation, whose normals
// come from a stateless counter hash: stream d*0x9E3779B9 ^ t_id*0x7FEB352D,
// counter row*tt + col in the reference's tile frame, seeds = the raw words
// of the charge-grid key.
//
// Design. One CTA owns one tile, so its output is private: no atomics, and
// the result is the same bits run to run. The tile's f32 accumulator
// (tw*tt*4 = 64 KB at the default tile) lives in dynamic shared memory. The
// CTA walks its list in order and stops at the first -1, which is the order
// of the Pallas grid's k axis; every pixel therefore sums its contributions
// in the reference's order. Per depo the CTA evaluates only the intersection
// of the patch support with the tile (at most pw*pt = 400 pixels) instead of
// all 16384 tile pixels as the TPU kernel does: outside the support the mean
// and the variance are 0, so the reference adds exactly +0.0 there and
// skipping those pixels changes no bit. The per-row and per-column erf
// weights are computed once per depo into small shared buffers (double
// buffered, so one __syncthreads() per depo suffices) and reused by every
// pixel; the values are the same as evaluating them per pixel.
//
// Numerics. IEEE erff, logf, cosf, sqrtf and division; no --use_fast_math.
// The build does not pass --fmad=false: instead the products and sums that
// could be contracted into an FMA are written with __fmul_rn / __fadd_rn,
// which the compiler never contracts, so the arithmetic is the reference's
// operation for operation. The remaining differences to the plain PyTorch
// version are the ULPs of erff, logf and cosf.
//
// What bounds it on an H100. The least bytes are the inputs (7 x 4 bytes per
// depo plus the filled list entries) and the grid written once (2560 x 9592 x
// 4 bytes = 98 MB at MicroBooNE width): ~102 MB, about 30 us at 3.35 TB/s.
// The operations are 40 M in-support pixel evaluations per event at 100k
// depos, each ~63 operations (four fmix32 hashes of 8 integer ops, the two
// uniforms, Box-Muller's log, sqrt and cos, the binomial step, the
// accumulate), plus ~10 per row/column weight (two erf) and ~12 per
// (depo, tile) stream seed: ~2.6 G operations, about 38 us at the card's
// 67 TFLOP/s float32 rate. Operations bound it, narrowly (chip_smoke.py
// computes both from the run's own lists). This first design accepts low
// occupancy: at most
// 400 of a tile's 16384 pixels are live per depo, so most of the CTA's 256
// threads idle between barriers, and tiles with long lists finish last.
// Spreading one tile's depos over several CTAs (with a deterministic
// reduction) is later work.
//
// Planes. Both kernels are plane-aware; one plane is the case P = 1. The
// CTA index runs plane-major over P planes (i = p * per_plane + slot), the
// depo parameters are (P, N) arrays flattened plane-major, and each plane
// has its own two seed words (the raw words of fold_in(kf, p)). The depo id
// and the tile id that seed a counter stream stay PLANE-LOCAL, so plane p
// of a multi-plane launch is bit for bit the one-plane launch with plane
// p's parameters and seed. Three planes triple the bound above; the design
// is unchanged.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kDepoStream = 0x9E3779B9u;
constexpr uint32_t kTileStream = 0x7FEB352Du;
constexpr float kSqrt2 = 1.41421353816986083984375f;   // float32(sqrt(2))
constexpr float kTwoPi = 6.283185482025146484375f;     // float32(2*pi)
constexpr float kInv2p24 = 1.0f / 16777216.0f;
constexpr int kThreads = 256;
constexpr int kMaxPatch = 64;  // largest patch extent the weight buffers hold
constexpr int kMaxPlanes = 16;  // most planes one launch takes

// One plane's view of the depo parameters (pointers already offset to it).
struct DepoParams {
  const float* wire;
  const float* tick;
  const float* sigma_w;
  const float* sigma_t;
  const float* charge;
  const int* w0;
  const int* t0;
  uint32_t seed0;
  uint32_t seed1;
  int fluctuate;
  int tiles_t;
  int tw;
  int tt;
  int pw;
  int pt;
  int k_max;
};

// The seed words of every plane of a launch, passed by value.
struct PlaneSeeds {
  uint32_t words[2 * kMaxPlanes];
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Bin-integrated Gaussian weight of the unit bin starting at `edge`.
__device__ __forceinline__ float axis_weight(float edge, float center,
                                             float den) {
  float lo = erff((edge - center) / den);
  float hi = erff((edge + 1.0f - center) / den);
  return fmaxf(__fmul_rn(0.5f, hi - lo), 0.0f);
}

// Std normal for pixel counter `pix` of stream base `base` (Box-Muller).
__device__ __forceinline__ float counter_normal(uint32_t base, uint32_t pix) {
  uint32_t b1 = fmix32(base ^ fmix32(2u * pix));
  uint32_t b2 = fmix32(base ^ fmix32(2u * pix + 1u));
  float u1 = 1.0f - __fmul_rn(static_cast<float>(b1 >> 8), kInv2p24);
  float u2 = __fmul_rn(static_cast<float>(b2 >> 8), kInv2p24);
  float r = sqrtf(__fmul_rn(-2.0f, logf(fmaxf(u1, 1e-12f))));
  return __fmul_rn(r, cosf(__fmul_rn(kTwoPi, u2)));
}

// Sum the contributions of every depo in `list` into the shared tile `acc`.
__device__ void accumulate_tile(const DepoParams& p, int t_id,
                                const int* __restrict__ list, float* acc) {
  __shared__ float ww_buf[2][kMaxPatch];
  __shared__ float wt_buf[2][kMaxPatch];

  const int tw = p.tw, tt = p.tt;
  for (int i = threadIdx.x; i < tw * tt; i += blockDim.x) acc[i] = 0.0f;

  const int tile_w0 = (t_id / p.tiles_t) * tw;
  const int tile_t0 = (t_id % p.tiles_t) * tt;
  for (int k = 0; k < p.k_max; ++k) {
    const int d = list[k];
    if (d < 0) break;  // lists fill from rank 0: the first -1 ends the run
    float* ww = ww_buf[k & 1];
    float* wt = wt_buf[k & 1];
    const float wire = p.wire[d], tick = p.tick[d], q = p.charge[d];
    const int w0 = p.w0[d], t0 = p.t0[d];
    // the patch support inside this tile, in tile-local rows/columns
    const int r_lo = max(w0 - tile_w0, 0), r_hi = min(w0 + p.pw - tile_w0, tw);
    const int c_lo = max(t0 - tile_t0, 0), c_hi = min(t0 + p.pt - tile_t0, tt);
    const int nr = max(r_hi - r_lo, 0), nc = max(c_hi - c_lo, 0);

    const float den_w = __fmul_rn(p.sigma_w[d], kSqrt2);
    const float den_t = __fmul_rn(p.sigma_t[d], kSqrt2);
    for (int i = threadIdx.x; i < nr + nc; i += blockDim.x) {
      if (i < nr)
        ww[i] = axis_weight(static_cast<float>(tile_w0 + r_lo + i), wire,
                            den_w);
      else
        wt[i - nr] = axis_weight(static_cast<float>(tile_t0 + c_lo + i - nr),
                                 tick, den_t);
    }
    __syncthreads();  // weights of depo k ready; all of depo k-1 is summed

    const uint32_t stream = (static_cast<uint32_t>(d) * kDepoStream) ^
                            (static_cast<uint32_t>(t_id) * kTileStream);
    const uint32_t base = fmix32(p.seed1 ^ stream) + p.seed0;
    const float qq = fmaxf(q, 1.0f);
    for (int i = threadIdx.x; i < nr * nc; i += blockDim.x) {
      const int r = r_lo + i / nc, c = c_lo + i % nc;
      float v = __fmul_rn(__fmul_rn(q, ww[r - r_lo]), wt[c - c_lo]);
      if (p.fluctuate) {
        const float z = counter_normal(base, static_cast<uint32_t>(r * tt + c));
        const float pr = fminf(fmaxf(v / qq, 0.0f), 1.0f);
        const float var = fmaxf(__fmul_rn(v, 1.0f - pr), 0.0f);
        v = fmaxf(__fadd_rn(v, __fmul_rn(sqrtf(var), z)), 0.0f);
      }
      acc[r * tt + c] = __fadd_rn(acc[r * tt + c], v);
    }
  }
  __syncthreads();  // the tile is complete
}

// Copy the shared tile to a row-major destination with row stride `stride`.
__device__ void store_tile(const float* acc, float* dst, int tw, int tt,
                           long long stride) {
  const int vec = tt / 4;
  for (int i = threadIdx.x; i < tw * vec; i += blockDim.x) {
    const int r = i / vec, c4 = i % vec;
    reinterpret_cast<float4*>(dst + r * stride)[c4] =
        reinterpret_cast<const float4*>(acc + r * tt)[c4];
  }
}

// Plane `plane`'s view of the plane-major (P, N) parameters.
__device__ __forceinline__ DepoParams plane_view(DepoParams p, int plane,
                                                 int n_depos,
                                                 const PlaneSeeds& seeds) {
  const long long off = static_cast<long long>(plane) * n_depos;
  p.wire += off;
  p.tick += off;
  p.sigma_w += off;
  p.sigma_t += off;
  p.charge += off;
  p.w0 += off;
  p.t0 += off;
  p.seed0 = seeds.words[2 * plane];
  p.seed1 = seeds.words[2 * plane + 1];
  return p;
}

// CTA i = p * n_tiles + t owns tile t of plane p; the output is (P, tiles_w
// * tw, tiles_t * tt), so i / tiles_t is the block row over all planes.
__global__ void __launch_bounds__(kThreads)
fused_sim_dense_kernel(DepoParams p, PlaneSeeds seeds, int n_depos,
                       int n_tiles, const int* __restrict__ ids,
                       float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  const int i = blockIdx.x;
  const int plane = i / n_tiles;
  accumulate_tile(plane_view(p, plane, n_depos, seeds), i - plane * n_tiles,
                  ids + static_cast<long long>(i) * p.k_max, acc);
  const long long stride = static_cast<long long>(p.tiles_t) * p.tt;
  float* dst = out + static_cast<long long>(i / p.tiles_t) * p.tw * stride +
               static_cast<long long>(i % p.tiles_t) * p.tt;
  store_tile(acc, dst, p.tw, p.tt, stride);
}

// CTA i = p * n_cap + slot owns slot `slot` of plane p's active list, whose
// entry is a plane-local tile id (-1 pads the list).
__global__ void __launch_bounds__(kThreads)
fused_sim_compact_kernel(DepoParams p, PlaneSeeds seeds, int n_depos,
                         int n_cap, const int* __restrict__ active,
                         const int* __restrict__ ids,
                         float* __restrict__ blocks) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  const int i = blockIdx.x;
  const int t_id = active[i];
  float* dst = blocks + static_cast<long long>(i) * p.tw * p.tt;
  if (t_id < 0) {  // padding slot: its block is all zeros
    for (int j = threadIdx.x; j < p.tw * p.tt; j += blockDim.x) dst[j] = 0.0f;
    return;
  }
  accumulate_tile(plane_view(p, i / n_cap, n_depos, seeds), t_id,
                  ids + static_cast<long long>(i) * p.k_max, acc);
  store_tile(acc, dst, p.tw, p.tt, p.tt);
}

DepoParams make_params(const float* wire, const float* tick,
                       const float* sigma_w, const float* sigma_t,
                       const float* charge, const int* w0, const int* t0,
                       int fluctuate, int tiles_t, int tw, int tt, int pw,
                       int pt, int k_max) {
  return DepoParams{wire, tick, sigma_w, sigma_t, charge, w0, t0, 0u, 0u,
                    fluctuate, tiles_t, tw, tt, pw, pt, k_max};
}

int check_shape(int num_planes, int tw, int tt, int pw, int pt) {
  if (num_planes <= 0 || num_planes > kMaxPlanes || tw <= 0 || tt <= 0 ||
      tt % 4 != 0 || pw <= 0 || pt <= 0 || pw > kMaxPatch || pt > kMaxPatch)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

PlaneSeeds copy_seeds(const uint32_t* words, int num_planes) {
  PlaneSeeds seeds{};
  for (int i = 0; i < 2 * num_planes; ++i) seeds.words[i] = words[i];
  return seeds;
}

}  // namespace

// Plain C entry points (bound with ctypes). Depo parameters are (P, N)
// plane-major; `seeds` is a HOST array of 2 * num_planes words; a launch
// runs num_planes * per_plane CTAs (per_plane = n_tiles for the dense
// layout, n_cap for the compact one). Each launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int fused_sim_dense(const float* wire, const float* tick,
                               const float* sigma_w, const float* sigma_t,
                               const float* charge, const int* w0,
                               const int* t0, const int* ids,
                               const uint32_t* seeds, int num_planes,
                               int n_depos, int fluctuate, int n_tiles,
                               int tiles_t, int tw, int tt, int pw, int pt,
                               int k_max, float* out, void* stream) {
  if (int err = check_shape(num_planes, tw, tt, pw, pt)) return err;
  const int smem = tw * tt * static_cast<int>(sizeof(float));
  cudaFuncSetAttribute(fused_sim_dense_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  DepoParams p = make_params(wire, tick, sigma_w, sigma_t, charge, w0, t0,
                             fluctuate, tiles_t, tw, tt, pw, pt, k_max);
  fused_sim_dense_kernel<<<num_planes * n_tiles, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      p, copy_seeds(seeds, num_planes), n_depos, n_tiles, ids, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_sim_compact(const float* wire, const float* tick,
                                 const float* sigma_w, const float* sigma_t,
                                 const float* charge, const int* w0,
                                 const int* t0, const int* active,
                                 const int* ids, const uint32_t* seeds,
                                 int num_planes, int n_depos, int fluctuate,
                                 int n_cap, int tiles_t, int tw, int tt,
                                 int pw, int pt, int k_max, float* blocks,
                                 void* stream) {
  if (int err = check_shape(num_planes, tw, tt, pw, pt)) return err;
  const int smem = tw * tt * static_cast<int>(sizeof(float));
  cudaFuncSetAttribute(fused_sim_compact_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  DepoParams p = make_params(wire, tick, sigma_w, sigma_t, charge, w0, t0,
                             fluctuate, tiles_t, tw, tt, pw, pt, k_max);
  fused_sim_compact_kernel<<<num_planes * n_cap, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      p, copy_seeds(seeds, num_planes), n_depos, n_cap, active, ids, blocks);
  return static_cast<int>(cudaGetLastError());
}
