// Owner-computes scatter-add of depo patches into the charge grid, for
// Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernels
//   src/repro/kernels/scatter_add/kernel.py:97   scatter_add_pallas
//   src/repro/kernels/scatter_add/kernel.py:140  scatter_add_pallas_compact
// (bodies _scatter_kernel and _scatter_kernel_compact).
//
// What it computes. The readout grid is cut into tw x tt tiles (64 x 256 by
// default). Each tile has a list of the depos whose pw x pt patch touches it
// (ascending depo order, -1 padded; see kernels/scatter_add/ops.py). Every
// tile adds, in list order, the part of each listed depo's float32 patch
// (already rasterised and fluctuated) that lies inside the tile.
//
// Design. One CTA owns one tile, so its output is private: no atomics, and
// the result is the same bits run to run. The tile's f32 accumulator
// (tw*tt*4 = 64 KB at the default tile) lives in dynamic shared memory. The
// CTA walks its list in order and stops at the first -1, which is the order
// of the Pallas grid's k axis. For each depo it adds only the intersection
// of the patch with the tile (at most pw*pt pixels); the TPU kernel adds the
// whole tile window of a zero-padded staging buffer, that is +0.0 outside
// the patch, which changes no bit. One __syncthreads() per depo keeps two
// depos' adds to one pixel in list order, so every pixel sums exactly as
// the reference does (plain IEEE float adds, __fadd_rn).
//
// What bounds it on an H100. Bytes: the patches are read once (N x 20 x 20
// x 4 bytes = 160 MB at 100k depos), the lists and origins once, and the
// grid written once (2560 x 9592 x 4 bytes = 98 MB at MicroBooNE width):
// ~260 MB, about 77 us at 3.35 TB/s. Operations are one add per in-patch
// pixel (40 M), negligible beside that. This first design accepts low
// occupancy and a per-depo barrier: each depo adds at most 400 pixels
// across 256 threads, the dependent loads list -> origin -> patch are not
// prefetched, and tiles with long lists (~970 depos) finish last. Reading
// the next depo's origin ahead and spreading a long list over several CTAs
// is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Patches {
  const float* patches;  // (N, pw, pt)
  const int* w0;         // (N,) patch origin, wire
  const int* t0;         // (N,) patch origin, tick
  int pw;
  int pt;
  int tiles_t;
  int tw;
  int tt;
  int k_max;
};

// Sum the in-tile part of every patch in `list` into the shared tile `acc`.
__device__ void accumulate_tile(const Patches& p, int t_id,
                                const int* __restrict__ list, float* acc) {
  const int tw = p.tw, tt = p.tt;
  for (int i = threadIdx.x; i < tw * tt; i += blockDim.x) acc[i] = 0.0f;

  const int tile_w0 = (t_id / p.tiles_t) * tw;
  const int tile_t0 = (t_id % p.tiles_t) * tt;
  for (int k = 0; k < p.k_max; ++k) {
    const int d = list[k];
    if (d < 0) break;  // lists fill from rank 0: the first -1 ends the run
    // the patch origin in tile-local rows/columns, and its part in the tile
    const int ow = p.w0[d] - tile_w0, ot = p.t0[d] - tile_t0;
    const int r_lo = max(ow, 0), r_hi = min(ow + p.pw, tw);
    const int c_lo = max(ot, 0), c_hi = min(ot + p.pt, tt);
    const int nr = max(r_hi - r_lo, 0), nc = max(c_hi - c_lo, 0);
    const float* patch =
        p.patches + static_cast<long long>(d) * p.pw * p.pt;
    __syncthreads();  // the zeroing, or every add of depo k-1, is done
    for (int i = threadIdx.x; i < nr * nc; i += blockDim.x) {
      const int r = r_lo + i / nc, c = c_lo + i % nc;
      acc[r * tt + c] =
          __fadd_rn(acc[r * tt + c], patch[(r - ow) * p.pt + (c - ot)]);
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

__global__ void __launch_bounds__(kThreads)
scatter_add_dense_kernel(Patches p, const int* __restrict__ ids,
                         float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  const int t_id = blockIdx.x;
  accumulate_tile(p, t_id, ids + static_cast<long long>(t_id) * p.k_max, acc);
  const long long stride = static_cast<long long>(p.tiles_t) * p.tt;
  float* dst = out + static_cast<long long>(t_id / p.tiles_t) * p.tw * stride +
               static_cast<long long>(t_id % p.tiles_t) * p.tt;
  store_tile(acc, dst, p.tw, p.tt, stride);
}

__global__ void __launch_bounds__(kThreads)
scatter_add_compact_kernel(Patches p, const int* __restrict__ active,
                           const int* __restrict__ ids,
                           float* __restrict__ blocks) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  const int slot = blockIdx.x;
  const int t_id = active[slot];
  float* dst = blocks + static_cast<long long>(slot) * p.tw * p.tt;
  if (t_id < 0) {  // padding slot: its block is all zeros
    for (int i = threadIdx.x; i < p.tw * p.tt; i += blockDim.x) dst[i] = 0.0f;
    return;
  }
  accumulate_tile(p, t_id, ids + static_cast<long long>(slot) * p.k_max, acc);
  store_tile(acc, dst, p.tw, p.tt, p.tt);
}

int check_shape(int tw, int tt, int pw, int pt) {
  if (tw <= 0 || tt <= 0 || tt % 4 != 0 || pw <= 0 || pt <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int scatter_add_dense(const float* patches, const int* w0,
                                 const int* t0, const int* ids, int pw,
                                 int pt, int n_tiles, int tiles_t, int tw,
                                 int tt, int k_max, float* out,
                                 void* stream) {
  if (int err = check_shape(tw, tt, pw, pt)) return err;
  const int smem = tw * tt * static_cast<int>(sizeof(float));
  cudaFuncSetAttribute(scatter_add_dense_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const Patches p{patches, w0, t0, pw, pt, tiles_t, tw, tt, k_max};
  scatter_add_dense_kernel<<<n_tiles, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(p, ids,
                                                                  out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scatter_add_compact(const float* patches, const int* w0,
                                   const int* t0, const int* active,
                                   const int* ids, int pw, int pt, int n_cap,
                                   int tiles_t, int tw, int tt, int k_max,
                                   float* blocks, void* stream) {
  if (int err = check_shape(tw, tt, pw, pt)) return err;
  const int smem = tw * tt * static_cast<int>(sizeof(float));
  cudaFuncSetAttribute(scatter_add_compact_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const Patches p{patches, w0, t0, pw, pt, tiles_t, tw, tt, k_max};
  scatter_add_compact_kernel<<<n_cap, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      p, active, ids, blocks);
  return static_cast<int>(cudaGetLastError());
}
