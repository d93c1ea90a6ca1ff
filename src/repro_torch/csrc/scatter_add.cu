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
// tile adds, in list order, the part of each listed depo's patch (already
// rasterised, and fluctuated unless the config turns it off) that lies
// inside the tile. Patches are float32 or bfloat16, the two types the
// reference's kernel takes; a bfloat16 value is widened to float32
// (__bfloat162float, exact) before its add, as the reference upcasts, so the
// bfloat16 grid is the float32 grid of the widened patches, bit for bit. The
// TPU kernel adds the whole tile window of a zero-padded staging buffer, that
// is +0.0 outside the patch, which changes no bit; this one adds only the
// intersection.
//
// Summation order. Every pixel is the sum, from +0.0, of its contributions
// in list order (plain IEEE adds, __fadd_rn). A float sum cannot be
// reassociated without changing bits, so a pixel's sum is never split: each
// pixel has one owning thread, which adds its contributions one list entry
// after another. No atomics, so the output is the same bits run to run.
//
// Design (the shape of csrc/fused_sim.cu, without its per-pixel math).
//  - One CTA of 8 warps owns one tile, or the rows r = part (mod 4) of a
//    tile with a long list; its f32 accumulator (64 KB for a whole 64 x 256
//    tile) lives in dynamic shared memory. Thread (warp w, lane l) owns the
//    pixels of the CTA's rows r = w (mod 8) (mod 32 for a part) and columns
//    c = l (mod 32). Every thread walks the whole list in order and adds
//    only its own pixels, so no barrier is needed between depos: one
//    barrier after zeroing, one before the store.
//  - A warp's share of one depo is up to ceil(pw / 8) patch rows, each a
//    contiguous span of at most 32 columns (80 bytes at pt = 20): one load
//    instruction per row, lane l taking its column. The warp flattens the
//    (entry, own row, 32-column block) slots of a chunk of entries and
//    takes them 16 at a time, issuing the 16 loads before the 16 adds, so
//    the loads of ~5 depos are in flight together (on an H100, 8 at a
//    time was slower and 32 no faster).
//  - The list is read in chunks of 32 entries, one per lane: each lane of
//    each warp gathers its entry's origin and turns it into the entry's
//    clipped rows and columns and its patch offset once, and the slots take
//    them by shuffle. The next chunk's origins and the ids of the chunk
//    after it are in flight while a chunk is added, so the list -> origin ->
//    patch chain is not paid per depo. Lanes past k_max hold -1.
//  - CTAs start in the order of descending list length (`order` and
//    `lengths`, from the launch-order kernels of csrc/fused_sim.cu), so the
//    longest lists (~17 x the median where tracks cross) start in the first
//    wave. A list longer than each resident CTA's share of the launch's
//    expected entries splits over 4 CTAs by row, among the first 64 ranks
//    (when tw is a multiple of 4); each part walks the whole list for its
//    rows. A thread owns its pixels
//    in any order of CTAs, so neither changes a bit.
//  - Two layouts, one body, both writing the padded grid: the dense lists
//    (slot = tile) or the compact ones, each occupied tile written in place
//    (slot -> tile active[slot]; the caller zeroes the grid once and -1
//    slots return). The reference's compact (n_cap, tw, tt) blocks are the
//    grid's tiles at `active`, so the wrapper gathers them from it.
//
// What bounds it on an H100. Bytes: the patches are read once (N x 20 x 20
// x 4 bytes = 160 MB at 100k depos in float32, 80 MB in bfloat16), the lists
// and origins once, and the grid written once (2560 x 9592 x 4 bytes = 98 MB
// at MicroBooNE width): ~260 MB, about 77 us at 3.35 TB/s (~180 MB, ~54 us,
// for bfloat16). Operations are one add per in-tile pixel (40 M), negligible
// beside that. What the design pays on top: a 20-column row keeps 20 of 32
// lanes busy, and each (entry, own row) slot costs three shuffles, the
// mapping arithmetic and a shared-memory read-modify-write, paid by each of
// the 8 warps for each entry. A bfloat16 row is read as 2-byte loads, one a
// lane (loads of 8 values a lane are later work).

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarpShift = 3;  // log2(warps per CTA)
static_assert(kThreads == 32 << kWarpShift, "kWarpShift is log2(warps)");
constexpr int kChunk = 32;     // list entries read at once (one per lane)
constexpr int kBatch = 16;     // slots whose loads are issued before adds
// the longest kSplitSlots lists of a launch may split over 2^kSplitShift
// CTAs each (see scatter_add_kernel)
constexpr int kSplitSlots = 64;
constexpr int kSplitShift = 2;

// Layouts of the lists (the entry point's `mode`).
constexpr int kDense = 0;    // slot s = tile s
constexpr int kCompact = 1;  // slot s = tile active[s], -1 for none

// Patch element types (the entry point's `patch_dtype`).
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
struct Geometry {
  const T* patches;  // (N, pw, pt)
  const int* w0;         // (N,) patch origin, wire
  const int* t0;         // (N,) patch origin, tick
  int pw;
  int pt;
  int tiles_t;
  int tw;
  int tt;
  int k_max;
};

// Add the own pixels of the n entries a warp's lanes hold (lane e: patch
// offset `base` with patch index = base + r * pt + c for tile-local pixel
// (r, c), first own row and row end packed in `rows`, column span packed in
// `cols`) to `acc`, in list order. Own rows: r = cls (mod 2^shift).
template <typename T>
__device__ __forceinline__ void add_chunk(const Geometry<T>& g, int n, int base,
                                          int rows, int cols, int shift,
                                          int part_shift, int lane,
                                          float* acc) {
  const int row_slots = (g.pw + (1 << shift) - 1) >> shift;
  const int col_blocks = (g.pt + 31) >> 5;
  const int total = n * row_slots * col_blocks;
  // warp-uniform cursor: entry e, own row slot rs, column block cb
  int e = 0, rs = 0, cb = 0;
  for (int j0 = 0; j0 < total; j0 += kBatch) {
    float v[kBatch];
    int a[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int eb = min(e, kChunk - 1);
      const int off = __shfl_sync(kAll, base, eb);
      const int rg = __shfl_sync(kAll, rows, eb);
      const int cg = __shfl_sync(kAll, cols, eb);
      const int r = (rg & 0xFFFF) + (rs << shift), r_hi = rg >> 16;
      const int c_lo = cg & 0xFFFF, c_hi = cg >> 16;
      const int c = c_lo + ((lane - c_lo) & 31) + (cb << 5);
      a[b] = -1;
      v[b] = 0.0f;
      if (j0 + b < total && r < r_hi && c < c_hi) {
        v[b] = widen(g.patches[off + r * g.pt + c]);
        a[b] = (r >> part_shift) * g.tt + c;  // the CTA holds its rows
      }
      if (++cb == col_blocks) {
        cb = 0;
        if (++rs == row_slots) {
          rs = 0;
          ++e;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (a[b] >= 0) acc[a[b]] = __fadd_rn(acc[a[b]], v[b]);
  }
}

// The entry a lane holds, for its warp's rows r = cls (mod 2^shift) of tile
// (tile_w0, tile_t0): patch offset, (first own row, row end), (first column,
// column end), tile-local; no rows for d = -1.
template <typename T>
__device__ __forceinline__ void place_entry(const Geometry<T>& g, int d, int w0,
                                            int t0, int tile_w0, int tile_t0,
                                            int cls, int shift, int& base,
                                            int& rows, int& cols) {
  const int ow = w0 - tile_w0, ot = t0 - tile_t0;
  const int r_lo = max(ow, 0);
  const int r_hi = d < 0 ? 0 : max(min(ow + g.pw, g.tw), 0);
  const int c_lo = min(max(ot, 0), g.tt), c_hi = min(ot + g.pt, g.tt);
  const int r0 = r_lo + ((cls - r_lo) & ((1 << shift) - 1));
  base = d < 0 ? 0 : d * g.pw * g.pt - ow * g.pt - ot;
  rows = min(r0, r_hi) | (r_hi << 16);
  cols = c_lo | (max(c_hi, c_lo) << 16);
}

// Sum the in-tile part of every patch in `list` into the rows r = part (mod
// 2^part_shift) of tile t_id, held packed in the shared `acc`.
template <typename T>
__device__ void accumulate_tile(const Geometry<T>& g, int t_id, int part,
                                int part_shift,
                                const int* __restrict__ list, float* acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < (g.tw >> part_shift) * g.tt; i += kThreads)
    acc[i] = 0.0f;
  __syncthreads();  // zeroed: from here each thread touches its own pixels

  const int shift = kWarpShift + part_shift;
  const int cls = part + (warp << part_shift);  // own rows: r = cls mod 2^shift
  const int tile_w0 = (t_id / g.tiles_t) * g.tw;
  const int tile_t0 = (t_id % g.tiles_t) * g.tt;
  auto id_at = [&](int k) { return k < g.k_max ? list[k] : -1; };
  int d = id_at(lane);
  int d_next = id_at(kChunk + lane);
  int w0 = d >= 0 ? g.w0[d] : 0, t0 = d >= 0 ? g.t0[d] : 0;
  for (int k0 = 0;; k0 += kChunk) {
    // the list fills from rank 0: the first -1 ends the run
    const unsigned gap = ~__ballot_sync(kAll, d >= 0);
    const int n = gap ? __ffs(gap) - 1 : kChunk;
    const bool more = n == kChunk && k0 + kChunk < g.k_max;
    int base, rows, cols;
    place_entry(g, d, w0, t0, tile_w0, tile_t0, cls, shift, base, rows, cols);
    // in flight while this chunk is added: the next chunk's origins and the
    // ids of the chunk after it
    int d2 = -1, w2 = 0, t2 = 0;
    if (more) {
      d2 = d_next;
      if (d2 >= 0) {
        w2 = g.w0[d2];
        t2 = g.t0[d2];
      }
      d_next = id_at(k0 + 2 * kChunk + lane);
    }
    add_chunk(g, n, base, rows, cols, shift, part_shift, lane, acc);
    if (!more) break;
    d = d2;
    w0 = w2;
    t0 = t2;
  }
  __syncthreads();  // the tile is complete
}

// Copy the shared rows r = part (mod 2^part_shift) of a tile to `dst`, the
// tile's top-left pixel in a row-major array of row stride `stride`.
__device__ void store_tile(const float* acc, float* dst, long long stride,
                           int tw, int tt, int part, int part_shift) {
  const int vec = tt / 4;
  for (int i = threadIdx.x; i < (tw >> part_shift) * vec; i += kThreads) {
    const int r = i / vec, c4 = i % vec;
    reinterpret_cast<float4*>(dst + ((r << part_shift) + part) * stride)[c4] =
        reinterpret_cast<const float4*>(acc + r * tt)[c4];
  }
}

// The first n_split ranks of `order` (the longest lists) get
// 2^kSplitShift CTAs each: a slot whose list is longer than `long_list`
// runs as one CTA per row part, a shorter one in its first CTA alone (the
// others return). Every later rank runs as one CTA. CTA b runs slot i =
// order[rank]; lists are (n_slots, k_max), `lengths` their filled lengths.
template <int kMode, typename T>
__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(Geometry<T> g, int n_split, int long_list,
                   const int* __restrict__ order,
                   const int* __restrict__ lengths,
                   const int* __restrict__ active,
                   const int* __restrict__ ids, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  const int split = n_split << kSplitShift;  // CTAs of the first ranks
  const int b = blockIdx.x;
  int i, part = 0, part_shift = 0;
  if (b < split) {
    i = order[b >> kSplitShift];
    if (lengths[i] > long_list) {
      part_shift = kSplitShift;
      part = b & ((1 << kSplitShift) - 1);
    } else if (b & ((1 << kSplitShift) - 1)) {
      return;
    }
  } else {
    i = order[n_split + b - split];
  }
  const int t_id = kMode == kDense ? i : active[i];
  if (t_id < 0) return;  // a padding slot: nothing in the grid
  accumulate_tile(g, t_id, part, part_shift,
                  ids + static_cast<long long>(i) * g.k_max, acc);
  const long long stride = static_cast<long long>(g.tiles_t) * g.tt;
  float* dst = out + static_cast<long long>(t_id / g.tiles_t) * g.tw * stride +
               static_cast<long long>(t_id % g.tiles_t) * g.tt;
  store_tile(acc, dst, stride, g.tw, g.tt, part, part_shift);
}

int check_shape(int n_depos, int n_slots, int tiles_t, int tw, int tt, int pw,
                int pt, int k_max) {
  if (n_depos < 0 || n_slots < 0 || tiles_t <= 0 || tw <= 0 || tt <= 0 ||
      tt % 4 != 0 || pw <= 0 || pt <= 0 || k_max < 0 ||
      static_cast<long long>(n_depos) * pw * pt > 0x7FFFFFFFLL ||
      static_cast<long long>(tw) * tt * 4 > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The CTAs of one layout's kernel resident on the card at once with `smem`
// bytes of shared memory each. The host work behind it (the kernel's
// opt-in to that much shared memory, raised and never lowered, and the
// occupancy query) is done once per device and size, not on every launch.
template <int kMode, typename T>
int resident_ctas(int smem) {
  static std::mutex mutex;
  static std::map<int, int> opted_in;                  // device -> bytes
  static std::map<std::pair<int, int>, int> resident;  // (device, bytes)
  int device = 0;
  cudaGetDevice(&device);
  const std::lock_guard<std::mutex> hold(mutex);
  int& opted = opted_in[device];
  if (smem > opted &&
      cudaFuncSetAttribute(scatter_add_kernel<kMode, T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) == cudaSuccess)
    opted = smem;
  const auto key = std::make_pair(device, smem);
  auto it = resident.find(key);
  if (it == resident.end()) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scatter_add_kernel<kMode, T>, kThreads, smem);
    it = resident.emplace(key, max(sms * per_sm, 1)).first;
  }
  return it->second;
}

template <int kMode, typename T>
int launch(const Geometry<T>& g, int n_depos, int n_slots, const int* order,
           const int* lengths, const int* active, const int* ids, float* out,
           cudaStream_t stream) {
  const int smem = g.tw * g.tt * static_cast<int>(sizeof(float));
  // A list is long when it holds more entries than the CTAs resident at
  // once would each get of the launch's expected entries (a patch lands in
  // (1 + (pw-1)/tw)(1 + (pt-1)/tt) tiles on average): such a list would
  // still run after the rest of the work is done, so it splits, when the
  // tile's rows split evenly into the parts.
  const double entries = static_cast<double>(n_depos) *
                         (1.0 + (g.pw - 1.0) / g.tw) *
                         (1.0 + (g.pt - 1.0) / g.tt);
  const int long_list =
      static_cast<int>(entries / resident_ctas<kMode, T>(smem));
  const int n_split =
      g.tw % (1 << kSplitShift) ? 0 : min(kSplitSlots, n_slots);
  const int ctas = n_slots + (n_split << kSplitShift) - n_split;
  scatter_add_kernel<kMode, T><<<ctas, kThreads, smem, stream>>>(
      g, n_split, long_list, order, lengths, active, ids, out);
  return static_cast<int>(cudaGetLastError());
}

// The layout's launch for patches of type T.
template <typename T>
int launch_mode(const void* patches, const int* w0, const int* t0,
                const int* active, const int* ids, const int* order,
                const int* lengths, int n_depos, int pw, int pt, int n_slots,
                int tiles_t, int tw, int tt, int k_max, int mode, float* out,
                cudaStream_t stream) {
  const Geometry<T> g{static_cast<const T*>(patches), w0, t0, pw, pt, tiles_t,
                      tw, tt, k_max};
  switch (mode) {
    case kDense:
      return launch<kDense>(g, n_depos, n_slots, order, lengths, nullptr, ids,
                            out, stream);
    case kCompact:
      return launch<kCompact>(g, n_depos, n_slots, order, lengths, active,
                              ids, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). `patches` holds (n_depos, pw, pt)
// values of type `patch_dtype` (0: float32, 1: bfloat16). `ids` holds
// n_slots lists of k_max depo ids (-1 padded); `order` is the CTA launch
// order, a permutation of the slots, and `lengths` their filled lengths
// (both from fused_sim_launch_order). `out` is the padded (tiles_w*tw,
// tiles_t*tt) float32 grid. mode 0: dense lists, slot s = tile s; mode 1:
// compact lists with `active` (n_slots,) global tile ids, written only at
// the occupied tiles (the caller zeroes the grid). Launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int scatter_add_launch(const void* patches, const int* w0,
                                  const int* t0, const int* active,
                                  const int* ids, const int* order,
                                  const int* lengths, int n_depos, int pw,
                                  int pt, int n_slots, int tiles_t, int tw,
                                  int tt, int k_max, int mode,
                                  int patch_dtype, float* out, void* stream) {
  if (int err = check_shape(n_depos, n_slots, tiles_t, tw, tt, pw, pt, k_max))
    return err;
  if (n_slots == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (patch_dtype) {
    case kFloat32:
      return launch_mode<float>(patches, w0, t0, active, ids, order, lengths,
                                n_depos, pw, pt, n_slots, tiles_t, tw, tt,
                                k_max, mode, out, s);
    case kBFloat16:
      return launch_mode<__nv_bfloat16>(patches, w0, t0, active, ids, order,
                                        lengths, n_depos, pw, pt, n_slots,
                                        tiles_t, tw, tt, k_max, mode, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
