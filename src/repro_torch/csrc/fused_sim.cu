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
// of the charge-grid key. Outside the patch support the mean and the
// variance are 0, so the reference adds exactly +0.0 there; the kernel
// evaluates only the support (at most pw*pt pixels per depo and tile).
//
// Summation order. Every output pixel is the sum, from +0.0, of its
// contributions in the tile's list order, the order of the Pallas grid's k
// axis. A float sum cannot be reassociated without changing bits, so a
// pixel's sum is never split: each pixel has one owning warp, which adds its
// contributions one list entry after another. No atomics touch the output,
// so it is the same bits run to run.
//
// Design.
//  - One CTA of 8 warps owns one tile, or the rows r = part (mod 4) of one
//    tile with a long list; its f32 accumulator (64 KB for a whole 64 x 256
//    tile) lives in dynamic shared memory. A list is long when it holds
//    more entries than each resident CTA's share of the launch's expected
//    entries: it would still run when the rest is done (where tracks cross,
//    a tile's list is ~17 x the median), so it splits over 4 CTAs, each
//    staging the whole list. In a launch with enough work no list is long
//    and no staging is duplicated.
//  - Warp w owns the CTA's local rows lr = w (mod 8). Every warp walks the
//    whole list in order. Its pixels of a chunk of entries form one run of
//    items in list order (entry by entry, each entry's share row-major),
//    which its lanes take 32 at a time, two items a lane side by side (the
//    independent chains overlap), so a small share leaves no lanes idle.
//    The entry of an item comes from warp votes over the entries' start
//    offsets and shuffles of the entry's fields; the column from a float
//    reciprocal that is exact at these sizes (no integer division per
//    pixel). A round's adds go entry by entry, with __syncwarp() between,
//    so a pixel that two entries of one round touch is summed in order.
//  - Each entry's support is trimmed to the span of its nonzero row and
//    column weights. A pixel whose weight is 0 has mean +-0, its
//    fluctuation is +-0, and adding +-0 leaves the sum as it is (it starts
//    at +0.0 and never turns -0.0), so skipping it changes no bit; only an
//    entry with a finite charge is trimmed (an infinite one would make NaN).
//    At MicroBooNE's widths ~26 % of the in-support pixels are skipped.
//  - The list is staged in chunks of 32 entries: one warp reads 32 list
//    entries (one coalesced load, the next chunk's already in flight) and
//    gathers each entry's 7 parameters with one lane per entry; the CTA then
//    computes the chunk's row and column weights (<= 32 x 40 erf pairs) with
//    all 256 threads at once: three CTA barriers per chunk, none per depo,
//    and no global load in the pixel loop. The gathers are indexed (list ->
//    depo id -> parameter), so TMA, which copies boxes of a tensor, does
//    not fit them; they are seven 4-byte loads per entry, not worth
//    cp.async.
//  - CTAs start in the order of descending list length (`order`, from two
//    small kernels below: per-slot lengths, then a stable rank), so the
//    longest lists start in the first wave instead of setting the tail.
//    A CTA still owns its rows, so the order changes no bit.
//  - The compact layout's CTAs write their tile straight into its place in
//    the (P, tiles_w*tw, tiles_t*tt) output, which the wrapper zeroes once;
//    unoccupied tiles stay 0 and padding slots return at once.
//  - Tensor cores (wgmma) do not apply: the per-pixel value is a product of
//    two weights and a charge followed by a fluctuation that is not a matrix
//    product, and a matrix unit would reassociate the sums.
//
// Numerics. IEEE erff, logf, cosf, sqrtf and division; no --use_fast_math.
// The build does not pass --fmad=false: instead the products and sums that
// could be contracted into an FMA are written with __fmul_rn / __fadd_rn,
// which the compiler never contracts, so the arithmetic is the reference's
// operation for operation, and bit for bit the plain PyTorch version's on
// the card (which uses the same libdevice erff, logf and cosf).
//
// What bounds it on an H100. The least bytes are the inputs (7 x 4 bytes per
// depo plus the filled list entries) and the grid written once (2560 x 9592 x
// 4 bytes = 98 MB per plane at MicroBooNE width), about 30 us per plane at
// 3.35 TB/s. The operations are 40 M in-support pixel evaluations per plane
// at 100k depos, each ~63 operations counted as chip_smoke.py counts them
// (a transcendental as one), ~38 us per plane at 67 TFLOP/s. The real floor
// is instruction issue: IEEE logf, cosf, two sqrtf and a division expand
// into several instructions each, the hash into ~40 integer ones, and each
// item's mapping and ordered add cost more; chip_smoke.py counts the pixel
// loop's instructions in the built library (~225 a pixel) and prints the
// floor they imply for the pixels evaluated. On three planes the kernel
// takes about twice that floor with 24 warps per SM (3 CTAs, by shared
// memory); what the rest goes to is not broken down (the card's machine
// gives no hardware counters).
//
// Planes. Both kernels are plane-aware; one plane is the case P = 1. The
// CTA slot runs plane-major over P planes (i = p * per_plane + slot), the
// depo parameters are (P, N) arrays flattened plane-major, and each plane
// has its own two seed words (the raw words of fold_in(kf, p)). The depo id
// and the tile id that seed a counter stream stay PLANE-LOCAL, so plane p
// of a multi-plane launch is bit for bit the one-plane launch with plane
// p's parameters and seed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kDepoStream = 0x9E3779B9u;
constexpr uint32_t kTileStream = 0x7FEB352Du;
constexpr float kSqrt2 = 1.41421353816986083984375f;   // float32(sqrt(2))
constexpr float kTwoPi = 6.283185482025146484375f;     // float32(2*pi)
constexpr float kInv2p24 = 1.0f / 16777216.0f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpShift = 3;  // log2(kWarps)
static_assert(kWarps == 1 << kWarpShift, "kWarpShift is log2(kWarps)");
// the longest kSplitSlots lists of a launch may split over 2^kSplitShift
// CTAs each (see fused_sim_kernel)
constexpr int kSplitSlots = 64;
constexpr int kSplitShift = 2;
constexpr int kChunk = 32;      // list entries staged at once (one per lane)
constexpr int kItems = 2;  // pixels a lane computes side by side
constexpr int kOrderThreads = 128;  // threads of a launch-order CTA
constexpr int kMaxPatch = 64;   // largest patch extent the kernel takes
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
  int part_shift;  // this CTA owns rows r = part (mod 2^part_shift)
};

// The seed words of every plane of a launch, passed by value.
struct PlaneSeeds {
  uint32_t words[2 * kMaxPlanes];
};

// One staged list entry: its patch support inside the tile (tile-local
// rows and columns), its stream base, its charge, and the inputs of its
// axis weights.
struct Entry {
  int r_lo, nr, c_lo, nc;
  uint32_t base;
  float q;
  float wire, tick, den_w, den_t;
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

// Fluctuate the means v[t] of charge q[t] in place by the binomial normal
// approximation, with the std normal of pixel counter pix[t] of stream base
// base[t] (Box-Muller). The N pixels go through each step side by side, so
// their independent chains overlap; the operations are those of one pixel.
template <int N>
__device__ __forceinline__ void fluctuate(const uint32_t (&base)[N],
                                          const uint32_t (&pix)[N],
                                          const float (&q)[N], float (&v)[N]) {
  float u1[N], u2[N], lg[N], cs[N], pr[N], rad[N], sd[N];
#pragma unroll
  for (int t = 0; t < N; ++t) {
    const uint32_t b1 = fmix32(base[t] ^ fmix32(2u * pix[t]));
    const uint32_t b2 = fmix32(base[t] ^ fmix32(2u * pix[t] + 1u));
    u1[t] = 1.0f - __fmul_rn(static_cast<float>(b1 >> 8), kInv2p24);
    u2[t] = __fmul_rn(static_cast<float>(b2 >> 8), kInv2p24);
  }
#pragma unroll
  for (int t = 0; t < N; ++t) lg[t] = logf(fmaxf(u1[t], 1e-12f));
#pragma unroll
  for (int t = 0; t < N; ++t) cs[t] = cosf(__fmul_rn(kTwoPi, u2[t]));
#pragma unroll
  for (int t = 0; t < N; ++t)
    pr[t] = fminf(fmaxf(v[t] / fmaxf(q[t], 1.0f), 0.0f), 1.0f);
#pragma unroll
  for (int t = 0; t < N; ++t) rad[t] = sqrtf(__fmul_rn(-2.0f, lg[t]));
#pragma unroll
  for (int t = 0; t < N; ++t)
    sd[t] = sqrtf(fmaxf(__fmul_rn(v[t], 1.0f - pr[t]), 0.0f));
#pragma unroll
  for (int t = 0; t < N; ++t) {
    const float z = __fmul_rn(rad[t], cs[t]);
    v[t] = fmaxf(__fadd_rn(v[t], __fmul_rn(sd[t], z)), 0.0f);
  }
}

// Stage list entry `d` (a depo id) of tile (tile_w0, tile_t0) into `e`.
__device__ __forceinline__ void stage_entry(const DepoParams& p, int d,
                                            int tile_w0, int tile_t0,
                                            uint32_t tile_stream, Entry* e) {
  const float q = p.charge[d];
  const int w0 = p.w0[d], t0 = p.t0[d];
  // the patch support inside this tile, in tile-local rows/columns
  const int r_lo = max(w0 - tile_w0, 0), r_hi = min(w0 + p.pw - tile_w0, p.tw);
  const int c_lo = max(t0 - tile_t0, 0), c_hi = min(t0 + p.pt - tile_t0, p.tt);
  const int nc = max(c_hi - c_lo, 0);
  const uint32_t stream = (static_cast<uint32_t>(d) * kDepoStream) ^
                          tile_stream;
  e->r_lo = r_lo;
  e->nr = max(r_hi - r_lo, 0);
  e->c_lo = c_lo;
  e->nc = nc;
  e->base = fmix32(p.seed1 ^ stream) + p.seed0;
  e->q = q;
  e->wire = p.wire[d];
  e->tick = p.tick[d];
  e->den_w = __fmul_rn(p.sigma_w[d], kSqrt2);
  e->den_t = __fmul_rn(p.sigma_t[d], kSqrt2);
}

// [lo, hi): the span from the first to the last nonzero of w[0..n) (lo =
// n, hi = 0 when all are zero).
__device__ __forceinline__ void nonzero_span(const float* w, int n, int& lo,
                                             int& hi) {
  lo = n;
  hi = 0;
  for (int j = 0; j < n; ++j) {
    if (w[j] != 0.0f) {
      lo = min(lo, j);
      hi = j + 1;
    }
  }
}

// Warp `warp` adds the `n` staged entries of a chunk (row weights at
// weights + e * stride, column weights pw further) to the rows it owns,
// r = cls (mod 2^(3 + part_shift)), cls = part + warp * 2^part_shift: one run
// of items in list order, 32 x kItems per round (see the header).
__device__ void add_chunk(const DepoParams& p, const Entry* entries, int n,
                          const float* weights, int stride, int cls,
                          int lane, float* acc) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  const int shift = kWarpShift + p.part_shift;  // own rows: r = cls mod 2^shift
  const int period = 1 << shift;
  // lane e: this warp's share of entry e (its pixel count), the entry's
  // support trimmed to its nonzero weights, packed: r_lo < 1024, c_lo <
  // 4096, nc <= 64 (check_shape), and where the trimmed weights start
  int count = 0, geom = 0, start_e = 0, offsets = 0;
  float q = 0.0f, inv_nc = 0.0f;
  uint32_t base = 0u;
  if (lane < n) {
    const Entry en = entries[lane];
    const float* ww = weights + lane * stride;
    int r_lo = en.r_lo, nr = en.nr, c_lo = en.c_lo, nc = en.nc;
    // A pixel whose row or column weight is 0 has mean +-0, its fluctuation
    // is +-0 too, and adding +-0 leaves the sum's bits as they are (the sum
    // starts at +0.0 and only grows): its evaluation can be skipped. A
    // non-finite charge would make it NaN instead, so only a finite one
    // trims. Trimming to the span of nonzero weights skips most such pixels.
    if (isfinite(en.q)) {
      int lo_r, hi_r, lo_c, hi_c;
      nonzero_span(ww, nr, lo_r, hi_r);
      nonzero_span(ww + p.pw, nc, lo_c, hi_c);
      offsets = lo_r | (lo_c << 6);
      r_lo += lo_r;
      nr = max(hi_r - lo_r, 0);
      c_lo += lo_c;
      nc = max(hi_c - lo_c, 0);
    }
    const int r0 = r_lo + ((cls - r_lo) & (period - 1));
    const int rows = r0 < r_lo + nr ? (r_lo + nr - r0 + period - 1) >> shift
                                    : 0;
    count = rows * nc;
    geom = r_lo | (c_lo << 10) | (nc << 22);
    q = en.q;
    inv_nc = __frcp_rn(static_cast<float>(max(nc, 1)));
    base = en.base;
  }
  // compact to the entries with pixels here: lane k takes the k-th of them
  __shared__ int src_of[kWarps][kChunk];
  const int warp = threadIdx.x >> 5;
  const unsigned live = __ballot_sync(kAll, count > 0);
  const int n_live = __popc(live);
  if (count > 0) src_of[warp][__popc(live & ((1u << lane) - 1u))] = lane;
  __syncwarp();
  const int src = lane < n_live ? src_of[warp][lane] : 0;
  count = __shfl_sync(kAll, count, src);
  if (lane >= n_live) count = 0;
  geom = __shfl_sync(kAll, geom, src);
  q = __shfl_sync(kAll, q, src);
  inv_nc = __shfl_sync(kAll, inv_nc, src);
  offsets = __shfl_sync(kAll, offsets, src);
  base = __shfl_sync(kAll, base, src);
  // inclusive scan of the counts: lane k's items are [end - count, end)
  int end = count;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kAll, end, d);
    if (lane >= d) end += v;
  }
  start_e = end - count;
  const int total = __shfl_sync(kAll, end, 31);
  // start < 2^14, src < 32, weight offsets < 64: one word
  const int key = start_e | (src << 14) | (offsets << 19);
  const unsigned lanes_le = (2u << lane) - 1u;  // lanes 0..lane (all at 31)
  const int tt = p.tt, pw = p.pw;
  for (int b = 0; b < total; b += 32 * kItems) {
    // item t of this lane is j = b + 32 t + lane; its entry is the number of
    // live entries starting at or before j, minus one
    int k[kItems], a[kItems];
    bool valid[kItems];
    float v[kItems], qk[kItems];
    uint32_t bk[kItems], pix[kItems];
    int before = __popc(__ballot_sync(kAll, lane < n_live && start_e < b));
#pragma unroll
    for (int t = 0; t < kItems; ++t) {
      const int bt = b + 32 * t;
      const bool opens = lane < n_live && start_e >= bt && start_e < bt + 32;
      const unsigned starts =
          __reduce_or_sync(kAll, opens ? 1u << (start_e - bt) : 0u);
      k[t] = before + __popc(starts & lanes_le) - 1;
      before += __popc(starts);
    }
#pragma unroll
    for (int t = 0; t < kItems; ++t) {
      const int kk = __shfl_sync(kAll, key, k[t]);
      const int g = __shfl_sync(kAll, geom, k[t]);
      const float inv = __shfl_sync(kAll, inv_nc, k[t]);
      qk[t] = __shfl_sync(kAll, q, k[t]);
      bk[t] = __shfl_sync(kAll, base, k[t]);
      const int r_lo = g & 1023, c_lo = (g >> 10) & 4095, nc = g >> 22;
      const int r0 = r_lo + ((cls - r_lo) & (period - 1));  // first own row
      const int j = b + 32 * t + lane;
      valid[t] = j < total;
      // a past-the-end item takes its entry's first pixel and is not added
      const int i = valid[t] ? j - (kk & 0x3FFF) : 0;
      // i -> (own row index, column): (i + 0.5) / nc is at least 0.5 / nc
      // from an integer and the float product errs by < 1e-3, so the
      // truncation is floor(i / nc) exactly (i < 512, nc <= 64)
      const int ri = static_cast<int>((static_cast<float>(i) + 0.5f) * inv);
      const int ci = i - ri * nc;
      const int r = r0 + (ri << shift), c = c_lo + ci;
      a[t] = (r >> p.part_shift) * tt + c;  // the CTA holds its rows
      pix[t] = static_cast<uint32_t>(r * tt + c);
      const float* ww = weights + ((kk >> 14) & 31) * stride;
      v[t] = __fmul_rn(__fmul_rn(qk[t], ww[((kk >> 19) & 63) + r - r_lo]),
                       ww[pw + (kk >> 25) + ci]);
    }
    if (p.fluctuate) fluctuate(bk, pix, qk, v);
    const int k_lo = __shfl_sync(kAll, k[0], 0);
    const int k_hi = __shfl_sync(kAll, k[kItems - 1], 31);
#pragma unroll 1
    for (int e = k_lo; e <= k_hi; ++e) {
#pragma unroll
      for (int t = 0; t < kItems; ++t)
        if (valid[t] && k[t] == e) acc[a[t]] = __fadd_rn(acc[a[t]], v[t]);
      __syncwarp();
    }
  }
}

// Sum the contributions of every depo in `list` to the rows r = part (mod
// 2^part_shift) of tile t_id into the shared `acc` (those rows, packed);
// `weights` holds kChunk x (pw + pt) floats.
__device__ void accumulate_tile(const DepoParams& p, int t_id, int part,
                                const int* __restrict__ list, float* acc,
                                float* weights) {
  __shared__ Entry entries[kChunk];
  __shared__ int n_staged;

  const int tw = p.tw, tt = p.tt, pw = p.pw, stride = p.pw + p.pt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < (tw >> p.part_shift) * tt; i += kThreads)
    acc[i] = 0.0f;
  const int cls = part + (warp << p.part_shift);  // this warp's row class

  const int tile_w0 = (t_id / p.tiles_t) * tw;
  const int tile_t0 = (t_id % p.tiles_t) * tt;
  const uint32_t tile_stream = static_cast<uint32_t>(t_id) * kTileStream;
  int d_next = (warp == 0 && lane < p.k_max) ? list[lane] : -1;
  for (int k0 = 0;; k0 += kChunk) {
    if (warp == 0) {
      // the list fills from rank 0: the first -1 ends the run
      const int d = d_next;
      const unsigned gap = ~__ballot_sync(0xFFFFFFFFu, d >= 0);
      const int n = gap ? __ffs(gap) - 1 : kChunk;
      // the next chunk, in flight; a lane past k_max holds -1, so a k_max
      // that is no multiple of kChunk ends the last chunk there
      if (n == kChunk)
        d_next = k0 + kChunk + lane < p.k_max ? list[k0 + kChunk + lane] : -1;
      if (lane < n) stage_entry(p, d, tile_w0, tile_t0, tile_stream,
                                &entries[lane]);
      if (lane == 0) n_staged = n;
    }
    __syncthreads();  // entries staged
    const int n = n_staged;
    for (int s = threadIdx.x; s < n * stride; s += kThreads) {
      const int e = s / stride, j = s - e * stride;
      const Entry& en = entries[e];
      if (j < pw) {
        if (j < en.nr)
          weights[s] = axis_weight(static_cast<float>(tile_w0 + en.r_lo + j),
                                   en.wire, en.den_w);
      } else if (j - pw < en.nc) {
        weights[s] = axis_weight(
            static_cast<float>(tile_t0 + en.c_lo + j - pw), en.tick,
            en.den_t);
      }
    }
    __syncthreads();  // weights ready
    add_chunk(p, entries, n, weights, stride, cls, lane, acc);
    __syncthreads();  // the chunk is summed; its buffers are free
    if (n < kChunk || k0 + kChunk >= p.k_max) break;
  }
}

// Copy the shared rows r = part (mod 2^part_shift) of tile t_id of plane
// `plane` to their place in the (P, tiles_w*tw, tiles_t*tt) output.
__device__ void store_tile(const float* acc, float* out, const DepoParams& p,
                           int plane, int tiles_w, int t_id, int part) {
  const long long stride = static_cast<long long>(p.tiles_t) * p.tt;
  const long long row0 =
      (static_cast<long long>(plane) * tiles_w + t_id / p.tiles_t) * p.tw;
  float* dst = out + row0 * stride +
               static_cast<long long>(t_id % p.tiles_t) * p.tt;
  const int vec = p.tt / 4;
  for (int i = threadIdx.x; i < (p.tw >> p.part_shift) * vec; i += kThreads) {
    const int r = i / vec, c4 = i % vec;
    reinterpret_cast<float4*>(dst + ((r << p.part_shift) + part) * stride)[c4] =
        reinterpret_cast<const float4*>(acc + r * p.tt)[c4];
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

// The first kSplitSlots ranks of `order` (the longest lists) get
// 2^kSplitShift CTAs each: a slot whose list is longer than `long_list`
// runs as one CTA per row part, a shorter one in its first CTA alone (the
// others return). Every later rank runs as one CTA. CTA b runs slot i =
// order[rank] = p * per_plane + s of plane p. Dense: slot s is tile s.
// Compact: slot s holds plane-local tile active[i] (-1: padding, nothing to
// write). Lists are (P * per_plane, k_max), `lengths` their filled lengths.
template <bool kCompact>
__global__ void __launch_bounds__(kThreads)
fused_sim_kernel(DepoParams p, PlaneSeeds seeds, int n_depos, int per_plane,
                 int tiles_w, int n_split, int long_list,
                 const int* __restrict__ order,
                 const int* __restrict__ lengths,
                 const int* __restrict__ active, const int* __restrict__ ids,
                 float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  const int split = n_split << kSplitShift;  // CTAs of the first ranks
  const int b = blockIdx.x;
  int i, part = 0;
  p.part_shift = 0;
  if (b < split) {
    i = order[b >> kSplitShift];
    if (lengths[i] > long_list) {
      p.part_shift = kSplitShift;
      part = b & ((1 << kSplitShift) - 1);
    } else if (b & ((1 << kSplitShift) - 1)) {
      return;
    }
  } else {
    i = order[n_split + b - split];
  }
  const int plane = i / per_plane;
  const int t_id = kCompact ? active[i] : i - plane * per_plane;
  if (t_id < 0) return;
  accumulate_tile(plane_view(p, plane, n_depos, seeds), t_id, part,
                  ids + static_cast<long long>(i) * p.k_max, acc,
                  acc + (p.tw >> p.part_shift) * p.tt);
  store_tile(acc, out, p, plane, tiles_w, t_id, part);
}

// lengths[s] = the filled length of slot s's list (up to its first -1),
// one warp per slot reading 32 entries at a time.
__global__ void list_lengths_kernel(const int* __restrict__ ids, int n_slots,
                                    int k_max, int* __restrict__ lengths) {
  const int slot = blockIdx.x * (kOrderThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (slot >= n_slots) return;
  const int* list = ids + static_cast<long long>(slot) * k_max;
  int n = k_max;
  for (int k0 = 0; k0 < k_max; k0 += 32) {
    const int d = k0 + lane < k_max ? list[k0 + lane] : -1;
    const unsigned gap = ~__ballot_sync(0xFFFFFFFFu, d >= 0);
    if (gap) {
      n = k0 + __ffs(gap) - 1;
      break;
    }
  }
  if (lane == 0) lengths[slot] = n;
}

// order[rank(i)] = i with rank(i) = #{j : len_j > len_i} + #{j < i : len_j
// == len_i}: the slots by descending length, stable. One warp ranks one
// slot against every length.
__global__ void launch_order_kernel(const int* __restrict__ lengths, int n,
                                    int* __restrict__ order) {
  const int i = blockIdx.x * (kOrderThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const int len = lengths[i];
  int rank = 0;
  for (int j = lane; j < n; j += 32) {
    const int other = lengths[j];
    rank += (other > len) | ((other == len) & (j < i));
  }
  rank = __reduce_add_sync(0xFFFFFFFFu, rank);
  if (lane == 0) order[rank] = i;
}

int check_shape(int num_planes, int n_tiles, int tiles_t, int tw, int tt,
                int pw, int pt) {
  if (num_planes <= 0 || num_planes > kMaxPlanes || tw <= 0 || tt <= 0 ||
      tw % (1 << kSplitShift) != 0 ||
      tt % 4 != 0 || tw > 1024 || tt > 4096 || pw <= 0 || pt <= 0 ||
      pw > kMaxPatch || pt > kMaxPatch ||
      tiles_t <= 0 || n_tiles % tiles_t != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <bool kCompact>
int launch(const float* wire, const float* tick, const float* sigma_w,
           const float* sigma_t, const float* charge, const int* w0,
           const int* t0, const int* active, const int* ids, const int* order,
           const uint32_t* seed_words, int num_planes, int n_depos,
           int fluctuate, int per_plane, int n_tiles, int tiles_t, int tw,
           int tt, int pw, int pt, int k_max, const int* lengths,
           float* out, void* stream) {
  if (int err = check_shape(num_planes, n_tiles, tiles_t, tw, tt, pw, pt))
    return err;
  const int smem =
      (tw * tt + kChunk * (pw + pt)) * static_cast<int>(sizeof(float));
  cudaFuncSetAttribute(fused_sim_kernel<kCompact>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // A list is long when it holds more entries than the CTAs resident at
  // once would each get of the launch's expected entries (a patch lands in
  // (1 + (pw-1)/tw)(1 + (pt-1)/tt) tiles on average): such a list would
  // still run after the rest of the work is done, so it splits.
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_sim_kernel<kCompact>, kThreads, smem);
  const double entries = static_cast<double>(n_depos) * num_planes *
                         (1.0 + (pw - 1.0) / tw) * (1.0 + (pt - 1.0) / tt);
  const int long_list =
      static_cast<int>(entries / max(sms * per_sm, 1));
  const int n_slots = num_planes * per_plane;
  const int n_split = min(kSplitSlots, n_slots);
  DepoParams p{wire, tick, sigma_w, sigma_t, charge, w0, t0, 0u, 0u,
               fluctuate, tiles_t, tw, tt, pw, pt, k_max, 0};
  PlaneSeeds seeds{};
  for (int i = 0; i < 2 * num_planes; ++i) seeds.words[i] = seed_words[i];
  const int ctas = n_slots + (n_split << kSplitShift) - n_split;
  fused_sim_kernel<kCompact><<<ctas, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      p, seeds, n_depos, per_plane, n_tiles / tiles_t, n_split, long_list,
      order, lengths, active, ids, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Depo parameters are (P, N)
// plane-major; `seeds` is a HOST array of 2 * num_planes words; `order` is
// the CTA launch order, a permutation of the num_planes * per_plane slots
// (per_plane = n_tiles for the dense layout, n_cap for the compact one);
// `out` is the (P, tiles_w*tw, tiles_t*tt) grid (the compact launch writes
// only the occupied tiles: the caller zeroes it). Each launches on `stream`
// and returns cudaGetLastError() as an int (0 = launched).
extern "C" int fused_sim_dense(const float* wire, const float* tick,
                               const float* sigma_w, const float* sigma_t,
                               const float* charge, const int* w0,
                               const int* t0, const int* ids,
                               const int* order, const uint32_t* seeds,
                               int num_planes, int n_depos, int fluctuate,
                               int per_plane, int n_tiles, int tiles_t,
                               int tw, int tt, int pw, int pt, int k_max,
                               const int* lengths, float* out,
                               void* stream) {
  if (per_plane != n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(wire, tick, sigma_w, sigma_t, charge, w0, t0, nullptr,
                       ids, order, seeds, num_planes, n_depos, fluctuate,
                       per_plane, n_tiles, tiles_t, tw, tt, pw, pt, k_max,
                       lengths, out, stream);
}

extern "C" int fused_sim_compact(const float* wire, const float* tick,
                                 const float* sigma_w, const float* sigma_t,
                                 const float* charge, const int* w0,
                                 const int* t0, const int* active,
                                 const int* ids, const int* order,
                                 const uint32_t* seeds, int num_planes,
                                 int n_depos, int fluctuate, int per_plane,
                                 int n_tiles, int tiles_t, int tw, int tt,
                                 int pw, int pt, int k_max,
                                 const int* lengths, float* out,
                                 void* stream) {
  return launch<true>(wire, tick, sigma_w, sigma_t, charge, w0, t0, active,
                      ids, order, seeds, num_planes, n_depos, fluctuate,
                      per_plane, n_tiles, tiles_t, tw, tt, pw, pt, k_max,
                      lengths, out, stream);
}

// The launch order of n_slots k_max-long lists `ids`: `order` (n_slots)
// receives the slots by descending filled length, stable; `lengths`
// (n_slots) is scratch that ends holding the lengths.
extern "C" int fused_sim_launch_order(const int* ids, int n_slots, int k_max,
                                      int* lengths, int* order,
                                      void* stream) {
  if (n_slots <= 0 || k_max <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int warps = kOrderThreads / 32;
  list_lengths_kernel<<<(n_slots + warps - 1) / warps, kOrderThreads, 0, s>>>(
      ids, n_slots, k_max, lengths);
  launch_order_kernel<<<(n_slots + warps - 1) / warps, kOrderThreads, 0, s>>>(
      lengths, n_slots, order);
  return static_cast<int>(cudaGetLastError());
}
