// Per-wire threshold-run hit scanner over a deconvolved (W, T) grid, for
// Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernel
//   src/repro/kernels/hitfind/kernel.py:40  hitfind_pallas
// (body _hitfind_kernel, running the scan src/repro/core/hitfind.py:70
// _wire_scan).
//
// What it computes. For each wire, every run of consecutive ticks with
// v > threshold (strictly greater) is one hit. The wire's total run count
// (runs still open at the last tick are flushed) goes to counts[w]; for the
// first `cap` runs, in time order, slot n of the wire holds
//   charge = sum of v over the run,
//   tick   = sum of v*t over the run / max(charge, 1e-30),
//   peak   = max of v over the run,
// each sum taken in tick order and started from the run's first sample
// (csum = v, tsum = v*t, not 0 + v). Slots past the stored runs are 0, as
// the reference's zero-initialised carry leaves them.
//
// Design. A float sum cannot be split or reordered without changing bits,
// so the parallelism comes from the wires and from finding the runs, never
// from summing one run. One warp owns one wire (4 wires per CTA, no CTA
// barrier), so a MicroBooNE plane gives 2560 warps on 132 SMs.
//  - Finding the runs. The warp reads its wire in steps of 512 ticks: 16
//    loads a lane, lane l of load j reading tick base + 32j + l, so each
//    load instruction of the warp is 128 consecutive bytes. Scalar loads
//    take any T (a row need not start on 16 bytes) and the tail is masked.
//    The next step's 16 loads are issued before the current step is
//    scanned, so up to 32 (4 KB a warp) are in flight: a warp's time is
//    mostly round trips to device memory. On an H100 at full width fewer
//    loads a step were slower, and more gained little for many more
//    registers. For each 32 ticks one ballot gives the
//    above-threshold flags as a 32-bit mask m; with the previous tick's flag
//    carried in as bit 0, starts = m & ~prev and closes = ~m & prev (a
//    close is the first tick below after a run). Ranks come from popcounts:
//    integer arithmetic, exact in any order. The k-th start and the k-th
//    close (k < cap) are the k-th run's [lo, hi); a run not closed by the
//    last tick ends at T. The bounds go to a shared ring of kRing entries:
//    the runs a step touches (one carried in, at most 256 starting in it)
//    never wrap it.
//  - Summing the stored runs. Lane l owns the stored runs k = l (mod 32)
//    and walks them one after another. In a step that a stored run touches
//    (known from the counts: warp-uniform), the warp copies the step's 512
//    samples to shared memory and each lane walks its runs' ticks inside
//    the step in tick order, one product and two adds a tick, so the grid
//    is read from device memory once. Runs are disjoint, so the lanes walk
//    in parallel; at most one run crosses a step edge, the last its lane
//    walks in the step and the first in the next, so its sums stay in that
//    lane's registers. A run's slot is written when its walk ends.
//  - Lane 0 writes the count, and the slots past the stored runs are
//    written 0 at the end.
//
// Numerics. The products and sums are written with __fmul_rn / __fadd_rn,
// which the compiler never contracts into an FMA: the reference's XLA on the
// CPU does not contract tsum + v*t either, so the arithmetic is the
// reference's operation for operation, and the division is IEEE (no
// --use_fast_math). t is exact as a float (T < 2^24). The threshold is the
// float32 the caller passes; ticks past T never count as above it.
//
// What bounds it on an H100. Bytes: the grid is read once (2560 x 9592 x 4
// bytes = 98 MB per MicroBooNE plane) and the candidates written once
// (2560 x (1 + 3 x 8) x 4 bytes = 0.26 MB): about 29 us at 3.35 TB/s per
// plane. Run finding is ~1 instruction a sample over the warp's 32 lanes.
// What sets the time. At full width the stored runs are tens of ticks long
// (chip_smoke.py prints their lengths per plane), so the walks cost little.
// Each warp streams its 38 KB wire with at most 4 KB in flight, so its time
// is ~10 round trips to device memory, and a plane's 2560 warps (~19 an SM)
// keep too few bytes in flight to reach the card's rate. A longer stored
// run would add one dependent add a tick to its warp, and a cap above 32
// walks several runs a lane one after another.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kWarps = 4;            // wires per CTA, one warp each
constexpr int kLoads = 16;           // 32-tick loads a lane issues per step
constexpr int kStep = 32 * kLoads;   // ticks per step
// run bounds a warp keeps: the runs touching one step (one carried in, at
// most kStep / 2 starting in it) must fit, and k & (kRing - 1) indexes it
constexpr int kRing = kStep;
static_assert(kRing >= kStep / 2 + 1 && (kRing & (kRing - 1)) == 0,
              "the ring holds a step's runs and is a power of two");

struct Candidates {
  int* counts;    // (W,)
  float* charge;  // (W, cap)
  float* tick;    // (W, cap)
  float* peak;    // (W, cap)
  int cap;
};

__global__ void __launch_bounds__(kWarps * 32)
hitfind_kernel(const float* __restrict__ decon, int num_wires, int num_ticks,
               float threshold, Candidates out) {
  __shared__ float samples[kWarps][kStep];
  __shared__ int run_lo[kWarps][kRing];
  __shared__ int run_hi[kWarps][kRing];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= num_wires) return;  // the whole warp: no CTA barrier follows
  const float* row = decon + static_cast<long long>(w) * num_ticks;
  const long long slots = static_cast<long long>(w) * out.cap;
  const int cap = out.cap;
  const unsigned below_lane = (1u << lane) - 1u;

  float cur[kLoads], nxt[kLoads] = {};
  auto load = [&](int base, float (&v)[kLoads]) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int t = base + 32 * j + lane;
      v[j] = t < num_ticks ? row[t] : 0.0f;
    }
  };

  int n = 0;           // runs started so far (warp-uniform)
  int closed = 0;      // runs closed so far (warp-uniform)
  unsigned carry = 0;  // the flag of the tick before the step
  // the sums of the run this lane walked last (one run k = lane mod 32)
  float csum = 0.0f, tsum = 0.0f, pk = 0.0f;
  load(0, cur);
  for (int base = 0; base < num_ticks; base += kStep) {
    if (base + kStep < num_ticks) load(base + kStep, nxt);
    const int closed_before = closed;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int t = base + 32 * j + lane;
      const unsigned m = __ballot_sync(kAll, t < num_ticks && cur[j] > threshold);
      const unsigned prev = (m << 1) | carry;
      carry = m >> 31;
      const unsigned starts = m & ~prev, closes = ~m & prev;
      if (n < cap && (starts >> lane & 1u)) {
        const int k = n + __popc(starts & below_lane);
        if (k < cap) run_lo[warp][k & (kRing - 1)] = t;
      }
      if (closed < cap && (closes >> lane & 1u)) {
        const int k = closed + __popc(closes & below_lane);
        if (k < cap) run_hi[warp][k & (kRing - 1)] = t;
      }
      n += __popc(starts);
      closed += __popc(closes);
    }
    // stored runs closed_before .. min(n, cap) - 1 touch this step
    const int stored = min(n, cap);
    const int step_end = base + kStep;
    if (closed_before < stored) {
#pragma unroll
      for (int j = 0; j < kLoads; ++j) samples[warp][32 * j + lane] = cur[j];
      __syncwarp();  // the samples and the run bounds are visible
      for (int k = closed_before + ((lane - closed_before) & 31); k < stored;
           k += 32) {
        const int lo = run_lo[warp][k & (kRing - 1)];
        const int hi = k < closed ? run_hi[warp][k & (kRing - 1)] : num_ticks;
        const int end = min(hi, step_end);
        int t = max(lo, base);
        if (t == lo) {  // the run's first sample starts its sums
          const float v = samples[warp][t - base];
          csum = v;
          tsum = __fmul_rn(v, static_cast<float>(t));
          pk = v;
          ++t;
        }
        for (; t < end; ++t) {
          const float v = samples[warp][t - base];
          csum = __fadd_rn(csum, v);
          tsum = __fadd_rn(tsum, __fmul_rn(v, static_cast<float>(t)));
          pk = fmaxf(pk, v);
        }
        if (hi <= step_end) {  // the walk is over: the run's slot
          out.charge[slots + k] = csum;
          out.tick[slots + k] = tsum / fmaxf(csum, 1e-30f);
          out.peak[slots + k] = pk;
        }
      }
      __syncwarp();  // every walk has read the samples and the bounds
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) cur[j] = nxt[j];
  }

  if (lane == 0) out.counts[w] = n;
  for (int k = min(n, cap) + lane; k < cap; k += 32) {
    out.charge[slots + k] = 0.0f;
    out.tick[slots + k] = 0.0f;
    out.peak[slots + k] = 0.0f;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). `step` is the caller's idea of
// the kernel's step in ticks (kernels/hitfind/kernel.py STEP, which its
// edge cases are built around): a mismatch is refused. Launches on
// `stream` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int hitfind_scan(const float* decon, int num_wires, int num_ticks,
                            float threshold, int cap, int step, int* counts,
                            float* charge, float* tick, float* peak,
                            void* stream) {
  if (num_wires < 0 || num_ticks < 0 || cap < 1 || step != kStep)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_wires == 0) return 0;
  const Candidates out{counts, charge, tick, peak, cap};
  const int blocks = (num_wires + kWarps - 1) / kWarps;
  hitfind_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      decon, num_wires, num_ticks, threshold, out);
  return static_cast<int>(cudaGetLastError());
}
