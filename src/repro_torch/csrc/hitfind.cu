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
// each sum taken in tick order. Slots past the stored runs are 0, as the
// reference's zero-initialised carry leaves them.
//
// Design. One thread per wire, as the reference's grid has one step per
// wire: the scan is sequential in time. A CTA is one warp and owns 32
// adjacent wires. Reading a wire's ticks thread by thread would put adjacent
// threads T*4 bytes apart, so the warp stages the grid through shared memory
// in [32 wires x 32 ticks] tiles: each of its 32 row loads reads 32
// consecutive ticks of one wire (128 bytes, coalesced), the tile is stored
// transposed with a padded row so neither the store nor the per-lane reads
// conflict on banks, and the next tile's loads are issued into registers
// before the current tile is scanned, so they are in flight during the scan.
// A run writes its slot to device memory when it closes; no (cap,) arrays
// live in registers.
//
// Numerics. The products and sums are written with __fmul_rn / __fadd_rn,
// which the compiler never contracts into an FMA: the reference's XLA on the
// CPU does not contract tsum + v*t either, so the arithmetic is the
// reference's operation for operation, and the division is IEEE (no
// --use_fast_math). t is exact as a float (T < 2^24).
//
// What bounds it on an H100. Bytes: the grid is read once (2560 x 9592 x 4
// bytes = 98 MB per MicroBooNE plane) and the candidates written once
// (2560 x (1 + 3 x 8) x 4 bytes = 0.26 MB): about 29 us at 3.35 TB/s per
// plane. Operations are ~10 per sample, far below that. This first design
// is latency-bound instead: a plane gives 80 warps (2560 wires / 32), one
// per SM on 80 of the 132 SMs, and each lane walks 9592 dependent steps.
// Splitting the time axis into segments scanned in parallel, with the runs
// that cross a segment edge joined afterwards, is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWires = 32;  // wires per CTA (one per lane)
constexpr int kTicks = 32;  // ticks per staged tile

struct Candidates {
  int* counts;    // (W,)
  float* charge;  // (W, cap)
  float* tick;    // (W, cap)
  float* peak;    // (W, cap)
  int cap;
};

__global__ void __launch_bounds__(kWires)
hitfind_kernel(const float* __restrict__ decon, int num_wires, int num_ticks,
               float threshold, Candidates out) {
  __shared__ float tile[kWires][kTicks + 1];
  const int lane = threadIdx.x;
  const int w_base = blockIdx.x * kWires;
  const int rows = min(kWires, num_wires - w_base);
  const int w = w_base + lane;
  const bool live = lane < rows;

  // next[r] = decon[w_base + r, t0 + lane]: row r of the tile at t0
  float next[kWires];
  auto load = [&](int t0) {
    const int t = t0 + lane;
#pragma unroll
    for (int r = 0; r < kWires; ++r)
      next[r] = (r < rows && t < num_ticks)
                    ? decon[static_cast<long long>(w_base + r) * num_ticks + t]
                    : 0.0f;
  };

  const long long slot0 = static_cast<long long>(w) * out.cap;
  int n = 0;
  bool active = false;
  float csum = 0.0f, tsum = 0.0f, pk = 0.0f;
  auto emit = [&]() {
    if (n < out.cap) {
      out.charge[slot0 + n] = csum;
      out.tick[slot0 + n] = tsum / fmaxf(csum, 1e-30f);
      out.peak[slot0 + n] = pk;
    }
    ++n;
  };

  load(0);
  for (int t0 = 0; t0 < num_ticks; t0 += kTicks) {
    __syncwarp();  // every lane has read the previous tile
#pragma unroll
    for (int r = 0; r < kWires; ++r) tile[r][lane] = next[r];
    __syncwarp();  // the tile is complete
    if (t0 + kTicks < num_ticks) load(t0 + kTicks);
    if (!live) continue;
    const int steps = min(kTicks, num_ticks - t0);
    for (int j = 0; j < steps; ++j) {
      const float v = tile[lane][j];
      const bool above = v > threshold;
      if (active && !above) emit();  // the run ended at the previous tick
      const float vt = __fmul_rn(v, static_cast<float>(t0 + j));
      if (above) {
        csum = active ? __fadd_rn(csum, v) : v;
        tsum = active ? __fadd_rn(tsum, vt) : vt;
        pk = active ? fmaxf(pk, v) : v;
      } else {
        csum = tsum = pk = 0.0f;
      }
      active = above;
    }
  }
  if (!live) return;
  if (active) emit();  // flush a run still open at the readout edge
  out.counts[w] = n;
  for (int s = min(n, out.cap); s < out.cap; ++s) {
    out.charge[slot0 + s] = 0.0f;
    out.tick[slot0 + s] = 0.0f;
    out.peak[slot0 + s] = 0.0f;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int hitfind_scan(const float* decon, int num_wires, int num_ticks,
                            float threshold, int cap, int* counts,
                            float* charge, float* tick, float* peak,
                            void* stream) {
  if (num_wires < 0 || num_ticks < 0 || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_wires == 0) return 0;
  const Candidates out{counts, charge, tick, peak, cap};
  const int blocks = (num_wires + kWires - 1) / kWires;
  hitfind_kernel<<<blocks, kWires, 0, static_cast<cudaStream_t>(stream)>>>(
      decon, num_wires, num_ticks, threshold, out);
  return static_cast<int>(cudaGetLastError());
}
