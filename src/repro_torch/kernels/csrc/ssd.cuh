// The Mamba2 SSD scan's pieces that its forward (ssm_scan.cu) and backward
// (ssm_scan_bwd.cu) share: tile sizes, the clipped exponential, the chunk's
// cumsum of dt·A, and cp.async staging (the forward's).
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace repro {
namespace ssd {

constexpr int kThreads = 256;  // 8 warps (chunk_cb: 4)
constexpr int kWarps = kThreads / 32;
constexpr int kCbThreads = 128;
constexpr int kMaxL = 128;     // steps per chunk
constexpr int kMaxN = 256;     // state size
constexpr int kPT = 64;        // P columns per block
constexpr int kKC = 32;        // state columns or steps staged at a time
constexpr int kLdK = kKC + 4;  // row of a [rows][kKC] tile read as (row, k): 4 mod 32 banks
constexpr int kLdP = kPT + 8;  // row of a [steps][kPT] tile read as (k, col): 8 mod 32

__device__ __forceinline__ float clip_exp(float t) {
  return expf(fminf(fmaxf(t, -60.f), 0.f));
}

// The chunk's dt (thread i < L holds step i's in d) into dts, and the
// inclusive cumsum of dt·A into cs: warp scans, then the totals of the
// warps before.
__device__ __forceinline__ void cumsum_steps(float d, float a_h, int L, float* cs, float* dts,
                                             float* wsum) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid < L) dts[tid] = d;
  float v = d * a_h;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFullMask, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (tid < L) {
    for (int w = 0; w < warp; ++w) v += wsum[w];
    cs[tid] = v;
  }
  __syncthreads();
}

// The same, reading dt of the chunk (steps dt_ss apart) itself.
__device__ __forceinline__ void chunk_cumsum(const float* dt, int64_t dt_ss, float a_h, int L,
                                             float* cs, float* dts, float* wsum) {
  cumsum_steps(threadIdx.x < L ? dt[threadIdx.x * dt_ss] : 0.f, a_h, L, cs, dts, wsum);
}

// Start copying a tile into shared memory by cp.async, kVec floats a copy
// (1, or 4 where every source row and column offset is 16-byte aligned):
// element (r, c) at dst[r * ld + c], for r < rows (at most kRows) and c <
// cols (at most kCols), is *src(r, c) where ok(r, c) and 0 elsewhere (ok
// is asked for the first column of each copy; `any` is a valid address
// that is not read).  The caller commits the group and waits.
template <int kN, int kRows, int kCols, int kVec, typename Ok, typename Src>
__device__ __forceinline__ void stage_copies(float* dst, int ld, int rows, int cols,
                                            const float* any, Ok ok, Src src) {
  static_assert(kRows * kCols % (kN * kVec) == 0, "whole copies a thread");
#pragma unroll
  for (int k = 0; k < kRows * kCols / (kN * kVec); ++k) {
    const int e = (threadIdx.x + k * kN) * kVec, r = e / kCols, c = e % kCols;
    if (r < rows && c < cols) {
      const bool in = ok(r, c);
      if (kVec == 4)
        cp_async_16(dst + r * ld + c, in ? src(r, c) : any, in);
      else
        cp_async_4(dst + r * ld + c, in ? src(r, c) : any, in);
    }
  }
}

// The same, 16 bytes a copy where `vec`, else 4.
template <int kN, int kRows, int kCols, typename Ok, typename Src>
__device__ __forceinline__ void stage_async(bool vec, float* dst, int ld, int rows, int cols,
                                            const float* any, Ok ok, Src src) {
  if (vec)
    stage_copies<kN, kRows, kCols, 4>(dst, ld, rows, cols, any, ok, src);
  else
    stage_copies<kN, kRows, kCols, 1>(dst, ld, rows, cols, any, ok, src);
}

}  // namespace ssd
}  // namespace repro
