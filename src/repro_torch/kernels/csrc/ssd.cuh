// The Mamba2 SSD scan's pieces that its forward (ssm_scan.cu) and backward
// (ssm_scan_bwd.cu) share: tile sizes, the clipped exponential, the chunk's
// cumsum of dt·A, cp.async staging, and chunk_state_kernel, the per-chunk
// (P x L)·(L x N) product on the tensor cores in 3xTF32 (the forward's own
// states; in the backward the entering state's gradient).
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

// dt of the chunk (steps dt_ss apart) into dts, and the inclusive cumsum of
// dt·A into cs: warp scans, then the totals of the warps before.
__device__ __forceinline__ void chunk_cumsum(const float* dt, int64_t dt_ss, float a_h, int L,
                                             float* cs, float* dts, float* wsum) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float d = tid < L ? dt[tid * dt_ss] : 0.f;
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

constexpr int kNT = 128;  // state columns per chunk_state block
constexpr int kLdN = kNT + 8;  // row of a [steps][kNT] tile read as (k, col): 8 mod 32

inline size_t state_smem_bytes() {
  return sizeof(float) * (2 * kMaxL + 8 + kWarps + 2 * kKC * kLdP + 2 * kKC * kLdN);
}

// 2. states[b, c, h, p, n] = sum_j clip_exp(cs_L - cs_j) dt_j x[j, h, p]
// B[j, n] over the chunk's steps j; decay[b, c, h] = cs_L.  One block per
// (chunk, head and 64-row P tile and 128-column N tile, batch row); warp w
// the P rows 16 (w % 4).. and the columns 64 (w / 4)..  With kEntering
// (the backward), the weights are clip_exp(cs_j) and nothing is written to
// decay: given dy for x and C for B, the gradient of the state entering the
// chunk from the chunk's y, sum_j clip_exp(cs_j) dy_j ⊗ C_j.
template <bool kEntering>
__global__ void __launch_bounds__(kThreads, 2)  // two blocks an SM
chunk_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   float* __restrict__ states, float* __restrict__ decay, int H, int P, int N,
                   int L, bool vec, int64_t x_sb, int64_t x_ss, int64_t x_sh, int64_t dt_sb,
                   int64_t dt_ss, int64_t b_sb, int64_t b_ss) {
  extern __shared__ float4 smem_state[];  // float4: 16-byte alignment
  float* cs = reinterpret_cast<float*>(smem_state);  // [kMaxL]
  float* wt = cs + kMaxL;                             // [kMaxL + 8] dt, then the weights
  float* wsum = wt + kMaxL + 8;                       // [kWarps]
  float* xs = wsum + kWarps;                          // [2][kKC][kPT] of x
  float* bs = xs + 2 * kKC * kLdP;                    // [2][kKC][kNT] of B
  const int ptiles = (P + kPT - 1) / kPT, ntiles = (N + kNT - 1) / kNT;
  const int c = blockIdx.x, b = blockIdx.z, nc = gridDim.x;
  const int h = blockIdx.y / (ptiles * ntiles);
  const int pt = blockIdx.y / ntiles % ptiles, ntile = blockIdx.y % ntiles;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int p0 = pt * kPT, pw = min(kPT, P - p0);
  const int n0 = ntile * kNT, nw = min(kNT, N - n0);
  const int64_t t0 = static_cast<int64_t>(c) * L;
  const float* xg = x + b * x_sb + t0 * x_ss + h * x_sh + p0;
  const float* bg = Bm + b * b_sb + t0 * b_ss + n0;

  auto issue = [&](int stage, int j0) {
    stage_async<kThreads, kKC, kPT>(vec, xs + stage * kKC * kLdP, kLdP, kKC, kPT, xg,
        [&](int j, int p) { return j0 + j < L && p < pw; },
        [&](int j, int p) { return xg + (j0 + j) * x_ss + p; });
    stage_async<kThreads, kKC, kNT>(vec, bs + stage * kKC * kLdN, kLdN, kKC, kNT, bg,
        [&](int j, int n) { return j0 + j < L && n < nw; },
        [&](int j, int n) { return bg + (j0 + j) * b_ss + n; });
  };
  issue(0, 0);
  cp_async_commit();

  chunk_cumsum(dt + b * dt_sb + t0 * dt_ss + h, dt_ss, A[h], L, cs, wt, wsum);
  const float cl = cs[L - 1];
  if (tid < L)  // the step's weight in the state
    wt[tid] = kEntering ? clip_exp(cs[tid]) : wt[tid] * clip_exp(cl - cs[tid]);
  else if (tid < kMaxL + 8)
    wt[tid] = 0.f;  // past the chunk: read beside zero-filled x, so never NaN
  if (!kEntering && tid == 0 && pt == 0 && ntile == 0)
    decay[(static_cast<int64_t>(b) * nc + c) * H + h] = cl;

  const int rt = w % 4, c0 = 64 * (w / 4);  // the warp's 16 P rows and 64 columns
  const bool active = 16 * rt < pw && c0 < nw;
  const int nq = min(8, (nw - c0 + 7) / 8);  // its 8-column tiles
  float acc[8][4];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;

  for (int j0 = 0, s = 0; j0 < L; j0 += kKC, s ^= 1) {
    if (j0 + kKC < L) issue(s ^ 1, j0 + kKC);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this stage has landed (and the weights are in wt)
    const float* xt = xs + s * kKC * kLdP;
    const float* bt = bs + s * kKC * kLdN;
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 8) {
        if (j0 + kk >= L) break;
        FragA3 a;  // (p, j) = weight_j x[j][p]
        a.load([&](int r, int k) { return xt[(kk + k) * kLdP + 16 * rt + r] * wt[j0 + kk + k]; },
               lane);
        FragB3 bf[8];  // (j, n) = B[j][n]
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (q < nq)
            bf[q].load([&](int k, int n) { return bt[(kk + k) * kLdN + c0 + 8 * q + n]; }, lane);
        mma_3xtf32(acc, a, bf, nq);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  if (!active) return;
  const int g = lane >> 2, t = lane & 3;
  float* out = states + ((static_cast<int64_t>(b) * nc + c) * H + h) * P * N;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int n = n0 + c0 + 8 * q + 2 * t;
    if (q >= nq || n >= N) continue;  // N is a multiple of 4, so n + 1 < N too
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = p0 + 16 * rt + g + 8 * r;
      *reinterpret_cast<float2*>(out + static_cast<int64_t>(p) * N + n) =
          make_float2(acc[q][2 * r], acc[q][2 * r + 1]);
    }
  }
}

}  // namespace ssd
}  // namespace repro
