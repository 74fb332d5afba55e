// The Mamba2 SSD chunked scan, for sm_90a.
//
// Replaces: src/repro/kernels/ssm_scan.py, ssm_scan_bshp (Pallas body
// _ssd_kernel).
//
// What bounds it on the H100: float32 operations.  Per chunk of L steps,
// every head does L(L+1)/2 * P multiply-adds for the intra-chunk term and
// 2 * L * P * N for the inter-chunk term and the state update.  At
// mamba2-370m's shapes (S = 1024, H = 32, P = 64, N = 128, batch 1) that is
// about 1.4 GFLOP against about 19 MB read and written once, some 70 flops
// a byte, far above the 20 flops a byte where the 67 TFLOP/s of the float32
// CUDA cores meet the 3.35 TB/s of device memory.
//
// Design:
//   * two launches per call.  The first computes C·Bᵀ of every chunk once
//     (B and C are one group, shared by every head) into an (B, nc, L, L)
//     scratch of at most 0.5 MB a batch row, which stays in L2.  Computed in
//     every (head, P-tile) block instead, it would about triple the
//     arithmetic at mamba2's shapes;
//   * the second runs one block per (P-tile of 16, SSM head, batch row):
//     128 blocks for mamba2 and 256 for zamba2 at batch 1.  The block walks
//     the chunks in order and keeps its N x 16 float32 slice of the state in
//     shared memory from one chunk to the next.  That loop takes the place
//     of the Pallas grid's sequential chunk axis and its VMEM scratch;
//   * per chunk: an inclusive cumsum of dt*A over the L steps (warp
//     shuffles); then y_i = exp(cs_i) C_i·state (N staged 32 columns at a
//     time) + sum_{j<=i} W_ij x_j, W_ij = CB_ij exp(cs_i - cs_j) dt_j, with
//     W built once per (i, j) as CB is staged 32 columns at a time; two
//     threads a y row, 8 columns each; then
//     state = exp(cs_L) state + sum_j exp(cs_L - cs_j) dt_j x_j B_jᵀ, each
//     thread holding a 2 x 4 (p, n) piece of the state in registers while
//     B streams through in 32-row tiles (two 16-byte-or-less loads per 8
//     multiply-adds).  Every exponent is clipped to [-60, 0] as in the
//     reference, so a padded step (dt = 0) leaves the state exactly as it
//     was;
//   * staged C and W tiles are padded to 33 floats a row, so the 16 rows a
//     warp reads lie in different banks; the state is stored n-major, so a
//     thread's 8 columns are two 16-byte loads;
//   * float32 on the CUDA cores throughout.  The L x L and L x N products
//     are matrix products that tensor cores and TMA loads would serve:
//     later work.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kMaxL = 128;        // steps per chunk
constexpr int kMaxN = 256;        // state size
constexpr int kNT = 32;           // columns of a staged tile
constexpr int kRow = kNT + 1;     // its padded row
constexpr int kPT = 16;           // P columns per block
constexpr int kPer = kPT / 2;     // y columns per thread: two threads a row

__device__ __forceinline__ float clip_exp(float t) {
  return expf(fminf(fmaxf(t, -60.f), 0.f));
}

// Stage rows [0, rows) and columns [0, cols) of a row-major source (row
// stride src_rs) into a tile of row stride tile_rs.
__device__ __forceinline__ void stage(float* tile, int tile_rs, const float* src,
                                      int64_t src_rs, int rows, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int r = e / cols, k = e % cols;
    tile[r * tile_rs + k] = src[r * src_rs + k];
  }
}

// cb[b, c, i, j] = sum_n C[b, c*L + i, n] * B[b, c*L + j, n]: one block per
// (chunk, batch row), each thread an 8 x 8 grid of (i, j) outputs.
__global__ void __launch_bounds__(kThreads)
chunk_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                float* __restrict__ cb, int N, int L, int64_t b_sb, int64_t b_ss,
                int64_t c_sb, int64_t c_ss) {
  __shared__ float ct[kMaxL * kRow];
  __shared__ float bt[kMaxL * kRow];
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t t0 = static_cast<int64_t>(c) * L;
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[a][q] = 0.f;

  for (int n0 = 0; n0 < N; n0 += kNT) {
    const int kt = min(kNT, N - n0);
    stage(ct, kRow, Cm + b * c_sb + t0 * c_ss + n0, c_ss, L, kt);
    stage(bt, kRow, Bm + b * b_sb + t0 * b_ss + n0, b_ss, L, kt);
    __syncthreads();
    for (int k = 0; k < kt; ++k) {
      float cv[8], bv[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int i = ty + 16 * a;
        cv[a] = i < L ? ct[i * kRow + k] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = tx + 16 * q;
        bv[q] = j < L ? bt[j * kRow + k] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[a][q] += cv[a] * bv[q];
    }
    __syncthreads();
  }
  float* out = cb + (static_cast<int64_t>(b) * nc + c) * L * L;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = ty + 16 * a, j = tx + 16 * q;
      if (i < L && j < L) out[i * L + j] = acc[a][q];
    }
}

// The state update's micro-tiles: 2 P columns x 4 state columns a thread.
constexpr int kMaxMT = (kPT / 2) * (kMaxN / 4) / kThreads;  // per thread, at most

__host__ __device__ __forceinline__ int tile_floats(int N, int L) {
  return L * kRow > kNT * (N + 4) ? L * kRow : kNT * (N + 4);
}

size_t scan_smem_bytes(int N, int L) {
  return sizeof(float) * (N * kPT + L * kPT + tile_floats(N, L) + 2 * L + kThreads / 32);
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ cb,
                float* __restrict__ y, float* __restrict__ fin, int S, int H, int P, int N,
                int L, int64_t x_sb, int64_t x_ss, int64_t x_sh, int64_t dt_sb,
                int64_t dt_ss, int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss) {
  extern __shared__ float4 smem4[];  // float4: 16-byte alignment for the vector reads
  float* st = reinterpret_cast<float*>(smem4);  // [N][kPT] state slice, n-major
  float* xs = st + N * kPT;                     // [L][kPT] x of the chunk, then weighted
  float* tile = xs + L * kPT;                   // [L][kRow] staged C or W, [kNT][N+4] B
  float* cs = tile + tile_floats(N, L);         // [L] inclusive cumsum of dt*A
  float* dts = cs + L;                          // [L]
  float* wsum = dts + L;                        // [kThreads / 32] warp totals of the scan

  const int p0 = blockIdx.x * kPT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row = tid / 2, half = (tid % 2) * kPer;  // the y row and 8 columns a thread owns
  const bool active = row < L;
  const float a_h = A[h];
  const int nc = S / L;
  for (int e = tid; e < N * kPT; e += kThreads) st[e] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int64_t t0 = static_cast<int64_t>(c) * L;
    // 1. stage dt and x of the chunk (the previous chunk's readers are done)
    for (int e = tid; e < L; e += kThreads) dts[e] = dt[b * dt_sb + (t0 + e) * dt_ss + h];
    for (int e = tid; e < L * kPT; e += kThreads) {
      const int j = e / kPT, p = e % kPT;
      xs[e] = x[b * x_sb + (t0 + j) * x_ss + h * x_sh + p0 + p];
    }
    __syncthreads();

    // 2. inclusive cumsum of dt*A: warp scans, then the totals of the warps before
    {
      float v = tid < L ? dts[tid] * a_h : 0.f;
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

    // 3. y of the chunk: the entering state's term, then the intra-chunk term
    float acc[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) acc[q] = 0.f;
    for (int n0 = 0; n0 < N; n0 += kNT) {
      const int kt = min(kNT, N - n0);
      stage(tile, kRow, Cm + b * c_sb + t0 * c_ss + n0, c_ss, L, kt);
      __syncthreads();
      if (active) {
        for (int k = 0; k < kt; ++k) {
          const float cv = tile[row * kRow + k];
          const float4* s4 = reinterpret_cast<const float4*>(st + (n0 + k) * kPT + half);
          const float4 s0 = s4[0], s1 = s4[1];
          acc[0] += cv * s0.x; acc[1] += cv * s0.y; acc[2] += cv * s0.z; acc[3] += cv * s0.w;
          acc[4] += cv * s1.x; acc[5] += cv * s1.y; acc[6] += cv * s1.z; acc[7] += cv * s1.w;
        }
      }
      __syncthreads();
    }
    const float cs_i = active ? cs[row] : 0.f;
    const float e_i = clip_exp(cs_i);
#pragma unroll
    for (int q = 0; q < kPer; ++q) acc[q] *= e_i;

    const float* cbc = cb + ((static_cast<int64_t>(b) * nc + c) * L) * L;
    for (int j0 = 0; j0 < L; j0 += kNT) {
      const int kt = min(kNT, L - j0);
      // W_ij = CB_ij exp(cs_i - cs_j) dt_j for j <= i, each pair once
      for (int e = tid; e < L * kt; e += kThreads) {
        const int r = e / kt, k = e % kt, j = j0 + k;
        tile[r * kRow + k] = j <= r ? cbc[r * L + j] * clip_exp(cs[r] - cs[j]) * dts[j] : 0.f;
      }
      __syncthreads();
      if (active) {
        const int kend = min(kt, row - j0 + 1);  // j <= i only
        for (int k = 0; k < kend; ++k) {
          const float w = tile[row * kRow + k];
          const int j = j0 + k;
          const float4* x4 = reinterpret_cast<const float4*>(xs + j * kPT + half);
          const float4 x0 = x4[0], x1 = x4[1];
          acc[0] += w * x0.x; acc[1] += w * x0.y; acc[2] += w * x0.z; acc[3] += w * x0.w;
          acc[4] += w * x1.x; acc[5] += w * x1.y; acc[6] += w * x1.z; acc[7] += w * x1.w;
        }
      }
      __syncthreads();
    }
    if (active) {
      float4* y4 = reinterpret_cast<float4*>(
          y + ((static_cast<int64_t>(b) * S + t0 + row) * H + h) * P + p0 + half);
      y4[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      y4[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }

    // 4. state update: weight x by exp(cs_L - cs_j) dt_j in place, then
    //    state = exp(cs_L) state + xwᵀ B, B streamed in tiles of kNT rows
    const float cl = cs[L - 1];
    const float decay = clip_exp(cl);
    if (tid < L) dts[tid] *= clip_exp(cl - cs[tid]);  // dt is not read again this chunk
    __syncthreads();
    for (int e = tid; e < L * kPT; e += kThreads) xs[e] *= dts[e / kPT];
    const int n_mt = (kPT / 2) * (N / 4);  // micro-tiles: 2 p x 4 n each
    float sacc[kMaxMT][8];
#pragma unroll
    for (int r = 0; r < kMaxMT; ++r) {
      const int m = tid + r * kThreads, pp = (m % (kPT / 2)) * 2, nn = (m / (kPT / 2)) * 4;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        sacc[r][q] = m < n_mt ? st[(nn + q / 2) * kPT + pp + q % 2] * decay : 0.f;
    }
    for (int j0 = 0; j0 < L; j0 += kNT) {
      const int rows = min(kNT, L - j0);
      __syncthreads();  // xs is weighted; the previous tile is consumed
      stage(tile, N + 4, Bm + b * b_sb + (t0 + j0) * b_ss, b_ss, rows, N);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kMaxMT; ++r) {
        const int m = tid + r * kThreads, pp = (m % (kPT / 2)) * 2, nn = (m / (kPT / 2)) * 4;
        if (m >= n_mt) continue;
        for (int j = 0; j < rows; ++j) {
          const float2 xv = *reinterpret_cast<const float2*>(xs + (j0 + j) * kPT + pp);
          const float4 bv = *reinterpret_cast<const float4*>(tile + j * (N + 4) + nn);
          sacc[r][0] += xv.x * bv.x; sacc[r][1] += xv.y * bv.x;
          sacc[r][2] += xv.x * bv.y; sacc[r][3] += xv.y * bv.y;
          sacc[r][4] += xv.x * bv.z; sacc[r][5] += xv.y * bv.z;
          sacc[r][6] += xv.x * bv.w; sacc[r][7] += xv.y * bv.w;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxMT; ++r) {
      const int m = tid + r * kThreads, pp = (m % (kPT / 2)) * 2, nn = (m / (kPT / 2)) * 4;
      if (m >= n_mt) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q) st[(nn + q / 2) * kPT + pp + q % 2] = sacc[r][q];
    }
    __syncthreads();  // the state is whole before the next chunk reads it
  }

  for (int e = tid; e < kPT * N; e += kThreads) {
    const int p = e / N, n = e % N;
    fin[((static_cast<int64_t>(b) * H + h) * P + p0 + p) * N + n] = st[n * kPT + p];
  }
}

}  // namespace

// x (B, S, H, P), dt (B, S, H), B/C (B, S, N): float32, contiguous last
// axis, other strides in `strides` as (batch, seq) pairs of x, dt, B, C,
// plus x's head stride x_sh; A (H,) contiguous; y (B, S, H, P) and fin
// (B, H, P, N) contiguous; cb scratch of B * (S / L) * L * L floats.
// Returns cudaGetLastError().
extern "C" int repro_ssm_scan(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* Cm, void* y, void* fin, void* cb, int B, int S,
                              int H, int P, int N, int L, const int64_t* strides,
                              int64_t x_sh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P % kPT != 0 || N <= 0 || N > kMaxN ||
      N % 4 != 0 || L <= 0 || L > kMaxL || S % L != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t x_sb = strides[0], x_ss = strides[1], dt_sb = strides[2], dt_ss = strides[3];
  const int64_t b_sb = strides[4], b_ss = strides[5], c_sb = strides[6], c_ss = strides[7];
  const int nc = S / L;
  chunk_cb_kernel<<<dim3(nc, B), kThreads, 0, s>>>(
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), static_cast<float*>(cb), N,
      L, b_sb, b_ss, c_sb, c_ss);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = scan_smem_bytes(N, L);
  err = allow_smem(ssd_scan_kernel, smem);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<<<dim3(P / kPT, H, B), kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(cb), static_cast<float*>(y),
      static_cast<float*>(fin), S, H, P, N, L, x_sb, x_ss, x_sh, dt_sb, dt_ss, b_sb, b_ss,
      c_sb, c_ss);
  return cudaGetLastError();
}
