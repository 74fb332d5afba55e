// Backward of the Mamba2 SSD chunked scan, for sm_90a.
//
// Replaces: the gradient the JAX package takes of its scan in training (jnp
// autodiff of src/repro/models/ssm.py:ssd_chunked; the Pallas kernel
// src/repro/kernels/ssm_scan.py, ssm_scan_bshp, has no VJP of its own).
// Its specification is kernels/ssm_scan.py:ssm_scan_bwd_plain.
//
// What bounds it on the H100.  At mamba2-370m's training shape (4 x 1024
// steps, 32 heads, P 64, N 128, chunk 128) work_bwd counts about 11 GFLOP
// of products and 144 MB (x, dy, dx and the entering states once each):
// 0.043 ms at 3.35 TB/s, so the bound is bytes.  The products are float32
// in 3xTF32 on the tensor cores (three TF32 products each, as in the
// forward: one-pass TF32 would break the 2e-3 tolerance and the CPU-card
// training parity), on mma.sync, whose TF32 rate is below wgmma's; but
// wgmma takes tf32 operands K-major only, and half of these products read
// one operand down its rows (dy as (p, step), the states as (p, n)), so
// each would need a transposed, hi/lo-split copy in shared memory.  What
// the design does about bytes: nothing that is per head and per step goes
// to device memory but the gradients themselves, every sum over the heads
// stays on chip, and every tile arrives by TMA (cp.async.bulk.tensor, one
// request a box of 32 float32 columns, 128-byte swizzled) on an mbarrier
// while the one before it is used.  Fragments are
// read in pairs: the k of each 8-step is permuted (the tensor core's k = t
// and t + 4 take k = 2t and 2t + 1 of A and B alike), so a pair that is
// contiguous in shared memory is one 8-byte load.
//
// Launches, the forward's steps in reverse:
//   1. state_bwd_kernel: the reverse recurrence over the chunks.  One block
//      per (64 state columns, head, batch row), two an SM, walks the chunks
//      last to first with G, the gradient of the state leaving the chunk,
//      in registers: it writes G as the chunk's own state's gradient
//      (dstates, written once), sums G ⊙ entering (the chunk decay's
//      gradient) in a fixed order, and forms the chunk's entering-state
//      gradient Σ_i clip_exp(cs_i) dy_i ⊗ C_i on the tensor cores, G <- that
//      + G clip_exp(cs_L).  dy and C stream through a three-stage ring of 64
//      steps, the next chunk's in flight while this one's are used.
//   2. dbc_heads_kernel: one block per (32 rows, chunk, batch row), 12
//      warps, walks the heads in order, each head's x, dy, entering state
//      and dOwn arriving in a two-stage ring (one where two do not fit, N >
//      128), and holds in registers d(C·Bᵀ) = Σ_h (dy_h x_hᵀ) ⊙ E_h ⊙ dt_h
//      over the block's cross of the lower triangle (its rows left of the
//      diagonal, its columns below it: 32 x L elements) and the state terms
//      of its rows, Σ_h clip_exp(cs_h) ⊙ Z_h with Z_h = dy_h·entering_h (dC)
//      and Σ_h [w_h ⊙ x_h]·dOwn_h (dB), w_j = clip_exp(cs_L - cs_j) dt_j.
//      Each row's C_i·Z_i of each head goes into ddt for pass 3.  Then dC +=
//      d(C·Bᵀ)·B and dB += d(C·Bᵀ)ᵀ·C, B and C arriving where the ring was.
//   3. chunk_bwd_kernel: one block per (chunk, head, batch row), two an SM
//      (about 108 KB of shared memory): dx, ddt and the chunk's dA share.  x
//      and dy arrive whole; W without dt, C·Bᵀ ⊙ clip_exp(cs_i - cs_j), is
//      built once into shared memory (the lower triangle's 16 x 16 blocks,
//      swizzled); dW = dy·xᵀ and dx = Wᵀ·dy run back to back (warp w's
//      shares of the two triangles add up to the same for every warp), then
//      V = B·dOwnᵀ streams B and dOwn 32 state columns at a time through a
//      two-stage ring placed where x and W were: dx += w ⊙ V.  The
//      exponents' gradients, their reverse cumsum over the chunk and dA's
//      share are warp scans and fixed-order sums.
//   4. da_sum_kernel: dA summed over batch rows and chunks.
// B and C are one group shared by every head, so their gradients are sums
// over the heads; every sum runs in a fixed order and no launch uses
// atomics, so the result is deterministic.  TMA reads x, B and C in place:
// their rows must start on 16 bytes (the wrapper copies them otherwise);
// the head dim P is 32 or 64 and N a multiple of 32 (the wrapper pads).
#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"
#include "ssd.cuh"

namespace {

using namespace repro;
using namespace repro::ssd;

constexpr int kMaxP = 64;        // head dim the kernels stage whole
constexpr int kSN = 64;          // state columns a state_bwd block carries
constexpr int kSub = 64;         // steps a state_bwd ring stage holds
constexpr int kKB = 32;          // state columns a chunk_bwd ring stage holds
constexpr int kRT = 32;          // rows of dB and dC a dbc_heads block owns
constexpr int kLdH = kMaxL + 4;  // its d(C·Bᵀ) rows, read as (row, j)
constexpr int kLdV = kRT + 8;    // its d(C·Bᵀ) columns, read as (i, column)

__device__ __forceinline__ float clip_grad(float t, float e) {
  return t >= -60.f && t <= 0.f ? e : 0.f;  // d clip_exp(t) / dt, e = clip_exp(t)
}

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }

// acc[r][q] (q < nq) += Σ_k a(16 r + m, k) b(k, 8q + n) over k in [k0, k1), 8
// at a time, on the tensor cores in 3xTF32 (mma_3xtf32's order): R row
// tiles of 16 share each B fragment, B fragments G tiles at a time.  The k
// of each 8-step is permuted, the tensor core's k = t4 and t4 + 4 taking k =
// 2 t4 and 2 t4 + 1 of A and of B alike (the sum does not depend on the
// order), so the loaders return pairs: a(m, k) = {A(m, k), A(m, k + 1)} and
// b(k, n) = {B(k, n), B(k + 1, n)} for even k, one 8-byte load where the
// pair is contiguous in shared memory.  Unrolled twice: more spilled and ran
// slower on the card.
template <int R, int Q, int G = Q, typename Af, typename Bf>
__device__ __forceinline__ void gemm_3xtf32(float (&acc)[R][Q][4], int nq, int k0, int k1, Af a,
                                            Bf b, int lane) {
  static_assert(Q % G == 0, "whole groups of B tiles");
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll 2
  for (int kk = k0; kk < k1; kk += 8) {
    FragA3 fa[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 u = a(16 * r + g, kk + t2), v = a(16 * r + g + 8, kk + t2);
      split_tf32(u.x, fa[r].hi[0], fa[r].lo[0]);
      split_tf32(v.x, fa[r].hi[1], fa[r].lo[1]);
      split_tf32(u.y, fa[r].hi[2], fa[r].lo[2]);
      split_tf32(v.y, fa[r].hi[3], fa[r].lo[3]);
    }
#pragma unroll
    for (int q0 = 0; q0 < Q; q0 += G) {
      if (q0 >= nq) break;
      FragB3 fb[G];
#pragma unroll
      for (int q = 0; q < G; ++q)
        if (q0 + q < nq) {
          const float2 w = b(kk + t2, 8 * (q0 + q) + g);
          split_tf32(w.x, fb[q].hi[0], fb[q].lo[0]);
          split_tf32(w.y, fb[q].hi[1], fb[q].lo[1]);
        }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < G; ++q)
          if (q0 + q < nq) mma_tf32(acc[r][q0 + q], fa[r].lo, fb[q].hi[0], fb[q].hi[1]);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < G; ++q)
          if (q0 + q < nq) mma_tf32(acc[r][q0 + q], fa[r].hi, fb[q].lo[0], fb[q].lo[1]);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < G; ++q)
          if (q0 + q < nq) mma_tf32(acc[r][q0 + q], fa[r].hi, fb[q].hi[0], fb[q].hi[1]);
    }
  }
}

template <int R, int Q>
__device__ __forceinline__ void zero(float (&acc)[R][Q][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[r][q][0] = acc[r][q][1] = acc[r][q][2] = acc[r][q][3] = 0.f;
}

// -- 1. the reverse state pass ------------------------------------------------

constexpr int kSubBox = kSub * 32;     // floats of a staged box of 32 columns x kSub steps (8 KB)
constexpr int kSbStage = 4 * kSubBox;  // a stage: dy (two boxes of p), then C (two of n)
constexpr int kSbRing = 3;

inline size_t state_bwd_smem_bytes() {
  return 1024 + sizeof(float) * (kSbRing * kSbStage + 3 * kMaxL + 2 * kWarps) +
         kSbRing * sizeof(uint64_t);
}

// One block per (64 state columns, head, batch row), last chunk first; two
// blocks an SM.  Warp w holds G's P rows 16 (w % 4).. and columns 32 (w /
// 4).. of the block's in the product's accumulator layout.  A ring stage is
// kSub steps of a chunk: dy (P / 32 boxes) and C (the block's columns, two
// boxes), by TMA; a chunk of L steps takes ceil(L / kSub) of them.
template <int P>
__global__ void __launch_bounds__(kThreads, 2)
state_bwd_kernel(const __grid_constant__ CUtensorMap dymap,
                 const __grid_constant__ CUtensorMap cmap, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ states,
                 const float* __restrict__ decay, const float* __restrict__ dfinal,
                 float* __restrict__ dstates, float* __restrict__ dpart, int S, int H, int N,
                 int L, int rows, int64_t dt_sb, int64_t dt_ss) {
  extern __shared__ unsigned char smem_sb[];
  float* ring = reinterpret_cast<float*>(smem_1k(smem_sb));  // [kSbRing][kSbStage]
  float* cs = ring + kSbRing * kSbStage;                     // [kMaxL] inclusive cumsum of dt·A
  float* wt = cs + kMaxL;                                    // [kMaxL] clip_exp(cs_i), 0 past L
  float* dts = wt + kMaxL;                                   // [kMaxL]
  float* wsum = dts + kMaxL;                                 // [kWarps]
  float* red = wsum + kWarps;                                // [kWarps]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + kWarps);  // [kSbRing] the stages' barriers
  const int nt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, ntiles = gridDim.x;
  const int nc = S / L, tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = nt * kSN, nw = min(kSN, N - n0), npb = P / 32, ncb = nw / 32;
  const int nsub = (L + kSub - 1) / kSub, total = nc * nsub;
  const int pr = 16 * (w % 4), cq = 32 * (w / 4);
  const int nq = pr < P && cq < nw ? 4 : 0;
  const float* dtb = dt + b * dt_sb + h;

  auto issue = [&](int q) {  // stage q: chunk nc - 1 - q / nsub, steps kSub (q % nsub)..; thread 0
    const int step = (nc - 1 - q / nsub) * L + kSub * (q % nsub), s = q % kSbRing;
    float* st = ring + s * kSbStage;
    mbar_expect_tx(&full[s], static_cast<uint32_t>((npb + ncb) * rows * 128));
    for (int u = 0; u < npb; ++u) tma_load_4d(st + u * kSubBox, &dymap, &full[s], 32 * u, h, step, b);
    for (int u = 0; u < ncb; ++u)
      tma_load_4d(st + (2 + u) * kSubBox, &cmap, &full[s], n0 + 32 * u, step, b, 0);
  };
  if (tid == 0) {
    prefetch_map(&dymap);
    prefetch_map(&cmap);
    for (int s = 0; s < kSbRing; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
    for (int q = 0; q < kSbRing && q < total; ++q) issue(q);
  }

  // G's element (q, e): p = pr + g + 8 (e / 2), n = n0 + cq + 8 q + 2 t4 + e % 2
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  float gst[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = pr + g + 8 * (e >> 1), n = n0 + cq + 8 * q + 2 * t4 + (e & 1);
      gst[q][e] = dfinal != nullptr && nq > 0 ? dfinal[(bh * P + p) * N + n] : 0.f;
    }
  float dtn = tid < L ? dtb[(static_cast<int64_t>(nc - 1) * L + tid) * dt_ss] : 0.f;
  float decn = decay[(static_cast<int64_t>(b) * nc + nc - 1) * H + h];  // the next chunk's cs_L
  __syncthreads();  // the barriers are initialised

  for (int k = 0; k < nc; ++k) {
    const int c = nc - 1 - k;
    const int64_t bch = (static_cast<int64_t>(b) * nc + c) * H + h;
    const float* ent = states + bch * P * N;
    float* own = dstates + bch * P * N;
    float en[4][4];  // the entering state at G's elements, in flight while cs forms
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 v = nq > 0 ? ld2(ent + static_cast<int64_t>(pr + g + 8 * r) * N + n0 + cq +
                                      8 * q + 2 * t4)
                                : make_float2(0.f, 0.f);
        en[q][2 * r] = v.x;
        en[q][2 * r + 1] = v.y;
      }
    cumsum_steps(dtn, A[h], L, cs, dts, wsum);
    if (c > 0 && tid < L) dtn = dtb[(static_cast<int64_t>(c - 1) * L + tid) * dt_ss];
    if (tid < kMaxL) wt[tid] = tid < L ? clip_exp(cs[tid]) : 0.f;

    // G is the chunk's own state's gradient; Σ G ⊙ entering its decay's
    float part = 0.f;
    if (nq > 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          part += gst[q][2 * r] * en[q][2 * r] + gst[q][2 * r + 1] * en[q][2 * r + 1];
          *reinterpret_cast<float2*>(own + static_cast<int64_t>(pr + g + 8 * r) * N + n0 + cq +
                                     8 * q + 2 * t4) = make_float2(gst[q][2 * r], gst[q][2 * r + 1]);
        }
    }
    part = warp_sum(part);
    if (lane == 0) red[w] = part;
    __syncthreads();  // wt and red in place
    if (tid == 0) {
      float sum = 0.f;
      for (int v = 0; v < kWarps; ++v) sum += red[v];
      dpart[bch * ntiles + nt] = sum;
    }
    const float dec = clip_exp(decn);
    if (c > 0) decn = decay[bch - H];

    // the chunk's entering-state gradient from its own y, (P x L)·(L x 64),
    // kSub steps a stage; steps past L (the next chunk's, or not loaded)
    // are masked
    float acc[1][4][4];
    zero(acc);
    for (int u = 0; u < nsub; ++u) {
      const int q = k * nsub + u, s = q % kSbRing, j0 = kSub * u, jn = min(kSub, L - j0);
      mbar_wait(&full[s], (q / kSbRing) & 1);
      const float* st = ring + s * kSbStage;
      // A = (clip_exp(cs) ⊙ dy)ᵀ and B = C, both read down the steps
      auto a = [&](int r, int j, bool in0, bool in1) {
        const int p = pr + r;
        const float* y = st + (p >> 5) * kSubBox;
        return make_float2(in0 ? y[sw128(j, p & 31)] * wt[j0 + j] : 0.f,
                           in1 ? y[sw128(j + 1, p & 31)] * wt[j0 + j + 1] : 0.f);
      };
      auto bm = [&](int j, int n, bool in0, bool in1) {
        const int m = cq + n;
        const float* cc = st + (2 + (m >> 5)) * kSubBox;
        return make_float2(in0 ? cc[sw128(j, m & 31)] : 0.f, in1 ? cc[sw128(j + 1, m & 31)] : 0.f);
      };
      if (nq > 0 && jn == kSub)  // a whole stage: no step masked, the loop unrolled
        gemm_3xtf32(acc, nq, 0, kSub, [&](int r, int j) { return a(r, j, true, true); },
                    [&](int j, int n) { return bm(j, n, true, true); }, lane);
      else if (nq > 0)
        gemm_3xtf32(acc, nq, 0, jn, [&](int r, int j) { return a(r, j, j < jn, j + 1 < jn); },
                    [&](int j, int n) { return bm(j, n, j < jn, j + 1 < jn); }, lane);
      __syncthreads();  // every warp is done with stage s (and, last, with cs, wt and red)
      if (tid == 0 && q + kSbRing < total) issue(q + kSbRing);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) gst[q][e] = acc[0][q][e] + gst[q][e] * dec;
  }
}

// -- 2. the per-(chunk, head) pass ---------------------------------------------

constexpr int kBox = kMaxL * 32;  // floats of a staged box of 32 columns x kMaxL steps (16 KB)
constexpr int kTri = kMaxL / 16 * (kMaxL / 16 + 1) / 2;  // 16 x 16 blocks on and below the diagonal
constexpr int kColParts = 8 * kWarps * (kWarps + 1);    // warp w's column sums: 16 (w + 1) at 8 w (w + 1)
// a ring stage: B (kMaxL rows) and dOwn (kMaxP rows), 32 columns each
constexpr int kStage = (kMaxL + kMaxP) * kKB;
static_assert(kStage <= 2 * kBox && kStage <= kTri * 256, "a stage fits where x or W was");

// W_ij's place in the packed lower triangle: the 16 x 16 block (i / 16,
// j / 16) in row order, stored transposed (row j % 16) and swizzled so that
// the dW pass's reads (lanes along i, 2 t4 along j) hit 32 different banks
// and the dx pass's A pairs (lanes along j, 2 t4 along i, 8 bytes each)
// two ways at most; i and i + 1 (even i) stay side by side.
__device__ __forceinline__ int wm_at(int i, int j) {
  const int I = i >> 4, ii = i & 15, jj = j & 15;
  return (I * (I + 1) / 2 + (j >> 4)) * 256 + (((jj << 4) ^ ((jj & 2) << 3)) |
                                               (ii ^ ((jj & 4) << 1) ^ ((jj & 1) << 2)));
}

inline size_t chunk_bwd_smem_bytes() {
  return 1024 + sizeof(float) * (4 * kBox + kTri * 256 + 4 * kMaxL + 2 * kColParts + kWarps) +
         3 * sizeof(uint64_t);
}

// One chunk of one head: dx, ddt and the chunk's dA share.  Warp w owns
// steps 16w..16w+15.  x and dy arrive as two boxes each (32 columns, Lb
// rows); a ring stage is B and dOwn in 32 state columns.  Each step's
// C_i·(dy_i·entering) is dbc_heads_kernel's, left in ddt.
template <int P>
__global__ void __launch_bounds__(kThreads, 2)
chunk_bwd_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap dymap,
                 const __grid_constant__ CUtensorMap bmap,
                 const __grid_constant__ CUtensorMap omap, const float* __restrict__ x,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 const float* __restrict__ cb, const float* __restrict__ dpart, int ntiles,
                 float* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ da_part,
                 int S, int H, int N, int L, int rows, int64_t x_sb, int64_t x_ss,
                 int64_t x_sh, int64_t dt_sb, int64_t dt_ss) {
  extern __shared__ unsigned char smem_cbw[];
  float* xs = reinterpret_cast<float*>(smem_1k(smem_cbw));  // [2 boxes] x, then stage 0
  float* dys = xs + 2 * kBox;                               // [2 boxes] dy
  float* wm = dys + 2 * kBox;                               // [kTri][256] C·Bᵀ ⊙ E, then stage 1
  float* cs = wm + kTri * 256;                              // [kMaxL] inclusive cumsum of dt·A
  float* dts = cs + kMaxL;                                  // [kMaxL]
  float* row_r = dts + kMaxL;                               // [kMaxL] Σ_j R_ij
  float* dwv = row_r + kMaxL;                               // [kMaxL] x_j·V_j
  float* col_r = dwv + kMaxL;                               // [kColParts] column sums of R
  float* col_t = col_r + kColParts;                         // [kColParts] column sums of dW·CB·E
  float* wsum = col_t + kColParts;                          // [kWarps]
  uint64_t* bar = reinterpret_cast<uint64_t*>(wsum + kWarps);  // [3] x and dy; stages 0, 1

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int Lb = (L + 15) / 16 * 16, nq = P / 8, npb = P / 32;
  const int nstages = (N + kKB - 1) / kKB;
  const int t0 = c * L;
  const int64_t bch = (static_cast<int64_t>(b) * nc + c) * H + h;
  const float* xg = x + b * x_sb + static_cast<int64_t>(t0) * x_ss + h * x_sh;
  const float* cbc = cb + (static_cast<int64_t>(b) * nc + c) * L * L;
  // x and dy at (step, p), and pairs of them at (step, p), (step, p + 1)
  auto DY = [&](int i, int p) { return dys[(p >> 5) * kBox + sw128(i, p & 31)]; };
  auto X2 = [&](int j, int p) { return ld2(xs + (p >> 5) * kBox + sw128(j, p & 31)); };
  auto DY2 = [&](int i, int p) { return ld2(dys + (p >> 5) * kBox + sw128(i, p & 31)); };

  // ring stage s (state columns 32 s..) into st on sb: thread 0
  auto issue = [&](int s, float* st, uint64_t* sb) {
    const int n0 = s * kKB, row = static_cast<int>(bch);
    mbar_expect_tx(sb, static_cast<uint32_t>((rows + P) * kKB * 4));
    tma_load_4d(st, &bmap, sb, n0, t0, b, 0);
    tma_load_4d(st + kMaxL * kKB, &omap, sb, n0, 0, row, 0);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    fence_barrier_init();
    mbar_expect_tx(&bar[0], static_cast<uint32_t>(2 * npb * rows * 128));  // x and dy
    for (int q = 0; q < npb; ++q) {
      tma_load_4d(xs + q * kBox, &xmap, &bar[0], 32 * q, h, t0, b);
      tma_load_4d(dys + q * kBox, &dymap, &bar[0], 32 * q, h, t0, b);
    }
  }
  for (int i = tid; i < 4 * kMaxL; i += kThreads) cs[i] = 0.f;  // cs .. dwv
  for (int i = tid; i < 2 * kColParts; i += kThreads) col_r[i] = 0.f;
  __syncthreads();  // zeroed before the cumsum writes the chunk's steps
  chunk_cumsum(dt + b * dt_sb + static_cast<int64_t>(t0) * dt_ss + h, dt_ss, A[h], L, cs, dts,
               wsum);
  // W without dt, each element once: C·Bᵀ ⊙ clip_exp(cs_i - cs_j) for j <= i;
  // warp w rows w, w + 8, ..., four rows' C·Bᵀ loads in flight at a time
  for (int ib = w; ib < Lb; ib += 4 * kWarps) {
    float v[4][kMaxL / 32];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int m = 0; m < kMaxL / 32; ++m) {
        const int i = ib + kWarps * u, j = lane + 32 * m;
        v[u][m] = j <= i && i < L ? cbc[i * L + j] : 0.f;
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int m = 0; m < kMaxL / 32; ++m) {
        const int i = ib + kWarps * u, j = lane + 32 * m;
        if (i < Lb && (j >> 4) <= (i >> 4))
          wm[wm_at(i, j)] = v[u][m] != 0.f ? v[u][m] * clip_exp(cs[i] - cs[j]) : 0.f;
      }
  }
  mbar_wait(&bar[0], 0);
  __syncthreads();  // x, dy, W and the zeroed sums are in place
  const float cs_l = cs[L - 1];
  const int i0 = 16 * w;
  const bool active = i0 < L;

  // dW = dy·xᵀ over the warp's rows i and the columns j up to its diagonal,
  // in two passes of 8 column tiles; each element's R_ij = dW W_ij dt_j
  // (where the exponent is unclipped) and T_ij = dW W_ij summed by row and
  // by column.  Steps past L (the next chunk's, or zeros) are masked.
  if (active) {
    float rsum[2] = {0.f, 0.f};
    const int nt = min(2 * (w + 1), (L + 7) / 8);
    float* colr = col_r + 8 * w * (w + 1);
    float* colt = col_t + 8 * w * (w + 1);
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int q0 = 8 * pass;
      float acc[1][8][4];
      zero(acc);
      if (q0 < nt)
        gemm_3xtf32<1, 8, 4>(acc, min(8, nt - q0), 0, P, [&](int r, int k) { return DY2(i0 + r, k); },
                          [&](int k, int n) { return X2(8 * q0 + n, k); }, lane);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float cr[2] = {0.f, 0.f}, ctt[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + g + 8 * (e >> 1), j = 8 * (q0 + q) + 2 * t4 + (e & 1);
          if (q0 + q < nt && j <= i && i < L) {
            const float seg = cs[i] - cs[j], tt = acc[0][q][e] * wm[wm_at(i, j)];
            const float r = seg >= -60.f && seg <= 0.f ? tt * dts[j] : 0.f;
            rsum[e >> 1] += r;
            cr[e & 1] += r;
            ctt[e & 1] += tt;
          }
        }
        // column sums over the warp's 16 rows: the 8 lanes of one t4
#pragma unroll
        for (int par = 0; par < 2; ++par) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            cr[par] += __shfl_xor_sync(kFullMask, cr[par], o);
            ctt[par] += __shfl_xor_sync(kFullMask, ctt[par], o);
          }
          const int j = 8 * (q0 + q) + 2 * t4 + par;
          if (g == 0 && q0 + q < nt && j < L) {
            colr[j] = cr[par];
            colt[j] = ctt[par];
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] = quad_sum(rsum[r]);
      if (t4 == 0 && i0 + g + 8 * r < L) row_r[i0 + g + 8 * r] = rsum[r];
    }
  }
  // dx = Wᵀ·dy over i >= j (rows j of the warp), W_ij = wm_ij dt_j; steps
  // past L (the next chunk's, or not loaded) are masked
  float dxa[1][kMaxP / 8][4];
  zero(dxa);
  if (active)
    gemm_3xtf32<1, kMaxP / 8, 4>(
        dxa, nq, i0, L,
        [&](int r, int k) {
          const float2 v = ld2(wm + wm_at(k, i0 + r));  // W_k,j and W_k+1,j: k even, side by side
          return make_float2(v.x * dts[i0 + r], v.y * dts[i0 + r]);
        },
        [&](int k, int n) {
          return make_float2(k < L ? DY(k, n) : 0.f, k + 1 < L ? DY(k + 1, n) : 0.f);
        }, lane);
  fence_proxy_async();
  __syncthreads();  // x and W are read: their space takes the ring's two stages
  if (tid == 0) {
    issue(0, xs, &bar[1]);
    if (nstages > 1) issue(1, wm, &bar[2]);
  }

  // V = B·dOwnᵀ (L x P), 32 state columns a stage
  float va[1][kMaxP / 8][4];
  zero(va);
  for (int s = 0; s < nstages; ++s) {
    float* st = (s & 1) ? wm : xs;
    mbar_wait(&bar[1 + (s & 1)], (s >> 1) & 1);
    const float* bt = st;                  // [kMaxL][32] B
    const float* ot = bt + kMaxL * kKB;    // [kMaxP][32] dOwn
    if (active)
      gemm_3xtf32<1, kMaxP / 8, 4>(va, nq, 0, kKB, [&](int r, int k) { return ld2(bt + sw128(i0 + r, k)); },
                                [&](int k, int n) { return ld2(ot + sw128(n, k)); }, lane);
    fence_proxy_async();
    __syncthreads();  // every warp is done with the stage before it is refilled
    if (tid == 0 && s + 2 < nstages) issue(s + 2, st, &bar[1 + (s & 1)]);
  }

  if (active) {
    // dw_j = x_j·V_j (x from device memory: its space holds the ring now);
    // dx = Wᵀ·dy + w_j V_j
    float dwp[2] = {0.f, 0.f};
#pragma unroll
    for (int q = 0; q < kMaxP / 8; ++q) {
      if (q >= nq) break;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = i0 + g + 8 * r;
        if (j >= L) continue;
        const float2 xv = *reinterpret_cast<const float2*>(xg + j * x_ss + 8 * q + 2 * t4);
        dwp[r] += xv.x * va[0][q][2 * r] + xv.y * va[0][q][2 * r + 1];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dwp[r] = quad_sum(dwp[r]);
      const int j = i0 + g + 8 * r;
      if (j >= L) continue;
      if (t4 == 0) dwv[j] = dwp[r];
      const float wj = clip_exp(cs_l - cs[j]) * dts[j];
      float* out = dx + ((static_cast<int64_t>(b) * S + t0 + j) * H + h) * P;
#pragma unroll
      for (int q = 0; q < kMaxP / 8; ++q) {
        if (q >= nq) break;
        *reinterpret_cast<float2*>(out + 8 * q + 2 * t4) =
            make_float2(dxa[0][q][2 * r] + wj * va[0][q][2 * r],
                        dxa[0][q][2 * r + 1] + wj * va[0][q][2 * r + 1]);
      }
    }
  }
  __syncthreads();  // every row's sums are in place

  // each step's exponent gradient (dcs) and dt's direct terms, a thread a step
  float dcs = 0.f, r_end = 0.f, direct = 0.f;
  float* ddt_i = ddt + (static_cast<int64_t>(b) * S + t0 + tid) * H + h;
  if (tid < L) {
    const int i = tid;
    const float inter = *ddt_i;  // C_i·(dy_i·entering), from dbc_heads_kernel
    float cr = 0.f, ctt = 0.f;
    for (int v = i >> 4; v < kWarps; ++v) {
      cr += col_r[8 * v * (v + 1) + i];
      ctt += col_t[8 * v * (v + 1) + i];
    }
    const float e_cs = clip_exp(cs[i]), to_end = cs_l - cs[i], e_end = clip_exp(to_end);
    r_end = clip_grad(to_end, e_end) * dts[i] * dwv[i];
    dcs = row_r[i] - cr + clip_grad(cs[i], e_cs) * inter - r_end;
    direct = ctt + e_end * dwv[i];
  }
  // cs_L's terms on the last step: Σ r_end (warp sums, then the warps' in
  // order) and the decay's gradient (the state pass's block sums, in order)
  float sum = warp_sum(r_end);
  if (lane == 0) wsum[w] = sum;
  __syncthreads();
  if (tid == L - 1) {
    float sum_end = 0.f, dec = 0.f;
    for (int v = 0; v < kWarps; ++v) sum_end += wsum[v];
    for (int k = 0; k < ntiles; ++k) dec += dpart[bch * ntiles + k];
    dcs += sum_end + clip_grad(cs_l, clip_exp(cs_l)) * dec;
  }
  // the reverse cumsum over the steps: warp suffix scans, then the totals of
  // the warps after
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_down_sync(kFullMask, dcs, o);
    if (lane + o < 32) dcs += u;
  }
  __syncthreads();  // wsum is read
  if (lane == 0) wsum[w] = dcs;
  __syncthreads();
  for (int v = w + 1; v < kWarps; ++v) dcs += wsum[v];
  if (tid < L) *ddt_i = direct + A[h] * dcs;
  sum = warp_sum(tid < L ? dts[tid] * dcs : 0.f);  // the chunk's dA share
  __syncthreads();  // wsum is read
  if (lane == 0) wsum[w] = sum;
  __syncthreads();
  if (tid == 0) {
    float da = 0.f;
    for (int v = 0; v < kWarps; ++v) da += wsum[v];
    da_part[bch] = da;
  }
}

// -- 3. dB and dC, the heads summed on chip ---------------------------------------

constexpr int kDbcThreads = 384;  // 12 warps: 4 on d(C·Bᵀ), 4 on dC's state term, 4 on dB's
constexpr int kSq = 32 * 32;      // floats of a staged box of 32 x 32
constexpr int kXY = 5 * 2 * kSq;  // x rows [0, xr) and dy rows [r0, L): at most 5 row boxes
constexpr int kHV = (kRT * kLdH + kMaxL * kLdV + 255) / 256 * 256;  // d(C·Bᵀ) rows and columns, 1 KB-aligned

// A ring stage: x and dy (32-row boxes, two column boxes each), then the
// entering state and dOwn (P rows, N / 32 column boxes each).
inline int dbc_slot_floats(int P, int N) { return kXY + 2 * (N / 32) * P * 32; }
// After the heads: the block's d(C·Bᵀ), then B rows [0, xr) and C rows [r0,
// L) in 32 x 32 boxes.
inline int dbc_final_floats(int N) { return kHV + 5 * (N / 32) * kSq; }
inline size_t dbc_smem_bytes(int ring_floats) {
  return 1024 + sizeof(float) * (ring_floats + 4 * kMaxL + kDbcThreads / 32 + 4 * kRT) +
         3 * sizeof(uint64_t);
}

// One block per (32 rows r0.., chunk, batch row), the heads in order.  Each
// warp holds one 32-row piece (two row tiles of 16 sharing every B
// fragment): warp u < 4 the piece u of the block's cross of d(C·Bᵀ) (32 x
// 32: its rows left of and on the diagonal, then its columns below it, L /
// 32 pieces), warp 4 + u the dC state term of the block's rows in state
// columns 8 kQ u.., warp 8 + u the dB state term there.  The dC warps also
// leave each step's C_i·(dy_i·entering), per head, in ddt for
// chunk_bwd_kernel.
template <int P, int kQ>
__global__ void __launch_bounds__(kDbcThreads, 1)
dbc_heads_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap dymap,
                 const __grid_constant__ CUtensorMap emap,
                 const __grid_constant__ CUtensorMap omap,
                 const __grid_constant__ CUtensorMap bmap,
                 const __grid_constant__ CUtensorMap cmap, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Cm,
                 float* __restrict__ dB, float* __restrict__ dC, float* __restrict__ ddt, int S,
                 int H, int N, int L, int rows, int slot, int ring, int ring_floats,
                 int64_t dt_sb, int64_t dt_ss, int64_t c_sb, int64_t c_ss) {
  extern __shared__ unsigned char smem_dbc[];
  float* ring_base = reinterpret_cast<float*>(smem_1k(smem_dbc));  // [ring][slot], then the final tiles
  float* cs = ring_base + ring_floats;  // [kMaxL] the head's cumsum of dt·A
  float* dts = cs + kMaxL;              // [kMaxL]
  float* ew = dts + kMaxL;              // [kMaxL] clip_exp(cs_i), 0 past L
  float* ww = ew + kMaxL;               // [kMaxL] clip_exp(cs_L - cs_i) dt_i, 0 past L
  float* wsum = ww + kMaxL;             // [12] the cumsum's warp totals
  float* ipart = wsum + kDbcThreads / 32;  // [4][kRT] the dC warps' C·Z row sums
  uint64_t* bar = reinterpret_cast<uint64_t*>(ipart + 4 * kRT);  // [3] stages 0, 1; B and C
  const int rt = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32, role = w / 4, u = w % 4;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = kRT * rt, xr = min(r0 + kRT, L), dr = L - r0;
  const int nbx = (xr + 31) / 32, nbd = (dr + 31) / 32, npb = P / 32, nN = N / 32;
  const int t0 = c * L;

  // a cross warp's piece: rows ra.., columns ca..
  int ra = r0, ca = 32 * u;                     // the block's rows, left of the diagonal
  if (u >= nbx) ra = r0 + 32 * (u - nbx + 1), ca = r0;  // its columns, below its rows
  const int nqx = role == 0 && ra < L ? min(4, (xr - ca + 7) / 8) : 0;
  // a state warp's columns: 8-column tiles from cb0
  const int cb0 = 8 * kQ * u;
  const int nqs = role > 0 ? max(0, min(kQ, N / 8 - kQ * u)) : 0;
  const int nact = min(4, (N / 8 + kQ - 1) / kQ);  // state warps with columns
  const float* cg = Cm + b * c_sb + static_cast<int64_t>(t0 + r0) * c_ss;  // C of the block's rows

  // x row j, dy row i (>= r0) of a stage at (row, p), as pairs (p, p + 1);
  // the entering state and dOwn at (p, n)
  auto X2 = [&](const float* st, int j, int p) {
    return ld2(st + ((j >> 5) * 2 + (p >> 5)) * kSq + sw128(j & 31, p & 31));
  };
  auto DY2 = [&](const float* st, int i, int p) {
    return ld2(st + ((nbx + ((i - r0) >> 5)) * 2 + (p >> 5)) * kSq + sw128((i - r0) & 31, p & 31));
  };
  auto ES = [&](const float* es, int p, int n) { return es[(n >> 5) * P * 32 + sw128(p, n & 31)]; };

  auto issue = [&](int h, int s) {  // head h into stage s: thread 0
    float* st = ring_base + s * slot;
    float* es = st + kXY;
    float* os = es + nN * P * 32;
    const int row = (b * nc + c) * H + h;
    mbar_expect_tx(&bar[s], static_cast<uint32_t>(((nbx + nbd) * npb * rows + 2 * nN * P) * 128));
    for (int k = 0; k < nbx; ++k)
      for (int q = 0; q < npb; ++q)
        tma_load_4d(st + (k * 2 + q) * kSq, &xmap, &bar[s], 32 * q, h, t0 + 32 * k, b);
    for (int k = 0; k < nbd; ++k)
      for (int q = 0; q < npb; ++q)
        tma_load_4d(st + ((nbx + k) * 2 + q) * kSq, &dymap, &bar[s], 32 * q, h, t0 + r0 + 32 * k, b);
    for (int q = 0; q < nN; ++q) {
      tma_load_4d(es + q * P * 32, &emap, &bar[s], 32 * q, 0, row, 0);
      tma_load_4d(os + q * P * 32, &omap, &bar[s], 32 * q, 0, row, 0);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    fence_barrier_init();
    for (int s = 0; s < ring && s < H; ++s) issue(s, s);
  }

  // the cross warps' d(C·Bᵀ); the state warps' dC or dB term
  float acc[2][kQ][4];
  zero(acc);
  const float* dtb = dt + b * dt_sb + static_cast<int64_t>(t0) * dt_ss;
  float dtn = tid < L ? dtb[tid * dt_ss] : 0.f, an = A[0];  // the next head's dt and A
  __syncthreads();  // the barriers are initialised
  for (int h = 0; h < H; ++h) {
    const int s = h % ring;
    cumsum_steps(dtn, an, L, cs, dts, wsum);
    if (h + 1 < H) {
      an = A[h + 1];
      if (tid < L) dtn = dtb[tid * dt_ss + h + 1];
    }
    if (tid < kMaxL) {
      const bool in = tid < L;
      ew[tid] = in ? clip_exp(cs[tid]) : 0.f;
      ww[tid] = in ? clip_exp(cs[L - 1] - cs[tid]) * dts[tid] : 0.f;
    }
    mbar_wait(&bar[s], (h / ring) & 1);
    __syncthreads();  // ew and ww in place
    const float* st = ring_base + s * slot;
    const float* es = st + kXY;
    const float* os = es + nN * P * 32;
    if (nqx > 0) {  // d(C·Bᵀ) += (dy_h x_hᵀ) ⊙ E_h ⊙ dt_h on and below the diagonal
      float sa[2][4][4];
      zero(sa);
      gemm_3xtf32(sa, nqx, 0, P, [&](int r, int k) { return DY2(st, ra + r, k); },
                  [&](int k, int n) { return X2(st, ca + n, k); }, lane);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = ra + 16 * m + g + 8 * (e >> 1), j = ca + 8 * q + 2 * t4 + (e & 1);
            if (q < nqx && j <= i && i < L)
              acc[m][q][e] += sa[m][q][e] * clip_exp(cs[i] - cs[j]) * dts[j];
          }
    } else if (nqs > 0 && role == 1) {
      // Z = dy_h·entering_h (32 rows x 32 columns at a time, over p): dC's
      // state term gathers clip_exp(cs_i) Z_i, and C_i·Z_i is the row's share
      float ip[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int q0 = 0; q0 < kQ; q0 += 4) {
        if (q0 >= nqs) break;
        float z[2][4][4];
        zero(z);
        gemm_3xtf32(z, min(4, nqs - q0), 0, P, [&](int r, int k) { return DY2(st, r0 + r, k); },
                    [&](int k, int n) {
                      return make_float2(ES(es, k, cb0 + 8 * q0 + n), ES(es, k + 1, cb0 + 8 * q0 + n));
                    }, lane);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q0 + q >= nqs) break;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int i = r0 + 16 * m + g + 8 * hh, n = cb0 + 8 * (q0 + q) + 2 * t4;
              acc[m][q0 + q][2 * hh] += ew[i] * z[m][q][2 * hh];
              acc[m][q0 + q][2 * hh + 1] += ew[i] * z[m][q][2 * hh + 1];
              if (i < L) {
                const float2 cv = ld2(cg + static_cast<int64_t>(i - r0) * c_ss + n);
                ip[m][hh] += cv.x * z[m][q][2 * hh] + cv.y * z[m][q][2 * hh + 1];
              }
            }
          }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float v = quad_sum(ip[m][hh]);
          if (t4 == 0) ipart[u * kRT + 16 * m + 8 * hh + g] = v;
        }
    } else if (nqs > 0) {  // dB's state term
      gemm_3xtf32<2, kQ, 4>(
          acc, nqs, 0, P,
          [&](int r, int k) {
            const float2 y = X2(st, r0 + r, k);
            return make_float2(y.x * ww[r0 + r], y.y * ww[r0 + r]);
          },
          [&](int k, int n) { return make_float2(ES(os, k, cb0 + n), ES(os, k + 1, cb0 + n)); },
          lane);
    }
    __syncthreads();  // every warp is done with stage s, the head's weights and C·Z shares
    if (tid == 0 && h + ring < H) issue(h + ring, s);
    if (w == 4 && r0 + lane < L) {  // each row's C_i·Z_i of head h: the warps' shares in order
      float v = 0.f;
      for (int k = 0; k < nact; ++k) v += ipart[k * kRT + lane];
      ddt[(static_cast<int64_t>(b) * S + t0 + r0 + lane) * H + h] = v;
    }
  }

  // dC += d(C·Bᵀ)·B over j <= i, dB += d(C·Bᵀ)ᵀ·C over i >= j
  float* hb = ring_base;          // [kRT][kLdH] the block's rows, columns j < xr
  float* vb = hb + kRT * kLdH;    // [kMaxL][kLdV] its columns, row i at i - r0
  float* bct = ring_base + kHV;   // B rows [0, xr), then C rows [r0, L): 32 x 32 boxes
  if (tid == 0) {
    mbar_expect_tx(&bar[2], static_cast<uint32_t>((nbx + nbd) * nN * rows * 128));
    for (int q = 0; q < nN; ++q) {
      for (int k = 0; k < nbx; ++k)
        tma_load_4d(bct + (k * nN + q) * kSq, &bmap, &bar[2], 32 * q, t0 + 32 * k, b, 0);
      for (int k = 0; k < nbd; ++k)
        tma_load_4d(bct + ((nbx + k) * nN + q) * kSq, &cmap, &bar[2], 32 * q, t0 + r0 + 32 * k,
                    b, 0);
    }
  }
  if (nqx > 0) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q >= nqx) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = ra + 16 * m + g + 8 * (e >> 1), j = ca + 8 * q + 2 * t4 + (e & 1);
          if (ra == r0) hb[(i - r0) * kLdH + j] = acc[m][q][e];
          if (j >= r0 && i - r0 < kMaxL) vb[(i - r0) * kLdV + j - r0] = acc[m][q][e];
        }
      }
  }
  __syncthreads();  // the block's d(C·Bᵀ) is in place
  mbar_wait(&bar[2], 0);
  if (nqs == 0) return;
  auto BC = [&](int box, int r, int n) {
    return bct[(box * nN + (n >> 5)) * kSq + sw128(r & 31, n & 31)];
  };
  if (role == 1)
    gemm_3xtf32<2, kQ, 4>(
        acc, nqs, 0, xr,
        [&](int r, int k) {
          const float* row = hb + r * kLdH;
          return make_float2(k < xr ? row[k] : 0.f, k + 1 < xr ? row[k + 1] : 0.f);
        },
        [&](int k, int n) {
          return make_float2(k < xr ? BC(k >> 5, k, cb0 + n) : 0.f,
                             k + 1 < xr ? BC((k + 1) >> 5, k + 1, cb0 + n) : 0.f);
        }, lane);
  else
    gemm_3xtf32<2, kQ, 4>(
        acc, nqs, 0, dr,
        [&](int r, int k) {
          return make_float2(k < dr ? vb[k * kLdV + r] : 0.f, k + 1 < dr ? vb[(k + 1) * kLdV + r] : 0.f);
        },
        [&](int k, int n) {
          return make_float2(k < dr ? BC(nbx + (k >> 5), k, cb0 + n) : 0.f,
                             k + 1 < dr ? BC(nbx + ((k + 1) >> 5), k + 1, cb0 + n) : 0.f);
        }, lane);
  float* out = role == 1 ? dC : dB;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      if (q >= nqs) break;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r0 + 16 * m + g + 8 * r, n = cb0 + 8 * q + 2 * t4;
        if (i >= L) continue;
        *reinterpret_cast<float2*>(out + (static_cast<int64_t>(b) * S + t0 + i) * N + n) =
            make_float2(acc[m][q][2 * r], acc[m][q][2 * r + 1]);
      }
    }
}

// -- 4. dA ----------------------------------------------------------------------

// dA[h] = Σ over batch rows and chunks of each chunk's share, in order.
__global__ void __launch_bounds__(kThreads)
da_sum_kernel(const float* __restrict__ da_part, float* __restrict__ dA, int rows, int H) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += da_part[static_cast<int64_t>(r) * H + h];
  dA[h] = s;
}

// The launches' arguments: the TMA maps (see repro_ssm_scan_bwd) and the
// rest.
struct BwdArgs {
  CUtensorMap dy64, c64, dy_l, x_l, b_l, x32, dy32, e32, o32, b32, c32;
  const float *x, *dt, *A, *C, *cb, *states, *decay, *dfinal;
  float *dstates, *dpart, *dx, *ddt, *da_part, *dB, *dC;
  int B, S, H, N, L, rows_l, rows32, rows64;
  int64_t x_sb, x_ss, x_sh, dt_sb, dt_ss, c_sb, c_ss;
};

// The three passes at head dim P, a dbc_heads warp holding kQ state tiles.
// The passes' shared-memory attributes, set once: the state and chunk
// passes run two blocks an SM (the largest carveout), the head sums one, at
// most 227 KB.
template <int P, int kQ>
cudaError_t set_attributes() {
  cudaError_t err = allow_smem(state_bwd_kernel<P>, state_bwd_smem_bytes());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(state_bwd_kernel<P>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = allow_smem(chunk_bwd_kernel<P>, chunk_bwd_smem_bytes());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(chunk_bwd_kernel<P>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = allow_smem(dbc_heads_kernel<P, kQ>, 232448);
  return err;
}

template <int P, int kQ>
cudaError_t launch_passes(const BwdArgs& a, cudaStream_t s) {
  static bool set[64] = {};  // per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device >= 64) return err != cudaSuccess ? err : cudaErrorInvalidDevice;
  if (!set[device]) {
    if ((err = set_attributes<P, kQ>()) != cudaSuccess) return err;
    set[device] = true;
  }
  const int nc = a.S / a.L, ntiles = (a.N + kSN - 1) / kSN;
  size_t smem = state_bwd_smem_bytes();
  state_bwd_kernel<P><<<dim3(ntiles, a.H, a.B), kThreads, smem, s>>>(
      a.dy64, a.c64, a.dt, a.A, a.states, a.decay, a.dfinal, a.dstates, a.dpart, a.S, a.H, a.N,
      a.L, a.rows64, a.dt_sb, a.dt_ss);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // two ring stages where they fit (N <= 128 at P 64), else one
  const int slot = dbc_slot_floats(P, a.N), final = dbc_final_floats(a.N);
  const int ring = dbc_smem_bytes(2 * slot) <= 232448 ? 2 : 1;
  const int ring_floats = ring * slot > final ? ring * slot : final;
  smem = dbc_smem_bytes(ring_floats);
  if (smem > 232448) return cudaErrorInvalidValue;
  dbc_heads_kernel<P, kQ><<<dim3((a.L + kRT - 1) / kRT, nc, a.B), kDbcThreads, smem, s>>>(
      a.x32, a.dy32, a.e32, a.o32, a.b32, a.c32, a.dt, a.A, a.C, a.dB, a.dC, a.ddt, a.S, a.H,
      a.N, a.L, a.rows32, slot, ring, ring_floats, a.dt_sb, a.dt_ss, a.c_sb, a.c_ss);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  smem = chunk_bwd_smem_bytes();
  chunk_bwd_kernel<P><<<dim3(nc, a.H, a.B), kThreads, smem, s>>>(
      a.x_l, a.dy_l, a.b_l, a.o32, a.x, a.dt, a.A, a.cb, a.dpart, ntiles, a.dx,
      a.ddt, a.da_part, a.S, a.H, a.N, a.L, a.rows_l, a.x_sb, a.x_ss, a.x_sh, a.dt_sb, a.dt_ss);
  return cudaGetLastError();
}

}  // namespace

// x (B, S, H, P), dt (B, S, H), B/C (B, S, N): the forward's inputs, with
// (batch, seq) strides of x, dt, B, C in `strides` and x's head stride
// x_sh; x, B and C start on 16-byte boundaries with strides that are
// multiples of 4 (TMA reads them); P is 32 or 64, N a multiple of 32 up to
// 256, L at most 128; A (H,); cb (B, nc, L,
// L), states (B, nc, H, P, N) and decay (B, nc, H): the forward's scratch
// (C·Bᵀ, the entering states, cs_L); dy (B, S, H, P) contiguous and 16-byte
// aligned; dfinal (B, H, P, N) contiguous or null.  Written: dx (B, S, H,
// P), ddt (B, S, H), dA (H,), dB and dC (B, S, N), all contiguous.
// Scratch: dstates like states (each chunk's own state's gradient), dpart
// (B, nc, H, ceil(N / 64)) and da_part (B, nc, H).  Returns
// cudaGetLastError().
extern "C" int repro_ssm_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                                  const void* Cm, const void* cb, const void* states,
                                  const void* decay, const void* dy, const void* dfinal,
                                  void* dx, void* ddt, void* dA, void* dB, void* dC,
                                  void* dstates, void* dpart, void* da_part, int B, int S, int H,
                                  int P, int N, int L, const int64_t* strides, int64_t x_sh,
                                  void* stream) {
  const int64_t x_sb = strides[0], x_ss = strides[1], dt_sb = strides[2], dt_ss = strides[3];
  const int64_t b_sb = strides[4], b_ss = strides[5], c_sb = strides[6], c_ss = strides[7];
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P % 32 != 0 || P > kMaxP || N <= 0 ||
      N > kMaxN || N % 32 != 0 || L <= 0 || L > kMaxL || S % L != 0)
    return cudaErrorInvalidValue;
  if (!aligned(x) || !aligned(Bm) || !aligned(Cm) || !aligned(dy) || !aligned(states) ||
      !aligned(dstates) || (x_sb | x_ss | x_sh | b_sb | b_ss | c_sb | c_ss) % 4 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = S / L;
  // boxes of L rounded up to 16 steps, of kSub or of 32 steps, never past S
  const int lb = (L + 15) / 16 * 16;
  const uint32_t Lb = lb < S ? lb : S, R32 = S < 32 ? S : 32, R64 = S < kSub ? S : kSub;
  const uint64_t uB = B, uS = S, uH = H, uP = P, uN = N, rows = static_cast<uint64_t>(B) * nc * H;
  const uint32_t uP32 = P;
  BwdArgs a;

  // TMA maps: x and dy (p, head, step, batch) in boxes of 32 p x Lb, kSub
  // or 32 steps; B and C (n, step, batch) in boxes of 32 or 16 n x Lb, kSub
  // or 32 steps; the entering states and dOwn (n, p, (batch, chunk, head))
  // in boxes of 32 or 16 n x P
  const int64_t dy_st[3] = {P, static_cast<int64_t>(H) * P, static_cast<int64_t>(S) * H * P};
  const int64_t x_st[3] = {x_sh, x_ss, x_sb}, b_st[3] = {b_ss, b_sb, 16}, c_st[3] = {c_ss, c_sb, 16};
  const int64_t st_st[3] = {N, static_cast<int64_t>(P) * N, 16};
  const uint64_t xd[4] = {uP, uH, uS, uB}, bd[4] = {uN, uS, uB, 1}, sd[4] = {uN, uP, rows, 1};
  if (!f32_map(&a.dy64, dy, xd, dy_st, {32, 1, R64, 1}) ||
      !f32_map(&a.c64, Cm, bd, c_st, {32, R64, 1, 1}) ||
      !f32_map(&a.dy_l, dy, xd, dy_st, {32, 1, Lb, 1}) ||
      !f32_map(&a.x_l, x, xd, x_st, {32, 1, Lb, 1}) ||
      !f32_map(&a.b_l, Bm, bd, b_st, {32, Lb, 1, 1}) ||
      !f32_map(&a.x32, x, xd, x_st, {32, 1, R32, 1}) ||
      !f32_map(&a.dy32, dy, xd, dy_st, {32, 1, R32, 1}) ||
      !f32_map(&a.o32, dstates, sd, st_st, {32, uP32, 1, 1}) ||
      !f32_map(&a.e32, states, sd, st_st, {32, uP32, 1, 1}) ||
      !f32_map(&a.b32, Bm, bd, b_st, {32, R32, 1, 1}) ||
      !f32_map(&a.c32, Cm, bd, c_st, {32, R32, 1, 1}))
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  a.x = f(x), a.dt = f(dt), a.A = f(A), a.C = f(Cm), a.cb = f(cb), a.states = f(states), a.decay = f(decay);
  a.dfinal = f(dfinal), a.dstates = o(dstates), a.dpart = o(dpart), a.dx = o(dx), a.ddt = o(ddt);
  a.da_part = o(da_part), a.dB = o(dB), a.dC = o(dC);
  a.B = B, a.S = S, a.H = H, a.N = N, a.L = L, a.rows_l = Lb, a.rows32 = R32, a.rows64 = R64;
  a.x_sb = x_sb, a.x_ss = x_ss, a.x_sh = x_sh, a.dt_sb = dt_sb, a.dt_ss = dt_ss;
  a.c_sb = c_sb, a.c_ss = c_ss;
  const cudaError_t err = P == 64 ? (N <= 128 ? launch_passes<64, 4>(a, s) : launch_passes<64, 8>(a, s))
                                  : (N <= 128 ? launch_passes<32, 4>(a, s) : launch_passes<32, 8>(a, s));
  if (err != cudaSuccess) return err;
  da_sum_kernel<<<(H + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      a.da_part, static_cast<float*>(dA), B * nc, H);
  return cudaGetLastError();
}
