// The Mamba2 SSD chunked scan, for sm_90a.
//
// Replaces: src/repro/kernels/ssm_scan.py, ssm_scan_bshp (Pallas body
// _ssd_kernel).
//
// What bounds it on the H100.  Per chunk of L steps, every head does
// L(L+1)/2 * P multiply-adds for the intra-chunk term and 2 * L * P * N for
// the entering state's term and the chunk's own state; C·Bᵀ adds L(L+1)/2 *
// N a chunk.  At mamba2-370m's shapes (S = 1024, H = 32, P = 64, N = 128,
// batch 1) that is about 1.4 GFLOP against about 19 MB read and written
// once: 0.020 ms at the 67 TFLOP/s of the float32 CUDA cores, but 0.0028 ms
// at the 495 TFLOP/s of TF32 on the tensor cores, under the 0.0057 ms that
// the bytes take at 3.35 TB/s.  So the products run on the tensor cores,
// and the kernel is held to the bytes.
//
// Precision: 3xTF32.  Each float32 operand is split into a tf32 hi part and
// a lo remainder, and lo·hi + hi·lo + hi·hi accumulate in float32
// (mma_3xtf32, mma.cuh), which keeps about float32's accuracy: one-pass
// TF32 (about 3 digits) would break the 2e-3 tolerance and put the CPU-card
// token parity of the float32 smoke configs at risk.  The weights W = CB ⊙
// decay ⊙ dt and every exponent stay float32 in registers, each exponent
// clipped to [-60, 0] as in the reference, so a padded step (dt = 0)
// leaves the state exactly as it was.
//
// Design: the chunked SSD split, four launches a call, the plain version's
// steps (kernels/ssm_scan.py: ssm_scan_plain) in the same order.  The
// Pallas grid walks the chunks in order with the state in VMEM; blocks
// that each walked all S / L chunks so would leave the card short of work
// at batch 1 (one per head and P tile: 128 for mamba2).  Here only the
// cheap elementwise recurrence walks the chunks; the products run one
// block per (chunk, head, P tile of 64, batch row): 256 blocks for mamba2
// and 512 for zamba2 at batch 1, two to an SM;
//   1. chunk_cb_kernel: C·Bᵀ of every chunk once (B and C are one group,
//      shared by every head), into an (B, nc, L, L) scratch that stays in
//      L2.  One block per (16-row tile, chunk, batch row), its 4 warps
//      sharing the 8-column tiles on and below the diagonal;
//   2. chunk_state_kernel: each chunk's own end state, states[c] =
//      Σ_j clip_exp(cs_L - cs_j) dt_j x_jᵀ B_j, a (P x L)·(L x N) product,
//      the weights applied as x's fragments are read.  One block per
//      (chunk, head, 64-row P tile, 128-column N tile, batch row), a warp
//      per 16 P rows and 64 columns, so a thread holds 32 accumulators.  It
//      also writes cs_L, the chunk's decay exponent;
//   3. state_pass_kernel: carry <- carry·clip_exp(cs_L) + states[c], one
//      thread per (batch row, head, p, n) walking the chunks; each chunk's
//      entering state overwrites its own state in place, and the carry
//      after the last is the final state;
//   4. chunk_scan_kernel: y = W·x + (clip_exp(cs) ⊙ C)·enteringᵀ with
//      W_ij = CB_ij clip_exp(cs_i - cs_j) dt_j for j <= i.  A warp per 16
//      rows of y; W is built in the warp's A fragments from the CB scratch
//      (each element once, only up to the warp's diagonal, the next step's
//      CB in flight meanwhile); x of the chunk is staged whole.
// Every chunk computes its inclusive cumsum of dt·A itself (warp scans).
// Tiles move by cp.async, 16 bytes a copy where x, B and C are 16-byte
// aligned (the model's packed xBC is) and 4 bytes otherwise, 32 columns or
// steps at a time in two stages, the next in flight while the current one
// is computed; rows are padded so the fragment loads hit 32 different
// banks.  Tiles are padded with zeros: any L in 1..128, P a multiple of 16,
// N a multiple of 4 up to 256.
#include "common.cuh"
#include "mma.cuh"
#include "ssd.cuh"

namespace {

using namespace repro;
using namespace repro::ssd;

// 1. cb[b, c, i, j] = sum_n C[b, c*L + i, n] * B[b, c*L + j, n] for the
// rows i of one 16-row tile and the 8-column tiles j up to its diagonal:
// one block per (row tile, chunk, batch row), warp w the tiles w, w + 4,
// ...  C's 16 rows and B's rows are staged 32 state columns at a time.
__global__ void __launch_bounds__(kCbThreads)
chunk_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                float* __restrict__ cb, int N, int L, bool vec, int64_t b_sb, int64_t b_ss,
                int64_t c_sb, int64_t c_ss) {
  __shared__ __align__(16) float ct[2][16 * kLdK];     // C rows of the tile
  __shared__ __align__(16) float bt[2][kMaxL * kLdK];  // B rows up to the diagonal
  const int rt = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int i0 = 16 * rt;
  const int nw = min(2 * (rt + 1), (L + 7) / 8);  // 8-column tiles up to the diagonal
  const int jrows = 8 * nw;
  const int64_t t0 = static_cast<int64_t>(c) * L;
  const float* cg = Cm + b * c_sb + t0 * c_ss;
  const float* bg = Bm + b * b_sb + t0 * b_ss;
  const int mine = (nw - w + 3) / 4;  // this warp's tiles: w + 4q, q < mine

  auto issue = [&](int stage, int n0) {
    stage_async<kCbThreads, 16, kKC>(vec, ct[stage], kLdK, 16, kKC, cg,
        [&](int r, int k) { return i0 + r < L && n0 + k < N; },
        [&](int r, int k) { return cg + (i0 + r) * c_ss + n0 + k; });
    stage_async<kCbThreads, kMaxL, kKC>(vec, bt[stage], kLdK, jrows, kKC, bg,
        [&](int r, int k) { return r < L && n0 + k < N; },
        [&](int r, int k) { return bg + r * b_ss + n0 + k; });
  };

  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
  issue(0, 0);
  cp_async_commit();
  for (int n0 = 0, s = 0; n0 < N; n0 += kKC, s ^= 1) {
    if (n0 + kKC < N) issue(s ^ 1, n0 + kKC);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this stage has landed for every thread
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 8) {
      FragA3 a;
      a.load([&](int r, int k) { return ct[s][r * kLdK + kk + k]; }, lane);
      FragB3 bf[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < mine)
          bf[q].load([&](int k, int n) { return bt[s][(8 * (w + 4 * q) + n) * kLdK + kk + k]; },
                     lane);
      mma_3xtf32(acc, a, bf, mine);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  float* out = cb + (static_cast<int64_t>(b) * nc + c) * L * L;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q >= mine) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + 8 * (e >> 1), j = 8 * (w + 4 * q) + 2 * t + (e & 1);
      if (i < L && j < L) out[i * L + j] = acc[q][e];
    }
  }
}

constexpr int kNT = 128;  // state columns per chunk_state block
constexpr int kLdN = kNT + 8;  // row of a [steps][kNT] tile read as (k, col): 8 mod 32

inline size_t state_smem_bytes() {
  return sizeof(float) * (2 * kMaxL + 8 + kWarps + 2 * kKC * kLdP + 2 * kKC * kLdN);
}

// 2. states[b, c, h, p, n] = sum_j clip_exp(cs_L - cs_j) dt_j x[j, h, p]
// B[j, n] over the chunk's steps j; decay[b, c, h] = cs_L.  One block per
// (chunk, head and 64-row P tile and 128-column N tile, batch row); warp w
// the P rows 16 (w % 4).. and the columns 64 (w / 4)..
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
    wt[tid] = wt[tid] * clip_exp(cl - cs[tid]);
  else if (tid < kMaxL + 8)
    wt[tid] = 0.f;  // past the chunk: read beside zero-filled x, so never NaN
  if (tid == 0 && pt == 0 && ntile == 0)
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

// 3. The carried recurrence along the chunks, one thread per (batch row,
// head, p, n): each chunk's state is replaced by the state entering it, and
// the state after the last chunk is the final state.
__global__ void __launch_bounds__(kThreads)
state_pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
                  float* __restrict__ fin, int B, int nc, int H, int PN) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t per_row = static_cast<int64_t>(H) * PN;
  if (e >= B * per_row) return;
  const int64_t b = e / per_row, hpn = e % per_row;
  const int h = static_cast<int>(hpn / PN);
  // the loads of 8 chunks at a time are in flight together
  constexpr int kBatch = 8;
  float carry = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    float own[kBatch], dec[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k >= nc) break;
      own[k] = states[(b * nc + c0 + k) * per_row + hpn];
      dec[k] = decay[(b * nc + c0 + k) * H + h];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k >= nc) break;
      states[(b * nc + c0 + k) * per_row + hpn] = carry;
      carry = carry * clip_exp(dec[k]) + own[k];
    }
  }
  fin[e] = carry;
}

size_t scan_smem_bytes() {
  return sizeof(float) * (2 * kMaxL + kWarps + kMaxL * kLdP + 2 * (kMaxL + kPT) * kLdK);
}

// 4. y of the chunk: one block per (chunk, head and P tile, batch row); warp
// w the rows 16w..16w+15 over the tile's P columns.
__global__ void __launch_bounds__(kThreads, 2)  // two blocks an SM
chunk_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ Cm,
                  const float* __restrict__ cb, const float* __restrict__ states,
                  float* __restrict__ y, int S, int H, int P, int N, int L, bool vec,
                  int64_t x_sb, int64_t x_ss, int64_t x_sh, int64_t dt_sb, int64_t dt_ss,
                  int64_t c_sb, int64_t c_ss) {
  extern __shared__ float4 smem_scan[];  // float4: 16-byte alignment
  float* cs = reinterpret_cast<float*>(smem_scan);  // [kMaxL]
  float* dts = cs + kMaxL;                           // [kMaxL]
  float* wsum = dts + kMaxL;                         // [kWarps]
  float* xs = wsum + kWarps;                         // [Lp][kPT] of x
  float* ct = xs + kMaxL * kLdP;                     // [2][Lp][kKC] of C
  float* st = ct + 2 * kMaxL * kLdK;                 // [2][kPT][kKC] of the entering state
  const int ptiles = (P + kPT - 1) / kPT;
  const int c = blockIdx.x, h = blockIdx.y / ptiles, pt = blockIdx.y % ptiles;
  const int b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int p0 = pt * kPT, pw = min(kPT, P - p0);
  const int nq = pw / 8;  // 8-column tiles of the P tile
  const int Lp = (L + 15) / 16 * 16;
  const int64_t t0 = static_cast<int64_t>(c) * L;
  const float* xg = x + b * x_sb + t0 * x_ss + h * x_sh + p0;
  const float* cg = Cm + b * c_sb + t0 * c_ss;
  const float* sg = states + ((static_cast<int64_t>(b) * nc + c) * H + h) * P * N +
                    static_cast<int64_t>(p0) * N;
  const float* cbc = cb + (static_cast<int64_t>(b) * nc + c) * L * L;

  auto issue = [&](int stage, int n0) {
    stage_async<kThreads, kMaxL, kKC>(vec, ct + stage * kMaxL * kLdK, kLdK, Lp, kKC, cg,
        [&](int r, int k) { return r < L && n0 + k < N; },
        [&](int r, int k) { return cg + r * c_ss + n0 + k; });
    stage_copies<kThreads, kPT, kKC, 4>(st + stage * kPT * kLdK, kLdK, kPT, kKC, sg,
        [&](int p, int k) { return p < pw && n0 + k < N; },
        [&](int p, int k) { return sg + static_cast<int64_t>(p) * N + n0 + k; });
  };
  stage_async<kThreads, kMaxL, kPT>(vec, xs, kLdP, Lp, kPT, xg,
      [&](int j, int p) { return j < L && p < pw; },
      [&](int j, int p) { return xg + j * x_ss + p; });
  cp_async_commit();
  issue(0, 0);
  cp_async_commit();
  chunk_cumsum(dt + b * dt_sb + t0 * dt_ss + h, dt_ss, A[h], L, cs, dts, wsum);
  cp_async_wait<1>();  // x has landed
  __syncthreads();

  const bool active = 16 * w < L;
  const int g = lane >> 2, t = lane & 3;
  float acc[kPT / 8][4];
#pragma unroll
  for (int q = 0; q < kPT / 8; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;

  // the intra-chunk term, W·x, over the steps j < 16 (w + 1); W is built in
  // the A fragment from CB, whose next step is in flight meanwhile
  if (active) {
    const int i0 = 16 * w, kend = min(i0 + 16, L);
    // CB at the fragment's elements of step kk: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
    auto load_cb = [&](int kk, float (&v)[4]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + g + 8 * (e & 1), j = kk + t + 4 * (e >> 1);
        v[e] = j <= i && i < L ? cbc[i * L + j] : 0.f;
      }
    };
    float cur[4], nxt[4] = {0.f, 0.f, 0.f, 0.f};
    load_cb(0, cur);
    for (int kk = 0; kk < kend; kk += 8) {
      if (kk + 8 < kend) load_cb(kk + 8, nxt);
      FragA3 a;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + g + 8 * (e & 1), j = kk + t + 4 * (e >> 1);
        const float wv = j <= i && i < L ? cur[e] * clip_exp(cs[i] - cs[j]) * dts[j] : 0.f;
        split_tf32(wv, a.hi[e], a.lo[e]);
        cur[e] = nxt[e];
      }
      FragB3 bf[kPT / 8];  // (j, p) = x[j][p]
#pragma unroll
      for (int q = 0; q < kPT / 8; ++q)
        if (q < nq) bf[q].load([&](int k, int n) { return xs[(kk + k) * kLdP + 8 * q + n]; }, lane);
      mma_3xtf32(acc, a, bf, nq);
    }
  }

  // the entering state's term, (clip_exp(cs) C)·enteringᵀ, 32 columns of N
  // at a time; the rows' factors clip_exp(cs_i) applied as C is read
  const float e0 = active && 16 * w + g < L ? clip_exp(cs[16 * w + g]) : 0.f;
  const float e1 = active && 16 * w + g + 8 < L ? clip_exp(cs[16 * w + g + 8]) : 0.f;
  for (int n0 = 0, s = 0; n0 < N; n0 += kKC, s ^= 1) {
    if (n0 + kKC < N) issue(s ^ 1, n0 + kKC);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this stage has landed for every thread
    const float* cts = ct + s * kMaxL * kLdK;
    const float* sts = st + s * kPT * kLdK;
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 8) {
        FragA3 a;
        a.load([&](int r, int k) {
          return cts[(16 * w + r) * kLdK + kk + k] * (r < 8 ? e0 : e1);
        }, lane);
        FragB3 bf[kPT / 8];  // (n, p) = entering[p][n]
#pragma unroll
        for (int q = 0; q < kPT / 8; ++q)
          if (q < nq)
            bf[q].load([&](int k, int n) { return sts[(8 * q + n) * kLdK + kk + k]; }, lane);
        mma_3xtf32(acc, a, bf, nq);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = 16 * w + g + 8 * r;
    if (i >= L) continue;
    float* yrow = y + ((static_cast<int64_t>(b) * S + t0 + i) * H + h) * P + p0;
#pragma unroll
    for (int q = 0; q < kPT / 8; ++q) {
      if (q >= nq) break;
      *reinterpret_cast<float2*>(yrow + 8 * q + 2 * t) =
          make_float2(acc[q][2 * r], acc[q][2 * r + 1]);
    }
  }
}

}  // namespace

// x (B, S, H, P), dt (B, S, H), B/C (B, S, N): float32, contiguous last
// axis, other strides in `strides` as (batch, seq) pairs of x, dt, B, C,
// plus x's head stride x_sh; A (H,) contiguous; y (B, S, H, P) and fin
// (B, H, P, N) contiguous; scratch: cb of B * nc * L * L floats, states of
// B * nc * H * P * N and decay of B * nc * H, nc = S / L.  `aligned`: x, B
// and C start on 16-byte boundaries and their batch, seq (and x's head)
// strides are multiples of 4, so their rows move 16 bytes a copy.
// Returns cudaGetLastError().
extern "C" int repro_ssm_scan(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* Cm, void* y, void* fin, void* cb, void* states,
                              void* decay, int B, int S, int H, int P, int N, int L,
                              int aligned, const int64_t* strides, int64_t x_sh,
                              void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P % 16 != 0 || N <= 0 || N > kMaxN ||
      N % 4 != 0 || L <= 0 || L > kMaxL || S % L != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t x_sb = strides[0], x_ss = strides[1], dt_sb = strides[2], dt_ss = strides[3];
  const int64_t b_sb = strides[4], b_ss = strides[5], c_sb = strides[6], c_ss = strides[7];
  const int nc = S / L;
  const int ptiles = (P + kPT - 1) / kPT, ntiles = (N + kNT - 1) / kNT;
  const bool vec = aligned != 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  auto* cbf = static_cast<float*>(cb);
  auto* st = static_cast<float*>(states);
  auto* dec = static_cast<float*>(decay);

  chunk_cb_kernel<<<dim3((L + 15) / 16, nc, B), kCbThreads, 0, s>>>(
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), cbf, N, L, vec, b_sb, b_ss,
      c_sb, c_ss);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  size_t smem = state_smem_bytes();
  err = allow_smem(chunk_state_kernel, smem);
  if (err != cudaSuccess) return err;
  chunk_state_kernel<<<dim3(nc, H * ptiles * ntiles, B), kThreads, smem, s>>>(
      xf, dtf, Af, static_cast<const float*>(Bm), st, dec, H, P, N, L, vec, x_sb, x_ss, x_sh,
      dt_sb, dt_ss, b_sb, b_ss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t elems = static_cast<int64_t>(B) * H * P * N;
  state_pass_kernel<<<static_cast<unsigned>((elems + kThreads - 1) / kThreads), kThreads, 0,
                      s>>>(st, dec, static_cast<float*>(fin), B, nc, H, P * N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = scan_smem_bytes();
  err = allow_smem(chunk_scan_kernel, smem);
  if (err != cudaSuccess) return err;
  chunk_scan_kernel<<<dim3(nc, H * ptiles, B), kThreads, smem, s>>>(
      xf, dtf, Af, static_cast<const float*>(Cm), cbf, st, static_cast<float*>(y), S, H, P, N,
      L, vec, x_sb, x_ss, x_sh, dt_sb, dt_ss, c_sb, c_ss);
  return cudaGetLastError();
}
