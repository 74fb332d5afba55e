// Backward of the Mamba2 SSD chunked scan, for sm_90a.
//
// Replaces: the gradient the JAX package takes of its scan in training (jnp
// autodiff of src/repro/models/ssm.py:ssd_chunked; the Pallas kernel
// src/repro/kernels/ssm_scan.py, ssm_scan_bshp, has no VJP of its own).
// Its specification is kernels/ssm_scan.py:ssm_scan_bwd_plain, whose steps
// it runs in the same order.
//
// What bounds it on the H100: about twice the forward's products (each
// chunk's dy·xᵀ, Wᵀ·dy, B·dOwnᵀ, dy·entering, x·dOwn and the entering
// state's gradient, plus the head-summed d(C·Bᵀ) against B and C), all
// float32 in 3xTF32 on the tensor cores as in the forward; at mamba2-370m's
// training shape (4 x 1024 steps, 32 heads, P 64, N 128) about 11 GFLOP,
// 0.02 ms at the TF32 rate, against the entering states and their
// gradients (33.5 MB each) moved a few times: the bytes bound it.
//
// Launches, the forward's steps in reverse:
//   1. chunk_state_kernel<true> (ssd.cuh): each chunk's entering-state
//      gradient from its own y, Σ_i clip_exp(cs_i) dy_i ⊗ C_i, a (P x L)·
//      (L x N) product a (chunk, head);
//   2. state_pass_bwd_kernel: the reverse recurrence from d(final) (zero
//      when the loss does not reach it), G_c = D_c + G_{c+1} clip_exp(cs_L),
//      leaving each chunk's own-state gradient G_{c+1} in place of D_c, and
//      Σ G_{c+1} ⊙ entering_c (the chunk decay's gradient) in fixed-order
//      block sums, one per group of 2048 (p, n) elements;
//   3. chunk_bwd_kernel: one block per (chunk, head, batch row), a warp per
//      16 steps: dW = dy·xᵀ, dx = Wᵀ·dy + w ⊙ (B·dOwnᵀ), the head's share
//      of d(C·Bᵀ) = dW ⊙ E ⊙ dt and of dC (clip_exp(cs) dy·entering) and
//      dB (w x·dOwn) into scratch, every exponent's gradient (clamp's rule:
//      it passes where -60 <= t <= 0, masked upper-triangle entries carry
//      none), and their reverse cumsum within the chunk: ddt (with dt's
//      direct terms) and the chunk's share of dA;
//   4. head_sum_kernel: the heads' shares summed in a fixed order;
//   5. dbc_kernel: dC = d(CBᵀ)·B + Σ_h dC_h and dB = d(CBᵀ)ᵀ·C + Σ_h dB_h,
//      a 16-row tile a block;
//   6. da_kernel: dA summed over batch rows and chunks.
// B and C are one group shared by every head, so their gradients are sums
// over the heads; every sum runs in a fixed order and no launch uses
// atomics, so the result is deterministic.  The head dim P is at most 64
// here (every model's is 32 or 64); the wrapper raises above.
#include "common.cuh"
#include "mma.cuh"
#include "ssd.cuh"

namespace {

using namespace repro;
using namespace repro::ssd;

constexpr int kPer = 8;                  // (p, n) elements a thread carries in pass 2
constexpr int kGroup = kPer * kThreads;  // elements a state_pass_bwd block walks
constexpr int kMaxP = 64;                // head dim the chunk kernel stages whole
constexpr int kLdX = kMaxP + 4;          // row of an [steps][P] tile: 4 mod 32 banks

__device__ __forceinline__ float clip_grad(float t, float e) {
  return t >= -60.f && t <= 0.f ? e : 0.f;  // d clip_exp(t) / dt, e = clip_exp(t)
}

// 2. The entering states' gradients, last chunk first.  One block per (group
// of kGroup (p, n) elements, head, batch row); g holds G_{c+1} as it walks.
__global__ void __launch_bounds__(kThreads)
state_pass_bwd_kernel(float* __restrict__ dstates, const float* __restrict__ states,
                      const float* __restrict__ decay, const float* __restrict__ dfinal,
                      float* __restrict__ dpart, int nc, int H, int PN) {
  __shared__ float red[kWarps];
  const int grp = blockIdx.x, h = blockIdx.y, b = blockIdx.z, ngroups = gridDim.x;
  const int tid = threadIdx.x;
  float g[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = grp * kGroup + k * kThreads + tid;
    g[k] = dfinal != nullptr && e < PN ? dfinal[(static_cast<int64_t>(b) * H + h) * PN + e] : 0.f;
  }
  for (int c = nc - 1; c >= 0; --c) {
    const int64_t bch = (static_cast<int64_t>(b) * nc + c) * H + h;
    const float ex = clip_exp(decay[bch]);
    // every load of the chunk in flight before any is used: a loop that may
    // stop early keeps them in order, one round trip each
    float d[kPer], s[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = grp * kGroup + k * kThreads + tid;
      d[k] = e < PN ? dstates[bch * PN + e] : 0.f;
      s[k] = e < PN ? states[bch * PN + e] : 0.f;
    }
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = grp * kGroup + k * kThreads + tid;
      part += g[k] * s[k];
      if (e < PN) dstates[bch * PN + e] = g[k];  // the chunk's own state's gradient
      g[k] = d[k] + g[k] * ex;
    }
    part = warp_sum(part);
    if (tid % 32 == 0) red[tid / 32] = part;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[w];
      dpart[bch * ngroups + grp] = s;
    }
    __syncthreads();  // red is free for the next chunk
  }
}

// acc[q] (q < nq) += Σ_k a(r, k) b(k, 8q + n) over k in [k0, k1), 8 at a time,
// on the tensor cores in 3xTF32; a and b give 0 past their ranges.
template <int Q, typename Af, typename Bf>
__device__ __forceinline__ void gemm_3xtf32(float (&acc)[Q][4], int nq, int k0, int k1, Af a,
                                            Bf b, int lane) {
  for (int kk = k0; kk < k1; kk += 8) {
    FragA3 fa;
    fa.load([&](int r, int k) { return a(r, kk + k); }, lane);
    FragB3 fb[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q)
      if (q < nq) fb[q].load([&](int k, int n) { return b(kk + k, 8 * q + n); }, lane);
    mma_3xtf32(acc, fa, fb, nq);
  }
}

template <int Q>
__device__ __forceinline__ void zero(float (&acc)[Q][4]) {
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
}

inline size_t chunk_bwd_smem_bytes() {
  return sizeof(float) * (6 * kMaxL + kWarps + 2 * kWarps * kMaxL + 2 * kMaxL * kLdX +
                          2 * kMaxL * kLdK + 2 * kMaxP * kLdK);
}

// 3. One chunk of one head: dx, ddt, the chunk's dA share, and the head's
// shares of d(C·Bᵀ), dC and dB into scratch.  Warp w owns steps 16w..16w+15.
__global__ void __launch_bounds__(kThreads)
chunk_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const float* __restrict__ dy,
                 const float* __restrict__ cb, const float* __restrict__ states,
                 const float* __restrict__ down, const float* __restrict__ dpart, int ngroups,
                 float* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ da_part,
                 float* __restrict__ dcb_h, float* __restrict__ g_h, int S, int H, int P, int N,
                 int L, bool vec, int64_t x_sb, int64_t x_ss, int64_t x_sh, int64_t dt_sb,
                 int64_t dt_ss, int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss) {
  extern __shared__ float4 smem_bwd[];  // float4: 16-byte alignment
  float* cs = reinterpret_cast<float*>(smem_bwd);  // [kMaxL] inclusive cumsum of dt·A
  float* dts = cs + kMaxL;                          // [kMaxL]
  float* wsum = dts + kMaxL;                        // [kWarps]
  float* row_r = wsum + kWarps;                     // [kMaxL] Σ_j R_ij, then R'_i
  float* inter = row_r + kMaxL;                     // [kMaxL] C_i·Z_i, then dt's direct terms
  float* dwv = inter + kMaxL;                       // [kMaxL] x_j·V_j
  float* dcs = dwv + kMaxL;                         // [kMaxL] exponent gradients
  float* col_r = dcs + kMaxL;                       // [kWarps][kMaxL] column sums of R
  float* col_t = col_r + kWarps * kMaxL;            // [kWarps][kMaxL] column sums of dW·CB·E
  float* xs = col_t + kWarps * kMaxL;               // [kMaxL][kLdX] x of the chunk
  float* dys = xs + kMaxL * kLdX;                   // [kMaxL][kLdX] dy of the chunk
  float* bt = dys + kMaxL * kLdX;                   // [kMaxL][kLdK] B, kKC columns
  float* ct = bt + kMaxL * kLdK;                    // [kMaxL][kLdK] C, kKC columns
  float* ot = ct + kMaxL * kLdK;                    // [kMaxP][kLdK] dOwn, kKC columns
  float* st = ot + kMaxP * kLdK;                    // [kMaxP][kLdK] entering, kKC columns

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int Lp = (L + 15) / 16 * 16, nq = P / 8;
  const int64_t t0 = static_cast<int64_t>(c) * L;
  const int64_t bch = (static_cast<int64_t>(b) * nc + c) * H + h;
  const float* xg = x + b * x_sb + t0 * x_ss + h * x_sh;
  const int64_t dy_ss = static_cast<int64_t>(H) * P;
  const float* dyg = dy + (static_cast<int64_t>(b) * S + t0) * dy_ss + static_cast<int64_t>(h) * P;
  const float* cbc = cb + (static_cast<int64_t>(b) * nc + c) * L * L;
  float* dcbc = dcb_h + bch * L * L;
  float* gc = g_h + bch * L * 2 * N;

  stage_async<kThreads, kMaxL, kMaxP>(vec, xs, kLdX, Lp, P, xg,
      [&](int j, int p) { return j < L; }, [&](int j, int p) { return xg + j * x_ss + p; });
  stage_copies<kThreads, kMaxL, kMaxP, 4>(dys, kLdX, Lp, P, dyg,
      [&](int j, int p) { return j < L; }, [&](int j, int p) { return dyg + j * dy_ss + p; });
  cp_async_commit();
  for (int i = tid; i < 4 * kMaxL; i += kThreads) row_r[i] = 0.f;  // row_r, inter, dwv, dcs
  for (int i = tid; i < 2 * kWarps * kMaxL; i += kThreads) col_r[i] = 0.f;
  chunk_cumsum(dt + b * dt_sb + t0 * dt_ss + h, dt_ss, A[h], L, cs, dts, wsum);
  cp_async_wait<0>();
  __syncthreads();  // x, dy, cs and the zeroed sums are in place
  const float cs_l = cs[L - 1];
  const int i0 = 16 * w;
  const bool active = i0 < L;

  // dW = dy·xᵀ over the warp's rows i and the columns j up to its diagonal,
  // in two passes of 8 column tiles; each element's R_ij and dW·CB·E summed
  // by row and by column, and the head's d(C·Bᵀ) = dW E dt_j stored
  if (active) {
    float rsum[2] = {0.f, 0.f};
    const int nt = min(2 * (w + 1), (L + 7) / 8);
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int q0 = 8 * pass;
      float acc[8][4];
      zero(acc);
      if (q0 < nt)
        gemm_3xtf32(acc, min(8, nt - q0), 0, P,
                    [&](int r, int k) { return dys[(i0 + r) * kLdX + k]; },
                    [&](int k, int n) { return xs[(8 * q0 + n) * kLdX + k]; }, lane);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float cr[2] = {0.f, 0.f}, ctt[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + g + 8 * (e >> 1), j = 8 * (q0 + q) + 2 * t4 + (e & 1);
          if (q0 + q < nt && j <= i && i < L) {
            const float seg = cs[i] - cs[j], ev = clip_exp(seg), dw = acc[q][e];
            const float tt = dw * cbc[i * L + j] * ev;
            const float r = dw * cbc[i * L + j] * clip_grad(seg, ev) * dts[j];
            dcbc[i * L + j] = dw * ev * dts[j];
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
            col_r[w * kMaxL + j] = cr[par];
            col_t[w * kMaxL + j] = ctt[par];
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

  // dx = Wᵀ·dy over i >= j (rows j of the warp), W_ij = CB_ij E(cs_i - cs_j) dt_j
  float dxa[kMaxP / 8][4];
  zero(dxa);
  if (active)
    gemm_3xtf32(dxa, nq, i0, L,
                [&](int r, int k) {
                  const int j = i0 + r, i = k;
                  return i >= j && i < L ? cbc[i * L + j] * clip_exp(cs[i] - cs[j]) * dts[j]
                                         : 0.f;
                },
                [&](int k, int n) { return dys[k * kLdX + n]; }, lane);

  // the state terms, kKC state columns at a time: V = B·dOwnᵀ (L x P),
  // Z = dy·entering and Y = x·dOwn (L x kKC each, stored as the head's dC
  // and dB shares), C·Z summed by row
  float va[kMaxP / 8][4];
  zero(va);
  float inter_acc[2] = {0.f, 0.f};
  const float* og = down + bch * P * N;
  const float* sg = states + bch * P * N;
  const float* bg = Bm + b * b_sb + t0 * b_ss;
  const float* cg = Cm + b * c_sb + t0 * c_ss;
  for (int n0 = 0; n0 < N; n0 += kKC) {
    stage_async<kThreads, kMaxL, kKC>(vec, bt, kLdK, Lp, kKC, bg,
        [&](int r, int k) { return r < L && n0 + k < N; },
        [&](int r, int k) { return bg + r * b_ss + n0 + k; });
    stage_async<kThreads, kMaxL, kKC>(vec, ct, kLdK, Lp, kKC, cg,
        [&](int r, int k) { return r < L && n0 + k < N; },
        [&](int r, int k) { return cg + r * c_ss + n0 + k; });
    stage_copies<kThreads, kMaxP, kKC, 4>(ot, kLdK, P, kKC, og,
        [&](int p, int k) { return n0 + k < N; },
        [&](int p, int k) { return og + static_cast<int64_t>(p) * N + n0 + k; });
    stage_copies<kThreads, kMaxP, kKC, 4>(st, kLdK, P, kKC, sg,
        [&](int p, int k) { return n0 + k < N; },
        [&](int p, int k) { return sg + static_cast<int64_t>(p) * N + n0 + k; });
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // this column block has landed
    if (active) {
      gemm_3xtf32(va, nq, 0, kKC, [&](int r, int k) { return bt[(i0 + r) * kLdK + k]; },
                  [&](int k, int n) { return ot[n * kLdK + k]; }, lane);
      float za[kKC / 8][4], ya[kKC / 8][4];
      zero(za);
      zero(ya);
      gemm_3xtf32(za, kKC / 8, 0, P, [&](int r, int k) { return dys[(i0 + r) * kLdX + k]; },
                  [&](int k, int n) { return st[k * kLdK + n]; }, lane);
      gemm_3xtf32(ya, kKC / 8, 0, P, [&](int r, int k) { return xs[(i0 + r) * kLdX + k]; },
                  [&](int k, int n) { return ot[k * kLdK + n]; }, lane);
#pragma unroll
      for (int q = 0; q < kKC / 8; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + g + 8 * (e >> 1), col = 8 * q + 2 * t4 + (e & 1), n = n0 + col;
          if (i < L && n < N) {
            inter_acc[e >> 1] += ct[i * kLdK + col] * za[q][e];
            gc[i * 2 * N + n] = clip_exp(cs[i]) * za[q][e];
            gc[i * 2 * N + N + n] = clip_exp(cs_l - cs[i]) * dts[i] * ya[q][e];
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the block before it is refilled
  }

  if (active) {
    // dw_j = x_j·V_j; dx = Wᵀ·dy + w_j V_j
    float dwp[2] = {0.f, 0.f};
#pragma unroll
    for (int q = 0; q < kMaxP / 8; ++q) {
      if (q >= nq) break;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dwp[e >> 1] += xs[(i0 + g + 8 * (e >> 1)) * kLdX + 8 * q + 2 * t4 + (e & 1)] * va[q][e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dwp[r] = quad_sum(dwp[r]);
      inter_acc[r] = quad_sum(inter_acc[r]);
      const int j = i0 + g + 8 * r;
      if (j >= L) continue;
      if (t4 == 0) {
        dwv[j] = dwp[r];
        inter[j] = inter_acc[r];
      }
      const float wj = clip_exp(cs_l - cs[j]) * dts[j];
      float* out = dx + ((static_cast<int64_t>(b) * S + t0 + j) * H + h) * P;
#pragma unroll
      for (int q = 0; q < kMaxP / 8; ++q) {
        if (q >= nq) break;
        *reinterpret_cast<float2*>(out + 8 * q + 2 * t4) =
            make_float2(dxa[q][2 * r] + wj * va[q][2 * r],
                        dxa[q][2 * r + 1] + wj * va[q][2 * r + 1]);
      }
    }
  }
  __syncthreads();  // every row's sums are in place

  // each step's exponent gradient, and dt's direct terms
  if (tid < L) {
    const int i = tid;
    float cr = 0.f, ctt = 0.f;
    for (int v = 0; v < kWarps; ++v) {
      cr += col_r[v * kMaxL + i];
      ctt += col_t[v * kMaxL + i];
    }
    const float e_cs = clip_exp(cs[i]), to_end = cs_l - cs[i], e_end = clip_exp(to_end);
    const float r_end = clip_grad(to_end, e_end) * dts[i] * dwv[i];
    dcs[i] = row_r[i] - cr + clip_grad(cs[i], e_cs) * inter[i] - r_end;
    row_r[i] = r_end;
    inter[i] = ctt + e_end * dwv[i];
  }
  __syncthreads();
  if (tid == 0) {  // cs_L's terms, then the reverse cumsum, in order
    float sum_end = 0.f, dec = 0.f;
    for (int i = 0; i < L; ++i) sum_end += row_r[i];
    for (int k = 0; k < ngroups; ++k) dec += dpart[bch * ngroups + k];
    dcs[L - 1] += sum_end + clip_grad(cs_l, clip_exp(cs_l)) * dec;
    float run = 0.f, da = 0.f;
    for (int i = L - 1; i >= 0; --i) {
      run += dcs[i];
      dcs[i] = run;
      da += dts[i] * run;
    }
    da_part[bch] = da;
  }
  __syncthreads();
  if (tid < L) ddt[(static_cast<int64_t>(b) * S + t0 + tid) * H + h] = inter[tid] + A[h] * dcs[tid];
}

// 4. The heads' shares of d(C·Bᵀ) (on and below the diagonal) and of dC and
// dB summed in head order: one thread per element of a (batch row, chunk).
__global__ void __launch_bounds__(kThreads)
head_sum_kernel(const float* __restrict__ dcb_h, const float* __restrict__ g_h,
                float* __restrict__ dcb, float* __restrict__ gsum, int H, int L, int N) {
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t LL = static_cast<int64_t>(L) * L, LG = static_cast<int64_t>(L) * 2 * N;
  const int64_t bc = static_cast<int64_t>(b) * nc + c;
  float s = 0.f;
  if (e < LL) {
    if (e % L <= e / L)
      for (int h = 0; h < H; ++h) s += dcb_h[(bc * H + h) * LL + e];
    dcb[bc * LL + e] = s;
  } else if (e < LL + LG) {
    const int64_t f = e - LL;
    for (int h = 0; h < H; ++h) s += g_h[(bc * H + h) * LG + f];
    gsum[bc * LG + f] = s;
  }
}

// 5. dC and dB of 16 steps of a chunk: dC_i = Σ_j d(CBᵀ)_ij B_j + the heads'
// Σ dC share, dB_j = Σ_i d(CBᵀ)_ij C_i + their Σ dB share; warp w the
// 8-column tiles w, w + 4, ...
constexpr int kBcThreads = 128;

__global__ void __launch_bounds__(kBcThreads)
dbc_kernel(const float* __restrict__ dcb, const float* __restrict__ gsum,
           const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ dB,
           float* __restrict__ dC, int S, int N, int L, int64_t b_sb, int64_t b_ss, int64_t c_sb,
           int64_t c_ss) {
  const int rt = blockIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * rt, nt = (N + 7) / 8, mine = (nt - w + 3) / 4;
  const int64_t t0 = static_cast<int64_t>(c) * L;
  const int64_t bc = static_cast<int64_t>(b) * nc + c;
  const float* d = dcb + bc * L * L;
  const float* gs = gsum + bc * L * 2 * N;
  const float* bg = Bm + b * b_sb + t0 * b_ss;
  const float* cg = Cm + b * c_sb + t0 * c_ss;
  auto col = [&](int cc) { return 8 * (w + 4 * (cc >> 3)) + (cc & 7); };  // local -> state column
  constexpr int kQ = kMaxN / 8 / 4;
  float acc_c[kQ][4], acc_b[kQ][4];
  zero(acc_c);
  zero(acc_b);
  if (mine > 0) {
    gemm_3xtf32(acc_c, mine, 0, min(L, r0 + 16),
                [&](int r, int k) { return r0 + r < L && k < L ? d[(r0 + r) * L + k] : 0.f; },
                [&](int k, int n) {
                  const int cn = col(n);
                  return k < L && cn < N ? bg[k * b_ss + cn] : 0.f;
                }, lane);
    gemm_3xtf32(acc_b, mine, r0, L,
                [&](int r, int k) { return r0 + r < L && k < L ? d[k * L + r0 + r] : 0.f; },
                [&](int k, int n) {
                  const int cn = col(n);
                  return k < L && cn < N ? cg[k * c_ss + cn] : 0.f;
                }, lane);
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    if (q >= mine) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + g + 8 * (e >> 1), n = 8 * (w + 4 * q) + 2 * t4 + (e & 1);
      if (i >= L || n >= N) continue;
      const int64_t at = (static_cast<int64_t>(b) * S + t0 + i) * N + n;
      dC[at] = acc_c[q][e] + gs[i * 2 * N + n];
      dB[at] = acc_b[q][e] + gs[i * 2 * N + N + n];
    }
  }
}

// 6. dA[h] = Σ over batch rows and chunks of each chunk's share, in order.
__global__ void __launch_bounds__(kThreads)
da_kernel(const float* __restrict__ da_part, float* __restrict__ dA, int rows, int H) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += da_part[static_cast<int64_t>(r) * H + h];
  dA[h] = s;
}

}  // namespace

// x (B, S, H, P), dt (B, S, H), B/C (B, S, N): the forward's inputs, with
// (batch, seq) strides of x, dt, B, C in `strides` and x's head stride
// x_sh; A (H,); cb (B, nc, L, L), states (B, nc, H, P, N) and decay (B, nc,
// H): the forward's scratch (C·Bᵀ, the entering states, cs_L); dy (B, S,
// H, P) contiguous and 16-byte aligned; dfinal (B, H, P, N) contiguous or
// null.  Written: dx (B, S, H, P), ddt (B, S, H), dA (H,), dB and dC (B, S,
// N), all contiguous.  Scratch: dstates like states, dpart (B, nc, H,
// ceil(P N / 2048)), da_part (B, nc, H), dcb_h (B, nc, H, L, L), g_h (B, nc,
// H, L, 2N), dcb (B, nc, L, L), gsum (B, nc, L, 2N).  `aligned` as for the
// forward.  Returns cudaGetLastError().
extern "C" int repro_ssm_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                                  const void* Cm, const void* cb, const void* states,
                                  const void* decay, const void* dy, const void* dfinal,
                                  void* dx, void* ddt, void* dA, void* dB, void* dC,
                                  void* dstates, void* dpart, void* da_part, void* dcb_h,
                                  void* g_h, void* dcb, void* gsum, int B, int S, int H, int P,
                                  int N, int L, int aligned, const int64_t* strides,
                                  int64_t x_sh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P % 16 != 0 || P > kMaxP || N <= 0 ||
      N > kMaxN || N % 4 != 0 || L <= 0 || L > kMaxL || S % L != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t x_sb = strides[0], x_ss = strides[1], dt_sb = strides[2], dt_ss = strides[3];
  const int64_t b_sb = strides[4], b_ss = strides[5], c_sb = strides[6], c_ss = strides[7];
  const int nc = S / L, PN = P * N, ngroups = (PN + kGroup - 1) / kGroup;
  const int ptiles = (P + kPT - 1) / kPT, ntiles = (N + kNT - 1) / kNT;
  const bool vec = aligned != 0;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto* dst = static_cast<float*>(dstates);
  const int64_t dy_ss = static_cast<int64_t>(H) * P;

  size_t smem = state_smem_bytes();
  cudaError_t err = allow_smem(chunk_state_kernel<true>, smem);
  if (err != cudaSuccess) return err;
  chunk_state_kernel<true><<<dim3(nc, H * ptiles * ntiles, B), kThreads, smem, s>>>(
      f(dy), f(dt), f(A), f(Cm), dst, nullptr, H, P, N, L, vec, S * dy_ss, dy_ss, P, dt_sb,
      dt_ss, c_sb, c_ss);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  state_pass_bwd_kernel<<<dim3(ngroups, H, B), kThreads, 0, s>>>(
      dst, f(states), f(decay), f(dfinal), static_cast<float*>(dpart), nc, H, PN);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  smem = chunk_bwd_smem_bytes();
  if ((err = allow_smem(chunk_bwd_kernel, smem)) != cudaSuccess) return err;
  chunk_bwd_kernel<<<dim3(nc, H, B), kThreads, smem, s>>>(
      f(x), f(dt), f(A), f(Bm), f(Cm), f(dy), f(cb), f(states), dst, f(dpart), ngroups,
      static_cast<float*>(dx), static_cast<float*>(ddt), static_cast<float*>(da_part),
      static_cast<float*>(dcb_h), static_cast<float*>(g_h), S, H, P, N, L, vec, x_sb, x_ss, x_sh,
      dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t elems = static_cast<int64_t>(L) * L + static_cast<int64_t>(L) * 2 * N;
  head_sum_kernel<<<dim3(static_cast<unsigned>((elems + kThreads - 1) / kThreads), nc, B),
                    kThreads, 0, s>>>(f(dcb_h), f(g_h), static_cast<float*>(dcb),
                                      static_cast<float*>(gsum), H, L, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dbc_kernel<<<dim3((L + 15) / 16, nc, B), kBcThreads, 0, s>>>(
      f(dcb), f(gsum), f(Bm), f(Cm), static_cast<float*>(dB), static_cast<float*>(dC), S, N, L,
      b_sb, b_ss, c_sb, c_ss);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  da_kernel<<<(H + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      f(da_part), static_cast<float*>(dA), B * nc, H);
  return cudaGetLastError();
}
