// Backward of causal (optionally sliding-window) GQA prefill attention, for
// sm_90a, FA2-style.
//
// Replaces: the gradient the JAX package takes of its attention in training
// (jnp autodiff; src/repro/kernels/flash_attention.py, flash_attention_bhsd,
// has no VJP of its own).  The forward kernel (flash_attention.cu) writes
// each query row's log-sum-exp; this file recomputes P from it a tile at a
// time and never holds an (S, S) matrix.
//
// What bounds it on the H100: 10*D flops for every causally live (query,
// key) pair (Q·Kᵀ recomputed, dO·Vᵀ, Pᵀ·dO, dS·K, dSᵀ·Q) against q, k, v,
// o, dO read and dq, dk, dv written once.  At the training cell (4 x 1024
// tokens, 32 heads over 8 KV heads, D 128) that is 86 GFLOP, 0.087 ms of
// bf16 tensor cores, against 0.05 ms of bytes: the products bound it.
//
// Three launches:
//   (a) delta_kernel: Δ_i = Σ_d dO_id · O_id per (batch, head, row), f32,
//       one warp a row;
//   (b) dK/dV: one block per (64-key tile, KV head, batch), 4 warps of 16
//       keys.  The block walks the G query heads of its KV head and, for
//       each, the 64-row query tiles that the causal limit and the window
//       let see its keys (Q, dO, lse and Δ in two cp.async stages, the next
//       in flight while the current is computed).  Per tile it recomputes
//       Sᵀ = K Qᵀ and Pᵀ = exp(scale·Sᵀ - lse), then dV += Pᵀ dO, dPᵀ = V dOᵀ,
//       dSᵀ = Pᵀ ⊙ (dPᵀ - Δ) and dK += dSᵀ Q.  dK and dV stay in registers
//       across the G heads, so no atomics: each is written once, in k's
//       dtype, dK times scale;
//   (c) dQ: one block per (64-row query tile, head, batch), 4 warps of 16
//       rows, walking the key tiles up to the causal limit (K and V in two
//       stages): S, P, dP = dO Vᵀ, dS, and dQ += dS K; dQ = scale · dQ.
// The result is deterministic: every output element has one owner, summed
// in a fixed order.
//
// bf16 runs every product on mma.sync m16n8k16 (mma.cuh), as the forward
// does: A fragments of K, V, Q and dO by ldmatrix from the staged tiles, P
// and dS rounded to bf16 in registers as A operands (the forward's one
// rounding, here twice), B fragments by ldmatrix or ldmatrix.trans; a
// warp takes its 64 columns 32 at a time, so its dK and dV accumulators
// (2 x 64 floats a thread at D 128) fit beside the scores.  The mask runs
// only on tiles the diagonal, the window or the ragged end cut.
// float32 runs on the CUDA cores, as the forward's float32 kernel does
// (TF32 would break the 1e-4 tolerance): 32-row tiles in shared memory,
// each thread one key (or query) row and D / 4 of its columns.
// Operands are read through (batch, seq, head) strides, so the model
// layout needs no copy; every row must start on a 16-byte boundary.
#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace repro;

// (batch, seq, head) element strides of q, k, v, o, dO, dq, dk, dv
enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV, kOperands };
struct Layout {
  int64_t s[kOperands][3];
};

template <typename T>
__device__ __forceinline__ T* row_of(T* base, const Layout& L, int t, int b, int64_t s, int h) {
  return base + b * L.s[t][0] + s * L.s[t][1] + h * L.s[t][2];
}

// -- (a) Δ = rowsum(dO ⊙ O) --------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             int64_t rows, int S, int H, int D, Layout L) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps: the row is the warp's
  const int s = static_cast<int>(row % S);
  const int h = static_cast<int>(row / S % H);
  const int b = static_cast<int>(row / S / H);
  const T* orow = row_of(o, L, kO, b, s, h);
  const T* drow = row_of(dout, L, kDO, b, s, h);
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += to_float(orow[d]) * to_float(drow[d]);
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// -- bf16: tensor-core kernels ------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16 * kWarps;  // keys (dK/dV) or query rows (dQ) a block; 64-wide tiles
constexpr int kHalf = 32;           // columns a warp takes per pass

template <int D>
constexpr size_t bwd_mma_smem_bytes() {
  // two fixed tiles, two stages of two streamed tiles, two stages of lse and Δ
  return sizeof(__nv_bfloat16) * kLd<D> * 6 * kTile + sizeof(float) * 4 * kTile;
}

// `rows` rows of a [*][D] bf16 tile by 16-byte cp.async into dst ([rows][kLd]),
// rows at or past S zero-filled.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                           int64_t row_stride, int r0, int S) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks, d0 = (c % kChunks) * 8, row = r0 + r;
    const int64_t src_row = row < S ? row : 0;
    cp_async_16(dst + r * kLd<D> + d0, base + src_row * row_stride + d0, row < S);
  }
}

// kTile floats of a (B, H, S) float32 array from row r0 into dst, zero past S
__device__ __forceinline__ void stage_row_floats(float* dst, const float* src, int r0, int S) {
  const int r = threadIdx.x;
  if (r < kTile) cp_async_4(dst + r, src + (r0 + r < S ? r0 + r : 0), r0 + r < S);
}

// A fragment (16 rows x 16 of the k dim, from kk * 16) of a staged tile
template <int D>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const __nv_bfloat16* tile, int row0,
                                       int kk, int lane) {
  ldsm_x4(a, tile + (row0 + (lane & 15)) * kLd<D> + kk * 16 + (lane >> 4) * 8);
}

// acc[n] (kHalf / 8 blocks of 8 columns) += A(16 rows of `arows` from row a0)
// · Bᵀ, where B's rows are the staged tile `brows` from row b0 (kHalf rows;
// the k dim is D): scores of 16 rows against kHalf columns.
template <int D>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[kHalf / 8][4],
                                              const __nv_bfloat16* arows, int a0,
                                              const __nv_bfloat16* brows, int b0, int lane) {
  constexpr int LD = kLd<D>;
  const __nv_bfloat16* bp =
      brows + (b0 + (lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    a_frag<D>(a, arows, a0, kk, lane);
#pragma unroll
    for (int np = 0; np < kHalf / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, bp + np * 16 * LD + kk * 16);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// out[D / 8] += X · R, X the 16 x kHalf accumulator tile x (rounded to bf16
// as the A operand), R the staged tile `rrows` from row r0 (kHalf rows of D)
template <int D>
__device__ __forceinline__ void acc_times_rows(float (&out)[D / 8][4],
                                               const float (&x)[kHalf / 8][4],
                                               const __nv_bfloat16* rrows, int r0, int lane) {
  constexpr int LD = kLd<D>;
  const __nv_bfloat16* rp =
      rrows + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kHalf / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, rp + kk * 16 * LD + dp * 16);
      mma_bf16(out[2 * dp], a, b[0], b[1]);
      mma_bf16(out[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// Write 16 rows x D of scale * acc as bf16 pairs to rows row0 + (g, g + 8)
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, int64_t row_stride, int row0,
                                           int S, const float (&acc)[D / 8][4], float scale,
                                           int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* out = base + static_cast<int64_t>(row) * row_stride + 2 * t4;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<uint32_t*>(out + nb * 8) =
          pack_bf16(acc[nb][2 * r] * scale, acc[nb][2 * r + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int H,
                int G, Layout L, float scale, float scale_log2, int window) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = kLd<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kTile][LD]
  bf16* vs = ks + kTile * LD;                    // [kTile][LD]
  bf16* qs = vs + kTile * LD;                    // [2][kTile][LD]
  bf16* ds = qs + 2 * kTile * LD;                // [2][kTile][LD] of dO
  float* ls = reinterpret_cast<float*>(ds + 2 * kTile * LD);  // [2][kTile] lse
  float* dl = ls + 2 * kTile;                                 // [2][kTile] Δ

  const int kt = blockIdx.z;  // the longest key tiles (the first) first
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = kt * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;

  stage_rows<D>(ks, row_of(k, L, kK, b, 0, kvh), L.s[kK][1], k0, S);
  stage_rows<D>(vs, row_of(v, L, kV, b, 0, kvh), L.s[kV][1], k0, S);
  // the query tiles that see a key of this tile: from its own (causal) to
  // the one holding the last key's window edge
  const int k_last = min(k0 + kTile - 1, S - 1);
  const int qt_last = window > 0 ? min((S - 1) / kTile, (k_last + window - 1) / kTile)
                                 : (S - 1) / kTile;
  const int nqt = qt_last - kt + 1;
  const int n_it = G * nqt;
  auto issue = [&](int stage, int it) {
    const int h = kvh * G + it / nqt, q0 = (kt + it % nqt) * kTile;
    stage_rows<D>(qs + stage * kTile * LD, row_of(q, L, kQ, b, 0, h), L.s[kQ][1], q0, S);
    stage_rows<D>(ds + stage * kTile * LD, row_of(dout, L, kDO, b, 0, h), L.s[kDO][1], q0, S);
    const int64_t bh = (static_cast<int64_t>(b) * H + h) * S;
    stage_row_floats(ls + stage * kTile, lse + bh, q0, S);
    stage_row_floats(dl + stage * kTile, delta + bh, q0, S);
  };
  issue(0, 0);
  cp_async_commit();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nb][e] = dva[nb][e] = 0.f;

  const int kr0 = warp * 16;  // the warp's keys in the tile
  for (int it = 0, stage = 0; it < n_it; ++it, stage ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // tile `it` landed; every warp is done with tile it - 1
    if (it + 1 < n_it) issue(stage ^ 1, it + 1);  // in flight while `it` computes
    cp_async_commit();
    const int q0 = (kt + it % nqt) * kTile;
    const bf16* qt = qs + stage * kTile * LD;
    const bf16* dot = ds + stage * kTile * LD;
    const float* lt = ls + stage * kTile;
    const float* dlt = dl + stage * kTile;
    const bool masked = q0 == k0 || q0 + kTile > S ||
                        (window > 0 && q0 + kTile - 1 - k0 >= window);
#pragma unroll
    for (int half = 0; half < kTile / kHalf; ++half) {
      const int c0 = half * kHalf;  // this pass's query columns in the tile
      float p[kHalf / 8][4], dp[kHalf / 8][4];
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = dp[j][e] = 0.f;
      rows_dot_rows<D>(p, ks, kr0, qt, c0, lane);    // Sᵀ = K Qᵀ
      rows_dot_rows<D>(dp, vs, kr0, dot, c0, lane);  // dPᵀ = V dOᵀ
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + 2 * t4 + (e & 1);
          const int kj = k0 + kr0 + g + 8 * (e >> 1), qi = q0 + col;
          const bool ok = !masked || (kj <= qi && qi < S && (window <= 0 || kj > qi - window));
          const float pv = ok ? exp2f(p[j][e] * scale_log2 - lt[col] * kLog2e) : 0.f;
          p[j][e] = pv;
          dp[j][e] = pv * (dp[j][e] - dlt[col]);  // dSᵀ
        }
      }
      acc_times_rows<D>(dva, p, dot, c0, lane);  // dV += Pᵀ dO
      acc_times_rows<D>(dka, dp, qt, c0, lane);  // dK += dSᵀ Q
    }
  }
  store_rows<D>(row_of(dk, L, kDK, b, 0, kvh), L.s[kDK][1], k0 + kr0, S, dka, scale, lane);
  store_rows<D>(row_of(dv, L, kDV, b, 0, kvh), L.s[kDV][1], k0 + kr0, S, dva, 1.f, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, int S, int H, int G, Layout L, float scale,
              float scale_log2, int window) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = kLd<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kTile][LD]
  bf16* ds = qs + kTile * LD;                    // [kTile][LD] of dO
  bf16* ks = ds + kTile * LD;                    // [2][kTile][LD]
  bf16* vs = ks + 2 * kTile * LD;                // [2][kTile][LD]

  const int qt = gridDim.z - 1 - blockIdx.z;  // the longest query tiles first
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / G;
  const int q0 = qt * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;

  stage_rows<D>(qs, row_of(q, L, kQ, b, 0, h), L.s[kQ][1], q0, S);
  stage_rows<D>(ds, row_of(dout, L, kDO, b, 0, h), L.s[kDO][1], q0, S);
  auto issue = [&](int stage, int t) {
    stage_rows<D>(ks + stage * kTile * LD, row_of(k, L, kK, b, 0, kvh), L.s[kK][1], t * kTile, S);
    stage_rows<D>(vs + stage * kTile * LD, row_of(v, L, kV, b, 0, kvh), L.s[kV][1], t * kTile, S);
  };
  const int kv_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_first = kv_first / kTile;
  issue(0, t_first);
  cp_async_commit();

  // the warp's rows' lse (in log2 units) and Δ
  const int r0 = q0 + warp * 16;
  const int64_t bh = (static_cast<int64_t>(b) * H + h) * S;
  float l2[2], dlr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + g + 8 * r;
    l2[r] = qi < S ? lse[bh + qi] * kLog2e : 0.f;
    dlr[r] = qi < S ? delta[bh + qi] : 0.f;
  }
  float dqa[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) dqa[nb][0] = dqa[nb][1] = dqa[nb][2] = dqa[nb][3] = 0.f;

  for (int t = t_first, stage = 0; t <= qt; ++t, stage ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // tile t landed (and Q, dO); every warp is done with tile t - 1
    if (t < qt) issue(stage ^ 1, t + 1);
    cp_async_commit();
    const bf16* kt = ks + stage * kTile * LD;
    const bf16* vt = vs + stage * kTile * LD;
    const int k_start = t * kTile;
    const bool masked = t == qt || k_start + kTile > S || q0 + kTile > S ||
                        (window > 0 && k_start + window <= q0 + kTile - 1);
#pragma unroll
    for (int half = 0; half < kTile / kHalf; ++half) {
      const int c0 = half * kHalf;  // this pass's keys in the tile
      float p[kHalf / 8][4], dp[kHalf / 8][4];
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = dp[j][e] = 0.f;
      rows_dot_rows<D>(p, qs, warp * 16, kt, c0, lane);   // S = Q Kᵀ
      rows_dot_rows<D>(dp, ds, warp * 16, vt, c0, lane);  // dP = dO Vᵀ
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, qi = r0 + g + 8 * r;
          const int kj = k_start + c0 + 8 * j + 2 * t4 + (e & 1);
          const bool ok = !masked || (kj <= qi && qi < S && kj < S &&
                                      (window <= 0 || kj > qi - window));
          const float pv = ok ? exp2f(p[j][e] * scale_log2 - l2[r]) : 0.f;
          dp[j][e] = pv * (dp[j][e] - dlr[r]);  // dS
        }
      }
      acc_times_rows<D>(dqa, dp, kt, c0, lane);  // dQ += dS K
    }
  }
  store_rows<D>(row_of(dq, L, kDQ, b, 0, h), L.s[kDQ][1], r0, S, dqa, scale, lane);
}

// -- float32: CUDA-core kernels -------------------------------------------------

constexpr int kF = 32;  // rows of a float32 tile

template <int D>
constexpr size_t bwd_f32_smem_bytes() {
  return sizeof(float) * (4 * kF * (D + 1) + 2 * kF * (kF + 1) + 2 * kF);
}

// kF rows of a [*][D] float32 operand into dst ([kF][D + 1]), zero past S
template <int D>
__device__ __forceinline__ void load_f32_rows(float* dst, const float* base, int64_t row_stride,
                                              int r0, int S) {
  for (int i = threadIdx.x; i < kF * D; i += kThreads) {
    const int r = i / D, d = i % D, row = r0 + r;
    dst[r * (D + 1) + d] = row < S ? base[static_cast<int64_t>(row) * row_stride + d] : 0.f;
  }
}

// a[r][c] = scale * Σ_d x[r][d] y[c][d] and b[r][c] = Σ_d u[r][d] w[c][d] for
// the kF x kF entries, kThreads at a time (a lane per column c)
template <int D, typename F>
__device__ __forceinline__ void pair_scores(const float* x, const float* y, const float* u,
                                            const float* w, F finish) {
  for (int e = threadIdx.x; e < kF * kF; e += kThreads) {
    const int r = e / kF, c = e % kF;
    float s = 0.f, t = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      s += x[r * (D + 1) + d] * y[c * (D + 1) + d];
      t += u[r * (D + 1) + d] * w[c * (D + 1) + d];
    }
    finish(r, c, s, t);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, int S, int H, int G, Layout L,
                float scale, int window) {
  constexpr int C = D / 4;  // columns a thread owns: (tid % 4) + 4c
  extern __shared__ float smem_f[];
  float* ks = smem_f;                 // [kF][D + 1]
  float* vs = ks + kF * (D + 1);
  float* qs = vs + kF * (D + 1);
  float* dos = qs + kF * (D + 1);
  float* pt = dos + kF * (D + 1);     // [kF][kF + 1] Pᵀ
  float* dst = pt + kF * (kF + 1);    // [kF][kF + 1] dSᵀ
  float* ls = dst + kF * (kF + 1);    // [kF]
  float* dl = ls + kF;                // [kF]

  const int kvh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kF;
  const int tid = threadIdx.x, row = tid / 4, col0 = tid % 4;
  load_f32_rows<D>(ks, row_of(k, L, kK, b, 0, kvh), L.s[kK][1], k0, S);
  load_f32_rows<D>(vs, row_of(v, L, kV, b, 0, kvh), L.s[kV][1], k0, S);
  float dka[C], dva[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dka[c] = dva[c] = 0.f;
  const int k_last = min(k0 + kF - 1, S - 1);
  const int q_end = window > 0 ? min(S - 1, k_last + window - 1) : S - 1;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const int64_t bh = (static_cast<int64_t>(b) * H + h) * S;
    for (int q0 = k0; q0 <= q_end; q0 += kF) {
      __syncthreads();  // the previous tile is consumed
      load_f32_rows<D>(qs, row_of(q, L, kQ, b, 0, h), L.s[kQ][1], q0, S);
      load_f32_rows<D>(dos, row_of(dout, L, kDO, b, 0, h), L.s[kDO][1], q0, S);
      if (tid < kF) {
        ls[tid] = q0 + tid < S ? lse[bh + q0 + tid] : 0.f;
        dl[tid] = q0 + tid < S ? delta[bh + q0 + tid] : 0.f;
      }
      __syncthreads();
      pair_scores<D>(ks, qs, vs, dos, [&](int r, int c, float s, float dpv) {
        const int kj = k0 + r, qi = q0 + c;
        const bool ok = kj <= qi && qi < S && (window <= 0 || kj > qi - window);
        const float p = ok ? expf(s * scale - ls[c]) : 0.f;
        pt[r * (kF + 1) + c] = p;
        dst[r * (kF + 1) + c] = p * (dpv - dl[c]);
      });
      __syncthreads();
      for (int c = 0; c < kF; ++c) {
        const float p = pt[row * (kF + 1) + c], dsv = dst[row * (kF + 1) + c];
#pragma unroll
        for (int j = 0; j < C; ++j) {
          dva[j] += p * dos[c * (D + 1) + col0 + 4 * j];
          dka[j] += dsv * qs[c * (D + 1) + col0 + 4 * j];
        }
      }
    }
  }
  const int kj = k0 + row;
  if (kj >= S) return;
  float* dkr = row_of(dk, L, kDK, b, kj, kvh);
  float* dvr = row_of(dv, L, kDV, b, kj, kvh);
#pragma unroll
  for (int j = 0; j < C; ++j) {
    dkr[col0 + 4 * j] = dka[j] * scale;
    dvr[col0 + 4 * j] = dva[j];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int S, int H, int G, Layout L, float scale, int window) {
  constexpr int C = D / 4;
  extern __shared__ float smem_f[];
  float* qs = smem_f;                 // [kF][D + 1]
  float* dos = qs + kF * (D + 1);
  float* ks = dos + kF * (D + 1);
  float* vs = ks + kF * (D + 1);
  float* dst = vs + kF * (D + 1);     // [kF][kF + 1] dS
  float* ls = dst + 2 * kF * (kF + 1);
  float* dl = ls + kF;

  const int h = blockIdx.x, b = blockIdx.y, q0 = blockIdx.z * kF, kvh = h / G;
  const int tid = threadIdx.x, row = tid / 4, col0 = tid % 4;
  const int64_t bh = (static_cast<int64_t>(b) * H + h) * S;
  load_f32_rows<D>(qs, row_of(q, L, kQ, b, 0, h), L.s[kQ][1], q0, S);
  load_f32_rows<D>(dos, row_of(dout, L, kDO, b, 0, h), L.s[kDO][1], q0, S);
  if (tid < kF) {
    ls[tid] = q0 + tid < S ? lse[bh + q0 + tid] : 0.f;
    dl[tid] = q0 + tid < S ? delta[bh + q0 + tid] : 0.f;
  }
  float dqa[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dqa[c] = 0.f;
  const int q_last = min(q0 + kF - 1, S - 1);
  const int k_first = window > 0 ? max(0, q0 - window + 1) / kF * kF : 0;
  for (int k0 = k_first; k0 <= q_last; k0 += kF) {
    __syncthreads();  // the previous tile is consumed (and the fixed ones written)
    load_f32_rows<D>(ks, row_of(k, L, kK, b, 0, kvh), L.s[kK][1], k0, S);
    load_f32_rows<D>(vs, row_of(v, L, kV, b, 0, kvh), L.s[kV][1], k0, S);
    __syncthreads();
    pair_scores<D>(qs, ks, dos, vs, [&](int r, int c, float s, float dpv) {
      const int qi = q0 + r, kj = k0 + c;
      const bool ok = kj <= qi && qi < S && kj < S && (window <= 0 || kj > qi - window);
      const float p = ok ? expf(s * scale - ls[r]) : 0.f;
      dst[r * (kF + 1) + c] = p * (dpv - dl[r]);
    });
    __syncthreads();
    for (int c = 0; c < kF; ++c) {
      const float dsv = dst[row * (kF + 1) + c];
#pragma unroll
      for (int j = 0; j < C; ++j) dqa[j] += dsv * ks[c * (D + 1) + col0 + 4 * j];
    }
  }
  const int qi = q0 + row;
  if (qi >= S) return;
  float* dqr = row_of(dq, L, kDQ, b, qi, h);
#pragma unroll
  for (int j = 0; j < C; ++j) dqr[col0 + 4 * j] = dqa[j] * scale;
}

// -- launch -------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, S, H, KV;
  Layout L;
  float scale;
  int window;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch_delta(const Args& a, int D) {
  const int64_t rows = static_cast<int64_t>(a.B) * a.H * a.S;
  delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, rows, a.S, a.H, D,
      a.L);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const Args& a) {
  using bf16 = __nv_bfloat16;
  cudaError_t err = launch_delta<bf16>(a, D);
  if (err != cudaSuccess) return err;
  const size_t smem = bwd_mma_smem_bytes<D>();
  const int G = a.H / a.KV, tiles = (a.S + kTile - 1) / kTile;
  const auto* q = static_cast<const bf16*>(a.q);
  const auto* k = static_cast<const bf16*>(a.k);
  const auto* v = static_cast<const bf16*>(a.v);
  const auto* d = static_cast<const bf16*>(a.dout);
  if ((err = allow_smem(dkdv_mma_kernel<D>, smem)) != cudaSuccess) return err;
  dkdv_mma_kernel<D><<<dim3(a.KV, a.B, tiles), kThreads, smem, a.stream>>>(
      q, k, v, d, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.S, a.H,
      G, a.L, a.scale, a.scale * kLog2e, a.window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(dq_mma_kernel<D>, smem)) != cudaSuccess) return err;
  dq_mma_kernel<D><<<dim3(a.H, a.B, tiles), kThreads, smem, a.stream>>>(
      q, k, v, d, a.lse, a.delta, static_cast<bf16*>(a.dq), a.S, a.H, G, a.L, a.scale,
      a.scale * kLog2e, a.window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a) {
  cudaError_t err = launch_delta<float>(a, D);
  if (err != cudaSuccess) return err;
  const size_t smem = bwd_f32_smem_bytes<D>();
  const int G = a.H / a.KV, tiles = (a.S + kF - 1) / kF;
  const auto* q = static_cast<const float*>(a.q);
  const auto* k = static_cast<const float*>(a.k);
  const auto* v = static_cast<const float*>(a.v);
  const auto* d = static_cast<const float*>(a.dout);
  if ((err = allow_smem(dkdv_f32_kernel<D>, smem)) != cudaSuccess) return err;
  dkdv_f32_kernel<D><<<dim3(a.KV, a.B, tiles), kThreads, smem, a.stream>>>(
      q, k, v, d, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.S,
      a.H, G, a.L, a.scale, a.window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(dq_f32_kernel<D>, smem)) != cudaSuccess) return err;
  dq_f32_kernel<D><<<dim3(a.H, a.B, tiles), kThreads, smem, a.stream>>>(
      q, k, v, d, a.lse, a.delta, static_cast<float*>(a.dq), a.S, a.H, G, a.L, a.scale,
      a.window);
  return cudaGetLastError();
}

}  // namespace

// q, dq (B, S, H, D); k, v, dk, dv (B, S, KV, D); o, dout like q: element
// strides in `strides`, 24 values, (batch, seq, head) of q, k, v, o, dout,
// dq, dk, dv in that order; the head dim contiguous and every row 16-byte
// aligned.  lse and delta: contiguous float32 (B, H, S), lse the forward's,
// delta scratch written here.  window <= 0 means no sliding window.
// Returns cudaGetLastError().
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv, int dtype,
                                         int B, int S, int H, int KV, int D,
                                         const int64_t* strides, float scale, int window,
                                         void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
         dq, dk, dv, B, S, H, KV, {}, scale, window, static_cast<cudaStream_t>(stream)};
  for (int t = 0; t < kOperands; ++t)
    for (int j = 0; j < 3; ++j) a.L.s[t][j] = strides[3 * t + j];
  if (dtype == kBFloat16) {
    switch (D) {
      case 16: return launch_mma<16>(a);
      case 32: return launch_mma<32>(a);
      case 64: return launch_mma<64>(a);
      case 128: return launch_mma<128>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == kFloat32) {
    switch (D) {
      case 16: return launch_f32<16>(a);
      case 32: return launch_f32<32>(a);
      case 64: return launch_f32<64>(a);
      case 128: return launch_f32<128>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}
