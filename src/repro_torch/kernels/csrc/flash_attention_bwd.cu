// Backward of causal (optionally sliding-window) GQA prefill attention, for
// sm_90a.
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
// Design: three launches, FA2's split (FA3's dQ by atomics would make the
// gradients depend on the order the blocks finish in):
//   (a) Δ_i = Σ_d dO_id · O_id per (batch, head, row), f32, one warp a row;
//   (b) dK/dV: a block owns a key tile of one KV head and walks the G query
//       heads of that KV head and, for each, the query tiles that the
//       causal limit and the window let see its keys.  Per tile it
//       recomputes Sᵀ = K Qᵀ and Pᵀ = exp(scale·Sᵀ - lse), then dV += Pᵀ dO,
//       dPᵀ = V dOᵀ, dSᵀ = Pᵀ ⊙ (dPᵀ - Δ) and dK += dSᵀ Q.  dK and dV stay
//       in registers across the G heads: each is written once, in k's
//       dtype, dK times scale;
//   (c) dQ: a block owns a query tile of one head and walks the key tiles
//       from the window's lower edge to the causal limit: S, P, dP = dO Vᵀ,
//       dS, and dQ += dS K; dQ = scale · dQ.
// No atomics: every output element has one owner, summed in a fixed order,
// so two calls give bit-equal gradients.
//
// bf16 at D 64 and 128 (every full-width model; hopper.cuh), on Hopper's
// warpgroup tensor cores: (a) is delta_lse_kernel, which also writes lse
// in log2 units; both it and Δ land in (B·H, S_pad) arrays padded with
// zeros to a multiple of 64 rows, so a tile's 64 values are one bulk copy.
// (b) dkdv_wgmma_kernel and (c) dq_wgmma_kernel have two consumer
// warpgroups and a producer warpgroup, one of whose threads keeps TMA
// loads in flight (setmaxnreg: 24 registers, the consumers 240).  In (b)
// a block owns 64 keys: both consumers form Pᵀ from Sᵀ = K Qᵀ, the first
// then adds dV += Pᵀ dO, the second forms dPᵀ = V dOᵀ and dSᵀ and adds
// dK += dSᵀ Q.  In (c) a block owns 128 query rows, 64 a consumer.  The
// block's own tiles (K and V in (b), Q and dO in (c)) load once; the
// streamed 64-row tiles (Q, dO, lse, Δ in (b), K and V in (c)) go round a
// two-stage ring with full and empty barriers.  Sᵀ, dPᵀ (b) and S, dP (c)
// are m64n64k16 wgmma chains with both operands K-major in shared memory;
// P and dS are formed in the accumulator registers, rounded to bf16 (the
// forward's one rounding, here twice; in (b) dSᵀ is formed from Pᵀ's bf16
// pairs, in their place) and are the register A operands of dV += Pᵀ dO,
// dK += dSᵀ Q and dQ += dS K, whose B operands (dO, Q, K in their natural
// (row, D) layout) are MN-major.  A warpgroup's 64 x D accumulator is
// spread over its 128 threads (64 registers a thread at D 128), so every
// column is computed in one pass.  Why (b) splits dV from dK: one
// warpgroup holding both (128 registers) beside the score tile and P
// leaves ptxas short of registers, and it then serialises every product
// (C7512) and spills the accumulators; Sᵀ twice costs a fifth more
// products instead.  The mask runs only on tiles the diagonal, the window
// or the ragged end cut; in (c) a consumer skips a tile none of its rows
// sees but still releases it.  At D 128 the shared memory is 96 KB (b) and
// 128 KB (c).
// bf16 at D 16 and 32 (smoke configs only, chosen by head dim: wgmma's
// 64-column swizzled boxes do not fit them): delta_kernel, then
// dkdv_mma_kernel and dq_mma_kernel on mma.sync m16n8k16 (mma.cuh): 64-row
// tiles, 4 warps of 16 rows, operands by ldmatrix from cp.async-staged
// tiles in two stages, a warp's 64 columns 32 at a time.
// float32 runs on the CUDA cores, as the forward's float32 kernel does
// (TF32 would break the 1e-4 tolerance): 32-row tiles in shared memory,
// each thread one key (or query) row and D / 4 of its columns.
// Operands are read through (batch, seq, head) strides, so the model
// layout needs no copy; every row must start on a 16-byte boundary.
#include "common.cuh"
#include "hopper.cuh"
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

// -- bf16 at D 64 and 128: TMA, wgmma, warp specialisation --------------------

constexpr int kWgBlock = 128;    // query rows of a dQ block: 64 a consumer
constexpr int kWgStream = 64;    // rows of a streamed tile (query rows in dK/dV, keys in dQ),
                                 // and the keys of a dK/dV block
constexpr int kWgStages = 2;     // streamed tiles in flight
constexpr int kWgThreads = 384;  // two consumer warpgroups, then the producer's
constexpr int kBlockBox = kWgBlock * 128;    // bytes of a 64-column box of a dQ block's rows
constexpr int kStreamBox = kWgStream * 128;  // and of a streamed tile's

// Rows of the padded (B·H, S_pad) float32 lse (log2 units) and Δ arrays
// that delta_lse_kernel writes: S rounded up to a streamed tile, so a
// tile's 64 values are one 256-byte bulk copy.
__host__ __device__ constexpr int padded_rows(int S) {
  return (S + kWgStream - 1) / kWgStream * kWgStream;
}

// Δ_i = Σ_d dO_id · O_id and lse_i · log2(e) of each (batch, head, row),
// zero in the padding.  A row is D / 8 lanes of one 16-byte load each from
// O and dO, so a warp takes 256 / D rows at once and every lane loads.
template <int D>
__global__ void __launch_bounds__(256)
delta_lse_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ lse2,
                 float* __restrict__ delta, int64_t rows, int S, int H, Layout L) {
  constexpr int kLanes = D / 8;  // lanes a row
  const int sub = threadIdx.x % kLanes;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (256 / kLanes) + threadIdx.x / kLanes;
  const int S_pad = padded_rows(S);
  const int s = static_cast<int>(row % S_pad);
  const int64_t bh = row / S_pad;
  float acc = 0.f;
  if (row < rows && s < S) {
    const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
    float x[8], y[8];
    unpack(*reinterpret_cast<const uint4*>(row_of(o, L, kO, b, s, h) + 8 * sub), x,
           __nv_bfloat16());
    unpack(*reinterpret_cast<const uint4*>(row_of(dout, L, kDO, b, s, h) + 8 * sub), y,
           __nv_bfloat16());
#pragma unroll
    for (int e = 0; e < 8; ++e) acc += x[e] * y[e];
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(kFullMask, acc, off);
  if (row < rows && sub == 0) {
    delta[row] = acc;  // 0 in the padding
    lse2[row] = s < S ? lse[bh * S + s] * kLog2e : 0.f;
  }
}

struct WgmmaArgs {
  const float* lse2;   // (B·H, S_pad), log2 units
  const float* delta;  // (B·H, S_pad)
  __nv_bfloat16 *dq, *dk, *dv;
  Layout L;
  int S, H, G, window;
  float scale, scale_log2;
};

// Store 16 rows of the warp, D columns of scale * acc (the accumulator
// layout of an m64nD product), as bf16 pairs; rows at or past S skipped.
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* base, int64_t row_stride, int row,
                                          int S, const float (&acc)[D / 2], float scale,
                                          int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= S) continue;
    __nv_bfloat16* out = base + static_cast<int64_t>(row + 8 * r) * row_stride + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

// Pᵀ in place of Sᵀ (an m64n64 accumulator: this thread's keys k and k + 8,
// query column c0 - q0 + 8j + e % 2 in register 4j + e, c0 = the tile's
// first query + 2t): exp2(s · scale_log2 - lse2[column]), or 0 where the
// key lies past the query, the query past S, or the key below the
// query's window (kMasked only).
template <bool kMasked>
__device__ __forceinline__ void probs_t(float (&st)[kWgStream / 2], const float* lse2,
                                        float scale_log2, int k, int c0, int t4, int S,
                                        int window) {
#pragma unroll
  for (int j = 0; j < kWgStream / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = fast_exp2(fmaf(st[4 * j + e], scale_log2, -lse2[8 * j + 2 * t4 + (e & 1)]));
      if (kMasked) {
        const int kj = k + 8 * (e >> 1), qi = c0 + 8 * j + (e & 1);
        st[4 * j + e] = kj <= qi && qi < S && (window <= 0 || kj > qi - window) ? x : 0.f;
      } else {
        st[4 * j + e] = x;
      }
    }
}

template <int D>
struct DkdvSmem {
  static constexpr int kChunks = D / 64;
  alignas(1024) __nv_bfloat16 k[kChunks][kWgStream * 64];
  __nv_bfloat16 v[kChunks][kWgStream * 64];
  __nv_bfloat16 q[kWgStages][kChunks][kWgStream * 64];
  __nv_bfloat16 dout[kWgStages][kChunks][kWgStream * 64];
  float lse2[kWgStages][kWgStream];
  float delta[kWgStages][kWgStream];
  uint64_t kv_full, full[kWgStages], empty[kWgStages];
};

// dK/dV: a block owns 64 keys of one KV head and walks the G query heads
// and, for each, the 64-row query tiles that see its keys, streamed by the
// producer.  The two consumer warpgroups split the outputs: both form
// Pᵀ = exp2(scale·log2e·Sᵀ - lse2) from Sᵀ = K Qᵀ (both operands in shared
// memory); the first adds dV += Pᵀ dO, the second forms dPᵀ = V dOᵀ and
// dSᵀ = Pᵀ ⊙ (dPᵀ - Δ) and adds dK += dSᵀ Q (Pᵀ and dSᵀ as register A
// operands, dO and Q MN-major).  Each then holds one 64 x D accumulator
// (64 registers a thread at D 128) beside one 64 x 64 score tile: a
// warpgroup that held both dK and dV would leave ptxas short of registers
// (it serialises every product), and Sᵀ twice costs a fifth more products.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap domap, const WgmmaArgs a) {
  using Smem = DkdvSmem<D>;
  constexpr int kChunks = Smem::kChunks;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_1k(smem_raw));

  const int kt = blockIdx.z;  // the longest key tiles (the first) first
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = kt * kWgStream;
  const int S_pad = padded_rows(a.S);
  // the query tiles that see a key of the block: from its first key's (the
  // causal limit) to the one holding the last key's window edge
  const int k_last = min(k0 + kWgStream - 1, a.S - 1);
  const int qt_first = k0 / kWgStream;
  const int qt_last = a.window > 0 ? min((a.S - 1) / kWgStream, (k_last + a.window - 1) / kWgStream)
                                   : (a.S - 1) / kWgStream;
  const int nqt = qt_last - qt_first + 1;
  const int n_it = a.G * nqt;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);  // one arrival from each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == 2) {  // producer: one thread keeps the TMA loads in flight
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      prefetch_map(&qmap);
      prefetch_map(&domap);
      mbar_expect_tx(&sm.kv_full, 2 * kChunks * kStreamBox);
      for (int c = 0; c < kChunks; ++c) {
        tma_load_4d(sm.k[c], &kmap, &sm.kv_full, 64 * c, k0, kvh, b);
        tma_load_4d(sm.v[c], &vmap, &sm.kv_full, 64 * c, k0, kvh, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kWgStages;
        const int h = kvh * a.G + it / nqt, q0 = (qt_first + it % nqt) * kWgStream;
        const int64_t bh = (static_cast<int64_t>(b) * a.H + h) * S_pad;
        if (it >= kWgStages) mbar_wait(&sm.empty[s], (it / kWgStages - 1) & 1);
        mbar_expect_tx(&sm.full[s], 2 * kChunks * kStreamBox + 2 * kWgStream * 4);
        for (int c = 0; c < kChunks; ++c) {
          tma_load_4d(sm.q[s][c], &qmap, &sm.full[s], 64 * c, q0, h, b);
          tma_load_4d(sm.dout[s][c], &domap, &sm.full[s], 64 * c, q0, h, b);
        }
        bulk_load(sm.lse2[s], a.lse2 + bh + q0, kWgStream * 4, &sm.full[s]);
        bulk_load(sm.delta[s], a.delta + bh + q0, kWgStream * 4, &sm.full[s]);
      }
    }
  } else {  // consumers: warpgroup 0 makes dV, warpgroup 1 dK, of the block's 64 keys
    setmaxnreg_inc<240>();
    const bool makes_dk = wg == 1;
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int k_thread = k0 + 16 * warp + g;  // this thread's keys: k_thread, + 8
    const uint64_t k_desc = desc_k(smem_u32(sm.k[0]));
    const uint64_t v_desc = desc_k(smem_u32(sm.v[0]));

    float acc[D / 2], sc[kWgStream / 2];  // dV or dK; Sᵀ, then dPᵀ
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(&sm.kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kWgStages, q0 = (qt_first + it % nqt) * kWgStream;
      mbar_wait(&sm.full[s], (it / kWgStages) & 1);
      // every tile sees a key of the block: the query tiles run from the
      // diagonal's to the one holding the last key's window edge
      const uint32_t q_base = smem_u32(sm.q[s][0]), do_base = smem_u32(sm.dout[s][0]);
      const uint64_t q_k = desc_k(q_base), do_k = desc_k(do_base);
      zero_acc(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {  // Sᵀ = K Qᵀ
        const int c = kk / 4, w = (kk % 4) * 32;
        wgmma_ss<kWgStream>(sc, desc_add(k_desc, c * kStreamBox + w),
                            desc_add(q_k, c * kStreamBox + w), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // Pᵀ, rounded to bf16 at once, masked only where the diagonal,
      // the ragged end or the window cuts the tile
      const float* ls = sm.lse2[s];
      if (q0 < k0 + 63 || q0 + kWgStream > a.S ||
          (a.window > 0 && q0 + kWgStream - 1 - k0 >= a.window))
        probs_t<true>(sc, ls, a.scale_log2, k_thread, q0 + 2 * t4, t4, a.S, a.window);
      else
        probs_t<false>(sc, ls, a.scale_log2, k_thread, q0 + 2 * t4, t4, a.S, a.window);
      uint32_t p[kWgStream / 16][4];
#pragma unroll
      for (int kk = 0; kk < kWgStream / 16; ++kk) a_from_acc(p[kk], sc, kk);

      if (makes_dk) {
        zero_acc(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {  // dPᵀ = V dOᵀ
          const int c = kk / 4, w = (kk % 4) * 32;
          wgmma_ss<kWgStream>(sc, desc_add(v_desc, c * kStreamBox + w),
                              desc_add(do_k, c * kStreamBox + w), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        // dSᵀ = Pᵀ ⊙ (dPᵀ - Δ), from Pᵀ's bf16 pairs and in their place
        const float* dl = sm.delta[s];
#pragma unroll
        for (int kk = 0; kk < kWgStream / 16; ++kk)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            // register c of the A fragment: accumulator block 2kk + c / 2, row half c % 2
            const int i = 4 * (2 * kk + c / 2) + 2 * (c % 2);
            const int col = 8 * (2 * kk + c / 2) + 2 * t4;
            const float2 pv = unpack_bf16(p[kk][c]);
            p[kk][c] = pack_bf16(pv.x * (sc[i] - dl[col]), pv.y * (sc[i + 1] - dl[col + 1]));
          }
      }
      // dV += Pᵀ dO, or dK += dSᵀ Q: the B operand MN-major
      const uint64_t b_mn = desc_mn(makes_dk ? q_base : do_base, kStreamBox);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgStream / 16; ++kk)
        wgmma_rs<D>(acc, p[kk], desc_add(b_mn, kk * 2048), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);  // this warp is done with the stage
    }
    const Layout& L = a.L;
    if (makes_dk)
      store_acc<D>(row_of(a.dk, L, kDK, b, 0, kvh), L.s[kDK][1], k_thread, a.S, acc, a.scale,
                   t4);
    else
      store_acc<D>(row_of(a.dv, L, kDV, b, 0, kvh), L.s[kDV][1], k_thread, a.S, acc, 1.f, t4);
  }
}

// dS in place of dP (m64n64 accumulators: this thread's rows r and r + 8,
// key k0 + 8j + e % 2 in register 4j + e, k0 = the tile's first key + 2t):
// exp2(s · scale_log2 - l2[row]) (dP - Δ[row]), or 0 where the key lies
// past the row, past S or below the row's window, or the row past S
// (kMasked only).
template <bool kMasked>
__device__ __forceinline__ void grads_s(const float (&sc)[kWgStream / 2],
                                        float (&dp)[kWgStream / 2], const float (&l2)[2],
                                        const float (&dl)[2], float scale_log2, int r, int k0,
                                        int S, int window) {
#pragma unroll
  for (int j = 0; j < kWgStream / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float x = fast_exp2(fmaf(sc[4 * j + e], scale_log2, -l2[h])) * (dp[4 * j + e] - dl[h]);
      if (kMasked) {
        const int qi = r + 8 * h, kj = k0 + 8 * j + (e & 1);
        dp[4 * j + e] = kj <= qi && qi < S && kj < S && (window <= 0 || kj > qi - window) ? x : 0.f;
      } else {
        dp[4 * j + e] = x;
      }
    }
}

template <int D>
struct DqSmem {
  static constexpr int kChunks = D / 64;
  alignas(1024) __nv_bfloat16 q[kChunks][kWgBlock * 64];
  __nv_bfloat16 dout[kChunks][kWgBlock * 64];
  __nv_bfloat16 k[kWgStages][kChunks][kWgStream * 64];
  __nv_bfloat16 v[kWgStages][kChunks][kWgStream * 64];
  uint64_t q_full, full[kWgStages], empty[kWgStages];
};

// dQ: a block owns 128 query rows of one head (64 a consumer warpgroup)
// and walks the 64-key tiles from the window's lower edge to the causal
// limit, streamed by the producer.  Per tile: S = Q Kᵀ and dP = dO Vᵀ
// (both operands in shared memory), dS = P ⊙ (dP - Δ) in registers, and
// dQ += dS K with dS as the register A operand and K MN-major.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap domap, const WgmmaArgs a) {
  using Smem = DqSmem<D>;
  constexpr int kChunks = Smem::kChunks;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_1k(smem_raw));

  const int qt = gridDim.z - 1 - blockIdx.z;  // the longest query tiles first
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / a.G;
  const int q0 = qt * kWgBlock;
  const int kv_first = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int t_first = kv_first / kWgStream;
  const int n_tiles = (min(q0 + kWgBlock, a.S) - 1) / kWgStream - t_first + 1;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == 2) {  // producer: one thread keeps the TMA loads in flight
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      mbar_expect_tx(&sm.q_full, 2 * kChunks * kBlockBox);
      for (int c = 0; c < kChunks; ++c) {
        tma_load_4d(sm.q[c], &qmap, &sm.q_full, 64 * c, q0, h, b);
        tma_load_4d(sm.dout[c], &domap, &sm.q_full, 64 * c, q0, h, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kWgStages, k_start = (t_first + i) * kWgStream;
        if (i >= kWgStages) mbar_wait(&sm.empty[s], (i / kWgStages - 1) & 1);
        mbar_expect_tx(&sm.full[s], 2 * kChunks * kStreamBox);
        for (int c = 0; c < kChunks; ++c) {
          tma_load_4d(sm.k[s][c], &kmap, &sm.full[s], 64 * c, k_start, kvh, b);
          tma_load_4d(sm.v[s][c], &vmap, &sm.full[s], 64 * c, k_start, kvh, b);
        }
      }
    }
  } else {  // consumers: 64 query rows each
    setmaxnreg_inc<240>();
    const int cw = wg;
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int row0 = q0 + 64 * cw, row_last = row0 + 63;
    const int r_thread = row0 + 16 * warp + g;  // this thread's rows: r_thread, + 8
    const uint64_t q_desc = desc_k(smem_u32(sm.q[0]) + cw * 64 * 128);
    const uint64_t do_desc = desc_k(smem_u32(sm.dout[0]) + cw * 64 * 128);
    const int64_t bh = (static_cast<int64_t>(b) * a.H + h) * padded_rows(a.S);
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r_thread + 8 * r;
      l2[r] = qi < a.S ? a.lse2[bh + qi] : 0.f;
      dl[r] = qi < a.S ? a.delta[bh + qi] : 0.f;
    }

    float dq[D / 2], sc[kWgStream / 2], dp[kWgStream / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kWgStream / 2; ++i) sc[i] = dp[i] = 0.f;

    mbar_wait(&sm.q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kWgStages, k_start = (t_first + i) * kWgStream;
      mbar_wait(&sm.full[s], (i / kWgStages) & 1);
      const bool dead = row0 >= a.S || k_start > row_last ||
                        (a.window > 0 && k_start + kWgStream - 1 + a.window <= row0);
      if (!dead) {
        const uint32_t k_base = smem_u32(sm.k[s][0]);
        const uint64_t k_k = desc_k(k_base), k_mn = desc_mn(k_base, kStreamBox);
        const uint64_t v_k = desc_k(smem_u32(sm.v[s][0]));
        zero_acc(sc);
        zero_acc(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {  // S = Q Kᵀ
          const int c = kk / 4, w = (kk % 4) * 32;
          wgmma_ss<kWgStream>(sc, desc_add(q_desc, c * kBlockBox + w),
                              desc_add(k_k, c * kStreamBox + w), 1);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {  // dP = dO Vᵀ
          const int c = kk / 4, w = (kk % 4) * 32;
          wgmma_ss<kWgStream>(dp, desc_add(do_desc, c * kBlockBox + w),
                              desc_add(v_k, c * kStreamBox + w), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        if (k_start + kWgStream - 1 > row0 || k_start + kWgStream > a.S || row0 + 64 > a.S ||
            (a.window > 0 && k_start + a.window <= row_last))
          grads_s<true>(sc, dp, l2, dl, a.scale_log2, r_thread, k_start + 2 * t4, a.S, a.window);
        else
          grads_s<false>(sc, dp, l2, dl, a.scale_log2, r_thread, k_start + 2 * t4, a.S, a.window);
        uint32_t ds[kWgStream / 16][4];
#pragma unroll
        for (int kk = 0; kk < kWgStream / 16; ++kk) a_from_acc(ds[kk], dp, kk);
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgStream / 16; ++kk)  // dQ += dS K
          wgmma_rs<D>(dq, ds[kk], desc_add(k_mn, kk * 2048), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }
    const Layout& L = a.L;
    store_acc<D>(row_of(a.dq, L, kDQ, b, 0, h), L.s[kDQ][1], r_thread, a.S, dq, a.scale, t4);
  }
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
cudaError_t launch_wgmma(const Args& a) {
  using bf16 = __nv_bfloat16;
  const int G = a.H / a.KV, S_pad = padded_rows(a.S);
  const Layout& L = a.L;
  // the padded lse (log2 units) and Δ, in the caller's scratch
  float* lse2 = a.delta;
  float* delta = a.delta + static_cast<int64_t>(a.B) * a.H * S_pad;
  const int64_t rows = static_cast<int64_t>(a.B) * a.H * S_pad;
  constexpr int kRowsPerBlock = 256 / (D / 8);
  delta_lse_kernel<D><<<static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock), 256,
                        0, a.stream>>>(static_cast<const bf16*>(a.o),
                                       static_cast<const bf16*>(a.dout), a.lse, lse2, delta,
                                       rows, a.S, a.H, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // tensor maps: Q and dO in the dQ block's rows (128) and in streamed
  // tiles (64), K and V in streamed tiles (also the dK/dV block's 64 keys)
  CUtensorMap q_blk, q_str, k_str, v_str, do_blk, do_str;
  auto map = [&](CUtensorMap* m, const void* p, int t, int heads, int rows) {
    return bf16_map(m, p, D, a.S, heads, a.B, L.s[t][0], L.s[t][1], L.s[t][2], rows);
  };
  if (!map(&q_blk, a.q, kQ, a.H, kWgBlock) || !map(&q_str, a.q, kQ, a.H, kWgStream) ||
      !map(&k_str, a.k, kK, a.KV, kWgStream) || !map(&v_str, a.v, kV, a.KV, kWgStream) ||
      !map(&do_blk, a.dout, kDO, a.H, kWgBlock) || !map(&do_str, a.dout, kDO, a.H, kWgStream))
    return cudaErrorInvalidValue;
  const WgmmaArgs w{lse2, delta, static_cast<bf16*>(a.dq), static_cast<bf16*>(a.dk),
                    static_cast<bf16*>(a.dv), L, a.S, a.H, G, a.window, a.scale,
                    a.scale * kLog2e};
  const size_t dkdv_smem = sizeof(DkdvSmem<D>) + 1024;
  if ((err = allow_smem(dkdv_wgmma_kernel<D>, dkdv_smem)) != cudaSuccess) return err;
  dkdv_wgmma_kernel<D><<<dim3(a.KV, a.B, (a.S + kWgStream - 1) / kWgStream), kWgThreads,
                         dkdv_smem, a.stream>>>(q_str, k_str, v_str, do_str, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t dq_smem = sizeof(DqSmem<D>) + 1024;
  if ((err = allow_smem(dq_wgmma_kernel<D>, dq_smem)) != cudaSuccess) return err;
  dq_wgmma_kernel<D><<<dim3(a.H, a.B, (a.S + kWgBlock - 1) / kWgBlock), kWgThreads, dq_smem,
                       a.stream>>>(q_blk, k_str, v_str, do_blk, w);
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
// aligned.  lse: the forward's, contiguous float32 (B, H, S); delta:
// float32 scratch of 2·B·H·S_pad values (S_pad: S rounded up to 64),
// written here.  window <= 0 means no sliding window.
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
    switch (D) {  // the wgmma kernels at 64 and 128, mma.sync at 16 and 32 (smoke configs)
      case 16: return launch_mma<16>(a);
      case 32: return launch_mma<32>(a);
      case 64: return launch_wgmma<64>(a);
      case 128: return launch_wgmma<128>(a);
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
