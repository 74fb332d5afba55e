// Causal (optionally sliding-window) prefill attention, GQA, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_bhsd
// (Pallas body _flash_kernel).
//
// What bounds it on the H100: at the engine's prompt lengths (S of a few
// hundred to a few thousand, head_dim 128) the work is 4*D flops for every
// causally live (query, key) pair against (q + k + v + o) bytes moved once,
// so it turns from memory-bound to compute-bound near S ~ 600 in bf16: at
// qwen3-8b's S = 512 the causal work is 2.15 GFLOP, 2.2 us at the bf16
// tensor cores' 989 TFLOP/s and 32 us at the CUDA cores' 67 in float32.
//
// Design: three kernels, by input type and head dim.
//
// bf16 at D 64 and 128 (flash_wgmma_kernel: every full-width model), on
// Hopper's warpgroup tensor cores, FA3-style (hopper.cuh):
//   * one block per (128-row query tile, head, batch): two consumer
//     warpgroups of 64 query rows each and a producer warpgroup, one of
//     whose threads issues the TMA loads; setmaxnreg moves registers
//     from the producer to the consumers (24 and 240);
//   * the producer loads the Q tile once and keeps 128-key K and V tiles
//     in flight in a ring of two stages, with full barriers (the TMA bytes)
//     and empty ones (an arrival from each consumer warp) for K and for V
//     apart, so a K stage refills as soon as its S is done; the model's
//     (B, S, H, D) layout is read in place through a 4-D tensor map (D, S,
//     heads, B) per operand, in 64-column boxes of 128 rows under the
//     128-byte swizzle (a D-128 row is two boxes); rows past S land as
//     zeros; at D 128 that is Q 32 KB, K and V 64 KB each, one block an SM;
//   * S = Q Kᵀ is one wgmma m64n128k16 chain with both operands in shared
//     memory (K-major); the online softmax runs in the accumulator
//     registers, one FFMA and one ex2 a score with scale * log2(e) folded
//     in, its row max and sum as trees; P is rounded to bf16 in registers
//     and is the A operand of O += P V, whose B operand is V in its natural
//     (key, D) layout through the MN-major descriptor: nothing is copied
//     from shared memory into registers (no ldmatrix);
//   * not FA3's overlaps: S of tile i beside P V of tile i - 1 in one
//     consumer needs S, O and P in flight at once, and ptxas then runs
//     short of registers and serialises every product; the two consumers
//     taking turns on the tensor cores (ping-pong) did not pay on the H100
//     at the main path's shapes, so they run side by side;
//   * the mask runs only where the diagonal (the last tile: query and key
//     tiles are both 128 wide and aligned, so key tile t == the query tile
//     holds the diagonal; for the first consumer only its left half is
//     live, for the second all of it) or the window's lower edge cuts the
//     tile; it sets a score to -inf, so a tile below a row's window adds
//     nothing to it; keys past S lie past the diagonal; the kv loop runs
//     from the window's lower edge to the causal limit, and the longest
//     query tiles go first.
// bf16 at D 16 and 32 (flash_mma_kernel: smoke configs only, chosen by
// head dim; wgmma's 64-column swizzled boxes do not fit them), FA2-style
// on mma.sync:
//   * one block per (64-row query tile, head, batch), 4 warps of 16 query
//     rows; a warp keeps its rows' Q fragments (ldmatrix), its online
//     softmax state and its output in registers;
//   * 64-key K and V tiles by 16-byte cp.async in two stages, rows padded
//     to D + 8 for conflict-free ldmatrix, rows past S zero-filled;
//   * S = Q K^T and O += P V as mma.sync m16n8k16 (attend_tile_mma in
//     mma.cuh), P rounded to bf16 in registers as the A operand of P V;
//     the mask on the diagonal tile and the window's edge only.
// P rounded to bf16 before P V is the one rounding the float32 reference
// lacks in both bf16 kernels; bf16 x bf16 products summed in f32 are what
// the Pallas kernel's upcast-then-f32 dot computes.
//
// float32 (flash_attention_kernel), on the CUDA cores, as first written:
//   TF32 tensor cores would keep about three decimal digits, past the 1e-4
//   float32 tolerance, and would break the token parity between the CPU's
//   plain path and the card that the float32 smoke configs check.
//   * one block per (query tile of 32 rows, head, batch); 4 warps, each
//     owning 8 query rows end to end (scores, online softmax, P.V), so the
//     softmax state never leaves registers and needs no block barrier;
//   * one lane per key of a 32-key tile: a lane computes its key's score
//     for the warp's 8 rows, the row max/sum are warp shuffles, and the P.V
//     update broadcasts each lane's probability with __shfl_sync;
//   * K/V rows move as 16-byte chunks, the next tile's loaded into
//     registers while the current one is computed, and are staged in
//     shared memory as float32 (the K rows padded by one word so lanes
//     reading different keys hit different banks);
//   * the kv loop bounds and the ragged tail as in the bf16 kernel.
//
// All read q/k/v/o through the strides the wrapper passes, so the model's
// (B, S, H, D) layout is read in place; any S works (the ragged tail is
// masked); the older kernels mask with -1e30 as the JAX code does (the
// wgmma kernel with -inf against a row max that starts at -1e30: the
// same probabilities), and l is clamped at 1e-30 before the final
// division.  Under training all also write each
// query row's log-sum-exp, m + log(l) (natural log), into a float32
// (B, H, S) array for the backward (flash_attention_bwd.cu); serving
// passes null and writes nothing more.
#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace repro;

// -- float32: the CUDA-core kernel --------------------------------------------

constexpr int kBQ = 32;                 // query rows per block
constexpr int kBK = 32;                 // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;     // query rows per warp

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (kBQ * D + kBK * (D + 1) + kBK * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S, int G,
                       int64_t q_sb, int64_t q_ss, int64_t q_sh,
                       int64_t k_sb, int64_t k_ss, int64_t k_sh,
                       int64_t v_sb, int64_t v_ss, int64_t v_sh,
                       int64_t o_sb, int64_t o_ss, int64_t o_sh,
                       float scale, int window, float* __restrict__ lse) {
  constexpr int C = kCols<D>;  // output columns per lane (common.cuh)
  extern __shared__ float smem[];
  float* qs = smem;                   // [kBQ][D]
  float* ks = qs + kBQ * D;           // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);     // [kBK][D]

  const int q_start = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int i = tid; i < kBQ * D; i += kWarps * 32) {
    const int r = i / D, d = i % D, qi = q_start + r;
    qs[i] = qi < S ? to_float(qb[qi * q_ss + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][C];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  // Each thread moves kPer 16-byte chunks of K and of V per tile; all the
  // chunk loads are independent, so their latencies overlap, and the next
  // tile's chunks are in flight while the current tile is computed.
  constexpr int V = kVec<T>;
  constexpr int kChunks = D / V;  // 16-byte chunks per row
  constexpr int kPer = kBK * kChunks / (kWarps * 32);
  static_assert(kPer >= 1 && kBK * kChunks % (kWarps * 32) == 0, "tile split");
  uint4 kraw[kPer], vraw[kPer];
  auto load_tile = [&](int k_start) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * kWarps * 32;
      const int kj = k_start + c / kChunks, d0 = (c % kChunks) * V;
      kraw[i] = vraw[i] = make_uint4(0u, 0u, 0u, 0u);
      if (kj < S) {
        kraw[i] = *reinterpret_cast<const uint4*>(kb + kj * k_ss + d0);
        vraw[i] = *reinterpret_cast<const uint4*>(vb + kj * v_ss + d0);
      }
    }
  };

  const int q_last = min(q_start + kBQ - 1, S - 1);
  const int kv_first = window > 0 ? max(0, q_start - window + 1) : 0;
  load_tile(kv_first / kBK * kBK);
  for (int t = kv_first / kBK; t <= q_last / kBK; ++t) {
    const int k_start = t * kBK;
    __syncthreads();  // the previous tile is consumed (and qs is written)
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * kWarps * 32;
      const int j = c / kChunks, d0 = (c % kChunks) * V;
      float f[V];
      unpack(kraw[i], f, T());
#pragma unroll
      for (int e = 0; e < V; ++e) ks[j * (D + 1) + d0 + e] = f[e];
      unpack(vraw[i], f, T());
#pragma unroll
      for (int e = 0; e < V; ++e) vs[j * D + d0 + e] = f[e];
    }
    __syncthreads();
    if (t < q_last / kBK) load_tile(k_start + kBK);

    // scores of this lane's key against the warp's rows
    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = 0.f;
    const float* kr = ks + lane * (D + 1);
    const float* qr = qs + warp * kRows * D;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) s[i] += qr[i * D + d] * kd;
    }

    const int kj = k_start + lane;
    float p[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q_start + warp * kRows + i;
      bool ok = kj <= qi && kj < S;
      if (window > 0) ok = ok && kj > qi - window;
      const float si = ok ? s[i] * scale : kNegInf;
      const float m_cur = fmaxf(m[i], warp_max(si));
      p[i] = expf(si - m_cur);
      const float alpha = expf(m[i] - m_cur);
      l[i] = l[i] * alpha + warp_sum(p[i]);
      m[i] = m_cur;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
    }

    // acc[row][lane + 32c] += sum_j p[row][j] * V[j][lane + 32c]
    for (int j = 0; j < kBK; ++j) {
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = col_ok<D>(lane, c) ? vs[j * D + lane + 32 * c] : 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float pj = __shfl_sync(kFullMask, p[i], j);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] += pj * vv[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q_start + warp * kRows + i;
    if (qi >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && lane == 0)
      lse[(static_cast<int64_t>(b) * gridDim.y + h) * S + qi] = m[i] + logf(denom);
    T* orow = o + b * o_sb + qi * o_ss + h * o_sh;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (col_ok<D>(lane, c)) orow[lane + 32 * c] = from_float<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                   int H, int KV, const int64_t* st, float scale, int window, float* lse,
                   cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  const size_t smem = flash_smem_bytes<D>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H / KV, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale, window, lse);
  return cudaGetLastError();
}

// -- bf16: the tensor-core kernel ---------------------------------------------

constexpr int kMmaRows = 16 * kWarps;  // query rows per block: 16 a warp
constexpr int kMmaKeys = 64;           // keys per K/V tile

template <int D>
constexpr size_t flash_mma_smem_bytes() {
  // the Q tile, then two stages of K and two of V
  return sizeof(__nv_bfloat16) * kLd<D> * (kMmaRows + 4 * kMmaKeys);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
                 int G, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 int64_t o_sb, int64_t o_ss, int64_t o_sh,
                 float scale_log2, int window, float* __restrict__ lse) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = kLd<D>;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kPer = kMmaKeys * kChunks / (kWarps * 32);
  static_assert(kPer >= 1 && kMmaKeys * kChunks % (kWarps * 32) == 0, "tile split");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kMmaRows][LD]
  bf16* ks = qs + kMmaRows * LD;                 // [2][kMmaKeys][LD]
  bf16* vs = ks + 2 * kMmaKeys * LD;             // [2][kMmaKeys][LD]

  const int qt = gridDim.z - 1 - blockIdx.z;  // the longest query tiles first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q_start = qt * kMmaRows;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;

  // Q rows by cp.async where they are 16-byte aligned, else element by
  // element (a strided view need not be); rows past S are zeros.
  if (reinterpret_cast<uintptr_t>(qb) % 16 == 0 && q_ss % 8 == 0) {
    for (int c = tid; c < kMmaRows * kChunks; c += kWarps * 32) {
      const int r = c / kChunks, d0 = (c % kChunks) * 8, qi = q_start + r;
      cp_async_16(qs + r * LD + d0, qb + (qi < S ? qi : 0) * q_ss + d0, qi < S);
    }
  } else {
    for (int i = tid; i < kMmaRows * D; i += kWarps * 32) {
      const int r = i / D, d = i % D, qi = q_start + r;
      qs[r * LD + d] = qi < S ? qb[qi * q_ss + d] : __float2bfloat16(0.f);
    }
  }
  cp_async_commit();  // group: Q

  // one 64-key tile of K and V into a stage, rows past S zero-filled
  auto load_kv = [&](int stage, int k_start) {
    bf16* kd = ks + stage * kMmaKeys * LD;
    bf16* vd = vs + stage * kMmaKeys * LD;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * kWarps * 32;
      const int r = c / kChunks, d0 = (c % kChunks) * 8, kj = k_start + r;
      const int64_t row = kj < S ? kj : 0;
      cp_async_16(kd + r * LD + d0, kb + row * k_ss + d0, kj < S);
      cp_async_16(vd + r * LD + d0, vb + row * v_ss + d0, kj < S);
    }
  };

  const int kv_first = window > 0 ? max(0, q_start - window + 1) : 0;
  const int t_first = kv_first / kMmaKeys;
  load_kv(0, t_first * kMmaKeys);
  cp_async_commit();  // group: the first K/V tile

  cp_async_wait<1>();
  __syncthreads();  // Q landed
  uint32_t qf[D / 16][4];
  load_q_frags<D>(qf, qs + warp * 16 * LD, lane);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  const int row0 = q_start + warp * 16;  // the warp's first query row

  // the diagonal tile (t == qt, since query and key tiles are both 64 wide)
  // is the causal limit; every tile before it is causally whole
  int stage = 0;
  for (int t = t_first; t <= qt; ++t, stage ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t < qt) load_kv(stage ^ 1, (t + 1) * kMmaKeys);  // in flight while t computes
    cp_async_commit();
    const bf16* kt = ks + stage * kMmaKeys * LD;
    const bf16* vt = vs + stage * kMmaKeys * LD;
    const int k_start = t * kMmaKeys;
    if (t == qt || (window > 0 && k_start + window <= q_start + kMmaRows - 1)) {
      auto ok = [&](int r, int j) {
        const int qi = row0 + r, kj = k_start + j;
        return kj <= qi && (window <= 0 || kj > qi - window);
      };
      attend_tile_mma<D, kMmaKeys, true>(qf, kt, vt, scale_log2, ok, lane, m, l, acc);
    } else {
      attend_tile_mma<D, kMmaKeys, false>(qf, kt, vt, scale_log2,
                                          [](int, int) { return true; }, lane, m, l, acc);
    }
  }

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(quad_sum(l[r]), 1e-30f);  // every lane: shuffles
    const int qi = row0 + g + 8 * r;
    if (qi >= S) continue;
    if (lse != nullptr && t4 == 0)  // m is in log2 units: scores carry log2(e)
      lse[(static_cast<int64_t>(b) * gridDim.x + h) * S + qi] = (m[r] + log2f(denom)) * kLn2;
    bf16* orow = o + b * o_sb + qi * o_ss + h * o_sh + 2 * t4;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<uint32_t*>(orow + nb * 8) =
          pack_bf16(acc[nb][2 * r] / denom, acc[nb][2 * r + 1] / denom);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int S,
                       int H, int KV, const int64_t* st, float scale, int window, float* lse,
                       cudaStream_t stream) {
  auto kernel = flash_mma_kernel<D>;
  const size_t smem = flash_mma_smem_bytes<D>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (S + kMmaRows - 1) / kMmaRows);  // query tiles slowest
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, H / KV, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale * kLog2e, window, lse);
  return cudaGetLastError();
}

// -- bf16 at D 64 and 128: TMA, wgmma, warp specialisation --------------------

constexpr int kWgRows = 128;   // query rows a block: 64 per consumer warpgroup
constexpr int kWgKeys = 128;   // keys a K/V tile
constexpr int kWgStages = 2;   // K/V tiles in flight
constexpr int kWgThreads = 384;  // two consumer warpgroups, then the producer's
constexpr int kBox = 128 * 128;  // bytes of a box: 128 rows of 64 bf16 columns

template <int D>
struct WgmmaSmem {
  static constexpr int kChunks = D / 64;  // 64-column boxes a row
  alignas(1024) __nv_bfloat16 q[kChunks][kWgRows * 64];
  __nv_bfloat16 k[kWgStages][kChunks][kWgKeys * 64];
  __nv_bfloat16 v[kWgStages][kChunks][kWgKeys * 64];
  uint64_t q_full, k_full[kWgStages], k_empty[kWgStages], v_full[kWgStages], v_empty[kWgStages];
};

struct WgmmaArgs {
  __nv_bfloat16* o;
  float* lse;
  int64_t o_sb, o_ss, o_sh;
  int S, G, window;
  float scale_log2;
};

// Set to -inf the scores of an accumulator tile (the m64nN layout; this
// thread's rows r and r + 8, key k0 + 8j + e % 2 in register 4j + e, with
// k0 = the tile's first key + 2t) that lie past the diagonal or below the
// window (window <= 0: none).
template <int N>
__device__ __forceinline__ void mask_scores(float (&s)[N / 2], int r, int k0, int window) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = r + 8 * (e >> 1), kj = k0 + 8 * j + (e & 1);
      if (kj > qi || (window > 0 && kj <= qi - window)) s[4 * j + e] = masked_score();
    }
}

// One tile of the online softmax on raw scores s (scaled by scale_log2
// inside the exponent: one FFMA and one ex2 a score): m in log2 units, l
// this thread's partial row sums, alpha the factor the caller rescales
// the output by; s becomes P.  The row max is a tree over the thread's
// scores, then a shuffle within the quad.
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[N / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float scale_log2) {
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) mx[r][q] = kNegInf;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx[r][j % 4] = fmaxf(mx[r][j % 4], fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
  float neg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
    const float m_new = fmaxf(m[r], x * scale_log2);
    alpha[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    neg[r] = -m_new;
  }
  float sum[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) sum[r][q] = 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = fast_exp2(fmaf(s[4 * j + e], scale_log2, neg[e >> 1]));
      sum[e >> 1][j % 4] += s[4 * j + e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] + ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const WgmmaArgs a) {
  using Smem = WgmmaSmem<D>;
  constexpr int kChunks = Smem::kChunks;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_1k(smem_raw));

  const int qt = gridDim.z - 1 - blockIdx.z;  // the longest query tiles first
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / a.G;
  const int q_start = qt * kWgRows;
  const int kv_first = a.window > 0 ? max(0, q_start - a.window + 1) : 0;
  const int t_first = kv_first / kWgKeys;
  // key tiles from the window's lower edge to the causal limit: the tile
  // holding the block's last row (its keys past S are zeros, and masked)
  const int n_tiles = (min(q_start + kWgRows, a.S) - 1) / kWgKeys - t_first + 1;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], 8);  // one arrival from each consumer warp
      mbar_init(&sm.v_empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == 2) {  // producer: one thread keeps the TMA loads in flight
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      mbar_expect_tx(&sm.q_full, kChunks * kBox);
      for (int c = 0; c < kChunks; ++c)
        tma_load_4d(sm.q[c], &qmap, &sm.q_full, 64 * c, q_start, h, b);
      // K and V of a tile are released apart: K once S is done, V once P V is
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kWgStages, k_start = (t_first + i) * kWgKeys;
        const uint32_t parity = (i / kWgStages - 1) & 1;
        if (i >= kWgStages) mbar_wait(&sm.k_empty[s], parity);
        mbar_expect_tx(&sm.k_full[s], kChunks * kBox);
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(sm.k[s][c], &kmap, &sm.k_full[s], 64 * c, k_start, kvh, b);
        if (i >= kWgStages) mbar_wait(&sm.v_empty[s], parity);
        mbar_expect_tx(&sm.v_full[s], kChunks * kBox);
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(sm.v[s][c], &vmap, &sm.v_full[s], 64 * c, k_start, kvh, b);
      }
    }
  } else {  // consumers: 64 query rows each
    setmaxnreg_inc<240>();
    const int cw = wg;
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int row0 = q_start + 64 * cw;        // the warpgroup's first row
    const int row_last = row0 + 63;
    const int r_thread = row0 + 16 * warp + g;  // this thread's rows: r_thread, + 8
    const uint64_t q_desc = desc_k(smem_u32(sm.q[0]) + cw * 64 * 128);

    float o[D / 2], s[kWgKeys / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kWgKeys / 2; ++i) s[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    auto release = [&](uint64_t* bar) {  // this warp is done with a stage
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    mbar_wait(&sm.q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kWgStages, k_start = (t_first + i) * kWgKeys;
      const uint32_t parity = (i / kWgStages) & 1;
      mbar_wait(&sm.k_full[st], parity);
      const uint64_t k_desc = desc_k(smem_u32(sm.k[st][0]));
      zero_acc(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {  // S, both K-major in shared memory
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_ss<kWgKeys>(s, desc_add(q_desc, off), desc_add(k_desc, off), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      release(&sm.k_empty[st]);

      // the mask only where the diagonal or the window's lower edge cuts
      // the tile (keys past S lie past the diagonal; a tile below a row's
      // window leaves the row untouched)
      if (k_start + kWgKeys - 1 > row0 || (a.window > 0 && k_start + a.window <= row_last))
        mask_scores<kWgKeys>(s, r_thread, k_start + 2 * t4, a.window);
      float alpha[2];
      online_softmax<kWgKeys>(s, m, l, alpha, a.scale_log2);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }

      // O += P V: P rounded to bf16 in registers, V MN-major
      uint32_t p[kWgKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kWgKeys / 16; ++kk) a_from_acc(p[kk], s, kk);
      mbar_wait(&sm.v_full[st], parity);
      const uint64_t v_desc = desc_mn(smem_u32(sm.v[st][0]), kBox);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgKeys / 16; ++kk)
        wgmma_rs<D>(o, p[kk], desc_add(v_desc, kk * 2048), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      release(&sm.v_empty[st]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float denom = fmaxf(quad_sum(l[r]), 1e-30f);  // every lane: shuffles
      const int qi = r_thread + 8 * r;
      if (qi >= a.S) continue;
      if (a.lse != nullptr && t4 == 0)  // m is in log2 units: scores carry log2(e)
        a.lse[(static_cast<int64_t>(b) * gridDim.x + h) * a.S + qi] =
            (m[r] + log2f(denom)) * kLn2;
      const float inv = 1.f / denom;
      __nv_bfloat16* orow = a.o + b * a.o_sb + qi * a.o_ss + h * a.o_sh + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int S,
                         int H, int KV, const int64_t* st, float scale, int window, float* lse,
                         cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!bf16_map(&qmap, q, D, S, H, B, st[0], st[1], st[2], kWgRows) ||
      !bf16_map(&kmap, k, D, S, KV, B, st[3], st[4], st[5], kWgKeys) ||
      !bf16_map(&vmap, v, D, S, KV, B, st[6], st[7], st[8], kWgKeys))
    return cudaErrorInvalidValue;
  auto kernel = flash_wgmma_kernel<D>;
  const size_t smem = sizeof(WgmmaSmem<D>) + 1024;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const WgmmaArgs a{static_cast<__nv_bfloat16*>(o), lse, st[9], st[10], st[11], S, H / KV,
                    window, scale * kLog2e};
  const dim3 grid(H, B, (S + kWgRows - 1) / kWgRows);  // query tiles slowest
  kernel<<<grid, kWgThreads, smem, stream>>>(qmap, kmap, vmap, a);
  return cudaGetLastError();
}

// bf16 by head dim: the wgmma kernel at 64 and 128 (every full-width
// model), the mma.sync kernel at 16 and 32 (smoke configs only)
cudaError_t dispatch_bf16(int D, const void* q, const void* k, const void* v, void* o, int B,
                          int S, int H, int KV, const int64_t* st, float scale, int window,
                          float* lse, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_mma<16>(q, k, v, o, B, S, H, KV, st, scale, window, lse, stream);
    case 32: return launch_mma<32>(q, k, v, o, B, S, H, KV, st, scale, window, lse, stream);
    case 64: return launch_wgmma<64>(q, k, v, o, B, S, H, KV, st, scale, window, lse, stream);
    case 128: return launch_wgmma<128>(q, k, v, o, B, S, H, KV, st, scale, window, lse, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dim(int D, const void* q, const void* k, const void* v, void* o,
                         int B, int S, int H, int KV, const int64_t* st, float scale,
                         int window, float* lse, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, KV, st, scale, window, lse, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, st, scale, window, lse, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, st, scale, window, lse, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, st, scale, window, lse, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/o element strides in `strides`, 12 values: (batch, seq, head) for
// q, k, v, o in that order; the head_dim axis must be contiguous, k and v
// 16-byte aligned with strides that keep every row 16-byte aligned (q too
// in bf16 at D 64 and 128, which TMA reads: else cudaErrorInvalidValue),
// and o's rows 4-byte aligned (the bf16 kernels store pairs).
// window <= 0 means no sliding window.  lse: null, or a contiguous float32
// (B, H, S) array that receives each query row's log-sum-exp.  Returns
// cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, int dtype, int B, int S, int H, int KV,
                                     int D, const int64_t* strides, float scale,
                                     int window, void* lse, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == kFloat32)
    return dispatch_dim<float>(D, q, k, v, o, B, S, H, KV, strides, scale, window, l, s);
  if (dtype == kBFloat16)
    return dispatch_bf16(D, q, k, v, o, B, S, H, KV, strides, scale, window, l, s);
  return cudaErrorInvalidValue;
}
