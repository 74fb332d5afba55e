// Causal (optionally sliding-window) prefill attention, GQA, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_bhsd
// (Pallas body _flash_kernel).
//
// What bounds it on the H100: at the engine's prompt lengths (S of a few
// hundred to a few thousand, head_dim 128) the work is 4*D flops for every
// causally live (query, key) pair against (q + k + v + o) bytes moved once,
// so it turns from memory-bound to compute-bound near S ~ 600 in bf16.
// This first version does its products on the CUDA cores in float32, not
// on the tensor cores, so in practice it is bound by shared-memory traffic
// and FP32 issue rate; wgmma/TMA tiles are later work.
//
// Design:
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
//   * the kv loop runs only over tiles the causal limit (and the window's
//     lower edge) can reach, as the Pallas kernel's pl.when skips dead
//     blocks; the ragged tail (S not a multiple of the tile) is masked and
//     zero-filled, so any S works;
//   * tiles are cut from the strides the wrapper passes, so the model's
//     (B, S, H, D) layout is read in place; masking uses -1e30 as the JAX
//     code does, and l is clamped at 1e-30 before the final division.
#include "common.cuh"

namespace {

using namespace repro;

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
                       float scale, int window) {
  constexpr int C = D / 32;  // output columns per lane
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
      for (int c = 0; c < C; ++c) vv[c] = vs[j * D + lane + 32 * c];
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
    T* orow = o + b * o_sb + qi * o_ss + h * o_sh;
#pragma unroll
    for (int c = 0; c < C; ++c) orow[lane + 32 * c] = from_float<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                   int H, int KV, const int64_t* st, float scale, int window,
                   cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  const size_t smem = flash_smem_bytes<D>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H / KV, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, const void* q, const void* k, const void* v, void* o,
                         int B, int S, int H, int KV, const int64_t* st, float scale,
                         int window, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, st, scale, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, st, scale, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, st, scale, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/o element strides in `strides`, 12 values: (batch, seq, head) for
// q, k, v, o in that order; the head_dim axis must be contiguous, and k and
// v 16-byte aligned with strides that keep every row 16-byte aligned.
// window <= 0 means no sliding window.  Returns cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, int dtype, int B, int S, int H, int KV,
                                     int D, const int64_t* strides, float scale,
                                     int window, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_dim<float>(D, q, k, v, o, B, S, H, KV, strides, scale, window, s);
  if (dtype == kBFloat16)
    return dispatch_dim<__nv_bfloat16>(D, q, k, v, o, B, S, H, KV, strides, scale,
                                       window, s);
  return cudaErrorInvalidValue;
}
