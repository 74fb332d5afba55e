// One-token GQA decode attention over a paged KV pool, for sm_90a.
//
// Replaces: src/repro/kernels/paged_attention.py, paged_decode_attention
// (Pallas body _paged_kernel).
//
// What bounds it on the H100: device-memory bytes.  Each request reads its
// first lengths[b] tokens of K and V once, sum_b lengths[b] * KV * D * 2 *
// dtype_bytes per layer, against only 4 * H * D flops per token, far below
// the ~295 flops/byte where bf16 tensor cores would take over.
//
// Design:
//   * one block per (KV head, request): the G query heads of the group
//     share the block, so every K/V row is read from device memory once for
//     all G heads (the Pallas kernel also reads a page once per group);
//   * the block reads its own page ids from page_tables and walks only the
//     ceil(lengths[b] / page_size) pages the request holds, in 32-token
//     tiles; the Pallas grid walks all max_pages and masks the dead ones;
//   * K/V rows move as 16-byte chunks, and the next tile's chunks are
//     loaded into registers while the current tile is computed;
//   * one lane per token of a tile; each warp owns R query heads (R = 1, 4,
//     12 or 16, compiled for each, so G <= 64: granite-20b's 48 heads over
//     one KV head take R = 12) and keeps their online-softmax state (m, l,
//     acc) in registers, so only the K/V tile and the query rows cross
//     shared memory (attend_tile in common.cuh, shared with the flat
//     decode).  The 4 * R rows are padded with zeros past G and all
//     computed, so no branch guards the tile's warp shuffles;
//     More rows per warp, not a grid axis over groups of heads, so K/V is
//     still read once per KV head: a grid axis would re-read every page
//     once per group (3x the bytes at G = 48);
//   * a length-0 row (an idle slot) runs no tile and writes zeros, since l
//     is clamped at 1e-30 before the division, as in the Pallas kernel;
//   * page id 0 is a legal dummy in unused table cells: cells past the
//     length are never read.
// Parallelism is B * KV blocks (64 for qwen3-8b at batch 8, 8 for
// granite-20b), under half the SMs; splitting the pages of a long request
// across blocks, as the flat decode does, is later work.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kTT = 32;        // tokens per tile: one per lane
constexpr int kWarps = 4;
constexpr int kMaxGroup = 16 * kWarps;  // query heads per KV head, R = 16

template <int D, int R>
size_t paged_smem_bytes() {
  return sizeof(float) * (kWarps * R * D + kTT * (D + 1) + kTT * D);
}

template <typename T, int D, int R>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v, const int* __restrict__ page_tables,
                    const int* __restrict__ lengths, T* __restrict__ o, int H, int KV,
                    int G, int page_size, int max_pages, int64_t q_sb, int64_t q_sh,
                    float scale) {
  constexpr int C = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [kWarps * R][D], zero past G
  float* ks = qs + kWarps * R * D;  // [kTT][D + 1]
  float* vs = ks + kTT * (D + 1);   // [kTT][D]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int len = min(lengths[b], max_pages * page_size);
  const int* table = page_tables + static_cast<int64_t>(b) * max_pages;
  const int64_t tok_stride = static_cast<int64_t>(KV) * D;  // one token's row in a page

  for (int i = tid; i < kWarps * R * D; i += kWarps * 32) {
    const int g = i / D, d = i % D;
    qs[i] = g < G ? to_float(q[b * q_sb + (kvh * G + g) * q_sh + d]) : 0.f;
  }

  float m[R], l[R], acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  // Each thread moves kPer 16-byte chunks of K and of V per tile; the page
  // id of a token is looked up once per chunk, and all the chunk loads are
  // independent, so their latencies overlap.
  constexpr int V = kVec<T>;
  constexpr int kChunks = D / V;  // 16-byte chunks per token row
  constexpr int kPer = kTT * kChunks / (kWarps * 32);
  static_assert(kPer >= 1 && kTT * kChunks % (kWarps * 32) == 0, "tile split");
  uint4 kraw[kPer], vraw[kPer];
  auto load_tile = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * kWarps * 32;
      const int t = t0 + c / kChunks;
      kraw[i] = vraw[i] = make_uint4(0u, 0u, 0u, 0u);
      if (t < len) {
        const int64_t page = table[t / page_size];
        const int64_t off =
            (page * page_size + t % page_size) * tok_stride + kvh * D + (c % kChunks) * V;
        kraw[i] = *reinterpret_cast<const uint4*>(pool_k + off);
        vraw[i] = *reinterpret_cast<const uint4*>(pool_v + off);
      }
    }
  };

  if (len > 0) load_tile(0);
  for (int t0 = 0; t0 < len; t0 += kTT) {
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
    if (t0 + kTT < len) load_tile(t0 + kTT);  // in flight while this tile computes

    attend_tile<kWarps, R, D>(qs, ks, vs, t0 + lane < len, scale, warp, lane, m, l, acc);
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int g = warp + kWarps * i;
    if (g >= G) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (static_cast<int64_t>(b) * H + kvh * G + g) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) orow[lane + 32 * c] = from_float<T>(acc[i][c] / denom);
  }
}

template <typename T, int D, int R>
cudaError_t launch_rows(const void* q, const void* pk, const void* pv, const void* pt,
                        const void* lens, void* o, int B, int H, int KV, int page_size,
                        int max_pages, int64_t q_sb, int64_t q_sh, float scale,
                        cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T, D, R>;
  const int G = H / KV;
  const size_t smem = paged_smem_bytes<D, R>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(KV, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk), static_cast<const T*>(pv),
      static_cast<const int*>(pt), static_cast<const int*>(lens), static_cast<T*>(o), H,
      KV, G, page_size, max_pages, q_sb, q_sh, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* pk, const void* pv, const void* pt,
                   const void* lens, void* o, int B, int H, int KV, int page_size,
                   int max_pages, int64_t q_sb, int64_t q_sh, float scale,
                   cudaStream_t s) {
  switch (rows_per_warp(H / KV, kWarps)) {
    case 1:
      return launch_rows<T, D, 1>(q, pk, pv, pt, lens, o, B, H, KV, page_size, max_pages,
                                  q_sb, q_sh, scale, s);
    case 4:
      return launch_rows<T, D, 4>(q, pk, pv, pt, lens, o, B, H, KV, page_size, max_pages,
                                  q_sb, q_sh, scale, s);
    case 12:
      return launch_rows<T, D, 12>(q, pk, pv, pt, lens, o, B, H, KV, page_size, max_pages,
                                   q_sb, q_sh, scale, s);
    default:
      return launch_rows<T, D, 16>(q, pk, pv, pt, lens, o, B, H, KV, page_size, max_pages,
                                   q_sb, q_sh, scale, s);
  }
}

template <typename T>
cudaError_t dispatch_dim(int D, const void* q, const void* pk, const void* pv,
                         const void* pt, const void* lens, void* o, int B, int H, int KV,
                         int page_size, int max_pages, int64_t q_sb, int64_t q_sh,
                         float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, pk, pv, pt, lens, o, B, H, KV, page_size, max_pages, q_sb,
                           q_sh, scale, s);
    case 64:
      return launch<T, 64>(q, pk, pv, pt, lens, o, B, H, KV, page_size, max_pages, q_sb,
                           q_sh, scale, s);
    case 128:
      return launch<T, 128>(q, pk, pv, pt, lens, o, B, H, KV, page_size, max_pages,
                            q_sb, q_sh, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, D) with element strides (q_sb, q_sh) and contiguous D; pools
// (num_pages, page_size, KV, D) contiguous and 16-byte aligned; page_tables (B, max_pages) and
// lengths (B,) contiguous int32; out (B, H, D) contiguous.
// Returns cudaGetLastError().
extern "C" int repro_paged_decode_attention(const void* q, const void* pool_k,
                                            const void* pool_v, const void* page_tables,
                                            const void* lengths, void* out, int dtype,
                                            int B, int H, int KV, int D, int page_size,
                                            int max_pages, int64_t q_sb, int64_t q_sh,
                                            float scale, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxGroup || page_size <= 0 ||
      max_pages <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_dim<float>(D, q, pool_k, pool_v, page_tables, lengths, out, B, H, KV,
                               page_size, max_pages, q_sb, q_sh, scale, s);
  if (dtype == kBFloat16)
    return dispatch_dim<__nv_bfloat16>(D, q, pool_k, pool_v, page_tables, lengths, out, B,
                                       H, KV, page_size, max_pages, q_sb, q_sh, scale, s);
  return cudaErrorInvalidValue;
}
