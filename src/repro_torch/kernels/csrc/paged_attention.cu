// One-token GQA decode attention over a paged KV pool, for sm_90a.
//
// Replaces: src/repro/kernels/paged_attention.py, paged_decode_attention
// (Pallas body _paged_kernel).
//
// What bounds it on the H100: device-memory bytes.  Each request reads its
// first lengths[b] tokens of K and V once, sum_b lengths[b] * KV * D * 2 *
// dtype_bytes per layer, plus q, o and the page table, against 4 * G * D
// flops per K/V row: at granite-20b's G = 48, 48 flops per bf16 byte, under
// the ~295 where the bf16 tensor cores become the limit but over the ~20
// the CUDA cores reach in float32.
//
// Design: the flat decode's (decode_attention.cu), with a page table in
// place of the mask; the split bodies are shared (split_decode.cuh):
//   * flash-decoding: one block per (split, KV head, request) over the page
//     table's width, max_pages * page_size tokens, cut into `splits` pieces
//     of split_len tokens by the wrapper from max_pages alone (reading the
//     lengths, which live on the card, would cost a host sync a step); a
//     second launch (paged_merge_kernel) merges the splits' partials.  The
//     Pallas grid walks one request's pages in order with (m, l, acc) in
//     VMEM; one block per (KV head, request) walking them so would leave
//     granite-20b's MQA with 8 blocks at batch 8 on 132 SMs.  The splits
//     fill the card about four times over (PAGED_WAVES in the wrapper), so
//     ragged lengths spread evenly over the SMs;
//   * a split clamps its range to the request's length; one wholly past it
//     writes the empty partial (m = -1e30, l = 0) and exits.  A length-0
//     row (an idle slot) gets only such partials and gives zeros;
//   * each token's page id is read from the block's row of page_tables as
//     its 16-byte chunks are loaded, so any page_size works; page id 0 is a
//     legal dummy in unused table cells, which are never read;
//   * the G query heads of a KV head share the block, so every K/V row is
//     read from device memory once for all G heads (G <= 64);
//   * bf16 (paged_split_mma_kernel): 64-token tiles by cp.async in two
//     stages, QK^T and P V as mma.sync m16n8k16 products over the G rows
//     padded to 16-row tiles (attend_tile_mma, mma.cuh);
//   * float32 (paged_split_kernel): 32-token tiles on the CUDA cores
//     (attend_tile, common.cuh): TF32 would break the 1e-4 float32
//     tolerance and the CPU-card token parity of the float32 smoke configs.
#include "split_decode.cuh"

namespace {

using namespace repro;

// Tokens of one request and KV head in the pool: every token before the
// split's clamped end is valid; token t lies in page table[t / page_size],
// row t % page_size, tok_stride elements a row.
struct PagedRows {
  const int* table;
  int page_size;
  int64_t tok_stride, head_off;
  __device__ __forceinline__ bool valid(int) const { return true; }
  __device__ __forceinline__ int64_t offset(int t) const {
    const int64_t page = table[t / page_size];
    return (page * page_size + t % page_size) * tok_stride + head_off;
  }
};

struct Args {
  const void *q, *pool_k, *pool_v, *page_tables, *lengths;
  void *part_m, *part_l, *part_acc, *o;
  int B, H, KV, page_size, max_pages, split_len, splits;
  int64_t q_sb, q_sh;
  float scale;
  cudaStream_t stream;
};

// The split's tokens [s_begin, s_end) of request b, and where they live.
__device__ __forceinline__ PagedRows paged_rows(const int* page_tables, const int* lengths,
                                                int KV, int D, int page_size, int max_pages,
                                                int split_len, int& s_begin, int& s_end) {
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int len = min(lengths[b], max_pages * page_size);
  s_begin = blockIdx.x * split_len;
  s_end = min(len, s_begin + split_len);
  return PagedRows{page_tables + static_cast<int64_t>(b) * max_pages, page_size,
                   static_cast<int64_t>(KV) * D, static_cast<int64_t>(kvh) * D};
}

// Partials: m and l (B, H, splits), acc (B, H, splits, D), all float32.
template <typename T, int D, int R>
__global__ void __launch_bounds__(kDecodeWarps * 32)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                   const T* __restrict__ pool_v, const int* __restrict__ page_tables,
                   const int* __restrict__ lengths, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_acc, int H, int KV,
                   int page_size, int max_pages, int split_len, int splits, int64_t q_sb,
                   int64_t q_sh, float scale) {
  int s_begin, s_end;
  const PagedRows rows =
      paged_rows(page_tables, lengths, KV, D, page_size, max_pages, split_len, s_begin, s_end);
  split_attend_f32<T, D, R>(q, pool_k, pool_v, rows, part_m, part_l, part_acc, H, H / KV,
                            s_begin, s_end, splits, q_sb, q_sh, scale);
}

template <int D, int MT>
__global__ void __launch_bounds__(kDecodeWarps * 32)
paged_split_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ pool_k,
                       const __nv_bfloat16* __restrict__ pool_v,
                       const int* __restrict__ page_tables, const int* __restrict__ lengths,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_acc, int H, int KV, int page_size,
                       int max_pages, int split_len, int splits, int64_t q_sb, int64_t q_sh,
                       float scale_log2) {
  int s_begin, s_end;
  const PagedRows rows =
      paged_rows(page_tables, lengths, KV, D, page_size, max_pages, split_len, s_begin, s_end);
  split_attend_mma<D, MT>(q, pool_k, pool_v, rows, part_m, part_l, part_acc, H, H / KV,
                          s_begin, s_end, splits, q_sb, q_sh, scale_log2);
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
paged_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                   const float* __restrict__ part_acc, T* __restrict__ o, int splits) {
  merge_partials<T, D>(part_m, part_l, part_acc, o, splits);
}

template <typename T, int D>
cudaError_t launch_merge(const Args& a) {
  paged_merge_kernel<T, D><<<a.B * a.H, D, 0, a.stream>>>(
      static_cast<const float*>(a.part_m), static_cast<const float*>(a.part_l),
      static_cast<const float*>(a.part_acc), static_cast<T*>(a.o), a.splits);
  return cudaGetLastError();
}

template <typename T, int D, int R>
cudaError_t launch_rows(const Args& a) {
  auto kernel = paged_split_kernel<T, D, R>;
  const size_t smem = split_smem_bytes<D, R>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.splits, a.KV, a.B), kDecodeWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.pool_k),
      static_cast<const T*>(a.pool_v), static_cast<const int*>(a.page_tables),
      static_cast<const int*>(a.lengths), static_cast<float*>(a.part_m),
      static_cast<float*>(a.part_l), static_cast<float*>(a.part_acc), a.H, a.KV, a.page_size,
      a.max_pages, a.split_len, a.splits, a.q_sb, a.q_sh, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge<T, D>(a);
}

template <typename T, int D>
cudaError_t launch(const Args& a) {
  switch (rows_per_warp(a.H / a.KV, kDecodeWarps)) {
    case 1:
      return launch_rows<T, D, 1>(a);
    case 4:
      return launch_rows<T, D, 4>(a);
    case 12:
      return launch_rows<T, D, 12>(a);
    default:
      return launch_rows<T, D, 16>(a);
  }
}

template <typename T>
cudaError_t dispatch_dim(int D, const Args& a) {
  switch (D) {
    case 16:
      return launch<T, 16>(a);
    case 32:
      return launch<T, 32>(a);
    case 64:
      return launch<T, 64>(a);
    case 128:
      return launch<T, 128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int D, int MT>
cudaError_t launch_mma(const Args& a) {
  auto kernel = paged_split_mma_kernel<D, MT>;
  const size_t smem = split_mma_smem_bytes<D, MT>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.splits, a.KV, a.B), kDecodeWarps * 32, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.pool_k),
      static_cast<const __nv_bfloat16*>(a.pool_v), static_cast<const int*>(a.page_tables),
      static_cast<const int*>(a.lengths), static_cast<float*>(a.part_m),
      static_cast<float*>(a.part_l), static_cast<float*>(a.part_acc), a.H, a.KV, a.page_size,
      a.max_pages, a.split_len, a.splits, a.q_sb, a.q_sh, a.scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge<__nv_bfloat16, D>(a);
}

template <int D>
cudaError_t launch_mma_rows(const Args& a) {
  switch ((a.H / a.KV + 15) / 16) {  // 16-row tiles of the group
    case 1:
      return launch_mma<D, 1>(a);
    case 2:
      return launch_mma<D, 2>(a);
    case 3:
      return launch_mma<D, 3>(a);
    default:
      return launch_mma<D, 4>(a);
  }
}

cudaError_t dispatch_mma(int D, const Args& a) {
  switch (D) {
    case 16:
      return launch_mma_rows<16>(a);
    case 32:
      return launch_mma_rows<32>(a);
    case 64:
      return launch_mma_rows<64>(a);
    case 128:
      return launch_mma_rows<128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, D) with element strides (q_sb, q_sh) and contiguous D; pools
// (num_pages, page_size, KV, D) contiguous and 16-byte aligned; page_tables
// (B, max_pages) and lengths (B,) contiguous int32; part_m, part_l: (B, H,
// splits) and part_acc: (B, H, splits, D) float32 scratch; out (B, H, D)
// contiguous.  The table's max_pages * page_size tokens are cut into
// `splits` pieces of split_len tokens (a multiple of the tile: 32 tokens in
// float32, 64 in bf16; splits * split_len >= max_pages * page_size).
// Returns cudaGetLastError().
extern "C" int repro_paged_decode_attention(const void* q, const void* pool_k,
                                            const void* pool_v, const void* page_tables,
                                            const void* lengths, void* part_m, void* part_l,
                                            void* part_acc, void* out, int dtype, int B, int H,
                                            int KV, int D, int page_size, int max_pages,
                                            int split_len, int splits, int64_t q_sb,
                                            int64_t q_sh, float scale, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxGroup || page_size <= 0 ||
      max_pages <= 0 || splits <= 0 || split_len <= 0 ||
      split_len % (dtype == kBFloat16 ? kMmaTT : kTT) != 0 ||
      static_cast<int64_t>(split_len) * splits < static_cast<int64_t>(max_pages) * page_size)
    return cudaErrorInvalidValue;
  const Args a{q,      pool_k,    pool_v, page_tables, lengths, part_m,
               part_l, part_acc,  out,    B,           H,       KV,
               page_size, max_pages, split_len, splits, q_sb, q_sh,
               scale,  static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return dispatch_dim<float>(D, a);
  if (dtype == kBFloat16) return dispatch_mma(D, a);
  return cudaErrorInvalidValue;
}
