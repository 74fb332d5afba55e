// One-token GQA decode attention over a flat (B, S, KV, D) cache with a
// per-request (B, S) validity mask, for sm_90a.
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention_bhd
// (Pallas body _decode_kernel).
//
// What bounds it on the H100: device-memory bytes.  A request reads the K
// and V rows its mask marks valid once, sum_b valid_b * KV * D * 2 *
// dtype_bytes, plus the mask and q/o, against 4 * G * D flops per K/V row
// (G query heads share it): at granite-20b's G = 48 that is 48 flops per
// bf16 byte, under the ~295 where the bf16 tensor cores become the limit
// but over the ~20 the CUDA cores reach in float32.  So the bf16 kernel
// runs its products on the tensor cores; the float32 one stays on the
// CUDA cores (TF32 would break the 1e-4 float32 tolerance and the CPU-card
// token parity of the float32 smoke configs).
//
// Design: what both kernels (one a dtype) share:
//   * flash-decoding: the Pallas grid (B, S / 512) carries (m, l, acc) in
//     VMEM along the sequence; GPU blocks run in no order, so the sequence
//     is cut into splits instead: one block per (split, KV head, request),
//     and a second small launch (decode_merge_kernel) merges the splits'
//     partials.  The splits are what fill the card: B * KV is only 8
//     blocks for granite-20b at batch 8 (MQA, one KV head), against 132 SMs;
//   * the G query heads of a KV head share the block, so every K/V row is
//     read from device memory once for all G heads (G <= 64);
//   * each block reads its own mask tiles, skips a tile with no valid
//     entry, and loads only the valid rows of the others: a prefix cache at
//     position p reads about p / tile tiles, not S / tile; a ring cache
//     (mask from slot positions, not a prefix) reads all of its W;
//   * the next live tile is in flight while the current one is computed;
//   * any S: the ragged tail of the last tile is masked;
//   * accumulation in float32; a row with no valid entry gives zeros (its
//     splits all report l = 0, and the merge clamps l at 1e-30), as the
//     port's paged decode does; the Pallas kernel averages v there.
//
// bf16 (decode_split_mma_kernel) and float32 (decode_split_kernel): the
// bodies in split_decode.cuh, shared with the paged decode (one warp split
// of 16-row mma.sync tiles over 64-token cp.async tiles in bf16; 32-token
// tiles on the CUDA cores in float32).  Here a token's row is valid where
// the (B, S) mask says so, and lies kv_ss elements after the one before.
#include "split_decode.cuh"

namespace {

using namespace repro;

// Tokens of one request and KV head in the flat cache: valid where the
// mask byte is set, rows kv_ss elements apart.
struct FlatRows {
  const uint8_t* vrow;
  int64_t kv_ss;
  __device__ __forceinline__ bool valid(int t) const { return vrow[t] != 0; }
  __device__ __forceinline__ int64_t offset(int t) const { return t * kv_ss; }
};

// Partials: m and l (B, H, splits), acc (B, H, splits, D), all float32.
template <typename T, int D, int R>
__global__ void __launch_bounds__(kDecodeWarps * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ valid,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int H, int G, int S, int split_len,
                    int splits, int64_t q_sb, int64_t q_sh, int64_t kv_sb, int64_t kv_ss,
                    int64_t kv_sh, int64_t valid_sb, float scale) {
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int s_begin = blockIdx.x * split_len;
  const int64_t base = b * kv_sb + kvh * kv_sh;
  split_attend_f32<T, D, R>(q, k + base, v + base, FlatRows{valid + b * valid_sb, kv_ss},
                            part_m, part_l, part_acc, H, G, s_begin,
                            min(S, s_begin + split_len), splits, q_sb, q_sh, scale);
}

// Partials as decode_split_kernel writes them (m in natural-log units).
template <int D, int MT>
__global__ void __launch_bounds__(kDecodeWarps * 32)
decode_split_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const uint8_t* __restrict__ valid, float* __restrict__ part_m,
                        float* __restrict__ part_l, float* __restrict__ part_acc, int H, int G,
                        int S, int split_len, int splits, int64_t q_sb, int64_t q_sh,
                        int64_t kv_sb, int64_t kv_ss, int64_t kv_sh, int64_t valid_sb,
                        float scale_log2) {
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int s_begin = blockIdx.x * split_len;
  const int64_t base = b * kv_sb + kvh * kv_sh;
  split_attend_mma<D, MT>(q, k + base, v + base, FlatRows{valid + b * valid_sb, kv_ss},
                          part_m, part_l, part_acc, H, G, s_begin,
                          min(S, s_begin + split_len), splits, q_sb, q_sh, scale_log2);
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                    const float* __restrict__ part_acc, T* __restrict__ o, int splits) {
  merge_partials<T, D>(part_m, part_l, part_acc, o, splits);
}

struct Args {
  const void *q, *k, *v, *valid;
  void *part_m, *part_l, *part_acc, *o;
  int B, H, KV, S, split_len, splits;
  int64_t q_sb, q_sh, kv_sb, kv_ss, kv_sh, valid_sb;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_merge(const Args& a) {
  decode_merge_kernel<T, D><<<a.B * a.H, D, 0, a.stream>>>(
      static_cast<const float*>(a.part_m), static_cast<const float*>(a.part_l),
      static_cast<const float*>(a.part_acc), static_cast<T*>(a.o), a.splits);
  return cudaGetLastError();
}

template <typename T, int D, int R>
cudaError_t launch_rows(const Args& a) {
  auto kernel = decode_split_kernel<T, D, R>;
  const int G = a.H / a.KV;
  const size_t smem = split_smem_bytes<D, R>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.splits, a.KV, a.B), kDecodeWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.valid), static_cast<float*>(a.part_m),
      static_cast<float*>(a.part_l), static_cast<float*>(a.part_acc), a.H, G, a.S,
      a.split_len, a.splits, a.q_sb, a.q_sh, a.kv_sb, a.kv_ss, a.kv_sh, a.valid_sb,
      a.scale);
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
  auto kernel = decode_split_mma_kernel<D, MT>;
  const size_t smem = split_mma_smem_bytes<D, MT>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.splits, a.KV, a.B), kDecodeWarps * 32, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const uint8_t*>(a.valid),
      static_cast<float*>(a.part_m), static_cast<float*>(a.part_l),
      static_cast<float*>(a.part_acc), a.H, a.H / a.KV, a.S, a.split_len, a.splits, a.q_sb,
      a.q_sh, a.kv_sb, a.kv_ss, a.kv_sh, a.valid_sb, a.scale * kLog2e);
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

// q: (B, H, D) with element strides (q_sb, q_sh) and contiguous D; k and v:
// (B, S, KV, D) with the same element strides (kv_sb, kv_ss, kv_sh),
// contiguous D, rows 16-byte aligned; valid: (B, S) bytes (0 or 1) with
// row stride valid_sb and contiguous S; part_m, part_l: (B, H, splits) and
// part_acc: (B, H, splits, D) float32 scratch; out: (B, H, D) contiguous.
// The sequence is cut into `splits` pieces of split_len tokens (a multiple
// of the tile: 32 tokens in float32, 64 in bf16; splits * split_len >= S).
// Returns cudaGetLastError().
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* valid, void* part_m, void* part_l,
                                      void* part_acc, void* out, int dtype, int B, int H,
                                      int KV, int S, int D, int split_len, int splits,
                                      int64_t q_sb, int64_t q_sh, int64_t kv_sb,
                                      int64_t kv_ss, int64_t kv_sh, int64_t valid_sb,
                                      float scale, void* stream) {
  if (B <= 0 || KV <= 0 || S <= 0 || H % KV != 0 || H / KV > kMaxGroup || splits <= 0 ||
      split_len <= 0 || split_len % (dtype == kBFloat16 ? kMmaTT : kTT) != 0 ||
      static_cast<int64_t>(split_len) * splits < S)
    return cudaErrorInvalidValue;
  const Args a{q,    k,    v,     valid, part_m, part_l, part_acc, out,
               B,    H,    KV,    S,     split_len, splits, q_sb, q_sh,
               kv_sb, kv_ss, kv_sh, valid_sb, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return dispatch_dim<float>(D, a);
  if (dtype == kBFloat16) return dispatch_mma(D, a);
  return cudaErrorInvalidValue;
}
