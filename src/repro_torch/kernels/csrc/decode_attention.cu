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
// bf16 byte, under the ~295 where the bf16 tensor cores would take over
// but over the ~20 the CUDA cores reach in float32, so this kernel, on the
// CUDA cores, is bound by its arithmetic at large G (tensor cores are
// later work).
//
// Design:
//   * flash-decoding: the Pallas grid (B, S / 512) carries (m, l, acc) in
//     VMEM along the sequence; GPU blocks run in no order, so the sequence
//     is cut into splits instead: one block per (split, KV head, request),
//     and a second small launch merges the splits' partials.  The splits are
//     what fill the card: B * KV is only 8 blocks for granite-20b at batch 8
//     (MQA, one KV head), against 132 SMs;
//   * the G query heads of a KV head share the block (R = 1, 4, 12 or 16
//     rows per warp, compiled for each: G <= 64; rows past G are zeros and
//     computed too, so no branch guards the tile's warp shuffles), so
//     every K/V row is read from device memory once for all G heads; the
//     per-tile arithmetic is attend_tile in common.cuh, shared with the
//     paged decode;
//   * each block reads its own 32-token mask tiles, skips a tile with no
//     valid entry, and loads only the valid rows of the others: a prefix
//     cache at position p reads about p / 32 tiles, not S / 32; a ring
//     cache (mask from slot positions, not a prefix) reads all of its W;
//   * K/V rows move as 16-byte chunks, and the next live tile's chunks are
//     loaded into registers while the current tile is computed;
//   * any S: the ragged tail of the last tile is masked;
//   * accumulation in float32; a row with no valid entry gives zeros (its
//     splits all report l = 0, and the merge clamps l at 1e-30), as the
//     port's paged decode does; the Pallas kernel averages v there.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kTT = 32;  // tokens per tile: one per lane
constexpr int kWarps = 4;
constexpr int kMaxGroup = 16 * kWarps;

template <int D, int R>
size_t split_smem_bytes() {
  return sizeof(float) * (kWarps * R * D + kTT * (D + 1) + kTT * D);
}

// Partials: m and l (B, H, splits), acc (B, H, splits, D), all float32.
template <typename T, int D, int R>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ valid,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int H, int G, int S, int split_len,
                    int splits, int64_t q_sb, int64_t q_sh, int64_t kv_sb, int64_t kv_ss,
                    int64_t kv_sh, int64_t valid_sb, float scale) {
  constexpr int C = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [kWarps * R][D], zero past G
  float* ks = qs + kWarps * R * D;  // [kTT][D + 1]
  float* vs = ks + kTT * (D + 1);  // [kTT][D]

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int s_begin = split * split_len;
  const int s_end = min(S, s_begin + split_len);
  const uint8_t* vrow = valid + b * valid_sb;
  const T* kb = k + b * kv_sb + kvh * kv_sh;
  const T* vb = v + b * kv_sb + kvh * kv_sh;

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

  // The first tile at or after t with a valid row, and its rows' bits.
  // Every warp reads the same 32 mask bytes, so the answer is block-uniform.
  auto next_tile = [&](int t, unsigned& bits) {
    for (; t < s_end; t += kTT) {
      bits = __ballot_sync(kFullMask, t + lane < s_end && vrow[t + lane] != 0);
      if (bits) return t;
    }
    bits = 0u;
    return s_end;
  };

  // Each thread moves kPer 16-byte chunks of K and of V per tile, of the
  // valid rows only; the chunk loads are independent, so their latencies
  // overlap.
  constexpr int V = kVec<T>;
  constexpr int kChunks = D / V;  // 16-byte chunks per token row
  constexpr int kPer = kTT * kChunks / (kWarps * 32);
  static_assert(kPer >= 1 && kTT * kChunks % (kWarps * 32) == 0, "tile split");
  uint4 kraw[kPer], vraw[kPer];
  auto load_tile = [&](int t0, unsigned bits) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * kWarps * 32;
      const int j = c / kChunks;
      kraw[i] = vraw[i] = make_uint4(0u, 0u, 0u, 0u);
      if ((bits >> j) & 1u) {  // a set bit implies t0 + j < s_end
        const int64_t off = static_cast<int64_t>(t0 + j) * kv_ss + (c % kChunks) * V;
        kraw[i] = *reinterpret_cast<const uint4*>(kb + off);
        vraw[i] = *reinterpret_cast<const uint4*>(vb + off);
      }
    }
  };

  unsigned bits;
  int t = next_tile(s_begin, bits);
  if (t < s_end) load_tile(t, bits);
  while (t < s_end) {
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
    const bool ok = (bits >> lane) & 1u;
    unsigned next_bits;
    const int t_next = next_tile(t + kTT, next_bits);
    if (t_next < s_end) load_tile(t_next, next_bits);  // in flight while this tile computes

    attend_tile<kWarps, R, D>(qs, ks, vs, ok, scale, warp, lane, m, l, acc);
    t = t_next;
    bits = next_bits;
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int g = warp + kWarps * i;
    if (g >= G) continue;
    const int64_t row = (static_cast<int64_t>(b) * H + kvh * G + g) * splits + split;
    if (lane == 0) {
      part_m[row] = m[i];
      part_l[row] = l[i];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) part_acc[row * D + lane + 32 * c] = acc[i][c];
  }
}

// One block of D threads per (request, query head): rescale each split's
// partial to the row's maximum and sum.  A split that saw no valid row
// reports m = -1e30 and l = 0, so it adds nothing; a row no split saw
// gives 0 / 1e-30 = 0.
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                    const float* __restrict__ part_acc, T* __restrict__ o, int splits) {
  const int64_t row = blockIdx.x;  // b * H + h
  const int d = threadIdx.x;
  const float* pm = part_m + row * splits;
  const float* pl = part_l + row * splits;
  const float* pa = part_acc + row * splits * D;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, pm[s]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = expf(pm[s] - mx);
    l += pl[s] * w;
    a += pa[s * D + d] * w;
  }
  o[row * D + d] = from_float<T>(a / fmaxf(l, 1e-30f));
}

struct Args {
  const void *q, *k, *v, *valid;
  void *part_m, *part_l, *part_acc, *o;
  int B, H, KV, S, split_len, splits;
  int64_t q_sb, q_sh, kv_sb, kv_ss, kv_sh, valid_sb;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int R>
cudaError_t launch_rows(const Args& a) {
  auto kernel = decode_split_kernel<T, D, R>;
  const int G = a.H / a.KV;
  const size_t smem = split_smem_bytes<D, R>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.splits, a.KV, a.B), kWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.valid), static_cast<float*>(a.part_m),
      static_cast<float*>(a.part_l), static_cast<float*>(a.part_acc), a.H, G, a.S,
      a.split_len, a.splits, a.q_sb, a.q_sh, a.kv_sb, a.kv_ss, a.kv_sh, a.valid_sb,
      a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T, D><<<a.B * a.H, D, 0, a.stream>>>(
      static_cast<const float*>(a.part_m), static_cast<const float*>(a.part_l),
      static_cast<const float*>(a.part_acc), static_cast<T*>(a.o), a.splits);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Args& a) {
  switch (rows_per_warp(a.H / a.KV, kWarps)) {
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

}  // namespace

// q: (B, H, D) with element strides (q_sb, q_sh) and contiguous D; k and v:
// (B, S, KV, D) with the same element strides (kv_sb, kv_ss, kv_sh),
// contiguous D, rows 16-byte aligned; valid: (B, S) bytes (0 or 1) with
// row stride valid_sb and contiguous S; part_m, part_l: (B, H, splits) and
// part_acc: (B, H, splits, D) float32 scratch; out: (B, H, D) contiguous.
// The sequence is cut into `splits` pieces of split_len tokens (a multiple
// of 32; splits * split_len >= S).  Returns cudaGetLastError().
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* valid, void* part_m, void* part_l,
                                      void* part_acc, void* out, int dtype, int B, int H,
                                      int KV, int S, int D, int split_len, int splits,
                                      int64_t q_sb, int64_t q_sh, int64_t kv_sb,
                                      int64_t kv_ss, int64_t kv_sh, int64_t valid_sb,
                                      float scale, void* stream) {
  if (B <= 0 || KV <= 0 || S <= 0 || H % KV != 0 || H / KV > kMaxGroup || splits <= 0 ||
      split_len <= 0 || split_len % kTT != 0 ||
      static_cast<int64_t>(split_len) * splits < S)
    return cudaErrorInvalidValue;
  const Args a{q,    k,    v,     valid, part_m, part_l, part_acc, out,
               B,    H,    KV,    S,     split_len, splits, q_sb, q_sh,
               kv_sb, kv_ss, kv_sh, valid_sb, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return dispatch_dim<float>(D, a);
  if (dtype == kBFloat16) return dispatch_dim<__nv_bfloat16>(D, a);
  return cudaErrorInvalidValue;
}
