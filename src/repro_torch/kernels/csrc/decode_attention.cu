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
// bf16 (decode_split_mma_kernel): 64-token tiles, moved by 16-byte
// cp.async straight into shared memory as bf16 (two stages, rows padded to
// D + 8 for conflict-free ldmatrix, rows the mask rules out zero-filled and
// never read).  QK^T and P V are mma.sync m16n8k16 products
// (attend_tile_mma in mma.cuh) over the G query rows padded with zeros to
// MT = ceil(G / 16) tiles of 16.  Registers fix the layout: a 16 x 128 f32
// accumulator is 64 registers a thread, so a warp holds one 16-row tile.
// With MT = 1 or 2 (G <= 32) the 4 warps would otherwise leave 3 or 2 idle,
// so the KS = 4 / MT warps of a row tile split each 64-token tile's tokens
// (16 or 32 each) and merge their (m, l, acc) in shared memory at the end;
// with MT = 3 (granite-20b's G = 48) or 4 each warp takes a row tile and all
// 64 tokens (the fourth warp of MT = 3 only loads).  Either way each K/V row
// crosses device memory once per KV head, and no warp computes a tile
// that is only padding.  A warp skips its token slice of a tile when the
// mask leaves nothing valid in it, and masks only a slice that is partly
// valid.
//
// float32 (decode_split_kernel), as first written: 32-token tiles, one
// lane per token, R = 1, 4, 12 or 16 query rows a warp (rows past G are
// zeros and computed too, so no branch guards the tile's warp shuffles),
// attend_tile in common.cuh (shared with the paged decode); K/V rows move
// as 16-byte chunks into registers, then into shared memory as float32.
#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace repro;

// -- float32: the CUDA-core kernel --------------------------------------------

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

// -- bf16: the tensor-core kernel ---------------------------------------------

constexpr int kMmaTT = 64;  // tokens per tile

// warps that split one 16-row tile's tokens, for MT row tiles
template <int MT>
constexpr int kSplitWarps = MT == 1 ? 4 : MT == 2 ? 2 : 1;

template <int D, int MT>
constexpr size_t split_mma_smem_bytes() {
  // the Q rows, then two stages of K and two of V; the warps' partials
  // reuse the K/V space once the last tile is done
  return sizeof(__nv_bfloat16) * kLd<D> * (16 * MT + 4 * kMmaTT);
}

// Partials as decode_split_kernel writes them (m in natural-log units).
template <int D, int MT>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const uint8_t* __restrict__ valid, float* __restrict__ part_m,
                        float* __restrict__ part_l, float* __restrict__ part_acc, int H, int G,
                        int S, int split_len, int splits, int64_t q_sb, int64_t q_sh,
                        int64_t kv_sb, int64_t kv_ss, int64_t kv_sh, int64_t valid_sb,
                        float scale_log2) {
  using bf16 = __nv_bfloat16;
  constexpr int KS = kSplitWarps<MT>;
  constexpr int NT = kMmaTT / KS;  // tokens of a tile one warp computes
  constexpr unsigned long long kSlice = NT == 64 ? ~0ull : (1ull << NT) - 1;
  constexpr int LD = kLd<D>;
  constexpr int kRowsQ = 16 * MT;
  constexpr int kChunks = D / 8;  // 16-byte chunks per token row
  constexpr int kPer = kMmaTT * kChunks / (kWarps * 32);
  static_assert(kPer >= 1 && kMmaTT * kChunks % (kWarps * 32) == 0, "tile split");
  static_assert(sizeof(float) * KS * kRowsQ * (D + 2) <= sizeof(bf16) * 4 * kMmaTT * LD,
                "the partials fit in the K/V stages");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kRowsQ][LD], zero past G
  bf16* ks = qs + kRowsQ * LD;                   // [2][kMmaTT][LD]
  bf16* vs = ks + 2 * kMmaTT * LD;               // [2][kMmaTT][LD]

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int mt = warp / KS;  // the warp's 16-row tile
  const int kq = warp % KS;  // and its slice of a tile's tokens
  const bool computes = warp < MT * KS;
  const int s_begin = split * split_len;
  const int s_end = min(S, s_begin + split_len);
  const uint8_t* vrow = valid + b * valid_sb;
  const bf16* kb = k + b * kv_sb + kvh * kv_sh;
  const bf16* vb = v + b * kv_sb + kvh * kv_sh;

  for (int i = tid; i < kRowsQ * D; i += kWarps * 32) {
    const int g = i / D, d = i % D;
    qs[g * LD + d] = g < G ? q[b * q_sb + (kvh * G + g) * q_sh + d] : __float2bfloat16(0.f);
  }

  // The first tile at or after t with a valid row, and its rows' bits.
  // Every warp reads the same 64 mask bytes, so the answer is block-uniform.
  auto next_tile = [&](int t, unsigned long long& bits) {
    for (; t < s_end; t += kMmaTT) {
      const unsigned lo = __ballot_sync(kFullMask, t + lane < s_end && vrow[t + lane] != 0);
      const unsigned hi =
          __ballot_sync(kFullMask, t + 32 + lane < s_end && vrow[t + 32 + lane] != 0);
      bits = lo | static_cast<unsigned long long>(hi) << 32;
      if (bits) return t;
    }
    bits = 0ull;
    return s_end;
  };

  // the tile's valid rows into a stage; the others zero-filled, not read
  auto load_tile = [&](int stage, int t0, unsigned long long bits) {
    bf16* kd = ks + stage * kMmaTT * LD;
    bf16* vd = vs + stage * kMmaTT * LD;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * kWarps * 32;
      const int j = c / kChunks, d0 = (c % kChunks) * 8;
      const bool in = (bits >> j) & 1ull;  // a set bit implies t0 + j < s_end
      const int64_t off = (in ? static_cast<int64_t>(t0 + j) * kv_ss : 0) + d0;
      cp_async_16(kd + j * LD + d0, kb + off, in);
      cp_async_16(vd + j * LD + d0, vb + off, in);
    }
  };

  uint32_t qf[D / 16][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;

  unsigned long long bits;
  int t = next_tile(s_begin, bits);
  if (t < s_end) load_tile(0, t, bits);
  cp_async_commit();
  __syncthreads();  // qs is written
  if (computes) load_q_frags<D>(qf, qs + mt * 16 * LD, lane);
  int stage = 0;
  while (t < s_end) {
    unsigned long long next_bits;
    const int t_next = next_tile(t + kMmaTT, next_bits);
    cp_async_wait<0>();
    __syncthreads();  // tile t landed; every warp is done with the previous one
    if (t_next < s_end) load_tile(stage ^ 1, t_next, next_bits);  // in flight meanwhile
    cp_async_commit();
    const unsigned long long mine = (bits >> (kq * NT)) & kSlice;
    if (computes && mine != 0ull) {
      const bf16* kt = ks + (stage * kMmaTT + kq * NT) * LD;
      const bf16* vt = vs + (stage * kMmaTT + kq * NT) * LD;
      if (mine == kSlice) {
        attend_tile_mma<D, NT, false>(qf, kt, vt, scale_log2, [](int, int) { return true; },
                                      lane, m, l, acc);
      } else {
        auto ok = [&](int, int j) { return ((mine >> j) & 1ull) != 0ull; };
        attend_tile_mma<D, NT, true>(qf, kt, vt, scale_log2, ok, lane, m, l, acc);
      }
    }
    t = t_next;
    bits = next_bits;
    stage ^= 1;
  }

  // merge the KS token slices of each row tile through shared memory
  __syncthreads();  // every warp is done with the K/V stages
  float* red_m = reinterpret_cast<float*>(ks);  // [KS][kRowsQ]
  float* red_l = red_m + KS * kRowsQ;            // [KS][kRowsQ]
  float* red_acc = red_l + KS * kRowsQ;          // [KS][kRowsQ][D]
  if (computes) {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = quad_sum(l[r]);
      const int row = kq * kRowsQ + mt * 16 + g + 8 * r;
      if (t4 == 0) {
        red_m[row] = m[r];
        red_l[row] = lr;
      }
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        red_acc[row * D + nb * 8 + 2 * t4] = acc[nb][2 * r];
        red_acc[row * D + nb * 8 + 2 * t4 + 1] = acc[nb][2 * r + 1];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kWarps * 32) {
    const int g = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int s = 0; s < KS; ++s) mx = fmaxf(mx, red_m[s * kRowsQ + g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const float w = exp2f(red_m[s * kRowsQ + g] - mx);
      lsum += red_l[s * kRowsQ + g] * w;
      a += red_acc[(s * kRowsQ + g) * D + d] * w;
    }
    const int64_t row = (static_cast<int64_t>(b) * H + kvh * G + g) * splits + split;
    part_acc[row * D + d] = a;
    if (d == 0) {
      part_m[row] = mx * kLn2;  // natural-log units, as the merge kernel reads them
      part_l[row] = lsum;
    }
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
  kernel<<<dim3(a.splits, a.KV, a.B), kWarps * 32, smem, a.stream>>>(
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

template <int D, int MT>
cudaError_t launch_mma(const Args& a) {
  auto kernel = decode_split_mma_kernel<D, MT>;
  const size_t smem = split_mma_smem_bytes<D, MT>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.splits, a.KV, a.B), kWarps * 32, smem, a.stream>>>(
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
