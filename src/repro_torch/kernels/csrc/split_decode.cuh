// Split-K one-token decode attention, shared by the flat and the paged
// decode (decode_attention.cu, paged_attention.cu): the bodies of the
// split kernels, which write one (m, l, acc) partial per (request, query
// head, split), and of the merge kernel, which combines them.  Each .cu
// file wraps them in __global__ kernels of its own names, so a profile
// tells the two decodes apart.
//
// The grid is (split, KV head, request).  A split covers the tokens
// [s_begin, s_end) of its request; `Rows` says where they live:
//   rows.valid(t)  may token t be attended (t < s_end is checked here);
//   rows.offset(t) the element offset of token t's row of this KV head
//                  from the K and V base pointers (the same for both).
// The flat decode reads a (B, S) mask and a strided cache, the paged decode
// its request's row of the page table, so any page size works.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace repro {

constexpr int kDecodeWarps = 4;  // warps of a split block
constexpr int kMaxGroup = 16 * kDecodeWarps;  // query heads per KV head

// A split with no token to attend writes the empty partial, m = -1e30 and
// l = 0, and returns: the merge reads every split's partial.
__device__ __forceinline__ void write_empty_partials(float* part_m, float* part_l,
                                                     float* part_acc, int H, int G, int D,
                                                     int kvh, int b, int split, int splits) {
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    const int64_t row = (static_cast<int64_t>(b) * H + kvh * G + g) * splits + split;
    part_acc[row * D + d] = 0.f;
    if (d == 0) {
      part_m[row] = kNegInf;
      part_l[row] = 0.f;
    }
  }
}

// -- float32: 32-token tiles on the CUDA cores --------------------------------

constexpr int kTT = 32;  // tokens per tile: one per lane

template <int D, int R>
size_t split_smem_bytes() {
  return sizeof(float) * (kDecodeWarps * R * D + kTT * (D + 1) + kTT * D);
}

// One lane per token of a tile, R = 1, 4, 12 or 16 query rows a warp (rows
// past G are zeros and computed too, so no branch guards the tile's warp
// shuffles), attend_tile in common.cuh; K/V rows move as 16-byte chunks
// into registers, the next tile's while the current one is computed, then
// into shared memory as float32.  Partials: m and l (B, H, splits), acc
// (B, H, splits, D), all float32, m in natural-log units.
template <typename T, int D, int R, typename Rows>
__device__ __forceinline__ void split_attend_f32(const T* __restrict__ q, const T* kb,
                                                 const T* vb, Rows rows, float* part_m,
                                                 float* part_l, float* part_acc, int H, int G,
                                                 int s_begin, int s_end, int splits,
                                                 int64_t q_sb, int64_t q_sh, float scale) {
  constexpr int W = kDecodeWarps;
  constexpr int C = kCols<D>;
  extern __shared__ __align__(16) float smem_f32[];
  float* qs = smem_f32;         // [W * R][D], zero past G
  float* ks = qs + W * R * D;   // [kTT][D + 1]
  float* vs = ks + kTT * (D + 1);  // [kTT][D]

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (s_begin >= s_end) {
    write_empty_partials(part_m, part_l, part_acc, H, G, D, kvh, b, split, splits);
    return;
  }

  for (int i = tid; i < W * R * D; i += W * 32) {
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
  // Every warp reads the same 32 tokens, so the answer is block-uniform.
  auto next_tile = [&](int t, unsigned& bits) {
    for (; t < s_end; t += kTT) {
      bits = __ballot_sync(kFullMask, t + lane < s_end && rows.valid(t + lane));
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
  constexpr int kPer = kTT * kChunks / (W * 32);
  static_assert(kPer >= 1 && kTT * kChunks % (W * 32) == 0, "tile split");
  uint4 kraw[kPer], vraw[kPer];
  auto load_tile = [&](int t0, unsigned bits) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = tid + i * W * 32;
      const int j = c / kChunks;
      kraw[i] = vraw[i] = make_uint4(0u, 0u, 0u, 0u);
      if ((bits >> j) & 1u) {  // a set bit implies t0 + j < s_end
        const int64_t off = rows.offset(t0 + j) + (c % kChunks) * V;
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
      const int c = tid + i * W * 32;
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

    attend_tile<W, R, D>(qs, ks, vs, ok, scale, warp, lane, m, l, acc);
    t = t_next;
    bits = next_bits;
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int g = warp + W * i;
    if (g >= G) continue;
    const int64_t row = (static_cast<int64_t>(b) * H + kvh * G + g) * splits + split;
    if (lane == 0) {
      part_m[row] = m[i];
      part_l[row] = l[i];
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (col_ok<D>(lane, c)) part_acc[row * D + lane + 32 * c] = acc[i][c];
  }
}

// -- bf16: 64-token tiles on the tensor cores ---------------------------------

constexpr int kMmaTT = 64;  // tokens per tile

// warps that split one 16-row tile's tokens, for MT row tiles
template <int MT>
constexpr int kTokenWarps = MT == 1 ? 4 : MT == 2 ? 2 : 1;

template <int D, int MT>
constexpr size_t split_mma_smem_bytes() {
  // the Q rows, then two stages of K and two of V; the warps' partials
  // reuse the K/V space once the last tile is done
  return sizeof(__nv_bfloat16) * kLd<D> * (16 * MT + 4 * kMmaTT);
}

// 64-token tiles, moved by 16-byte cp.async straight into shared memory as
// bf16 (two stages, rows padded to D + 8 for conflict-free ldmatrix, rows
// that are not valid zero-filled and never read).  QK^T and P V are
// mma.sync m16n8k16 products (attend_tile_mma) over the G query rows padded
// with zeros to MT = ceil(G / 16) tiles of 16.  A 16 x 128 f32 accumulator
// is 64 registers a thread, so a warp holds one 16-row tile.  With MT = 1
// or 2 (G <= 32) the KS = 4 / MT warps of a row tile split each tile's
// tokens (16 or 32 each) and merge their (m, l, acc) in shared memory at
// the end; with MT = 3 (G = 48) or 4 each warp takes a row tile and all 64
// tokens (the fourth warp of MT = 3 only loads).  Each K/V row crosses
// device memory once per KV head, and no warp computes a tile that is only
// padding.  A warp skips its token slice of a tile when nothing in it is
// valid, and masks only a slice that is partly valid.  Partials as
// split_attend_f32 writes them.
template <int D, int MT, typename Rows>
__device__ __forceinline__ void split_attend_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* kb, const __nv_bfloat16* vb,
    Rows rows, float* part_m, float* part_l, float* part_acc, int H, int G, int s_begin,
    int s_end, int splits, int64_t q_sb, int64_t q_sh, float scale_log2) {
  using bf16 = __nv_bfloat16;
  constexpr int W = kDecodeWarps;
  constexpr int KS = kTokenWarps<MT>;
  constexpr int NT = kMmaTT / KS;  // tokens of a tile one warp computes
  constexpr unsigned long long kSlice = NT == 64 ? ~0ull : (1ull << NT) - 1;
  constexpr int LD = kLd<D>;
  constexpr int kRowsQ = 16 * MT;
  constexpr int kChunks = D / 8;  // 16-byte chunks per token row
  constexpr int kPer = kMmaTT * kChunks / (W * 32);
  static_assert(kPer >= 1 && kMmaTT * kChunks % (W * 32) == 0, "tile split");
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
  if (s_begin >= s_end) {
    write_empty_partials(part_m, part_l, part_acc, H, G, D, kvh, b, split, splits);
    return;
  }

  for (int i = tid; i < kRowsQ * D; i += W * 32) {
    const int g = i / D, d = i % D;
    qs[g * LD + d] = g < G ? q[b * q_sb + (kvh * G + g) * q_sh + d] : __float2bfloat16(0.f);
  }

  // The first tile at or after t with a valid row, and its rows' bits.
  // Every warp reads the same 64 tokens, so the answer is block-uniform.
  auto next_tile = [&](int t, unsigned long long& bits) {
    for (; t < s_end; t += kMmaTT) {
      const unsigned lo = __ballot_sync(kFullMask, t + lane < s_end && rows.valid(t + lane));
      const unsigned hi =
          __ballot_sync(kFullMask, t + 32 + lane < s_end && rows.valid(t + 32 + lane));
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
      const int c = tid + i * W * 32;
      const int j = c / kChunks, d0 = (c % kChunks) * 8;
      const bool in = (bits >> j) & 1ull;  // a set bit implies t0 + j < s_end
      const int64_t off = (in ? rows.offset(t0 + j) : 0) + d0;
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
  for (int i = tid; i < G * D; i += W * 32) {
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
      part_m[row] = mx * kLn2;  // natural-log units, as the merge reads them
      part_l[row] = lsum;
    }
  }
}

// -- the merge ----------------------------------------------------------------

// One block of D threads per (request, query head): rescale each split's
// partial to the row's maximum and sum.  A split that saw no valid row
// reports m = -1e30 and l = 0, so it adds nothing; a row no split saw
// gives 0 / 1e-30 = 0.
template <typename T, int D>
__device__ __forceinline__ void merge_partials(const float* __restrict__ part_m,
                                               const float* __restrict__ part_l,
                                               const float* __restrict__ part_acc,
                                               T* __restrict__ o, int splits) {
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

}  // namespace repro
