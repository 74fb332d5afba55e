// Tensor-core building blocks: for the bf16 attention kernels, cp.async
// staging, ldmatrix fragment loads, the m16n8k16 bf16 -> f32 mma.sync, and
// one key tile of attention with the online softmax kept in the
// accumulator fragments (attend_tile_mma); for the float32 SSD scan, the
// m16n8k8 tf32 mma.sync in three passes (3xTF32, at the end).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16 inputs), for lane
// l of a warp, g = l / 4 and t = l % 4:
//   A (16 x 16, row-major), 4 registers of 2 bf16: a0 = (row g, cols 2t,
//     2t + 1), a1 = (row g + 8, same cols), a2 = (row g, cols 2t + 8,
//     2t + 9), a3 = (row g + 8, cols 2t + 8, 2t + 9);
//   B (16 x 8, k-major), 2 registers: b0 = (k 2t, 2t + 1; col g), b1 =
//     (k 2t + 8, 2t + 9; col g);
//   C/D (16 x 8, f32), 4 registers: c0, c1 = (row g, cols 2t, 2t + 1),
//     c2, c3 = (row g + 8, cols 2t, 2t + 1).
// So the score accumulators of two neighbouring 8-key blocks are, once
// rounded to bf16 pairs, the A operand of the next product over those 16
// keys: P never leaves registers.
#pragma once

#include "common.cuh"

namespace repro {

// log2(e): scores are scaled by scale * log2(e) so the softmax runs on exp2f
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, bypassing L1; with !pred nothing is read
// and the 16 bytes are zero-filled (a row past the end, or a masked row: V
// must be zero there, since 0 * an uninitialised NaN is NaN).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and register i receives matrix i's fragment (row l / 4, cols 2(l % 4)
// and 2(l % 4) + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The same, transposed: register i receives (rows 2(l % 4) and 2(l % 4) + 1,
// col l / 4) of matrix i.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a * b on the tensor cores: 16x16 bf16 times 16x8 bf16 into 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to nearest-even bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Shared-memory tiles are bf16 rows of D elements padded to D + 8: a row
// then starts 16 bytes further round the 32 banks than the one before, so
// the 8 row addresses of one ldmatrix matrix hit 8 different 16-byte bank
// groups (no conflict), and every row stays 16-byte aligned for cp.async.
template <int D>
constexpr int kLd = D + 8;

// The A fragments of 16 query rows over all of D: qs points at the first
// of the rows, ld elements apart.
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[D / 16][4],
                                             const __nv_bfloat16* qs, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(qf[kk], qs + (lane & 15) * kLd<D> + kk * 16 + (lane >> 4) * 8);
}

// One tile of NT keys (a multiple of 16) for a warp's 16 query rows.
//   qf: the rows' A fragments (load_q_frags); ks / vs: the tile's first K
//   and V rows in shared memory, bf16, kLd<D> apart; scale_log2 = scale *
//   log2(e); ok(r, j): may row r (0..15) see key j (0..NT-1), read only
//   when kMasked (masked scores are -1e30, as in the JAX kernels);
//   m, l: the online-softmax max (log2 domain) and this thread's partial
//   sum for rows g and g + 8; o: the output accumulators, D / 8 blocks of
//   8 columns in the C layout.
// S = Q K^T and O += P V both run as m16n8k16 products; the row max is a
// shuffle within the quad of lanes that share a row; P is rounded to bf16
// in registers and is the A operand of P V; V's B fragments come from
// ldmatrix.trans, K's from ldmatrix (K^T is the k-major B operand).
template <int D, int NT, bool kMasked, typename Ok>
__device__ __forceinline__ void attend_tile_mma(const uint32_t (&qf)[D / 16][4],
                                                const __nv_bfloat16* ks,
                                                const __nv_bfloat16* vs, float scale_log2,
                                                Ok ok, int lane, float (&m)[2], float (&l)[2],
                                                float (&o)[D / 8][4]) {
  static_assert(NT % 16 == 0 && D % 16 == 0, "whole 16-wide steps");
  constexpr int LD = kLd<D>;
  const int g = lane >> 2, t = lane & 3;

  float s[NT / 8][4];
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  // matrices of one ldmatrix.x4: keys 0-7 | d 0-7, keys 0-7 | d 8-15,
  // keys 8-15 | d 0-7, keys 8-15 | d 8-15: b0, b1 of two 8-key blocks
  const __nv_bfloat16* kp = ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < NT / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, kp + np * 16 * LD + kk * 16);
      mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
      mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
    }
  }

  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * scale_log2;
      if (kMasked && !ok(g + (e >> 1) * 8, j * 8 + 2 * t + (e & 1))) x = kNegInf;
      s[j][e] = x;
    }
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 2));
    alpha[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2f(s[j][e] - mx[e >> 1]);
      sum[e >> 1] += s[j][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    o[nb][0] *= alpha[0];
    o[nb][1] *= alpha[0];
    o[nb][2] *= alpha[1];
    o[nb][3] *= alpha[1];
  }

  // matrices of one ldmatrix.x4.trans: keys 0-7 | d 0-7, keys 8-15 | d 0-7,
  // keys 0-7 | d 8-15, keys 8-15 | d 8-15: b0, b1 of two 8-column blocks
  const __nv_bfloat16* vp = vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NT / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                           pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, vp + kk * 16 * LD + dp * 16);
      mma_bf16(o[2 * dp], a, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// -- float32 products on the tensor cores: 3xTF32 --------------------------
//
// mma.m16n8k8 with .tf32 inputs, for lane l of a warp, g = l / 4 and
// t = l % 4 (PTX ISA):
//   A (16 x 8, row-major), 4 registers of one tf32: a0 = (row g, col t),
//     a1 = (row g + 8, col t), a2 = (row g, col t + 4), a3 = (row g + 8,
//     col t + 4);
//   B (8 x 8, k-major), 2 registers: b0 = (k t, col g), b1 = (k t + 4,
//     col g);
//   C/D (16 x 8, f32): as for m16n8k16 above.
// A tf32 is a float32 whose low 13 mantissa bits the tensor core ignores:
// 10 of float32's 23 bits (about 3 digits).  Split each float32 operand a
// into hi = a rounded to a tf32 and lo = a - hi (exact in float32, at most
// 2^-11 |a|), and sum lo·hi + hi·lo + hi·hi in the float32 accumulator:
// the tensor core's cut of lo's low bits costs at most 2^-21 |a| and the
// dropped lo·lo term 2^-22 of the product, so the result keeps about
// float32's accuracy at three tensor-core products the tile.  The split is
// integer work (round half away from zero on the bits, then mask) and one
// subtraction, not conversions, which run at a quarter of the rate.

__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// d += a * b on the tensor cores: 16x8 tf32 times 8x8 tf32 into 16x8 f32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 16 x 8 A operand in hi and lo parts; at(r, k) gives element (r, k).
struct FragA3 {
  uint32_t hi[4], lo[4];
  template <typename At>
  __device__ __forceinline__ void load(At at, int lane) {
    const int g = lane >> 2, t = lane & 3;
    split_tf32(at(g, t), hi[0], lo[0]);
    split_tf32(at(g + 8, t), hi[1], lo[1]);
    split_tf32(at(g, t + 4), hi[2], lo[2]);
    split_tf32(at(g + 8, t + 4), hi[3], lo[3]);
  }
};

// An 8 x 8 B operand in hi and lo parts; at(k, n) gives element (k, n).
struct FragB3 {
  uint32_t hi[2], lo[2];
  template <typename At>
  __device__ __forceinline__ void load(At at, int lane) {
    const int g = lane >> 2, t = lane & 3;
    split_tf32(at(t, g), hi[0], lo[0]);
    split_tf32(at(t + 4, g), hi[1], lo[1]);
  }
};

// d[q] += a * b[q] in about float32 precision for the first n of Q tiles
// that share the A operand: the small terms first, each term over all n
// tiles before the next, so two products into one accumulator are n mma
// apart and the tensor pipe does not wait on its own results.
template <int Q>
__device__ __forceinline__ void mma_3xtf32(float (&d)[Q][4], const FragA3& a,
                                           const FragB3 (&b)[Q], int n) {
#pragma unroll
  for (int q = 0; q < Q; ++q)
    if (q < n) mma_tf32(d[q], a.lo, b[q].hi[0], b[q].hi[1]);
#pragma unroll
  for (int q = 0; q < Q; ++q)
    if (q < n) mma_tf32(d[q], a.hi, b[q].lo[0], b[q].lo[1]);
#pragma unroll
  for (int q = 0; q < Q; ++q)
    if (q < n) mma_tf32(d[q], a.hi, b[q].hi[0], b[q].hi[1]);
}

// The sum over the quad of lanes that share a row (the m of a row is
// already the same on all four after attend_tile_mma).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 1);
  x += __shfl_xor_sync(kFullMask, x, 2);
  return x;
}

}  // namespace repro
