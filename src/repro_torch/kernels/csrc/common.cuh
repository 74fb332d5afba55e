// Helpers shared by the attention kernels: element conversions, warp
// reductions and the dtype codes of the C interface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes passed by the Python wrappers (kernels/_build.py: DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// masked score, as the JAX kernels write it (never -inf: exp(-inf - -inf) is NaN)
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A 16-byte chunk of a row: kVec<T> elements, loaded with one instruction.
template <typename T>
constexpr int kVec = 16 / sizeof(T);

// Unpack one 16-byte chunk into kVec<T> floats.
__device__ __forceinline__ void unpack(const uint4& raw, float* out, float) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = f[e];
}
__device__ __forceinline__ void unpack(const uint4& raw, float* out, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// Output columns a lane holds in the float32 tiles: lane + 32 * c for
// c < kCols<D>.  Below D = 32 (D = 16) lanes 0..D-1 hold one column and
// the others none: col_ok is false for them, and they read zeros of V and
// write nothing.
template <int D>
constexpr int kCols = (D + 31) / 32;

template <int D>
__device__ __forceinline__ bool col_ok(int lane, int c) {
  return D % 32 == 0 || lane + 32 * c < D;
}

// One 32-token tile of one-query attention: the float32 tile of both
// decode kernels (split_attend_f32 in split_decode.cuh; bf16 runs
// attend_tile_mma on the tensor cores instead).  K sits in ks as [32][D + 1]
// floats (padded: lane j reads row j without bank conflicts), V in vs as
// [32][D], the query rows in qs as [W * R][D], zero past the G real ones.
// A warp owns rows warp + W * i, i < R, and keeps their online-softmax
// state (m, l, acc) in registers, lane holding output columns lane + 32 *
// c (kCols above).  Lane j scores token j, masked where !ok; the K value
// of a column is read once for all R rows.  Every row is computed,
// padding included, so no branch guards the shuffles: the caller writes
// out only the real rows.
template <int W, int R, int D>
__device__ __forceinline__ void attend_tile(const float* qs, const float* ks,
                                            const float* vs, bool ok, float scale,
                                            int warp, int lane, float (&m)[R], float (&l)[R],
                                            float (&acc)[R][kCols<D>]) {
  constexpr int C = kCols<D>;
  const float* kr = ks + lane * (D + 1);
  float s[R];
#pragma unroll
  for (int i = 0; i < R; ++i) s[i] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float k0 = kr[d], k1 = kr[d + 1], k2 = kr[d + 2], k3 = kr[d + 3];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + (warp + W * i) * D + d);
      s[i] += qv.x * k0;
      s[i] += qv.y * k1;
      s[i] += qv.z * k2;
      s[i] += qv.w * k3;
    }
  }
  float p[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float si = ok ? s[i] * scale : kNegInf;
    const float m_cur = fmaxf(m[i], warp_max(si));
    p[i] = expf(si - m_cur);
    const float alpha = expf(m[i] - m_cur);
    l[i] = l[i] * alpha + warp_sum(p[i]);
    m[i] = m_cur;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
  }
  for (int j = 0; j < 32; ++j) {
    float vv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) vv[c] = col_ok<D>(lane, c) ? vs[j * D + lane + 32 * c] : 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float pj = __shfl_sync(kFullMask, p[i], j);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] += pj * vv[c];
    }
  }
}

// Query rows per warp a decode kernel is compiled for: the smallest of
// 1, 4, 12 and 16 that covers G rows over `warps` warps (G <= 16 * warps).
inline int rows_per_warp(int G, int warps) {
  if (G <= warps) return 1;
  if (G <= 4 * warps) return 4;
  return G <= 12 * warps ? 12 : 16;
}

// Raise a kernel's dynamic shared memory cap where it needs more than the
// 48 KB a launch gets by default.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
