// RMSNorm (optionally behind a residual add) and split-half rotary
// embedding, each one pass over its rows.
//
// Neither replaces a Pallas kernel: the JAX package writes its norms and
// its rotary as jnp (models/common.py) and leaves them to XLA, which fuses
// each into one loop.  In the port they ran as PyTorch's elementwise
// chains: six launches and about 36 bytes an element a norm, about 48 a
// rotary call, which rebuilt its frequencies and cos/sin every time.
//
// Both are bound by bytes.  The norm reads each row once into registers,
// reduces its sum of squares in float32 within the block and writes the
// row once: 4 bytes an element in bf16, 8 behind a residual add (x and the
// residual read, the sum and the normed row written).  The rotary reads and
// writes q and k in place, 4 bytes an element, one launch for both; each
// thread computes the cos and sin of its own frequency once, from the
// positions on the device, and rotates that pair in every head of its token.
//
// The rounding is the plain version's (models/common.py) as PyTorch's ops
// round it on the card: the norm normalises in float32, rounds to the
// input's type, then multiplies by the weight in float32 and rounds again;
// a residual sum is rounded before it is normed.  The rotary computes its
// angles as float(pos) * 1 / theta^(2i/hd) with the precise powf, cosf and
// sinf, and each product and sum rounded on its own (no fused
// multiply-add), as PyTorch's separate elementwise ops round them; a
// division by a scalar (the mean's 1 / D, the exponent's 1 / hd) is a
// product with the rounded reciprocal, as PyTorch takes it.  Only the
// norm's sum of squares is taken in another order.

#include "common.cuh"

namespace repro {
namespace {

constexpr int kBlock = 256;       // threads a block aims for
constexpr int kMaxThreads = 512;  // threads of one norm row at most
constexpr int kMaxChunks = 8;     // 16-byte chunks (or elements) a thread holds at most

// VEC elements at p as floats, and back (VEC > 1: one 16-byte access).
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  if constexpr (VEC == 1) {
    f[0] = to_float(*p);
  } else {
    unpack(*reinterpret_cast<const uint4*>(p), f, T());
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  if constexpr (VEC == 1) {
    *p = from_float<T>(f[0]);
  } else {
    alignas(16) T tmp[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) tmp[e] = from_float<T>(f[e]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(tmp);
  }
}

// One row of D elements per `tpr` threads (whole warps), blockDim.x / tpr
// rows a block.  Thread t of a row holds its chunks t, t + tpr, ... of VEC
// elements in registers, at most CHUNKS of them.  With `res`, the row is
// round(x + res), written to `sum_out` before it is normed.
template <typename T, int VEC, int CHUNKS>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res, const T* __restrict__ w,
               T* __restrict__ out, T* __restrict__ sum_out, int64_t rows, int D, int tpr,
               int64_t x_rs, int64_t res_rs, float eps) {
  __shared__ float part[kMaxThreads / 32];
  const int tid = threadIdx.x;
  const int rows_per_block = blockDim.x / tpr;
  const int r = tid / tpr;
  const int t = tid % tpr;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * rows_per_block + r;
  const bool live = row < rows;
  const int nvec = D / VEC;
  float v[CHUNKS][VEC];
  float ss = 0.f;
  if (live) {
    const T* xr = x + row * x_rs;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int j = t + c * tpr;
      if (j < nvec) {
        load_vec<T, VEC>(xr + j * VEC, v[c]);
        if (res != nullptr) {
          float rv[VEC];
          load_vec<T, VEC>(res + row * res_rs + j * VEC, rv);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            v[c][e] = to_float(from_float<T>(__fadd_rn(rv[e], v[c][e])));
          store_vec<T, VEC>(sum_out + row * D + j * VEC, v[c]);
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) ss += v[c][e] * v[c][e];
      }
    }
  }
  // every lane of a warp serves one row: tpr is a multiple of 32
  ss = warp_sum(ss);
  const int wpr = tpr / 32;
  if (wpr > 1) {
    if ((tid & 31) == 0) part[tid / 32] = ss;
    __syncthreads();
    ss = 0.f;
    for (int i = 0; i < wpr; ++i) ss += part[r * wpr + i];
  }
  if (!live) return;
  // the mean as PyTorch's reduction takes it, times the rounded 1 / D
  const float inv = rsqrtf(__fmul_rn(ss, 1.0f / static_cast<float>(D)) + eps);
  T* o = out + row * D;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int j = t + c * tpr;
    if (j < nvec) {
      float wv[VEC];
      load_vec<T, VEC>(w + j * VEC, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        v[c][e] = __fmul_rn(to_float(from_float<T>(__fmul_rn(v[c][e], inv))), wv[e]);
      store_vec<T, VEC>(o + j * VEC, v[c]);
    }
  }
}

template <typename T, int VEC, int CHUNKS>
int launch_rmsnorm(const void* x, const void* res, const void* w, void* out, void* sum_out,
                   int64_t rows, int D, int tpr, int64_t x_rs, int64_t res_rs, float eps,
                   cudaStream_t stream) {
  const int rows_per_block = tpr >= kBlock ? 1 : kBlock / tpr;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  rmsnorm_kernel<T, VEC, CHUNKS><<<static_cast<unsigned>(blocks), tpr * rows_per_block, 0,
                                   stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const T*>(w),
      static_cast<T*>(out), static_cast<T*>(sum_out), rows, D, tpr, x_rs, res_rs, eps);
  return cudaGetLastError();
}

// The threads of a row, and the chunks each holds: one chunk a thread while
// a row fits kBlock threads; past it kBlock threads, or more where a thread
// would hold more than kMaxChunks chunks.  Registers are sized for the
// fewest chunks, 1, 2, 4 or 8, that hold the row.
template <typename T, int VEC>
int size_rmsnorm(const void* x, const void* res, const void* w, void* out, void* sum_out,
                 int64_t rows, int D, int64_t x_rs, int64_t res_rs, float eps,
                 cudaStream_t stream) {
  const int nvec = D / VEC;
  int tpr = (nvec + 31) / 32 * 32;
  if (tpr > kBlock) {
    const int want = ((nvec + kMaxChunks - 1) / kMaxChunks + 31) / 32 * 32;
    tpr = want > kBlock ? want : kBlock;
  }
  if (tpr > kMaxThreads) return cudaErrorInvalidValue;
  const int chunks = (nvec + tpr - 1) / tpr;
  if (chunks == 1)
    return launch_rmsnorm<T, VEC, 1>(x, res, w, out, sum_out, rows, D, tpr, x_rs, res_rs, eps,
                                     stream);
  if (chunks == 2)
    return launch_rmsnorm<T, VEC, 2>(x, res, w, out, sum_out, rows, D, tpr, x_rs, res_rs, eps,
                                     stream);
  if (chunks <= 4)
    return launch_rmsnorm<T, VEC, 4>(x, res, w, out, sum_out, rows, D, tpr, x_rs, res_rs, eps,
                                     stream);
  return launch_rmsnorm<T, VEC, kMaxChunks>(x, res, w, out, sum_out, rows, D, tpr, x_rs,
                                            res_rs, eps, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int dispatch_rmsnorm(const void* x, const void* res, const void* w, void* out, void* sum_out,
                     int64_t rows, int D, int64_t x_rs, int64_t res_rs, float eps,
                     cudaStream_t stream) {
  constexpr int V = kVec<T>;
  const bool vec = D % V == 0 && x_rs % V == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(out) &&
                   (res == nullptr || (res_rs % V == 0 && aligned16(res) && aligned16(sum_out)));
  if (vec) return size_rmsnorm<T, V>(x, res, w, out, sum_out, rows, D, x_rs, res_rs, eps, stream);
  return size_rmsnorm<T, 1>(x, res, w, out, sum_out, rows, D, x_rs, res_rs, eps, stream);
}

// One block a token (blockIdx.x its position in the sequence, blockIdx.y
// its batch row).  Thread i % P of the block owns frequency i: it computes
// that angle's cos and sin once, then rotates the pair (i, i + P) in heads
// g, g + groups, ... of q's H heads followed by k's KV.
template <typename T>
__global__ void rope_kernel(T* __restrict__ q, T* __restrict__ k, const int64_t* __restrict__ pos,
                            int H, int KV, int P, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                            int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t pos_sb,
                            int64_t pos_ss, float theta) {
  const int s = blockIdx.x, b = blockIdx.y;
  const int i = threadIdx.x % P;
  const int groups = blockDim.x / P;
  // 2i / hd as PyTorch divides by a scalar on the card: times the rounded 1 / hd
  const float e = __fmul_rn(static_cast<float>(2 * i), 1.0f / static_cast<float>(2 * P));
  const float inv = 1.0f / powf(theta, e);
  const float angle = __fmul_rn(static_cast<float>(pos[b * pos_sb + s * pos_ss]), inv);
  const float c = cosf(angle), sn = sinf(angle);
  T* qt = q + b * q_sb + s * q_ss;
  T* kt = k + b * k_sb + s * k_ss;
  for (int h = threadIdx.x / P; h < H + KV; h += groups) {
    T* row = h < H ? qt + h * q_sh : kt + (h - H) * k_sh;
    const float x1 = to_float(row[i]), x2 = to_float(row[i + P]);
    row[i] = from_float<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, sn)));
    row[i + P] = from_float<T>(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, sn)));
  }
}

template <typename T>
int launch_rope(void* q, void* k, const void* pos, int B, int S, int H, int KV, int P,
                const int64_t* st, float theta, cudaStream_t stream) {
  const int groups = P >= kBlock ? 1 : kBlock / P;
  const dim3 grid(S, B);
  rope_kernel<T><<<grid, P * groups, 0, stream>>>(
      static_cast<T*>(q), static_cast<T*>(k), static_cast<const int64_t*>(pos), H, KV, P,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], theta);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

using namespace repro;

// out = rmsnorm(x [+ res]) * w over rows of D elements; x's rows x_rs
// elements apart, res's res_rs; out (and, with res, sum_out = x + res)
// contiguous.  w holds D elements.
extern "C" int repro_rmsnorm(const void* x, const void* res, const void* w, void* out,
                             void* sum_out, int dtype, int64_t rows, int D, int64_t x_rs,
                             int64_t res_rs, float eps, void* stream) {
  if (rows < 0 || D <= 0 || (res != nullptr && sum_out == nullptr)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_rmsnorm<float>(x, res, w, out, sum_out, rows, D, x_rs, res_rs, eps, st);
  if (dtype == kBFloat16)
    return dispatch_rmsnorm<__nv_bfloat16>(x, res, w, out, sum_out, rows, D, x_rs, res_rs, eps,
                                           st);
  return cudaErrorInvalidValue;
}

// Split-half rotary embedding of q (B, S, H, hd) and k (B, S, KV, hd) in
// place at positions pos (B, S) int64.  strides: q's batch, sequence and
// head strides, k's, then pos's batch and sequence strides, in elements;
// the head dim is contiguous.
extern "C" int repro_rope(void* q, void* k, const void* pos, int dtype, int B, int S, int H,
                          int KV, int hd, const int64_t* strides, float theta, void* stream) {
  if (B <= 0 || S <= 0 || H < 0 || KV < 0 || hd <= 0 || hd % 2 || hd / 2 > 1024 || B > 65535)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_rope<float>(q, k, pos, B, S, H, KV, hd / 2, strides, theta, st);
  if (dtype == kBFloat16)
    return launch_rope<__nv_bfloat16>(q, k, pos, B, S, H, KV, hd / 2, strides, theta, st);
  return cudaErrorInvalidValue;
}
