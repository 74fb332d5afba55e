// Hopper (sm_90a) building blocks of the bf16 flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu) and of the float32 scan
// backward (ssm_scan_bwd.cu: f32_map, sw128): TMA tile loads into
// 128-byte-swizzled shared memory that complete on mbarriers, the
// warpgroup product wgmma.mma_async m64nNk16 bf16 -> f32 (A from shared
// memory or from registers, B from shared memory, K-major or MN-major),
// the shared-memory descriptors that match the swizzle, setmaxnreg, and
// on the host the encoding of a tensor map, its encoder looked up through
// the CUDA runtime (no -lcuda).
//
// A staged tile is what TMA writes for a box of 64 bf16 columns x R rows
// under CU_TENSOR_MAP_SWIZZLE_128B: R rows of 128 bytes, 1024-byte
// aligned, the 16-byte chunk c of row r stored at chunk c ^ (r % 8).  A
// row of D = 128 is two such boxes, the second (columns 64-127) right
// after the first.  Rows past the tensor's end are zeros: V and dO must be
// zero there, since 0 * an uninitialised NaN is NaN.
//
// Descriptors (PTX ISA, wgmma "Matrix Descriptor Format"): bits 0-13 the
// start address >> 4, 16-29 the leading byte offset >> 4, 32-45 the
// stride byte offset >> 4, 62-63 the layout (1: 128-byte swizzle).
//   K-major (the product's k dim along a row: Q and K for S = Q Kᵀ): the
//   canonical layout ((8, m), (T, 2k)) : ((8T, SBO), (1, T)) in 16-byte
//   units T; the 8-row groups are 1024 bytes apart (SBO); a k16 step is 32
//   bytes further into the row, and the next 64 columns the next box.
//   The leading offset is unused.
//   MN-major (the k dim down the rows: V for P V, dO and Q for dV and dK,
//   K for dQ; the transposed B operand): ((T, 8, m), (8, k)) : ((1, T,
//   LBO), (8T, SBO)); the next 64 columns of N are the next box (LBO =
//   R * 128 bytes), the next 8 rows of k 1024 bytes on (SBO); a k16 step
//   is 16 rows, 2048 bytes.
// Fragments (PTX ISA, wgmma .m64nNk16): warp w of the warpgroup holds rows
// 16w + g and 16w + g + 8 (g = lane / 4, t = lane % 4); accumulator
// register 4j + e of an m64nN product is (row g + 8 (e / 2), column 8j +
// 2t + e % 2), the layout mma.sync m16n8k16 gives each 8-column block
// (mma.cuh).  The A operand of a k16 step in registers is mma.sync's A
// fragment, so an accumulator's two neighbouring 8-column blocks, rounded
// to bf16 pairs, are the A operand of the next product over those 16
// columns: P and dS never leave registers.
//
// wgmma runs asynchronously: the accumulators and the A registers of a
// product may not be touched until wgmma_wait; fence_regs pins the
// compiler's reads and writes of the accumulators to either side of the
// fence and the wait, and ptxas keeps the registers live across the
// asynchronous window (or serialises the products and says so).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing linked)
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace repro {

// -- barriers -----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive and expect `bytes` more of TMA transactions in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that
// outlasts 2^24 polls (far beyond any tile's time) traps, so a barrier that
// can never complete fails the launch instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 24)) __trap();
  }
}

// -- TMA ------------------------------------------------------------------------

// The box of a 4-D tensor map at coordinates (c0, c1, c2, c3) into dst,
// completing on bar.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes from 16-byte-aligned global
// memory into dst, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Order this thread's shared-memory reads and writes before the async
// proxy's (a TMA load that then refills the same bytes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// -- arithmetic ---------------------------------------------------------------------

// 2^x on the special-function unit, one instruction (subnormal results
// flush to zero: a probability below 2^-126 is 0 in bf16's eyes too)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- registers between warpgroups ---------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// -- wgmma ------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Zero an accumulator before a chain that starts it afresh, so that none
// of its earlier values stays live into the chain (an accumulator is an
// input of every wgmma: else each chain would need registers of its own).
template <int M>
__device__ __forceinline__ void zero_acc(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) d[i] = 0.f;
  fence_regs(d);
}

// The descriptor of a 128-byte-swizzled operand at shared address `addr`.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major: rows 128 bytes apart, 8-row groups 1024 apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) { return wgmma_desc(addr, 16, 1024); }

// MN-major: 8-row groups of k 1024 bytes apart, the next 64 columns of N
// `box` bytes on.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t box) {
  return wgmma_desc(addr, box, 1024);
}

// The descriptor `bytes` further into its tile (a k16 step, a box): the
// start address is the low field, and a tile never crosses 256 KB.
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// The warpgroup of the thread, as a value the compiler knows is the same
// across the warp: the shared addresses and descriptors derived from it
// then live in uniform registers, which wgmma reads its descriptors from.
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(kFullMask, static_cast<int>(threadIdx.x) / 128, 0);
}

// A 64 x 16 slice of an accumulator, columns 16 kk .. 16 kk + 15, rounded
// to bf16 as the A operand of the next product.
template <int M>
__device__ __forceinline__ void a_from_acc(uint32_t (&a)[4], const float (&x)[M], int kk) {
  a[0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
  a[1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
}

// A masked score: exp2 of it is 0 whatever the row max (which starts at
// -1e30, finite), so a tile adds nothing to a row it hides.
__device__ __forceinline__ float masked_score() { return -__int_as_float(0x7f800000); }

// The two bf16 of a packed pair (pack_bf16's lo, hi) as floats.
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// -- the wgmma instructions (operand lists written out: asm takes no loops) ----

// d (+)= A B, m64n64k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B, m64n128k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B, m64n64k16, A (64 x 16) from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (+)= A B, m64n128k16, A (64 x 16) from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}


// d (+)= A B over one k16 step, N = 64 or 128; the SS form for A and B
// K-major in shared memory, the RS form for A in registers and B MN-major
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, accumulate);
  else wgmma_rs_n128(d, a, db, accumulate);
}

// -- host: tensor maps ------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, or null.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map (D, S, heads, B) of a bf16 operand read in place through its
// (batch, seq, head) element strides, in boxes of 64 columns x `rows` rows
// of one head, 128-byte swizzled; rows past S read as zeros.  False if TMA
// cannot read it (a base or a stride not a multiple of 16 bytes).
inline bool bf16_map(CUtensorMap* map, const void* base, int D, int S, int heads, int B,
                     int64_t sb, int64_t ss, int64_t sh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0) return false;
  // a stride of a dim of size 1 is never used: any multiple of 16 will do
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const int64_t given[3] = {ss, sh, sb};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    const int64_t bytes = dims[i + 1] == 1 ? 16 : given[i] * 2;
    if (bytes <= 0 || bytes % 16 != 0) return false;
    strides[i] = static_cast<cuuint64_t>(bytes);
  }
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D map of a float32 tensor read in place: dims innermost first, the
// element strides of dims 1-3, boxes of `box` elements, a row of 32 floats
// (box[0], 128 bytes) 128-byte swizzled; elements out of the tensor read as
// zeros.  False if TMA cannot read it (a base or a stride not a multiple of
// 16 bytes).
inline bool f32_map(CUtensorMap* map, const void* base, const uint64_t (&dims)[4],
                    const int64_t (&strides)[3], const uint32_t (&box)[4]) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0 || box[0] != 32)
    return false;
  cuuint64_t d[4], st[3];
  for (int i = 0; i < 4; ++i) d[i] = dims[i];
  for (int i = 0; i < 3; ++i) {  // a stride of a dim of size 1 is never used
    const int64_t bytes = dims[i + 1] == 1 ? 16 : strides[i] * 4;
    if (bytes <= 0 || bytes % 16 != 0) return false;
    st[i] = static_cast<cuuint64_t>(bytes);
  }
  const cuuint32_t bx[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), d, st, bx, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Element (r, c) of a staged f32_map box, 1024-byte aligned: rows of 32
// floats, the 16-byte chunk c / 4 of row r at chunk c / 4 ^ r % 8.
__device__ __forceinline__ int sw128(int r, int c) {
  return (r << 5) | ((((c >> 2) ^ r) & 7) << 2) | (c & 3);
}

// The shared memory of a block, rounded up to the 1024-byte alignment of a
// 128-byte-swizzled tile (the launch asks for 1 KB more than it uses).
__device__ __forceinline__ unsigned char* smem_1k(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

}  // namespace repro
