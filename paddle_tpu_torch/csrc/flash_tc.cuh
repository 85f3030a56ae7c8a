// Tensor-core tile routines shared by the 16-bit routes (bf16 and fp16) of
// the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_varlen_fwd.cu, flash_varlen_bwd.cu): tiles in shared memory in the
// 128-byte-swizzled layout that Hopper's wgmma descriptors read, 16-byte
// cp.async loads into them (and bounded variants for the ragged end of a
// packed stream, which zero-fill rows past the end and store none of them),
// the descriptors, the wgmma instructions (m64nNk16, bf16 or fp16 operands,
// fp32 accumulators) and their fences, and the conversion of an fp32
// accumulator into a 16-bit A operand in registers.
//
// Every routine takes the element type T (bf16 or fp16) from its pointers,
// and a descriptor carries T to the wgmma that reads it (Desc<T>), so a
// kernel templated on T picks the .bf16 or .f16 instruction without naming
// it. The copies are blind to T. fp32 values become T by round to nearest
// even with no clamp (__floats2bfloat162_rn, __floats2half2_rn): an fp16
// value past 65504 becomes inf, as the JAX kernels' .astype(float16) does,
// so a loss scaler sees the overflow.
//
// One warpgroup (4 warps, 128 threads) issues each wgmma for a 64-row
// tile; warp w holds rows [16w, 16w + 16). Accumulator layout, lane =
// 4 * g + t: d[4j], d[4j + 1] are (row g, columns 8j + 2t, 8j + 2t + 1)
// and d[4j + 2], d[4j + 3] the same columns of row g + 8. The register A
// operand of a k16 step takes (rows g, g + 8) x (columns 2t.., 2t + 8..),
// which is what accumulator columns [16kk, 16kk + 16) hold: a score tile
// becomes the A operand of the next product without leaving registers.
//
// Shared tiles hold `ROWS` x D 16-bit values (D in {64, 128, 256}) as D / 64
// slabs of 64 columns, slab after slab; within a slab, row after row of
// 128 bytes, and 16-byte chunk c of row r stored at chunk c ^ (r & 7).
// That is the canonical 128-byte-swizzled layout (atoms of 8 rows x 128
// bytes, 1024 bytes apart) both for a K-major operand (rows = M or N,
// columns = K) and for an MN-major one (rows = K, columns = N), so one
// tile serves as either; the tile must start on a 1024-byte boundary.
// The 16-byte stores of the loads and of the output staging land in
// distinct bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_tc {

using bf16 = __nv_bfloat16;
using fp16 = __half;

template <typename T>
struct IsFp16 {
  static constexpr bool value = false;
};
template <>
struct IsFp16<fp16> {
  static constexpr bool value = true;
};
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 232448;  // bytes one H100 block can opt into

// element offset of (row, col) in a swizzled [ROWS][D] tile
template <int ROWS>
__device__ __forceinline__ int tile_off(int row, int col) {
  return (col >> 6) * (ROWS * 64) + row * 64 +
         ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 16 bytes when src_bytes is 16; 16 zero bytes (nothing read) when it is 0
__device__ __forceinline__ void cp_async_16_zfill(void* dst, const void* src,
                                                  int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// one 4-byte word when src_bytes is 4; a zero word (nothing read) when 0
__device__ __forceinline__ void cp_async_4_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS x D 16-bit tile from global rows `row_stride` elements apart into a
// swizzled shared tile, 16 bytes per cp.async, kThreads threads
template <int ROWS, int D, int kThreads, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          size_t row_stride) {
  constexpr int kChunks = ROWS * D / 8;
  static_assert(kChunks % kThreads == 0, "tile chunks must split evenly");
#pragma unroll
  for (int i = 0; i < kChunks / kThreads; ++i) {
    const int e = i * kThreads + threadIdx.x;
    const int r = e / (D / 8);
    const int c = (e % (D / 8)) * 8;
    cp_async_16(dst + tile_off<ROWS>(r, c), src + (size_t)r * row_stride + c);
  }
}

// load_tile for the ragged end of a stream: rows at or past n_rows (n_rows
// >= 1, so row 0 is a valid address) are zero-filled and never read (a
// separate routine: load_tile written as this of all ROWS rows changed
// K2's and K3's register allocation)
template <int ROWS, int D, int kThreads, typename T>
__device__ __forceinline__ void load_tile_rows(T* dst, const T* src,
                                               size_t row_stride,
                                               int n_rows) {
  constexpr int kChunks = ROWS * D / 8;
  static_assert(kChunks % kThreads == 0, "tile chunks must split evenly");
#pragma unroll
  for (int i = 0; i < kChunks / kThreads; ++i) {
    const int e = i * kThreads + threadIdx.x;
    const int r = e / (D / 8);
    const int c = (e % (D / 8)) * 8;
    const bool in = r < n_rows;
    cp_async_16_zfill(dst + tile_off<ROWS>(r, c),
                      in ? src + (size_t)r * row_stride + c : src,
                      in ? 16 : 0);
  }
}

// N 4-byte words (fp32 row statistics, int32 segment ids) into shared
// memory, one cp.async each, by the first N threads; words at or past n
// (n >= 1) are zero. No alignment beyond 4 bytes is needed, so a row
// statistic of any row of an [h, T] array loads as it lies.
template <int N>
__device__ __forceinline__ void load_words(void* dst, const void* src,
                                           int n) {
  if (threadIdx.x < N) {
    const bool in = (int)threadIdx.x < n;
    cp_async_4_zfill(static_cast<uint32_t*>(dst) + threadIdx.x,
                     static_cast<const uint32_t*>(src) +
                         (in ? threadIdx.x : 0),
                     in ? 4 : 0);
  }
}

// N fp32 values (N a multiple of 4) into shared memory, 16 bytes per
// cp.async, by the first N / 4 threads
template <int N>
__device__ __forceinline__ void load_row_stats(float* dst, const float* src) {
  static_assert(N % 4 == 0, "row statistics load in 16-byte chunks");
  if (threadIdx.x < N / 4) cp_async_16(dst + 4 * threadIdx.x,
                                       src + 4 * threadIdx.x);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand of
// element type T
template <typename T>
struct Desc {
  uint64_t bits;
};

// the descriptor of an operand starting at p: leading byte offset `lbo`,
// 1024 bytes between 8-row atoms
template <typename T>
__device__ __forceinline__ Desc<T> make_desc(const T* p, uint32_t lbo) {
  return {(uint64_t)((smem_addr(p) >> 4) & 0x3FFF) |
          ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
          ((uint64_t)(1024 >> 4) << 32) | (1ull << 62)};
}

// k16 step kk of a K-major operand: a [ROWS][D] tile read as ROWS (M or
// N) rows by D (K) columns
template <int ROWS, typename T>
__device__ __forceinline__ Desc<T> desc_k(const T* tile, int kk) {
  return make_desc(tile + (kk >> 2) * (ROWS * 64) + (kk & 3) * 16, 16);
}

// k16 step kk of an MN-major B operand: a [ROWS][D] tile read as ROWS (K)
// rows by columns [c0, D) (N), c0 a multiple of 64
template <int ROWS, typename T>
__device__ __forceinline__ Desc<T> desc_mn(const T* tile, int kk, int c0) {
  return make_desc(tile + (c0 >> 6) * (ROWS * 64) + kk * 16 * 64,
                   ROWS * 128);
}

// shared-memory writes of the generic proxy (cp.async, stores) visible to
// the wgmma that read them next
__device__ __forceinline__ void fence_view_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pin registers that an in-flight wgmma writes (accumulators) or reads
// (register A operands) to this point of the program, so that the
// compiler neither reads them earlier nor reuses them before it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.0f;
}

// two fp32 values as one register of two T, `lo` in the low half (round
// to nearest even; an fp16 value past the range becomes inf)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<bf16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<fp16>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// one register of two T as two fp32 values, the low half first
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t u);
template <>
__device__ __forceinline__ float2 unpack2<bf16>(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
template <>
__device__ __forceinline__ float2 unpack2<fp16>(uint32_t u) {
  return __half22float2(*reinterpret_cast<const __half2*>(&u));
}

// accumulator columns [16kk, 16kk + 16) as the T A operand of k16 step kk
template <typename T, int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N / 8][4],
                                         const float (&c)[N]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack2<T>(c[8 * kk + 2 * e], c[8 * kk + 2 * e + 1]);
}

// The warpgroup's 64 x W accumulator (W / 2 values a thread), times
// scale0 (row g) and scale1 (row g + 8), as T through a swizzled
// [64][D] staging tile and out to global rows `row_stride` elements apart
// with 16-byte stores, into columns [col0, col0 + W) (col0 a multiple of
// 64). Each warp stages and stores its own 16 rows.
template <int D, int W, typename T>
__device__ __forceinline__ void store_rows(T* stage,
                                           const float (&acc)[W / 2],
                                           float scale0, float scale1,
                                           T* dst, size_t row_stride,
                                           int col0) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const int c = col0 + 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(stage + tile_off<64>(r0 + g, c)) =
        pack2<T>(acc[4 * j] * scale0, acc[4 * j + 1] * scale0);
    *reinterpret_cast<uint32_t*>(stage + tile_off<64>(r0 + g + 8, c)) =
        pack2<T>(acc[4 * j + 2] * scale1, acc[4 * j + 3] * scale1);
  }
  __syncwarp();
  constexpr int kRowChunks = W / 8;
#pragma unroll
  for (int i = 0; i < 16 * kRowChunks / 32; ++i) {
    const int e = i * 32 + lane;
    const int r = r0 + e / kRowChunks;
    const int c = col0 + (e % kRowChunks) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * row_stride + c) =
        *reinterpret_cast<const uint4*>(stage + tile_off<64>(r, c));
  }
}

// store_rows for the ragged end of a stream: rows at or past n_rows are
// not stored (a separate routine, as load_tile_rows is)
template <int D, int W, typename T>
__device__ __forceinline__ void store_rows_upto(T* stage,
                                                const float (&acc)[W / 2],
                                                float scale0, float scale1,
                                                T* dst, size_t row_stride,
                                                int col0, int n_rows) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const int c = col0 + 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(stage + tile_off<64>(r0 + g, c)) =
        pack2<T>(acc[4 * j] * scale0, acc[4 * j + 1] * scale0);
    *reinterpret_cast<uint32_t*>(stage + tile_off<64>(r0 + g + 8, c)) =
        pack2<T>(acc[4 * j + 2] * scale1, acc[4 * j + 3] * scale1);
  }
  __syncwarp();
  constexpr int kRowChunks = W / 8;
#pragma unroll
  for (int i = 0; i < 16 * kRowChunks / 32; ++i) {
    const int e = i * 32 + lane;
    const int r = r0 + e / kRowChunks;
    const int c = col0 + (e % kRowChunks) * 8;
    if (r < n_rows)
      *reinterpret_cast<uint4*>(dst + (size_t)r * row_stride + c) =
          *reinterpret_cast<const uint4*>(stage + tile_off<64>(r, c));
  }
}

// wgmma.mma_async m64nNk16, T x T -> fp32 (T bf16 or fp16, from the
// descriptors), d += a * b (d = a * b when scale_d is 0). Each instruction
// is written once, as a macro of its type string, and instantiated for
// both types. wgmma_ss takes A and B from shared memory through
// descriptors (N = 32, 64, 128: the score products); wgmma_rs takes A
// from registers (N = 64, 128, 256: the products that take P or dS).
// kTransB is 0 for a K-major B, 1 for an MN-major one.
#define FLASH_TC_MMA_1(TY)                                                  \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
      "%15}, "                                                              \
      "%16, %17, p, 1, 1, 0, %19;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15])                                                         \
      : "l"(da.bits), "l"(db.bits), "r"(scale_d), "n"(kTransB))
template <int kTransB, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], Desc<T> da,
                                         Desc<T> db, int scale_d) {
  if constexpr (IsFp16<T>::value)
    FLASH_TC_MMA_1("f16");
  else
    FLASH_TC_MMA_1("bf16");
}
#undef FLASH_TC_MMA_1

#define FLASH_TC_MMA_2(TY)                                                  \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
      "%28, %29, %30, %31}, "                                               \
      "%32, %33, p, 1, 1, 0, %35;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31])                                            \
      : "l"(da.bits), "l"(db.bits), "r"(scale_d), "n"(kTransB))
template <int kTransB, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], Desc<T> da,
                                         Desc<T> db, int scale_d) {
  if constexpr (IsFp16<T>::value)
    FLASH_TC_MMA_2("f16");
  else
    FLASH_TC_MMA_2("bf16");
}
#undef FLASH_TC_MMA_2

#define FLASH_TC_MMA_3(TY)                                                       \
  asm volatile(                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                               \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "       \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "        \
      "%28, %29, %30, %31}, "                                                    \
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                            \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),              \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),              \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),         \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),         \
        "+f"(d[30]), "+f"(d[31])                                                 \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db.bits), "r"(scale_d),  \
        "n"(kTransB))
template <int kTransB, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], Desc<T> db,
                                         int scale_d) {
  if constexpr (IsFp16<T>::value)
    FLASH_TC_MMA_3("f16");
  else
    FLASH_TC_MMA_3("bf16");
}
#undef FLASH_TC_MMA_3

#define FLASH_TC_MMA_4(TY)                                                  \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                 \
      "%64, %65, p, 1, 1, 0, %67;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
      : "l"(da.bits), "l"(db.bits), "r"(scale_d), "n"(kTransB))
template <int kTransB, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], Desc<T> da,
                                         Desc<T> db, int scale_d) {
  if constexpr (IsFp16<T>::value)
    FLASH_TC_MMA_4("f16");
  else
    FLASH_TC_MMA_4("bf16");
}
#undef FLASH_TC_MMA_4

#define FLASH_TC_MMA_5(TY)                                                       \
  asm volatile(                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                               \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "       \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "        \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "        \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "        \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                      \
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"                            \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),              \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),              \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),         \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),         \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),         \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),         \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),         \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),         \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),         \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),         \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db.bits), "r"(scale_d),  \
        "n"(kTransB))
template <int kTransB, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], Desc<T> db,
                                         int scale_d) {
  if constexpr (IsFp16<T>::value)
    FLASH_TC_MMA_5("f16");
  else
    FLASH_TC_MMA_5("bf16");
}
#undef FLASH_TC_MMA_5

#define FLASH_TC_MMA_6(TY)                                                       \
  asm volatile(                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                              \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "               \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "       \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "        \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "        \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "        \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "        \
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "        \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "        \
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "        \
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "       \
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "       \
      "%127}, "                                                                  \
      "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),              \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),              \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),         \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),         \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),         \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),         \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),         \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),         \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),         \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),         \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),         \
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),         \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),         \
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),         \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),         \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),         \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),         \
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),         \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),    \
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),    \
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),    \
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),    \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),    \
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                                 \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db.bits), "r"(scale_d),  \
        "n"(kTransB))
template <int kTransB, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], Desc<T> db,
                                         int scale_d) {
  if constexpr (IsFp16<T>::value)
    FLASH_TC_MMA_6("f16");
  else
    FLASH_TC_MMA_6("bf16");
}
#undef FLASH_TC_MMA_6

}  // namespace flash_tc
