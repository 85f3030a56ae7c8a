// Flash-attention forward on Hopper (sm_90a): o and the natural-log
// logsumexp of softmax(q k^T * sm_scale) v, with an online softmax.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::_fwd_kernel (the Pallas TPU
// kernel behind flash_attention_with_lse / flash_attention_values).
//
// Semantics carried over exactly:
//   - layout q [b, sq, h, d], k/v [b, sk, kh, d], h % kh == 0;
//   - GQA: q head i reads kv head i / (h / kh);
//   - causal masks are bottom-right aligned: row r sees columns
//     c <= r + (sk - sq);
//   - o in the input dtype, lse = m + ln(l) as fp32 [b, h, sq].
//
// Three routes behind the one C entry, chosen by dtype (nothing is caught,
// and none is a fallback for another):
//
// bf16: flash_fwd_kernel_tc, tensor cores. The training path (O2) and
// serving run it. What bounds it on the H100: at the training shape
// ([16, 1024, 12, 64] causal) the work is 2.58e10 flops (4 * d per
// visible pair) over 1.01e8 bytes of q, k, v, o and lse: 0.0303 ms at
// 3.35 TB/s against 0.026 ms at 989 TFLOP/s, so bytes bound it, with the
// operations close behind; a kernel of scalar fp32 FMAs is bound by its
// own arithmetic at 15x that. What the design does about it: both
// products run on Hopper's warpgroup tensor-core instruction (wgmma,
// bf16 operands, fp32 accumulators in registers), and device memory sees
// q and o once and each kv tile once per q tile.
//   - One CTA of one warpgroup (128 threads) per (b*h, 64-row q tile);
//     blockIdx.x is reversed so the heaviest causal tiles start first.
//     [1, 1024, 12, 64] (serving's prefill) gives 192 CTAs for 132 SMs,
//     all resident at once (two a SM); the training shape gives 3,072.
//     128-row tiles (two warpgroups sharing each kv tile) halve the kv
//     reads but measured slower at the training shape (one 256-thread
//     CTA a SM instead of two independent ones), and leave serving 96
//     CTAs.
//   - q, k and v tiles sit in shared memory as bf16 in the 128-byte
//     swizzled layout the wgmma descriptors read (flash_tc.cuh). 16-byte
//     cp.async fills them: the q tile and kv tile 0 first, then kv tile
//     j + 1 streams into the other stage of a 2-stage ring while tile j is
//     in the tensor cores. q stays resident for the whole kv loop.
//   - S = q k^T is a wgmma with both operands in shared memory; the online
//     softmax runs on its fp32 accumulator in registers, each row's max and
//     sum across its quad of lanes by __shfl_xor_sync; p =
//     exp2(s * sm_scale * log2(e) - m') is rounded to bf16 in registers
//     and is the register A operand of the P v wgmma, with v read through
//     a transposed (MN-major) descriptor: shared memory sees no P.
//   - kv tiles wholly above the causal diagonal are skipped; only the
//     diagonal tiles pay for the mask.
//   - o leaves through shared memory as 16-byte coalesced stores.
// Precision: q, k, v enter the products as given (bf16); sm_scale * log2e
// multiplies the fp32 scores, so the JAX kernel's bf16 rounding of the
// scaled q (:222-223) is not needed (at d = 64 and 256 the scale is a
// power of two and the two agree bit for bit); p is rounded to bf16
// before P v, as the JAX kernel rounds it (:248); the running max, the
// row sums (of the fp32 p), lse and the accumulator stay fp32.
// Tiles (q rows x kv rows per step), shared memory, registers per thread
// (ptxas, sm_90a, CUDA 12.9): d = 64: 64 x 128, 73,728 bytes, 179; d =
// 128: 64 x 64, 81,920 bytes, 174; d = 256: 64 x 32, 98,304 bytes, 227
// (fwd_tc_smem_bytes below; a static_assert holds each to a block's
// 232,448 bytes; 0 bytes of spills; chip_smoke.py's environment phase
// prints the registers of each instantiation). Loads are cp.async, not
// TMA, and one warpgroup both loads and computes: TMA with a producer
// warp and ping-pong consumer warpgroups is still open.
//
// fp16 (dtype 2): flash_fwd_kernel_tc<fp16>, the same kernels instantiated
// for __half (flash_tc.cuh picks the .f16 wgmma from the operands' type).
// Eager AMP O2 in float16 with a loss scaler runs this route. The only
// differences from bf16 are the instruction and the rounding of p and o to
// fp16, to nearest even and never clamped: a value past 65504 becomes inf,
// as the JAX kernel's .astype(float16) makes it, so the loss scaler sees the
// overflow. fp16 keeps 3 more mantissa bits than bf16 and 3 fewer exponent
// bits.
//
// fp32: flash_fwd_kernel, the first port's scalar kernel, unchanged. fp32
// is not the dtype of any main path; it carries the exactness checks
// (2e-5 against the fp32 plain version), which TF32 tensor cores, at
// about three decimal digits, would break. One block of 256 threads per
// (b*h, 64-row q tile) keeps the q tile in shared memory as fp32 for its
// whole kv loop; kv tiles wholly above the causal diagonal are skipped,
// and only the diagonal tiles pay for the mask. Four threads share a q
// row: each scores 16 of the tile's 64 columns and owns a quarter of the
// output dims, so the row statistics need two shuffles and no shared
// memory. Padded row strides (D + 1, 64 + 1) keep the shared-memory reads
// free of bank conflicts. It is bound by its own scalar FMAs and
// shared-memory reads (one per FMA).
//
// Not carried over from the TPU kernel: the packed [b, s, h*d] operand
// trick, the ones-column row sum, the x64-off scope, the _MIN_SEQ floor
// and the 512/256 tile choices.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_tc.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // four threads per q row

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBlockQ * (D + 1) + (size_t)kBlockK * (D + 1) +
                          (size_t)kBlockK * D + (size_t)kBlockQ * (kBlockK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int sq, int sk, int num_heads,
    int num_kv_heads, float sm_scale, int causal) {
  constexpr int QS = D + 1;        // padded row stride of the q and k tiles
  constexpr int PS = kBlockK + 1;  // padded row stride of the prob tile
  constexpr int DQ = D / 4;        // output dims per thread
  constexpr int CQ = kBlockK / 4;  // score columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kBlockQ][QS], sm_scale folded in
  float* k_s = q_s + kBlockQ * QS;    // [kBlockK][QS]
  float* v_s = k_s + kBlockK * QS;    // [kBlockK][D]
  float* p_s = v_s + kBlockK * D;     // [kBlockQ][PS]

  const int q0 = blockIdx.x * kBlockQ;
  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh - b * num_heads;
  const int kvh = h / (num_heads / num_kv_heads);
  const int tid = threadIdx.x;
  const int r = tid >> 2;        // q row within the tile
  const int quarter = tid & 3;   // which quarter of columns and dims

  const size_t q_stride = (size_t)num_heads * D;
  const size_t kv_stride = (size_t)num_kv_heads * D;
  const T* qb = q + (size_t)b * sq * q_stride + (size_t)h * D;
  const T* kb = k + (size_t)b * sk * kv_stride + (size_t)kvh * D;
  const T* vb = v + (size_t)b * sk * kv_stride + (size_t)kvh * D;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int rr = e / D;
    const int c = e - rr * D;
    q_s[rr * QS + c] = to_float(qb[(size_t)(q0 + rr) * q_stride + c]) * sm_scale;
  }

  const int offset = sk - sq;  // bottom-right causal alignment
  int n_kv = sk / kBlockK;
  int n_full = n_kv;  // tiles that need no mask
  if (causal) {
    // the tile's last row sees columns <= q0 + kBlockQ - 1 + offset
    n_kv = min(n_kv, (q0 + kBlockQ - 1 + offset) / kBlockK + 1);
    // a tile is unmasked when its last column is visible to the first row
    n_full = min(n_kv, (q0 + offset + 1) / kBlockK);
  }

  float m = -INFINITY;  // row statistics, the same in the row's 4 threads
  float l = 0.0f;
  float acc[DQ];
#pragma unroll
  for (int i = 0; i < DQ; ++i) acc[i] = 0.0f;
  __syncthreads();

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBlockK;
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int rr = e / D;
      const int c = e - rr * D;
      const size_t g = (size_t)(k0 + rr) * kv_stride + c;
      k_s[rr * QS + c] = to_float(kb[g]);
      v_s[rr * D + c] = to_float(vb[g]);
    }
    __syncthreads();

    // scores of row r against columns 4*jj + quarter
    float s[CQ];
#pragma unroll
    for (int jj = 0; jj < CQ; ++jj) s[jj] = 0.0f;
    const float* qrow = q_s + r * QS;
#pragma unroll 4
    for (int i = 0; i < D; ++i) {
      const float qv = qrow[i];
#pragma unroll
      for (int jj = 0; jj < CQ; ++jj)
        s[jj] += qv * k_s[(4 * jj + quarter) * QS + i];
    }

    const bool masked = causal && kt >= n_full;
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < CQ; ++jj) {
      if (masked && k0 + 4 * jj + quarter > q0 + r + offset) s[jj] = -INFINITY;
      tmax = fmaxf(tmax, s[jj]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = m == -INFINITY ? 0.0f : expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int jj = 0; jj < CQ; ++jj) {
      const float p = s[jj] == -INFINITY ? 0.0f : expf(s[jj] - m_new);
      psum += p;
      p_s[r * PS + 4 * jj + quarter] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's probs come from the 4 threads of this warp

#pragma unroll
    for (int i = 0; i < DQ; ++i) acc[i] *= alpha;
    const float* prow = p_s + r * PS;
    for (int c = 0; c < kBlockK; ++c) {
      const float p = prow[c];
      const float* vrow = v_s + c * D + quarter;
#pragma unroll
      for (int i = 0; i < DQ; ++i) acc[i] += p * vrow[4 * i];
    }
    __syncthreads();  // k_s, v_s and p_s are rewritten by the next tile
  }

  const float lc = fmaxf(l, 1e-30f);
  T* orow = o + ((size_t)b * sq + q0 + r) * q_stride + (size_t)h * D + quarter;
#pragma unroll
  for (int i = 0; i < DQ; ++i) orow[4 * i] = from_float<T>(acc[i] / lc);
  if (quarter == 0)
    lse[((size_t)b * num_heads + h) * sq + q0 + r] = m + logf(lc);
}

// -- bf16 and fp16 routes: tensor cores -------------------------------------

using bf16 = __nv_bfloat16;
using fp16 = __half;
constexpr int kTcThreads = 128;  // one warpgroup
constexpr int kTcBlockM = 64;    // q rows per CTA, 16 per warp

// kv rows per step: the score accumulator (64 x kBlockN) and the output
// accumulator (64 x D) share a thread's registers
template <int D>
struct FwdTile {
  static constexpr int kBlockN = D == 64 ? 128 : (D == 128 ? 64 : 32);
};

// the q tile and two stages of k and v tiles, all bf16
template <int D>
constexpr size_t fwd_tc_smem_bytes() {
  return sizeof(bf16) *
         ((size_t)kTcBlockM * D + 4 * (size_t)FwdTile<D>::kBlockN * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_kernel_tc(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o,
    float* __restrict__ lse, int sq, int sk, int num_heads, int num_kv_heads,
    float sm_scale, int causal) {
  using namespace flash_tc;
  constexpr int BM = kTcBlockM;
  constexpr int BN = FwdTile<D>::kBlockN;
  constexpr int NS = BN / 2;  // score accumulators a thread holds
  constexpr int NO = D / 2;   // output accumulators a thread holds
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [BM][D], later o
  T* k_s = q_s + BM * D;                    // [2][BN][D]
  T* v_s = k_s + 2 * BN * D;                // [2][BN][D]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // heavy tiles first
  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh - b * num_heads;
  const int kvh = h / (num_heads / num_kv_heads);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = q0 + (threadIdx.x >> 5) * 16 + g;  // and row + 8

  const size_t q_stride = (size_t)num_heads * D;
  const size_t kv_stride = (size_t)num_kv_heads * D;
  const size_t qrow0 = ((size_t)b * sq + q0) * q_stride + (size_t)h * D;
  const T* kb = k + (size_t)b * sk * kv_stride + (size_t)kvh * D;
  const T* vb = v + (size_t)b * sk * kv_stride + (size_t)kvh * D;

  const int offset = sk - sq;  // bottom-right causal alignment
  int n_kv = sk / BN;
  int n_full = n_kv;  // tiles that need no mask
  if (causal) {
    n_kv = min(n_kv, (q0 + BM - 1 + offset) / BN + 1);
    n_full = min(n_kv, (q0 + offset + 1) / BN);
  }

  load_tile<BM, D, kTcThreads>(q_s, q + qrow0, q_stride);
  load_tile<BN, D, kTcThreads>(k_s, kb, kv_stride);
  load_tile<BN, D, kTcThreads>(v_s, vb, kv_stride);
  cp_async_commit();

  const float scale_log2 = sm_scale * kLog2e;
  float acc[NO];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, raw scores
  float l[2] = {0.0f, 0.0f};            // this lane's share of the row sum

  for (int kt = 0; kt < n_kv; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kv) {
      const size_t next = (size_t)(kt + 1) * BN * kv_stride;
      load_tile<BN, D, kTcThreads>(k_s + (st ^ 1) * BN * D, kb + next,
                                   kv_stride);
      load_tile<BN, D, kTcThreads>(v_s + (st ^ 1) * BN * D, vb + next,
                                   kv_stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_view_async_shared();  // this thread's copies, then everyone's
    __syncthreads();
    const T* ks = k_s + st * BN * D;
    const T* vs = v_s + st * BN * D;

    // S = q k^T
    float s[NS];
    zero(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0>(s, desc_k<BM>(q_s, kk), desc_k<BN>(ks, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    if (causal && kt >= n_full) {
      const int k0 = kt * BN;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t + (e & 1) > row + (e >> 1) * 8 + offset)
            s[4 * j + e] = -INFINITY;
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row that has seen only masked columns keeps m = -inf: offset 0
      // keeps exp2 away from (-inf) - (-inf)
      const float ms = mx == -INFINITY ? 0.0f : mx * scale_log2;
      const float alpha = exp2f(m[i] * scale_log2 - ms);
      m[i] = mx;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[4 * j + e] = exp2f(s[4 * j + e] * scale_log2 - ms);
          rs += s[4 * j + e];
        }
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 2 * i] *= alpha;
        acc[4 * j + 2 * i + 1] *= alpha;
      }
    }

    // O += P v: p as bf16 A operands from registers, v MN-major
    uint32_t pa[BN / 16][4];
    acc_to_a<T>(pa, s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<1>(acc, pa[kk], desc_mn<BN>(vs, kk, 0), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    __syncthreads();  // this stage is refilled by the next iteration
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float lc = fmaxf(l[i], 1e-30f);
    inv[i] = 1.0f / lc;
    if (t == 0)
      lse[(size_t)bh * sq + row + 8 * i] = m[i] * sm_scale + logf(lc);
  }
  // q_s, which no wgmma reads any more, stages o
  store_rows<D, D>(q_s, acc, inv[0], inv[1], o + qrow0, q_stride, 0);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int batch, int sq, int sk, int num_heads, int num_kv_heads,
           float sm_scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(sq / kBlockQ, batch * num_heads);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      sq, sk, num_heads, num_kv_heads, sm_scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, void* lse,
              int batch, int sq, int sk, int num_heads, int num_kv_heads,
              float sm_scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_tc_smem_bytes<D>();
  static_assert(smem <= flash_tc::kMaxSmem,
                "the tiles exceed a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel_tc<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(sq / kTcBlockM, batch * num_heads);
  flash_fwd_kernel_tc<T, D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), sq, sk, num_heads, num_kv_heads, sm_scale,
      causal);
  return (int)cudaGetLastError();
}

// the route of `dtype` at head dim D: 0 = float32, the scalar kernel;
// 1 = bfloat16 and 2 = float16, the tensor-core kernel
template <int D>
int dispatch_dtype(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int sq, int sk, int num_heads,
                   int num_kv_heads, float sm_scale, int causal, int dtype,
                   cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, o, lse, batch, sq, sk, num_heads,
                            num_kv_heads, sm_scale, causal, stream);
  if (dtype == 1)
    return launch_tc<bf16, D>(q, k, v, o, lse, batch, sq, sk, num_heads,
                              num_kv_heads, sm_scale, causal, stream);
  if (dtype == 2)
    return launch_tc<fp16, D>(q, k, v, o, lse, batch, sq, sk, num_heads,
                              num_kv_heads, sm_scale, causal, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns cudaGetLastError() after the
// launch (0 on success).
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              int batch, int sq, int sk, int num_heads, int num_kv_heads,
              int head_dim, float sm_scale, int causal, int dtype,
              void* stream) {
  if (batch <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return dispatch_dtype<64>(q, k, v, o, lse, batch, sq, sk, num_heads,
                                num_kv_heads, sm_scale, causal, dtype, s);
    case 128:
      return dispatch_dtype<128>(q, k, v, o, lse, batch, sq, sk, num_heads,
                                 num_kv_heads, sm_scale, causal, dtype, s);
    case 256:
      return dispatch_dtype<256>(q, k, v, o, lse, batch, sq, sk, num_heads,
                                 num_kv_heads, sm_scale, causal, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
