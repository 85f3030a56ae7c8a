// Packed varlen flash-attention forward on Hopper (sm_90a): o and the
// natural-log logsumexp of block-diagonal softmax(q k^T * sm_scale) v over
// sequences packed end to end into one token stream.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::_vl_fwd_kernel (:714, the
// Pallas TPU kernel behind flash_attention_varlen_values and
// F.flash_attn_unpadded).
//
// Semantics carried over exactly:
//   - layout q [tq, h, d], k/v [tk, h, d] (kv heads == q heads);
//   - seg_q [tq] / seg_k [tk] int32 segment ids (searchsorted over
//     cu_seqlens); q row i sees k column j only when seg_q[i] == seg_k[j]
//     and, when causal, i >= j in absolute token positions (the caller
//     admits causal only when cu_q == cu_k, so this is per-segment causal);
//   - per q tile, the kv tiles [kv_lo, kv_hi) that can hold a visible
//     column, computed outside the kernel (ops/cuda_kernels.py
//     varlen_plan, the counterpart of _vl_ranges); tiles outside it are
//     never loaded;
//   - o in the input dtype, lse = m + ln(l) as fp32 [h, tq];
//   - masked scores count as the reference's finite -1e30: a row's first
//     visited tile can hold no column of its segment (the tile starts in
//     the previous one), and a running max of -inf would then give
//     exp(-inf - (-inf)) = NaN. Here the running max starts at -1e30 and a
//     masked score contributes p = exp(-inf - m) = 0, so no NaN arises
//     and a row that sees no key at all writes o = +0 and lse = -1e30.
//
// Not carried over: the 128-token padding of the packed stream (rows and
// columns past tq / tk are bound-checked here instead), the packed
// [T, h*d] operand, the static per-head loop, the exp2 scaling, the
// ones-column row sum and the x64-off scope.
//
// What bounds it on the H100: at the main path's shape (16,384 packed
// tokens, h 12, d 64, causal bf16, ~11 M visible pairs per head) the work
// is 4 * d flops per visible pair, ~3.4e10 flops, against ~25 MB of
// operands: a tensor-core kernel would be bound by operations (~35 us).
// This first kernel follows flash_fwd.cu: scalar fp32 FMAs, so it is
// bound by its own arithmetic and shared-memory reads. One block of 256
// threads per (64-row q tile, head) keeps the q tile in shared memory for
// its whole kv range; four threads share a q row, each scoring 16 of a kv
// tile's 64 columns and owning a quarter of the output dims, so the row
// statistics need two shuffles. Padded row strides (D + 1, 64 + 1) keep
// the shared-memory reads free of bank conflicts. The segment ids of the
// tile's rows and columns sit in shared memory beside the operands.
// Shared memory: 66,816 bytes at d = 64, 115,968 at d = 128 and 214,272
// at d = 256, held to a block's 232,448 by a static_assert.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // four threads per q row
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // bytes one H100 block can opt into

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// q and k tiles [64][D + 1], v tile [64][D], prob tile [64][65], all fp32,
// and the int32 segment ids of the tile's 64 rows and 64 columns
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBlockQ * (D + 1) + (size_t)kBlockK * (D + 1) +
                          (size_t)kBlockK * D + (size_t)kBlockQ * (kBlockK + 1)) +
         sizeof(int) * (kBlockQ + kBlockK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_varlen_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k,
    const int* __restrict__ kv_lo, const int* __restrict__ kv_hi,
    T* __restrict__ o, float* __restrict__ lse, int tq, int tk, int num_heads,
    float sm_scale, int causal) {
  constexpr int QS = D + 1;        // padded row stride of the q and k tiles
  constexpr int PS = kBlockK + 1;  // padded row stride of the prob tile
  constexpr int DQ = D / 4;        // output dims per thread
  constexpr int CQ = kBlockK / 4;  // score columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kBlockQ][QS], sm_scale folded in
  float* k_s = q_s + kBlockQ * QS;    // [kBlockK][QS]
  float* v_s = k_s + kBlockK * QS;    // [kBlockK][D]
  float* p_s = v_s + kBlockK * D;     // [kBlockQ][PS]
  int* segr_s = reinterpret_cast<int*>(p_s + kBlockQ * PS);  // [kBlockQ]
  int* segc_s = segr_s + kBlockQ;                             // [kBlockK]

  const int qt = blockIdx.x;
  const int q0 = qt * kBlockQ;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid >> 2;        // q row within the tile
  const int quarter = tid & 3;   // which quarter of columns and dims
  const int row = q0 + r;

  const size_t stride = (size_t)num_heads * D;
  const T* qb = q + (size_t)h * D;
  const T* kb = k + (size_t)h * D;
  const T* vb = v + (size_t)h * D;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int rr = e / D;
    const int c = e - rr * D;
    q_s[rr * QS + c] =
        q0 + rr < tq ? to_float(qb[(size_t)(q0 + rr) * stride + c]) * sm_scale
                     : 0.0f;
  }
  // rows past tq take segment -1, columns past tk -2: neither matches
  for (int e = tid; e < kBlockQ; e += kThreads)
    segr_s[e] = q0 + e < tq ? seg_q[q0 + e] : -1;

  const int lo = kv_lo[qt];
  const int hi = kv_hi[qt];
  float m = kNegInf;  // row statistics, the same in the row's 4 threads
  float l = 0.0f;
  float acc[DQ];
#pragma unroll
  for (int i = 0; i < DQ; ++i) acc[i] = 0.0f;
  __syncthreads();
  const int my_seg = segr_s[r];

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBlockK;
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int rr = e / D;
      const int c = e - rr * D;
      const bool in = k0 + rr < tk;
      const size_t g = (size_t)(k0 + rr) * stride + c;
      k_s[rr * QS + c] = in ? to_float(kb[g]) : 0.0f;
      v_s[rr * D + c] = in ? to_float(vb[g]) : 0.0f;
    }
    for (int e = tid; e < kBlockK; e += kThreads)
      segc_s[e] = k0 + e < tk ? seg_k[k0 + e] : -2;
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

    // masked scores become -inf: they never raise the (finite) running
    // max, and exp(-inf - m) = 0 takes them out of the sums
    float tmax = kNegInf;
#pragma unroll
    for (int jj = 0; jj < CQ; ++jj) {
      const int c = 4 * jj + quarter;
      const bool seen = segc_s[c] == my_seg && (!causal || k0 + c <= row);
      s[jj] = seen ? s[jj] : -INFINITY;
      tmax = fmaxf(tmax, s[jj]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int jj = 0; jj < CQ; ++jj) {
      const float p = expf(s[jj] - m_new);
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
    __syncthreads();  // k_s, v_s, p_s and segc_s are rewritten next tile
  }

  if (row >= tq) return;
  const float lc = fmaxf(l, 1e-30f);
  T* orow = o + (size_t)row * stride + (size_t)h * D + quarter;
#pragma unroll
  for (int i = 0; i < DQ; ++i) orow[4 * i] = from_float<T>(acc[i] / lc);
  if (quarter == 0) lse[(size_t)h * tq + row] = m + logf(lc);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* seg_q,
           const void* seg_k, const void* kv_lo, const void* kv_hi, void* o,
           void* lse, int tq, int tk, int num_heads, float sm_scale,
           int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static_assert(smem <= kMaxSmem, "the tiles exceed a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_varlen_fwd_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tq + kBlockQ - 1) / kBlockQ, num_heads);
  flash_varlen_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_k), static_cast<const int*>(kv_lo),
      static_cast<const int*>(kv_hi), static_cast<T*>(o),
      static_cast<float*>(lse), tq, tk, num_heads, sm_scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* seg_q,
               const void* seg_k, const void* kv_lo, const void* kv_hi,
               void* o, void* lse, int tq, int tk, int num_heads,
               int head_dim, float sm_scale, int causal,
               cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(q, k, v, seg_q, seg_k, kv_lo, kv_hi, o, lse, tq,
                           tk, num_heads, sm_scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, seg_q, seg_k, kv_lo, kv_hi, o, lse, tq,
                            tk, num_heads, sm_scale, causal, stream);
    case 256:
      return launch<T, 256>(q, k, v, seg_q, seg_k, kv_lo, kv_hi, o, lse, tq,
                            tk, num_heads, sm_scale, causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o alike; lse fp32 [h, tq]).
// seg_q [tq], seg_k [tk], kv_lo / kv_hi [ceil(tq / 64)] int32, in 64-token
// tiles. Returns cudaGetLastError() after the launch (0 on success).
int flash_varlen_fwd(const void* q, const void* k, const void* v,
                     const void* seg_q, const void* seg_k, const void* kv_lo,
                     const void* kv_hi, void* o, void* lse, int tq, int tk,
                     int num_heads, int head_dim, float sm_scale, int causal,
                     int dtype, void* stream) {
  if (tq <= 0 || num_heads <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, seg_q, seg_k, kv_lo, kv_hi, o, lse, tq,
                             tk, num_heads, head_dim, sm_scale, causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, seg_q, seg_k, kv_lo, kv_hi, o,
                                     lse, tq, tk, num_heads, head_dim,
                                     sm_scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
