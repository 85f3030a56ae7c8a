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
// What bounds it on the H100: at the main path's shape ([1, 1024, 12, 64]
// causal, bf16) the work is ~1.6 GFLOP over ~6.3 MB, ~260 flops per byte,
// just under the ridge: a tensor-core kernel would be bound by bytes
// (~1.9 us) and by operations nearly as much. This first kernel uses
// scalar fp32 FMAs, so it is bound by its own arithmetic and shared-memory
// traffic. What the design does about that: one block of 256 threads per
// (b*h, 64-row q tile) keeps the q tile in shared memory for its whole kv
// loop, so device memory sees each q row once and each kv tile once per q
// tile; kv tiles wholly above the causal diagonal are skipped, and only
// the diagonal tiles pay for the mask. Four threads share a q row: each
// scores 16 of the tile's 64 columns and owns a quarter of the output
// dims, so the row statistics need two shuffles and no shared memory.
// Padded row strides (D + 1, 64 + 1) keep the shared-memory reads free of
// bank conflicts. wgmma, TMA and mma.sync are later work.
//
// Not carried over from the TPU kernel: the packed [b, s, h*d] operand
// trick, the ones-column row sum, the x64-off scope, the _MIN_SEQ floor
// and the 512/256 tile choices.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // four threads per q row

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

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               void* lse, int batch, int sq, int sk, int num_heads,
               int num_kv_heads, int head_dim, float sm_scale, int causal,
               cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(q, k, v, o, lse, batch, sq, sk, num_heads,
                           num_kv_heads, sm_scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, batch, sq, sk, num_heads,
                            num_kv_heads, sm_scale, causal, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, batch, sq, sk, num_heads,
                            num_kv_heads, sm_scale, causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success).
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              int batch, int sq, int sk, int num_heads, int num_kv_heads,
              int head_dim, float sm_scale, int causal, int dtype,
              void* stream) {
  if (batch <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, lse, batch, sq, sk, num_heads,
                             num_kv_heads, head_dim, sm_scale, causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, batch, sq, sk,
                                     num_heads, num_kv_heads, head_dim,
                                     sm_scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
