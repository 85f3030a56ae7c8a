// Ragged paged attention for decode (KQ = 1) and k-query speculative
// verify (KQ = k + 1) on Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::_paged_verify_kernel (the
// Pallas TPU kernel behind paged_attention_decode and
// paged_attention_verify_decode).
//
// What it computes, per slot b and head h: query row j (j < KQ) attends
// over the first ctx[b] + j tokens of the slot's paged KV history, with an
// online softmax in fp32. ctx[b] == 0 marks an inactive slot, whose rows
// are written as exact zeros.
//
// Layouts (the data contract the serving engine writes into):
//   q            [B, KQ, H, D]                 contiguous
//   k/v pages    [num_pages, page_size, H*D]   page 0 is the null page
//   block_tables [B, max_pages] int32          padded with page 0
//   context_lens [B] int32
//   out          [B, KQ, H, D]                 same dtype as q
//
// What bounds it on the H100: bytes. Each (slot, head) reads its context's
// K and V rows once, D values each, and does 4*D flops per row and query
// row: about 2*KQ flops per byte, far below the ~295 flops/byte where the
// tensor cores would start to matter. So the design moves the fewest
// bytes: one block per (slot, head) reads the slot's page ids itself and
// walks only the pages below ceil((ctx + KQ - 1) / page_size). The TPU
// kernel DMAs every max_pages entry and skips the compute; this kernel
// reads nothing it does not use. K and V tiles of 32 tokens are staged in
// shared memory (fp32), so each row is read from device memory once while
// all KQ query rows use it.
//
// Not carried over from the TPU kernel: the static head loop, the
// page-group DMA ring and its PDTPU_PAGED_PAGES_PER_STEP knob.
//
// A simple kernel first: scalar fp32 FMAs, 128 threads, no cp.async or
// TMA. Its time on the card stands beside its bound in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;      // tokens per staged tile: one warp's width
constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, T* __restrict__ out, int kq,
    int num_heads, int head_dim, int page_size, int max_pages,
    float sm_scale) {
  extern __shared__ float smem[];
  const int d = head_dim;
  float* q_s = smem;                 // [kq][d], sm_scale folded in
  float* acc = q_s + kq * d;         // [kq][d]
  float* k_s = acc + kq * d;         // [kTile][d]
  float* v_s = k_s + kTile * d;      // [kTile][d]
  float* p_s = v_s + kTile * d;      // [kq][kTile]: scores, then probs
  float* m_s = p_s + kq * kTile;     // [kq] running max
  float* l_s = m_s + kq;             // [kq] running sum
  float* alpha_s = l_s + kq;         // [kq] this tile's rescale

  const int b = blockIdx.x / num_heads;
  const int h = blockIdx.x - b * num_heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t hd = (size_t)num_heads * d;
  // row j of this (slot, head) lives at base + j * hd
  const size_t base = (size_t)b * kq * hd + (size_t)h * d;
  const int ctx = context_lens[b];

  if (ctx <= 0) {  // inactive slot: exact (+0) zeros, nothing read
    for (int e = tid; e < kq * d; e += kThreads) {
      const int j = e / d;
      out[base + j * hd + (e - j * d)] = from_float<T>(0.0f);
    }
    return;
  }

  for (int e = tid; e < kq * d; e += kThreads) {
    const int j = e / d;
    q_s[e] = to_float(q[base + j * hd + (e - j * d)]) * sm_scale;
    acc[e] = 0.0f;
  }
  for (int j = tid; j < kq; j += kThreads) {
    m_s[j] = -INFINITY;
    l_s[j] = 0.0f;
  }
  // the last row sees ctx + kq - 1 tokens; no row sees more. The clamp to
  // the table's extent keeps a too-long ctx from reading past the table.
  const int n_tok = min(ctx + kq - 1, max_pages * page_size);
  const int* table = block_tables + (size_t)b * max_pages;
  __syncthreads();

  for (int t0 = 0; t0 < n_tok; t0 += kTile) {
    const int nt = min(kTile, n_tok - t0);
    for (int e = tid; e < nt * d; e += kThreads) {
      const int t = e / d;
      const int c = e - t * d;
      const int pos = t0 + t;
      const int page = table[pos / page_size];
      const size_t off =
          ((size_t)page * page_size + (pos % page_size)) * hd + h * d + c;
      k_s[e] = to_float(k_pages[off]);
      v_s[e] = to_float(v_pages[off]);
    }
    __syncthreads();

    // scores: warp w takes tokens w, w + 4, ...; the lanes split D
    for (int t = warp; t < kTile; t += kWarps) {
      for (int j = 0; j < kq; ++j) {
        float part = 0.0f;
        if (t < nt) {
          for (int c = lane; c < d; c += 32)
            part += q_s[j * d + c] * k_s[t * d + c];
        }
        part = warp_sum(part);
        if (lane == 0) {
          const bool visible = t < nt && t0 + t < ctx + j;
          p_s[j * kTile + t] = visible ? part : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax: warp w takes rows w, w + 4, ...; lane = token
    for (int j = warp; j < kq; j += kWarps) {
      const float s = p_s[j * kTile + lane];
      const float m_old = m_s[j];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = s == -INFINITY ? 0.0f : expf(s - m_new);
      const float alpha = m_old == -INFINITY ? 0.0f : expf(m_old - m_new);
      const float psum = warp_sum(p);
      p_s[j * kTile + lane] = p;
      if (lane == 0) {
        m_s[j] = m_new;
        l_s[j] = l_s[j] * alpha + psum;
        alpha_s[j] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V; each thread owns fixed (row, column) slots
    for (int e = tid; e < kq * d; e += kThreads) {
      const int j = e / d;
      const int c = e - j * d;
      const float* pj = p_s + j * kTile;
      float a = acc[e] * alpha_s[j];
      for (int t = 0; t < nt; ++t) a += pj[t] * v_s[t * d + c];
      acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < kq * d; e += kThreads) {
    const int j = e / d;
    out[base + j * hd + (e - j * d)] =
        from_float<T>(acc[e] / fmaxf(l_s[j], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_tables, const void* context_lens, void* out,
           int batch, int kq, int num_heads, int head_dim, int page_size,
           int max_pages, float sm_scale, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_attention_kernel<T><<<batch * num_heads, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<T*>(out), kq,
      num_heads, head_dim, page_size, max_pages, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success).
int paged_attention_fwd(const void* q, const void* k_pages,
                        const void* v_pages, const void* block_tables,
                        const void* context_lens, void* out, int batch, int kq,
                        int num_heads, int head_dim, int page_size,
                        int max_pages, float sm_scale, int dtype,
                        void* stream) {
  if (batch <= 0 || kq <= 0) return 0;
  // q, acc [kq][d]; k, v tiles [kTile][d]; probs [kq][kTile]; m, l, alpha
  const size_t smem = sizeof(float) *
                      (2 * (size_t)kq * head_dim + 2 * (size_t)kTile * head_dim +
                       (size_t)kq * kTile + 3 * (size_t)kq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, block_tables, context_lens, out,
                         batch, kq, num_heads, head_dim, page_size, max_pages,
                         sm_scale, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables,
                                 context_lens, out, batch, kq, num_heads,
                                 head_dim, page_size, max_pages, sm_scale,
                                 smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
