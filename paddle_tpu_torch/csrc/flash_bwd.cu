// Flash-attention backward on Hopper (sm_90a): dq, and per-q-head dk/dv,
// of o = softmax(q k^T * sm_scale) v from the saved q, k, v, lse and the
// cotangent do, with delta = rowsum(do * o) - dlse computed by the caller.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::_bwd_fused_kernel (:398, the
// Pallas TPU kernel behind the custom vjp of flash_attention_with_lse).
//
// Semantics carried over exactly:
//   - layout q/do [b, sq, h, d], k/v [b, sk, kh, d], h % kh == 0, lse and
//     delta [b, h, sq] fp32 (lse natural-log, as the forward wrote it);
//   - GQA: q head i reads kv head i / (h / kh); dk/dv come out per q head,
//     [b, sk, h, d], and the caller sums them over the head group;
//   - causal masks are bottom-right aligned: row r sees columns
//     c <= r + (sk - sq);
//   - per visible (q row i, kv row j): s = sm_scale * q_i.k_j,
//     p = exp(s - lse_i), dv_j += p do_i, dp = do_i.v_j,
//     ds = p (dp - delta_i), dk_j += sm_scale ds q_i, dq_i += sm_scale ds k_j.
//
// Design. The TPU kernel keeps dk/dv in VMEM scratch across a sequential
// q-tile grid; Hopper's blocks run in no order, so the work is split into
// two __global__ functions behind one C entry, both on the caller's
// stream, with no atomics (repeated runs give the same bits):
//   - dk/dv pass: one block per (b*h, kv tile). It stages its K and V tile
//     in shared memory, keeps fp32 dk/dv accumulators in registers, and
//     loops over every q tile that can see the kv tile (q tiles wholly
//     above the causal diagonal are never loaded), recomputing p from lse;
//   - dq pass: one block per (b*h, q tile). It keeps q and do in shared
//     memory and loops over the visible kv tiles, recomputing p and ds.
// Tiles are 64 x 64 for d = 64 and 128, and 32 x 32 for d = 256, so that
// each pass's fp32 tiles fit a block's 227 KB (232,448 bytes) of shared
// memory. The dk/dv pass holds four operand tiles, two score tiles and
// two row statistics: 100,352 bytes at d = 64, 165,888 at d = 128 and
// 140,288 at d = 256. The dq pass holds four operand tiles and one score
// tile: 83,200, 148,736 and 135,808 bytes (dkdv_smem_bytes and
// dq_smem_bytes below; a static_assert holds both to the limit, and a
// launch over it would fail in cudaFuncSetAttribute, which the C entry
// returns and the wrapper raises on). Each row of the block's own tile is
// owned by
// 256 / rows threads of one warp: each computes an interleaved share of the
// row's scores and owns an interleaved share of its accumulator dims, so a
// row's p and ds pass between its threads through shared memory with only
// a __syncwarp. Padded row strides (d + 1, rows + 1) keep the shared reads
// free of bank conflicts.
//
// What bounds it on the H100: at the training shape ([16, 1024, 12, 64]
// causal, bf16) the work is 10 * d flops per visible (i, j) pair, 6.45e10
// flops, against ~2e8 bytes of inputs and outputs, ~320 flops per byte:
// a tensor-core kernel would be bound by operations (~65 us at 989
// TFLOP/s). This first kernel uses scalar fp32 FMAs, so it is bound by its
// own arithmetic and shared-memory reads (one shared load per FMA), and
// recomputing s and dp in the dq pass adds 6 * d flops per pair to the
// 8 * d of the dk/dv pass. mma.sync / wgmma tiles and TMA loads are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

// rows of the block's own tile and of the tile it loops over
template <int D> struct Tile { static constexpr int kRows = 64; };
template <> struct Tile<256> { static constexpr int kRows = 32; };

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

constexpr size_t kMaxSmem = 232448;  // bytes one H100 block can opt into

// dk/dv pass: four [rows][D + 1] operand tiles, two [rows][rows + 1]
// score tiles and two [rows] row statistics, all fp32
template <int D>
constexpr size_t dkdv_smem_bytes() {
  constexpr size_t R = Tile<D>::kRows;
  return sizeof(float) * (4 * R * (D + 1) + 2 * R * (R + 1) + 2 * R);
}

// dq pass: four [rows][D + 1] operand tiles and one [rows][rows + 1]
// score tile, all fp32
template <int D>
constexpr size_t dq_smem_bytes() {
  constexpr size_t R = Tile<D>::kRows;
  return sizeof(float) * (4 * R * (D + 1) + R * (R + 1));
}

// rows x D tile of a [*, row_stride] tensor starting at row r0 into
// shared memory as fp32 with row stride D + 1, times `scale`
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          size_t row_stride, float scale) {
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int rr = e / D;
    const int c = e - rr * D;
    dst[rr * (D + 1) + c] = to_float(src[(size_t)(r0 + rr) * row_stride + c]) * scale;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int sq, int sk, int num_heads, int num_kv_heads, float sm_scale,
    int causal) {
  constexpr int R = Tile<D>::kRows;  // kv rows owned, q rows per step
  constexpr int TPR = kThreads / R;  // threads per kv row
  constexpr int CS = R / TPR;        // scores per thread
  constexpr int DT = D / TPR;        // accumulator dims per thread
  constexpr int RS = D + 1;
  constexpr int PS = R + 1;
  extern __shared__ float smem[];
  float* k_s = smem;                // [R][RS]
  float* v_s = k_s + R * RS;        // [R][RS]
  float* q_s = v_s + R * RS;        // [R][RS], sm_scale folded in
  float* do_s = q_s + R * RS;       // [R][RS]
  float* p_s = do_s + R * RS;       // [R q rows][PS]
  float* ds_s = p_s + R * PS;       // [R q rows][PS]
  float* lse_s = ds_s + R * PS;     // [R]
  float* delta_s = lse_s + R;       // [R]

  const int k0 = blockIdx.x * R;
  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh - b * num_heads;
  const int kvh = h / (num_heads / num_kv_heads);
  const int tid = threadIdx.x;
  const int j = tid / TPR;  // kv row within the tile
  const int t = tid % TPR;  // which share of scores and dims

  const size_t q_stride = (size_t)num_heads * D;
  const size_t kv_stride = (size_t)num_kv_heads * D;
  const T* qb = q + (size_t)b * sq * q_stride + (size_t)h * D;
  const T* dob = dout + (size_t)b * sq * q_stride + (size_t)h * D;
  const T* kb = k + (size_t)b * sk * kv_stride + (size_t)kvh * D;
  const T* vb = v + (size_t)b * sk * kv_stride + (size_t)kvh * D;
  const float* lse_b = lse + (size_t)bh * sq;
  const float* delta_b = delta + (size_t)bh * sq;

  load_tile<T, D, R>(k_s, kb, k0, kv_stride, 1.0f);
  load_tile<T, D, R>(v_s, vb, k0, kv_stride, 1.0f);

  const int offset = sk - sq;  // bottom-right causal alignment
  // the first q tile with a row that sees column k0: r + offset >= k0
  const int qt0 = causal ? max(0, k0 - offset) / R : 0;
  const int n_q = sq / R;

  float acc_k[DT], acc_v[DT];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    acc_k[i] = 0.0f;
    acc_v[i] = 0.0f;
  }

  for (int qt = qt0; qt < n_q; ++qt) {
    const int q0 = qt * R;
    load_tile<T, D, R>(q_s, qb, q0, q_stride, sm_scale);
    load_tile<T, D, R>(do_s, dob, q0, q_stride, 1.0f);
    for (int e = tid; e < R; e += kThreads) {
      lse_s[e] = lse_b[q0 + e];
      delta_s[e] = delta_b[q0 + e];
    }
    __syncthreads();

    // s and dp of kv row j against q rows t + TPR * ii
    float s[CS], dp[CS];
#pragma unroll
    for (int ii = 0; ii < CS; ++ii) {
      s[ii] = 0.0f;
      dp[ii] = 0.0f;
    }
    const float* krow = k_s + j * RS;
    const float* vrow = v_s + j * RS;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float kc = krow[c];
      const float vc = vrow[c];
#pragma unroll
      for (int ii = 0; ii < CS; ++ii) {
        const int i = t + TPR * ii;
        s[ii] += q_s[i * RS + c] * kc;
        dp[ii] += do_s[i * RS + c] * vc;
      }
    }
    // the tile needs the mask unless its first row sees the last column
    const bool masked = causal && q0 + offset < k0 + R - 1;
#pragma unroll
    for (int ii = 0; ii < CS; ++ii) {
      const int i = t + TPR * ii;
      const float p = (masked && k0 + j > q0 + i + offset)
                          ? 0.0f
                          : expf(s[ii] - lse_s[i]);
      p_s[i * PS + j] = p;
      ds_s[i * PS + j] = p * (dp[ii] - delta_s[i]);
    }
    __syncwarp();  // row j's p and ds come from its TPR threads, one warp

    // dv_j += sum_i p_ij do_i ; dk_j += sum_i ds_ij (sm_scale q_i)
    for (int i = 0; i < R; ++i) {
      const float p = p_s[i * PS + j];
      const float ds = ds_s[i * PS + j];
      const float* dorow = do_s + i * RS + t;
      const float* qrow = q_s + i * RS + t;
#pragma unroll
      for (int cc = 0; cc < DT; ++cc) {
        acc_v[cc] += p * dorow[TPR * cc];
        acc_k[cc] += ds * qrow[TPR * cc];
      }
    }
    __syncthreads();  // q_s, do_s and the score tiles are rewritten next
  }

  T* dkrow = dk + ((size_t)b * sk + k0 + j) * q_stride + (size_t)h * D + t;
  T* dvrow = dv + ((size_t)b * sk + k0 + j) * q_stride + (size_t)h * D + t;
#pragma unroll
  for (int cc = 0; cc < DT; ++cc) {
    dkrow[TPR * cc] = from_float<T>(acc_k[cc]);
    dvrow[TPR * cc] = from_float<T>(acc_v[cc]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk,
    int num_heads, int num_kv_heads, float sm_scale, int causal) {
  constexpr int R = Tile<D>::kRows;  // q rows owned, kv rows per step
  constexpr int TPR = kThreads / R;  // threads per q row
  constexpr int CS = R / TPR;        // scores per thread
  constexpr int DT = D / TPR;        // accumulator dims per thread
  constexpr int RS = D + 1;
  constexpr int PS = R + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                // [R][RS], sm_scale folded in
  float* do_s = q_s + R * RS;       // [R][RS]
  float* k_s = do_s + R * RS;       // [R][RS]
  float* v_s = k_s + R * RS;        // [R][RS]
  float* ds_s = v_s + R * RS;       // [R q rows][PS]

  const int q0 = blockIdx.x * R;
  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh - b * num_heads;
  const int kvh = h / (num_heads / num_kv_heads);
  const int tid = threadIdx.x;
  const int i = tid / TPR;  // q row within the tile
  const int t = tid % TPR;

  const size_t q_stride = (size_t)num_heads * D;
  const size_t kv_stride = (size_t)num_kv_heads * D;
  const T* qb = q + (size_t)b * sq * q_stride + (size_t)h * D;
  const T* dob = dout + (size_t)b * sq * q_stride + (size_t)h * D;
  const T* kb = k + (size_t)b * sk * kv_stride + (size_t)kvh * D;
  const T* vb = v + (size_t)b * sk * kv_stride + (size_t)kvh * D;
  const float lse_i = lse[(size_t)bh * sq + q0 + i];
  const float delta_i = delta[(size_t)bh * sq + q0 + i];

  load_tile<T, D, R>(q_s, qb, q0, q_stride, sm_scale);
  load_tile<T, D, R>(do_s, dob, q0, q_stride, 1.0f);

  const int offset = sk - sq;
  int n_kv = sk / R;
  int n_full = n_kv;  // kv tiles that need no mask
  if (causal) {
    // the tile's last row sees columns <= q0 + R - 1 + offset
    n_kv = min(n_kv, (q0 + R - 1 + offset) / R + 1);
    // a kv tile is unmasked when its last column is visible to row q0
    n_full = min(n_kv, (q0 + offset + 1) / R);
  }

  float acc[DT];
#pragma unroll
  for (int cc = 0; cc < DT; ++cc) acc[cc] = 0.0f;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * R;
    load_tile<T, D, R>(k_s, kb, k0, kv_stride, 1.0f);
    load_tile<T, D, R>(v_s, vb, k0, kv_stride, 1.0f);
    __syncthreads();

    // s and dp of q row i against kv rows t + TPR * jj
    float s[CS], dp[CS];
#pragma unroll
    for (int jj = 0; jj < CS; ++jj) {
      s[jj] = 0.0f;
      dp[jj] = 0.0f;
    }
    const float* qrow = q_s + i * RS;
    const float* dorow = do_s + i * RS;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float qc = qrow[c];
      const float dc = dorow[c];
#pragma unroll
      for (int jj = 0; jj < CS; ++jj) {
        const int jr = t + TPR * jj;
        s[jj] += qc * k_s[jr * RS + c];
        dp[jj] += dc * v_s[jr * RS + c];
      }
    }
    const bool masked = causal && kt >= n_full;
#pragma unroll
    for (int jj = 0; jj < CS; ++jj) {
      const int jr = t + TPR * jj;
      const float p = (masked && k0 + jr > q0 + i + offset)
                          ? 0.0f
                          : expf(s[jj] - lse_i);
      ds_s[i * PS + jr] = p * (dp[jj] - delta_i);
    }
    __syncwarp();  // row i's ds come from its TPR threads, one warp

    // dq_i += sum_j ds_ij k_j (sm_scale applied at the store)
    const float* dsrow = ds_s + i * PS;
    for (int jr = 0; jr < R; ++jr) {
      const float ds = dsrow[jr];
      const float* krow = k_s + jr * RS + t;
#pragma unroll
      for (int cc = 0; cc < DT; ++cc) acc[cc] += ds * krow[TPR * cc];
    }
    __syncthreads();  // k_s, v_s and ds_s are rewritten by the next tile
  }

  T* dqrow = dq + ((size_t)b * sq + q0 + i) * q_stride + (size_t)h * D + t;
#pragma unroll
  for (int cc = 0; cc < DT; ++cc)
    dqrow[TPR * cc] = from_float<T>(acc[cc] * sm_scale);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int batch, int sq, int sk, int num_heads, int num_kv_heads,
           float sm_scale, int causal, cudaStream_t stream) {
  constexpr int R = Tile<D>::kRows;
  constexpr size_t smem_dkdv = dkdv_smem_bytes<D>();
  constexpr size_t smem_dq = dq_smem_bytes<D>();
  static_assert(smem_dkdv <= kMaxSmem && smem_dq <= kMaxSmem,
                "a pass's tiles exceed a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  const float* dt = static_cast<const float*>(delta);
  flash_bwd_dkdv_kernel<T, D><<<dim3(sk / R, batch * num_heads), kThreads,
                                smem_dkdv, stream>>>(
      qt, kt, vt, dot, lt, dt, static_cast<T*>(dk), static_cast<T*>(dv), sq,
      sk, num_heads, num_kv_heads, sm_scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<T, D><<<dim3(sq / R, batch * num_heads), kThreads,
                              smem_dq, stream>>>(qt, kt, vt, dot, lt, dt,
                                        static_cast<T*>(dq), sq, sk,
                                        num_heads, num_kv_heads, sm_scale,
                                        causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, int batch, int sq, int sk, int num_heads,
               int num_kv_heads, int head_dim, float sm_scale, int causal,
               cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, batch, sq,
                           sk, num_heads, num_kv_heads, sm_scale, causal,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, batch, sq,
                            sk, num_heads, num_kv_heads, sm_scale, causal,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, dout, lse, delta, dq, dk, dv, batch, sq,
                            sk, num_heads, num_kv_heads, sm_scale, causal,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do, dq, dk, dv alike; lse and
// delta fp32). dk/dv are per q head: [b, sk, num_heads, head_dim]. sq and
// sk must be multiples of 64 (of 32 at head_dim 256). Returns
// cudaGetLastError() after the two launches (0 on success).
int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, void* dk,
              void* dv, int batch, int sq, int sk, int num_heads,
              int num_kv_heads, int head_dim, float sm_scale, int causal,
              int dtype, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, dout, lse, delta, dq, dk, dv, batch, sq,
                             sk, num_heads, num_kv_heads, head_dim, sm_scale,
                             causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv,
                                     batch, sq, sk, num_heads, num_kv_heads,
                                     head_dim, sm_scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
