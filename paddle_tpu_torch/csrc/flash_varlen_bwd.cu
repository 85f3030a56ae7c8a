// Packed varlen flash-attention backward on Hopper (sm_90a): dq, dk and dv
// of o = block-diagonal softmax(q k^T * sm_scale) v from the saved q, k,
// v, lse and the cotangent do, with delta = rowsum(do * o) computed by the
// caller in fp32.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::_vl_bwd_kernel (:769, the
// Pallas TPU kernel behind the custom vjp of flash_attention_varlen_values).
//
// Semantics carried over exactly:
//   - layout q/do/dq [tq, h, d], k/v/dk/dv [tk, h, d] (kv heads == q
//     heads), lse and delta [h, tq] fp32 (lse natural-log, as K4 wrote it);
//   - visibility as in K4: seg_q[i] == seg_k[j] and, when causal, i >= j
//     in absolute token positions;
//   - per visible (q row i, kv row j): s = sm_scale * q_i.k_j,
//     p = exp(min(s - lse_i, 0)), dv_j += p do_i, dp = do_i.v_j,
//     ds = p (dp - delta_i), dk_j += sm_scale ds q_i, dq_i += sm_scale ds k_j.
//     The min is the reference's guard (:809): s <= lse holds in exact
//     arithmetic, and where both sit at the -1e30 mask scale fp32 noise
//     could flip the difference positive, exp to inf and inf * 0 to NaN.
//
// Design. The TPU kernel keeps dk/dv in VMEM scratch across a sequential
// q-tile grid; Hopper's blocks run in no order, so, as in flash_bwd.cu,
// the work is two __global__ functions behind one C entry, both on the
// caller's stream, with no atomics (repeated runs give the same bits):
//   - dk/dv pass: one block per (kv tile, head). It stages its K and V
//     tile in shared memory, keeps fp32 dk/dv accumulators in registers,
//     and loops over its q tiles [q_lo, q_hi): the q tokens of the tile's
//     first through last segment, from its first column on when causal,
//     so no q tile outside the tile's segments is loaded;
//   - dq pass: one block per (q tile, head). It keeps q and do in shared
//     memory and loops over K4's kv tiles [kv_lo, kv_hi), recomputing p
//     and ds.
// Both ranges come from ops/cuda_kernels.py varlen_plan at this kernel's
// tile size, which the C entry checks. Rows and columns past tq / tk are
// bound-checked (loaded as zeros, masked, never stored). Tiles are 64 x 64
// for d = 64 and 128, and 32 x 32 for d = 256, so that each pass's fp32
// tiles fit a block's 227 KB (232,448 bytes) of shared memory. The dk/dv
// pass holds four operand tiles, two score tiles, two row statistics and
// the segment ids of its rows and columns: 100,864 bytes at d = 64,
// 166,400 at d = 128 and 140,544 at d = 256. The dq pass holds four
// operand tiles, one score tile and the segment ids: 83,712, 149,248 and
// 136,064 bytes (dkdv_smem_bytes and dq_smem_bytes below; a static_assert
// holds both to the limit). Each row of the block's own tile is owned by
// 256 / rows threads of one warp, which meet in shared memory behind a
// __syncwarp; padded row strides keep the shared reads free of bank
// conflicts.
//
// What bounds it on the H100: 10 * d flops per visible pair against the
// bytes of q, k, v, o, do, dq, dk, dv, lse and delta; at the main path's
// shape (16,384 packed tokens, h 12, d 64, causal bf16, ~11 M visible
// pairs per head) that is ~8.6e10 flops against ~50 MB, so a tensor-core
// kernel would be bound by operations (~87 us). This first kernel uses
// scalar fp32 FMAs, so it is bound by its own arithmetic and shared-memory
// reads, and the dq pass recomputes s and dp (6 * d flops per pair more).

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
// score tiles and two [rows] row statistics, all fp32, and the int32
// segment ids of the q rows and kv rows
template <int D>
constexpr size_t dkdv_smem_bytes() {
  constexpr size_t R = Tile<D>::kRows;
  return sizeof(float) * (4 * R * (D + 1) + 2 * R * (R + 1) + 2 * R) +
         sizeof(int) * 2 * R;
}

// dq pass: four [rows][D + 1] operand tiles and one [rows][rows + 1] score
// tile, all fp32, and the int32 segment ids of the q rows and kv rows
template <int D>
constexpr size_t dq_smem_bytes() {
  constexpr size_t R = Tile<D>::kRows;
  return sizeof(float) * (4 * R * (D + 1) + R * (R + 1)) +
         sizeof(int) * 2 * R;
}

// R x D tile of a [n, row_stride] tensor starting at row r0 into shared
// memory as fp32 with row stride D + 1, times `scale`; rows past n are 0
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n, size_t row_stride,
                                          float scale) {
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int rr = e / D;
    const int c = e - rr * D;
    dst[rr * (D + 1) + c] =
        r0 + rr < n ? to_float(src[(size_t)(r0 + rr) * row_stride + c]) * scale
                    : 0.0f;
  }
}

// the R segment ids from row r0 on; rows past n take `pad`
template <int R>
__device__ __forceinline__ void load_seg(int* dst, const int* seg, int r0,
                                         int n, int pad) {
  for (int e = threadIdx.x; e < R; e += kThreads)
    dst[e] = r0 + e < n ? seg[r0 + e] : pad;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_varlen_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ seg_q,
    const int* __restrict__ seg_k, const int* __restrict__ q_lo,
    const int* __restrict__ q_hi, T* __restrict__ dk, T* __restrict__ dv,
    int tq, int tk, int num_heads, float sm_scale, int causal) {
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
  int* segq_s = reinterpret_cast<int*>(delta_s + R);  // [R]
  int* segk_s = segq_s + R;                           // [R]

  const int kt = blockIdx.x;
  const int k0 = kt * R;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int j = tid / TPR;  // kv row within the tile
  const int t = tid % TPR;  // which share of scores and dims
  const int col = k0 + j;

  const size_t stride = (size_t)num_heads * D;
  const T* qb = q + (size_t)h * D;
  const T* dob = dout + (size_t)h * D;
  const T* kb = k + (size_t)h * D;
  const T* vb = v + (size_t)h * D;
  const float* lse_h = lse + (size_t)h * tq;
  const float* delta_h = delta + (size_t)h * tq;

  load_tile<T, D, R>(k_s, kb, k0, tk, stride, 1.0f);
  load_tile<T, D, R>(v_s, vb, k0, tk, stride, 1.0f);
  // rows past tq take segment -1, columns past tk -2: neither matches
  load_seg<R>(segk_s, seg_k, k0, tk, -2);

  float acc_k[DT], acc_v[DT];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    acc_k[i] = 0.0f;
    acc_v[i] = 0.0f;
  }

  const int lo = q_lo[kt];
  const int hi = q_hi[kt];
  for (int qt = lo; qt < hi; ++qt) {
    const int q0 = qt * R;
    load_tile<T, D, R>(q_s, qb, q0, tq, stride, sm_scale);
    load_tile<T, D, R>(do_s, dob, q0, tq, stride, 1.0f);
    load_seg<R>(segq_s, seg_q, q0, tq, -1);
    for (int e = tid; e < R; e += kThreads) {
      lse_s[e] = q0 + e < tq ? lse_h[q0 + e] : 0.0f;
      delta_s[e] = q0 + e < tq ? delta_h[q0 + e] : 0.0f;
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
    const int my_seg = segk_s[j];
#pragma unroll
    for (int ii = 0; ii < CS; ++ii) {
      const int i = t + TPR * ii;
      const bool seen = segq_s[i] == my_seg && (!causal || q0 + i >= col);
      const float p = seen ? expf(fminf(s[ii] - lse_s[i], 0.0f)) : 0.0f;
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
    __syncthreads();  // q_s, do_s, the score tiles and segq_s change next
  }

  if (col >= tk) return;
  T* dkrow = dk + (size_t)col * stride + (size_t)h * D + t;
  T* dvrow = dv + (size_t)col * stride + (size_t)h * D + t;
#pragma unroll
  for (int cc = 0; cc < DT; ++cc) {
    dkrow[TPR * cc] = from_float<T>(acc_k[cc]);
    dvrow[TPR * cc] = from_float<T>(acc_v[cc]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_varlen_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ seg_q,
    const int* __restrict__ seg_k, const int* __restrict__ kv_lo,
    const int* __restrict__ kv_hi, T* __restrict__ dq, int tq, int tk,
    int num_heads, float sm_scale, int causal) {
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
  int* segq_s = reinterpret_cast<int*>(ds_s + R * PS);  // [R]
  int* segk_s = segq_s + R;                             // [R]

  const int qt = blockIdx.x;
  const int q0 = qt * R;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int i = tid / TPR;  // q row within the tile
  const int t = tid % TPR;
  const int row = q0 + i;

  const size_t stride = (size_t)num_heads * D;
  const T* qb = q + (size_t)h * D;
  const T* dob = dout + (size_t)h * D;
  const T* kb = k + (size_t)h * D;
  const T* vb = v + (size_t)h * D;
  const float lse_i = row < tq ? lse[(size_t)h * tq + row] : 0.0f;
  const float delta_i = row < tq ? delta[(size_t)h * tq + row] : 0.0f;

  load_tile<T, D, R>(q_s, qb, q0, tq, stride, sm_scale);
  load_tile<T, D, R>(do_s, dob, q0, tq, stride, 1.0f);
  load_seg<R>(segq_s, seg_q, q0, tq, -1);

  float acc[DT];
#pragma unroll
  for (int cc = 0; cc < DT; ++cc) acc[cc] = 0.0f;

  const int lo = kv_lo[qt];
  const int hi = kv_hi[qt];
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * R;
    load_tile<T, D, R>(k_s, kb, k0, tk, stride, 1.0f);
    load_tile<T, D, R>(v_s, vb, k0, tk, stride, 1.0f);
    load_seg<R>(segk_s, seg_k, k0, tk, -2);
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
    const int my_seg = segq_s[i];
#pragma unroll
    for (int jj = 0; jj < CS; ++jj) {
      const int jr = t + TPR * jj;
      const bool seen = segk_s[jr] == my_seg && (!causal || k0 + jr <= row);
      const float p = seen ? expf(fminf(s[jj] - lse_i, 0.0f)) : 0.0f;
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
    __syncthreads();  // k_s, v_s, ds_s and segk_s are rewritten next tile
  }

  if (row >= tq) return;
  T* dqrow = dq + (size_t)row * stride + (size_t)h * D + t;
#pragma unroll
  for (int cc = 0; cc < DT; ++cc)
    dqrow[TPR * cc] = from_float<T>(acc[cc] * sm_scale);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *seg_q, *seg_k, *kv_lo, *kv_hi,
      *q_lo, *q_hi;
  void *dq, *dk, *dv;
  int tq, tk, num_heads;
  float sm_scale;
  int causal;
};

template <typename T, int D>
int launch(const Args& a, int block, cudaStream_t stream) {
  constexpr int R = Tile<D>::kRows;
  constexpr size_t smem_dkdv = dkdv_smem_bytes<D>();
  constexpr size_t smem_dq = dq_smem_bytes<D>();
  static_assert(smem_dkdv <= kMaxSmem && smem_dq <= kMaxSmem,
                "a pass's tiles exceed a block's shared memory");
  if (block != R) return (int)cudaErrorInvalidValue;  // ranges at R tokens
  cudaError_t err = cudaFuncSetAttribute(
      flash_varlen_bwd_dkdv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_varlen_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  const int* seg_q = static_cast<const int*>(a.seg_q);
  const int* seg_k = static_cast<const int*>(a.seg_k);
  if (a.tk > 0) {
    flash_varlen_bwd_dkdv_kernel<T, D>
        <<<dim3((a.tk + R - 1) / R, a.num_heads), kThreads, smem_dkdv,
           stream>>>(q, k, v, dout, lse, delta, seg_q, seg_k,
                     static_cast<const int*>(a.q_lo),
                     static_cast<const int*>(a.q_hi), static_cast<T*>(a.dk),
                     static_cast<T*>(a.dv), a.tq, a.tk, a.num_heads,
                     a.sm_scale, a.causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (a.tq > 0) {
    flash_varlen_bwd_dq_kernel<T, D>
        <<<dim3((a.tq + R - 1) / R, a.num_heads), kThreads, smem_dq,
           stream>>>(q, k, v, dout, lse, delta, seg_q, seg_k,
                     static_cast<const int*>(a.kv_lo),
                     static_cast<const int*>(a.kv_hi), static_cast<T*>(a.dq),
                     a.tq, a.tk, a.num_heads, a.sm_scale, a.causal);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const Args& a, int head_dim, int block, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(a, block, stream);
    case 128:
      return launch<T, 128>(a, block, stream);
    case 256:
      return launch<T, 256>(a, block, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do, dq, dk, dv alike; lse and
// delta fp32 [h, tq]). seg_q [tq] and seg_k [tk] int32; kv_lo / kv_hi per
// q tile and q_lo / q_hi per kv tile, int32, in tiles of `block` tokens,
// which must be this kernel's tile (64, or 32 at head_dim 256). Returns
// cudaGetLastError() after the two launches (0 on success).
int flash_varlen_bwd(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* seg_q, const void* seg_k, const void* kv_lo,
                     const void* kv_hi, const void* q_lo, const void* q_hi,
                     void* dq, void* dk, void* dv, int tq, int tk,
                     int num_heads, int head_dim, int block, float sm_scale,
                     int causal, int dtype, void* stream) {
  if (num_heads <= 0) return 0;
  const Args a{q,     k,     v,    dout, lse, delta, seg_q, seg_k,
               kv_lo, kv_hi, q_lo, q_hi, dq,  dk,    dv,    tq,
               tk,    num_heads,   sm_scale,  causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(a, head_dim, block, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(a, head_dim, block, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
