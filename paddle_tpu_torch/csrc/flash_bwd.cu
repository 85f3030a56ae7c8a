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
//   - dk/dv pass: one block per (b*h, kv tile). It keeps its K and V tile
//     in shared memory and fp32 dk/dv accumulators in registers, and loops
//     over every q tile that can see the kv tile (q tiles wholly above the
//     causal diagonal are never loaded), recomputing p from lse;
//   - dq pass: one block per (b*h, q tile). It keeps q and do in shared
//     memory and loops over the visible kv tiles, recomputing p and ds.
// The price of no atomics: the dq pass recomputes s and dp, so 14 * d
// flops are executed per visible pair (8 * d in the dk/dv pass, 6 * d in
// the dq pass) against the 10 * d the gradients need.
//
// What bounds it on the H100: at the training shape ([16, 1024, 12, 64]
// causal, bf16) the work is 10 * d flops per visible (i, j) pair, 6.45e10
// flops, against ~2e8 bytes of inputs and outputs, ~320 flops per byte:
// operations bound it, 0.0652 ms at 989 TFLOP/s.
//
// Three routes behind the one C entry, chosen by dtype (nothing is caught,
// and none is a fallback for another):
//
// bf16: flash_bwd_dkdv_kernel_tc and flash_bwd_dq_kernel_tc, tensor cores;
// the training path (O2) runs them. Every product (S, dP and the three
// gradient products) is a Hopper warpgroup wgmma with bf16 operands and
// fp32 accumulators in registers, so the kernel pays the tensor-core rate
// for its 14 * d flops instead of the scalar FMA rate. One warpgroup (128
// threads) per CTA owns 64 rows of the CTA's own tile:
//   - dk/dv pass: a CTA per (kv tile of 64 rows, b*h); K and V stay
//     resident as bf16 in shared memory; q, do, lse and delta tiles of the
//     q rows that see it stream through a 2-stage ring filled by 16-byte
//     cp.async. Per q tile: S^T = K q^T and dP^T = V do^T (both operands
//     in shared memory), then P^T = exp2(S^T * sm_scale * log2e - lse *
//     log2e) and dS^T = P^T (dP^T - delta) on the accumulators; both are
//     rounded to bf16 in registers and are the register A operands of
//     dV += P^T do and dK += dS^T q, with do and q read through transposed
//     (MN-major) descriptors. At d = 256 the 64 x 256 dk and dv
//     accumulators do not fit the registers, so a third grid dimension
//     gives each CTA one half of the columns (it recomputes S^T and dP^T
//     for its half).
//   - dq pass: a CTA per (q tile of 64 rows, b*h), heaviest causal tiles
//     first (blockIdx.x reversed); q and do stay resident in shared
//     memory, k and v tiles stream through the 2-stage ring. Per kv tile:
//     S = q K^T and dP = do V^T, P and dS in registers, dQ += dS K with K
//     through a transposed descriptor.
//   - shared tiles are in the 128-byte swizzled layout the wgmma
//     descriptors read (flash_tc.cuh); dq, dk and dv leave through shared
//     memory as 16-byte coalesced stores.
// Tiles, per d: the dk/dv pass takes 64 kv rows and q steps of 64 rows at
// d = 64, 32 at d = 128 and 256; the dq pass takes 64 q rows and kv steps
// of 64 rows, 32 at d = 256. Shared memory (dkdv_tc_smem_bytes,
// dq_tc_smem_bytes; a static_assert holds each to 232,448 bytes): dk/dv
// 50,176 / 66,048 / 131,584 bytes and dq 49,152 / 98,304 / 131,072 bytes
// at d = 64 / 128 / 256; registers per thread (ptxas, sm_90a, CUDA 12.9)
// dk/dv 168 / 212 / 234 and dq 142 / 202 / 236, with 0 bytes of spills
// (chip_smoke.py's environment phase prints them).
// Precision: q, k, v, do enter the products as given (bf16); sm_scale *
// log2e multiplies the fp32 scores and sm_scale the fp32 dq and dk at the
// store, so the JAX kernel's bf16 rounding of the scaled q (:430-431) is
// not needed (at d = 64 and 256 the two agree bit for bit); p is rounded
// to bf16 before P^T do (:450) and ds before dS^T q and dS K (:457), as
// the JAX kernel rounds them; ds itself is computed from the fp32 p;
// lse, delta and every accumulator stay fp32.
// Loads are cp.async, not TMA, and each warpgroup waits for its products
// before its elementwise work: TMA, a producer warp and overlapping the
// next tile's products with this tile's elementwise work are still open.
//
// fp16 (dtype 2): flash_bwd_dkdv_kernel_tc<fp16> and
// flash_bwd_dq_kernel_tc<fp16>, the same kernels instantiated for __half
// (flash_tc.cuh picks the .f16 wgmma from the operands' type). Eager AMP O2
// in float16 with a loss scaler runs this route. The only differences from
// bf16 are the instruction and the rounding of p, dS, dq, dk and dv to fp16,
// to nearest even and never clamped: a value past 65504 becomes inf, as the
// JAX kernel's .astype(float16) makes it, so the loss scaler sees the
// overflow. fp16 keeps 3 more mantissa bits than bf16 and 3 fewer exponent
// bits.
//
// fp32: flash_bwd_dkdv_kernel and flash_bwd_dq_kernel, the scalar kernels
// of the first port, unchanged. fp32 is not the dtype of any main path;
// it carries the exactness checks (5e-5 against the fp32 plain version),
// which TF32 tensor cores would break. Tiles are 64 x 64 for d = 64 and
// 128, and 32 x 32 for d = 256, so that each pass's fp32 tiles fit a
// block's 227 KB (232,448 bytes) of shared memory. The dk/dv pass holds
// four operand tiles, two score tiles and two row statistics: 100,352
// bytes at d = 64, 165,888 at d = 128 and 140,288 at d = 256. The dq pass
// holds four operand tiles and one score tile: 83,200, 148,736 and
// 135,808 bytes (dkdv_smem_bytes and dq_smem_bytes below; a static_assert
// holds both to the limit, and a launch over it would fail in
// cudaFuncSetAttribute, which the C entry returns and the wrapper raises
// on). Each row of the block's own tile is owned by 256 / rows threads of
// one warp: each computes an interleaved share of the row's scores and
// owns an interleaved share of its accumulator dims, so a row's p and ds
// pass between its threads through shared memory with only a __syncwarp.
// Padded row strides (d + 1, rows + 1) keep the shared reads free of bank
// conflicts. They are bound by their own scalar FMAs and shared-memory
// reads (one shared load per FMA).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_tc.cuh"

namespace {

constexpr int kThreads = 256;

// rows of the block's own tile and of the tile it loops over
template <int D> struct Tile { static constexpr int kRows = 64; };
template <> struct Tile<256> { static constexpr int kRows = 32; };

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

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

// -- bf16 and fp16 routes: tensor cores -------------------------------------

using bf16 = __nv_bfloat16;
using fp16 = __half;
constexpr int kTcThreads = 128;  // one warpgroup
constexpr int kTcRows = 64;      // rows of a CTA's own tile, 16 per warp

template <int D>
struct BwdTile {
  static constexpr int kDkdvStep = D == 64 ? 64 : 32;  // q rows per step
  static constexpr int kSplit = D == 256 ? 2 : 1;      // dk/dv column CTAs
  static constexpr int kDqStep = D == 256 ? 32 : 64;   // kv rows per step
};

// k and v tiles, two stages of q and do tiles (bf16) and of lse and
// delta rows (fp32)
template <int D>
constexpr size_t dkdv_tc_smem_bytes() {
  constexpr size_t M = BwdTile<D>::kDkdvStep;
  return sizeof(bf16) * (2 * (size_t)kTcRows * D + 4 * M * D) +
         sizeof(float) * 4 * M;
}

// q and do tiles and two stages of k and v tiles, all bf16
template <int D>
constexpr size_t dq_tc_smem_bytes() {
  constexpr size_t N = BwdTile<D>::kDqStep;
  return sizeof(bf16) * (2 * (size_t)kTcRows * D + 4 * N * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dkdv_kernel_tc(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int sq, int sk,
    int num_heads, int num_kv_heads, float sm_scale, int causal) {
  using namespace flash_tc;
  constexpr int BN = kTcRows;                  // kv rows owned
  constexpr int BM = BwdTile<D>::kDkdvStep;    // q rows per step
  constexpr int DO = D / BwdTile<D>::kSplit;   // output columns per CTA
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [BN][D], later dk
  T* v_s = k_s + BN * D;                    // [BN][D], later dv
  T* q_s = v_s + BN * D;                    // [2][BM][D]
  T* do_s = q_s + 2 * BM * D;               // [2][BM][D]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BM * D);  // [2][BM]
  float* dl_s = lse_s + 2 * BM;                                // [2][BM]

  const int k0 = blockIdx.x * BN;
  const int bh = blockIdx.y;
  const int c0 = blockIdx.z * DO;
  const int b = bh / num_heads;
  const int h = bh - b * num_heads;
  const int kvh = h / (num_heads / num_kv_heads);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kvr = k0 + (threadIdx.x >> 5) * 16 + g;  // and kvr + 8

  const size_t q_stride = (size_t)num_heads * D;
  const size_t kv_stride = (size_t)num_kv_heads * D;
  const T* qb = q + (size_t)b * sq * q_stride + (size_t)h * D;
  const T* dob = dout + (size_t)b * sq * q_stride + (size_t)h * D;
  const size_t kv0 = ((size_t)b * sk + k0) * kv_stride + (size_t)kvh * D;
  const float* lse_b = lse + (size_t)bh * sq;
  const float* delta_b = delta + (size_t)bh * sq;

  const int offset = sk - sq;  // bottom-right causal alignment
  // the first q tile with a row that sees column k0: r + offset >= k0
  const int qt0 = causal ? max(0, k0 - offset) / BM : 0;
  const int n_q = sq / BM;

  flash_tc::load_tile<BN, D, kTcThreads>(k_s, k + kv0, kv_stride);
  flash_tc::load_tile<BN, D, kTcThreads>(v_s, v + kv0, kv_stride);
  auto load_q_step = [&](int qt, int st) {
    const size_t r0 = (size_t)qt * BM;
    flash_tc::load_tile<BM, D, kTcThreads>(q_s + st * BM * D,
                                           qb + r0 * q_stride, q_stride);
    flash_tc::load_tile<BM, D, kTcThreads>(do_s + st * BM * D,
                                           dob + r0 * q_stride, q_stride);
    load_row_stats<BM>(lse_s + st * BM, lse_b + r0);
    load_row_stats<BM>(dl_s + st * BM, delta_b + r0);
    cp_async_commit();
  };
  load_q_step(qt0, 0);

  const float scale_log2 = sm_scale * kLog2e;
  float acc_k[DO / 2], acc_v[DO / 2];
  zero(acc_k);
  zero(acc_v);

  for (int qt = qt0; qt < n_q; ++qt) {
    const int st = (qt - qt0) & 1;
    if (qt + 1 < n_q) {
      load_q_step(qt + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_view_async_shared();  // this thread's copies, then everyone's
    __syncthreads();
    const T* qs = q_s + st * BM * D;
    const T* dos = do_s + st * BM * D;
    const float* ls = lse_s + st * BM;
    const float* dls = dl_s + st * BM;

    // S^T = K q^T and dP^T = V do^T: rows the 64 kv rows, columns the
    // BM q rows
    float s[BM / 2], dp[BM / 2];
    zero(s);
    zero(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<0>(s, desc_k<BN>(k_s, kk), desc_k<BM>(qs, kk), 1);
      wgmma_ss<0>(dp, desc_k<BN>(v_s, kk), desc_k<BM>(dos, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T into s and dS^T into dp; the tile needs the mask unless its
    // first row sees the kv tile's last column
    const int q0 = qt * BM;
    const bool masked = causal && q0 + offset < k0 + BN - 1;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1);
        const float p =
            (masked && kvr + (e >> 1) * 8 > q0 + qi + offset)
                ? 0.0f
                : exp2f(s[4 * j + e] * scale_log2 - ls[qi] * kLog2e);
        s[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - dls[qi]);
      }

    // dV += P^T do and dK += dS^T q over this CTA's output columns, the
    // A operands from registers, do and q MN-major
    uint32_t pa[BM / 16][4], sa[BM / 16][4];
    acc_to_a<T>(pa, s);
    acc_to_a<T>(sa, dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      wgmma_rs<1>(acc_v, pa[kk], desc_mn<BM>(dos, kk, c0), 1);
      wgmma_rs<1>(acc_k, sa[kk], desc_mn<BM>(qs, kk, c0), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
    fence_regs(pa);
    fence_regs(sa);
    __syncthreads();  // this stage is refilled by the next iteration
  }

  // dk/dv per q head, [b, sk, h, d], staged in k_s and v_s
  const size_t out0 = ((size_t)b * sk + k0) * q_stride + (size_t)h * D;
  store_rows<D, DO>(k_s, acc_k, sm_scale, sm_scale, dk + out0, q_stride, c0);
  store_rows<D, DO>(v_s, acc_v, 1.0f, 1.0f, dv + out0, q_stride, c0);
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dq_kernel_tc(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int sq, int sk, int num_heads, int num_kv_heads,
    float sm_scale, int causal) {
  using namespace flash_tc;
  constexpr int BM = kTcRows;               // q rows owned
  constexpr int BN = BwdTile<D>::kDqStep;   // kv rows per step
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [BM][D], later dq
  T* do_s = q_s + BM * D;                   // [BM][D]
  T* k_s = do_s + BM * D;                   // [2][BN][D]
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
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = lse[(size_t)bh * sq + row + 8 * i] * kLog2e;
    dlt[i] = delta[(size_t)bh * sq + row + 8 * i];
  }

  const int offset = sk - sq;
  int n_kv = sk / BN;
  int n_full = n_kv;  // kv tiles that need no mask
  if (causal) {
    // the tile's last row sees columns <= q0 + BM - 1 + offset
    n_kv = min(n_kv, (q0 + BM - 1 + offset) / BN + 1);
    // a kv tile is unmasked when its last column is visible to row q0
    n_full = min(n_kv, (q0 + offset + 1) / BN);
  }

  flash_tc::load_tile<BM, D, kTcThreads>(q_s, q + qrow0, q_stride);
  flash_tc::load_tile<BM, D, kTcThreads>(do_s, dout + qrow0, q_stride);
  flash_tc::load_tile<BN, D, kTcThreads>(k_s, kb, kv_stride);
  flash_tc::load_tile<BN, D, kTcThreads>(v_s, vb, kv_stride);
  cp_async_commit();

  const float scale_log2 = sm_scale * kLog2e;
  float acc[D / 2];
  zero(acc);

  for (int kt = 0; kt < n_kv; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kv) {
      const size_t next = (size_t)(kt + 1) * BN * kv_stride;
      flash_tc::load_tile<BN, D, kTcThreads>(k_s + (st ^ 1) * BN * D,
                                             kb + next, kv_stride);
      flash_tc::load_tile<BN, D, kTcThreads>(v_s + (st ^ 1) * BN * D,
                                             vb + next, kv_stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_view_async_shared();  // this thread's copies, then everyone's
    __syncthreads();
    const T* ks = k_s + st * BN * D;
    const T* vs = v_s + st * BN * D;

    // S = q K^T and dP = do V^T
    float s[BN / 2], dp[BN / 2];
    zero(s);
    zero(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<0>(s, desc_k<BM>(q_s, kk), desc_k<BN>(ks, kk), 1);
      wgmma_ss<0>(dp, desc_k<BM>(do_s, kk), desc_k<BN>(vs, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dS into dp
    const int k0 = kt * BN;
    const bool masked = causal && kt >= n_full;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p =
            (masked && k0 + 8 * j + 2 * t + (e & 1) > row + 8 * i + offset)
                ? 0.0f
                : exp2f(s[4 * j + e] * scale_log2 - lse2[i]);
        dp[4 * j + e] = p * (dp[4 * j + e] - dlt[i]);
      }

    // dQ += dS K, dS as bf16 A operands from registers, K MN-major
    uint32_t sa[BN / 16][4];
    acc_to_a<T>(sa, dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<1>(acc, sa[kk], desc_mn<BN>(ks, kk, 0), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(sa);
    __syncthreads();  // this stage is refilled by the next iteration
  }

  // q_s, which no wgmma reads any more, stages dq
  store_rows<D, D>(q_s, acc, sm_scale, sm_scale, dq + qrow0, q_stride, 0);
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

template <typename T, int D>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, void* dk,
              void* dv, int batch, int sq, int sk, int num_heads,
              int num_kv_heads, float sm_scale, int causal,
              cudaStream_t stream) {
  constexpr size_t smem_dkdv = dkdv_tc_smem_bytes<D>();
  constexpr size_t smem_dq = dq_tc_smem_bytes<D>();
  static_assert(smem_dkdv <= flash_tc::kMaxSmem &&
                    smem_dq <= flash_tc::kMaxSmem,
                "a pass's tiles exceed a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel_tc<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel_tc<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  const float* dt = static_cast<const float*>(delta);
  flash_bwd_dkdv_kernel_tc<T, D><<<dim3(sk / kTcRows, batch * num_heads,
                                     BwdTile<D>::kSplit),
                                kTcThreads, smem_dkdv, stream>>>(
      qt, kt, vt, dot, lt, dt, static_cast<T*>(dk), static_cast<T*>(dv),
      sq, sk, num_heads, num_kv_heads, sm_scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel_tc<T, D><<<dim3(sq / kTcRows, batch * num_heads),
                              kTcThreads, smem_dq, stream>>>(
      qt, kt, vt, dot, lt, dt, static_cast<T*>(dq), sq, sk, num_heads,
      num_kv_heads, sm_scale, causal);
  return (int)cudaGetLastError();
}

// the route of `dtype` at head dim D: 0 = float32, the scalar kernels;
// 1 = bfloat16 and 2 = float16, the tensor-core kernels
template <int D>
int dispatch_dtype(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, int batch, int sq, int sk,
                   int num_heads, int num_kv_heads, float sm_scale,
                   int causal, int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, dout, lse, delta, dq, dk, dv, batch, sq,
                            sk, num_heads, num_kv_heads, sm_scale, causal,
                            stream);
  if (dtype == 1)
    return launch_tc<bf16, D>(q, k, v, dout, lse, delta, dq, dk, dv, batch,
                              sq, sk, num_heads, num_kv_heads, sm_scale,
                              causal, stream);
  if (dtype == 2)
    return launch_tc<fp16, D>(q, k, v, dout, lse, delta, dq, dk, dv, batch,
                              sq, sk, num_heads, num_kv_heads, sm_scale,
                              causal, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v, do, dq, dk, dv alike; lse and
// delta fp32). dk/dv are per q head: [b, sk, num_heads, head_dim]. sq and
// sk must be multiples of 64. Returns cudaGetLastError() after the two
// launches (0 on success).
int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, void* dk,
              void* dv, int batch, int sq, int sk, int num_heads,
              int num_kv_heads, int head_dim, float sm_scale, int causal,
              int dtype, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return dispatch_dtype<64>(q, k, v, dout, lse, delta, dq, dk, dv, batch,
                                sq, sk, num_heads, num_kv_heads, sm_scale,
                                causal, dtype, s);
    case 128:
      return dispatch_dtype<128>(q, k, v, dout, lse, delta, dq, dk, dv, batch,
                                 sq, sk, num_heads, num_kv_heads, sm_scale,
                                 causal, dtype, s);
    case 256:
      return dispatch_dtype<256>(q, k, v, dout, lse, delta, dq, dk, dv, batch,
                                 sq, sk, num_heads, num_kv_heads, sm_scale,
                                 causal, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
