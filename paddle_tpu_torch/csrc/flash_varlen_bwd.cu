// Packed varlen flash-attention backward on Hopper (sm_90a): dq, dk and dv
// of o = block-diagonal softmax(q k^T * sm_scale) v from the saved q, k,
// v, o, lse and the cotangent do, with delta = rowsum(do * o) in fp32
// (computed by the caller for the fp32 route, by the dq pass for bf16).
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
//   - dk/dv pass: one block per (kv tile, head). It keeps its K and V tile
//     in shared memory and fp32 dk/dv accumulators in registers, and loops
//     over its q tiles [q_lo, q_hi): the q tokens of the tile's first
//     through last segment, from its first column on when causal, so no q
//     tile outside the tile's segments is loaded;
//   - dq pass: one block per (q tile, head). It keeps q and do in shared
//     memory and loops over K4's kv tiles [kv_lo, kv_hi), recomputing p
//     and ds.
// Both ranges come from ops/cuda_kernels.py varlen_plan at the route's
// tile size, which the C entry checks. Rows and columns past tq / tk are
// bound-checked (loaded as zeros, masked, never stored). The price of no
// atomics: the dq pass recomputes s and dp, so 14 * d flops are executed
// per visible pair against the 10 * d the gradients need.
//
// What bounds it on the H100: 10 * d flops per visible pair against the
// bytes of q, k, v, o, do, dq, dk, dv, lse and delta; at the main path's
// shape (16,384 packed tokens, h 12, d 64, causal bf16, ~11.4 M visible
// pairs per head) that is ~8.8e10 flops against ~50 MB: operations bound
// it (~89 us at 989 TFLOP/s).
//
// Three routes behind the one C entry, chosen by dtype (nothing is caught,
// and none is a fallback for another):
//
// bf16: flash_varlen_bwd_dkdv_kernel_tc and flash_varlen_bwd_dq_kernel_tc,
// tensor cores; the packed-attention path runs them. K3's design
// (flash_bwd.cu, *_tc) over the plan's ranges, one warpgroup (128
// threads) a CTA, 64 rows of the CTA's own tile, at every d (the plan is
// at 64 tokens on both sides, the forward's own plan):
//   - both passes start their tiles longest range first: blockIdx.y walks
//     an order of the kv tiles by descending q_hi - q_lo (dk/dv) or of the
//     q tiles by descending kv_hi - kv_lo (dq), which the C entry computes
//     right before (varlen_order.cuh); blockIdx.x is the head (and at
//     d = 256 the half of dk/dv's columns), so the heaviest tiles of every
//     head start in the first wave;
//   - dk/dv pass: a CTA per (64-row kv tile, head); K and V stay resident
//     as swizzled bf16; the q, do, lse, delta and seg_q rows of [64 q_lo,
//     min(64 q_hi, tq)) stream through a 2-stage cp.async ring (the
//     bounded loads of flash_tc.cuh zero-fill rows past tq; lse and delta
//     load as 4-byte words, so no row of [h, tq] needs 16-byte alignment).
//     Per step: S^T = K q^T and dP^T = V do^T on wgmma, then P^T and
//     dS^T on the accumulators, rounded to bf16 in registers as the A
//     operands of dV += P^T do and dK += dS^T q (do and q MN-major). Steps
//     are 64 q rows at d = 64 and 32 at d = 128 and 256 (two steps per
//     plan tile); at d = 256 two CTAs share each kv tile, each with one
//     half of the output columns, as in K3.
//   - dq pass, launched first: a CTA per (64-row q tile, head); q and do
//     resident; k, v and seg_k rows of [64 kv_lo, min(64 kv_hi, tk))
//     through the ring, 64 rows a step (32 at d = 256); S = q K^T,
//     dP = do V^T, dQ += dS K with K MN-major. While the first copies fly,
//     each warp computes delta = rowsum(do * o) of its 16 rows in fp32
//     from device memory and writes it, so the dk/dv pass that follows on
//     the stream reads it: the wrapper's five torch launches for delta
//     (casts, product, sum, transpose) took ~0.19 ms of device time on the
//     H100 at the packed shape, more than K4, and this takes ~0.02 ms;
//   - the mask: a step is interior when the CTA's rows and the step's rows
//     all lie in one segment, inside tq and tk, and (causal) wholly below
//     the diagonal; only the other steps compare segment ids and i >= j,
//     and set p = 0 where a pair is not visible.
//   - the guard in exp2 form: p = exp2(min(s * sm_scale * log2e - lse *
//     log2e, 0)).
// Precision: q, k, v, do enter the products as given (bf16); sm_scale *
// log2e multiplies the fp32 scores and sm_scale the fp32 dq and dk at the
// store (the JAX kernel rounds the scaled q to bf16 instead, :787-788); p
// is rounded to bf16 before P^T do (:810) and ds before dS^T q and dS K
// (:817), as the JAX kernel rounds them; ds itself is computed from the
// fp32 p; lse, delta and every accumulator stay fp32. Shared memory
// (varlen_dkdv_tc_smem_bytes, varlen_dq_tc_smem_bytes; a static_assert
// holds each to 232,448 bytes): dk/dv 50,688 / 66,304 / 131,840 bytes and
// dq 49,664 / 98,816 / 131,328 bytes at d = 64 / 128 / 256.
// chip_smoke.py's environment phase prints each instantiation's registers
// and spills. The dk/dv pass at d = 64 holds 202 registers, so two CTAs
// fit a SM (K3's holds 168, three); capping it at 170 spilled 54 bytes,
// and 32-row steps at d = 64 measured no faster on the H100.
//
// fp16 (dtype 2): flash_varlen_bwd_dkdv_kernel_tc<fp16> and
// flash_varlen_bwd_dq_kernel_tc<fp16>, the same kernels instantiated for
// __half (flash_tc.cuh picks the .f16 wgmma from the operands' type). Eager
// AMP O2 in float16 with a loss scaler runs this route. The only differences
// from bf16 are the instruction and the rounding of p, dS, dq, dk and dv to
// fp16, to nearest even and never clamped: a value past 65504 becomes inf,
// as the JAX kernel's .astype(float16) makes it, so the loss scaler sees the
// overflow. fp16 keeps 3 more mantissa bits than bf16 and 3 fewer exponent
// bits.
//
// fp32: flash_varlen_bwd_dkdv_kernel and flash_varlen_bwd_dq_kernel, the
// scalar kernels of the first port, unchanged; they carry the exactness
// checks (5e-5 against the fp32 plain version). Tiles are 64 x 64 for
// d = 64 and 128, and 32 x 32 for d = 256 (so the plan of that route is
// at 32 tokens there), so that each pass's fp32 tiles fit a block's 227 KB
// (232,448 bytes) of shared memory. The dk/dv pass holds four operand
// tiles, two score tiles, two row statistics and the segment ids of its
// rows and columns: 100,864 bytes at d = 64, 166,400 at d = 128 and
// 140,544 at d = 256. The dq pass holds four operand tiles, one score tile
// and the segment ids: 83,712, 149,248 and 136,064 bytes (dkdv_smem_bytes
// and dq_smem_bytes below; a static_assert holds both to the limit). Each
// row of the block's own tile is owned by 256 / rows threads of one warp,
// which meet in shared memory behind a __syncwarp; padded row strides
// keep the shared reads free of bank conflicts. They are bound by their
// own scalar FMAs and shared-memory reads.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_tc.cuh"
#include "varlen_order.cuh"

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

// -- bf16 and fp16 routes: tensor cores -------------------------------------

using bf16 = __nv_bfloat16;
using fp16 = __half;
constexpr int kTcThreads = 128;  // one warpgroup
constexpr int kTcRows = 64;      // rows of a CTA's own tile: one plan tile

template <int D>
struct BwdTile {
  static constexpr int kDkdvStep = D == 64 ? 64 : 32;  // q rows per step
  static constexpr int kSplit = D == 256 ? 2 : 1;      // dk/dv column CTAs
  static constexpr int kDqStep = D == 256 ? 32 : 64;   // kv rows per step
};

// k and v tiles, two stages of q and do tiles (bf16), of lse and delta
// rows (fp32) and of seg_q ids (int32)
template <int D>
constexpr size_t varlen_dkdv_tc_smem_bytes() {
  constexpr size_t M = BwdTile<D>::kDkdvStep;
  return sizeof(bf16) * (2 * (size_t)kTcRows * D + 4 * M * D) +
         sizeof(float) * 4 * M + sizeof(int) * 2 * M;
}

// q and do tiles, two stages of k and v tiles (bf16) and of seg_k ids
template <int D>
constexpr size_t varlen_dq_tc_smem_bytes() {
  constexpr size_t N = BwdTile<D>::kDqStep;
  return sizeof(bf16) * (2 * (size_t)kTcRows * D + 4 * N * D) +
         sizeof(int) * 2 * N;
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads) flash_varlen_bwd_dkdv_kernel_tc(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k,
    const int* __restrict__ q_lo, const int* __restrict__ q_hi,
    const int* __restrict__ kv_order, T* __restrict__ dk,
    T* __restrict__ dv, int tq, int tk, int num_heads, float sm_scale,
    int causal) {
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
  int* segq_s = reinterpret_cast<int*>(dl_s + 2 * BM);         // [2][BM]

  constexpr int kSplit = BwdTile<D>::kSplit;
  const int kt = kv_order[blockIdx.y];  // longest q range first
  const int k0 = kt * BN;
  const int h = blockIdx.x / kSplit;
  const int c0 = (blockIdx.x % kSplit) * DO;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kvr = k0 + (threadIdx.x >> 5) * 16 + g;  // and kvr + 8

  const size_t stride = (size_t)num_heads * D;
  const T* qb = q + (size_t)h * D;
  const T* dob = dout + (size_t)h * D;
  const size_t kv0 = (size_t)k0 * stride + (size_t)h * D;
  const float* lse_h = lse + (size_t)h * tq;
  const float* delta_h = delta + (size_t)h * tq;

  // each thread's two kv rows' segments; rows past tk take -2, which no
  // q row's segment equals
  int segr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    segr[i] = kvr + 8 * i < tk ? seg_k[kvr + 8 * i] : -2;
  const int k_seg = seg_k[k0];
  const bool k_one_seg = k0 + BN <= tk && seg_k[k0 + BN - 1] == k_seg;

  // the plan's q tiles as rows, clipped to tq
  const int r_lo = q_lo[kt] * kTcRows;
  const int r_hi = min(q_hi[kt] * kTcRows, tq);
  const int n_q = r_hi > r_lo ? (r_hi - r_lo + BM - 1) / BM : 0;

  load_tile_rows<BN, D, kTcThreads>(k_s, k + kv0, stride, tk - k0);
  load_tile_rows<BN, D, kTcThreads>(v_s, v + kv0, stride, tk - k0);
  auto load_q_step = [&](int j, int st) {
    const int r0 = r_lo + j * BM;
    const size_t off = (size_t)r0 * stride;
    load_tile_rows<BM, D, kTcThreads>(q_s + st * BM * D, qb + off, stride,
                                      tq - r0);
    load_tile_rows<BM, D, kTcThreads>(do_s + st * BM * D, dob + off, stride,
                                      tq - r0);
    load_words<BM>(lse_s + st * BM, lse_h + r0, tq - r0);
    load_words<BM>(dl_s + st * BM, delta_h + r0, tq - r0);
    load_words<BM>(segq_s + st * BM, seg_q + r0, tq - r0);
  };
  if (n_q > 0) load_q_step(0, 0);
  cp_async_commit();

  const float scale_log2 = sm_scale * kLog2e;
  float acc_k[DO / 2], acc_v[DO / 2];
  zero(acc_k);
  zero(acc_v);

  for (int j = 0; j < n_q; ++j) {
    const int st = j & 1;
    if (j + 1 < n_q) {
      load_q_step(j + 1, st ^ 1);
      cp_async_commit();
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
    const int* segc = segq_s + st * BM;

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

    // P^T into s and dS^T into dp, under the guard; only a step that is
    // not interior compares segments and positions
    const int q0 = r_lo + j * BM;
    const bool interior = k_one_seg && q0 + BM <= tq && segc[0] == k_seg &&
                          segc[BM - 1] == k_seg &&
                          (!causal || q0 >= k0 + BN - 1);
#pragma unroll
    for (int jj = 0; jj < BM / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * jj + 2 * t + (e & 1);
        float p = exp2f(
            fminf(s[4 * jj + e] * scale_log2 - ls[qi] * kLog2e, 0.0f));
        if (!interior) {
          const bool seen = q0 + qi < tq && segc[qi] == segr[e >> 1] &&
                            (!causal || q0 + qi >= kvr + (e >> 1) * 8);
          p = seen ? p : 0.0f;
        }
        s[4 * jj + e] = p;
        dp[4 * jj + e] = p * (dp[4 * jj + e] - dls[qi]);
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
  cp_async_wait<0>();  // with an empty range, the k and v copies
  __syncthreads();

  // dk/dv staged in k_s and v_s; rows past tk are not stored
  store_rows_upto<D, DO>(k_s, acc_k, sm_scale, sm_scale, dk + kv0, stride,
                         c0, tk - k0);
  store_rows_upto<D, DO>(v_s, acc_v, 1.0f, 1.0f, dv + kv0, stride, c0,
                         tk - k0);
}

// delta = rowsum(do * o) in fp32 of the warp's 16 rows from r0 (rows at or
// past tq give 0): into delta[r] and, for this lane's rows g and g + 8,
// into dlt. A row's D bf16 are D / 8 chunks of 16 bytes, one a lane, so
// one load instruction covers 256 / D rows and all of the warp's loads
// are in flight at once; bf16 and fp16 products are exact in fp32, the sum
// is fp32.
template <typename T, int D>
__device__ __forceinline__ void row_delta(const T* dout, const T* o,
                                          size_t stride, int r0, int tq,
                                          float* delta, float (&dlt)[2]) {
  constexpr int kLanesPerRow = D / 8;
  constexpr int kRowsPerLoad = 32 / kLanesPerRow;  // 4, 2, 1
  constexpr int kLoads = 16 / kRowsPerLoad;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int sub = lane / kLanesPerRow;  // row within a load
  const int c = (lane % kLanesPerRow) * 8;
  float res[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int r = r0 + i * kRowsPerLoad + sub;
    float part = 0.0f;
    if (r < tq) {
      const uint4 x = *reinterpret_cast<const uint4*>(
          dout + (size_t)r * stride + c);
      const uint4 y = *reinterpret_cast<const uint4*>(
          o + (size_t)r * stride + c);
      const uint32_t* xs = reinterpret_cast<const uint32_t*>(&x);
      const uint32_t* ys = reinterpret_cast<const uint32_t*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = flash_tc::unpack2<T>(xs[e]);
        const float2 b = flash_tc::unpack2<T>(ys[e]);
        part += a.x * b.x + a.y * b.y;
      }
    }
    // the row's sum in each of its kLanesPerRow (aligned) lanes
#pragma unroll
    for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    res[i] = part;
    if (lane % kLanesPerRow == 0 && r < tq) delta[r] = part;
  }
  // rows g and g + 8 come from load g / kRowsPerLoad (and 8 / kRowsPerLoad
  // loads later) at the same sub-row, g % kRowsPerLoad
  const int src = (g % kRowsPerLoad) * kLanesPerRow;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const float val = __shfl_sync(0xffffffffu, res[i], src);
    if (i == g / kRowsPerLoad) dlt[0] = val;
    if (i == (g + 8) / kRowsPerLoad) dlt[1] = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads) flash_varlen_bwd_dq_kernel_tc(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const T* __restrict__ o, const float* __restrict__ lse,
    float* __restrict__ delta, const int* __restrict__ seg_q,
    const int* __restrict__ seg_k,
    const int* __restrict__ kv_lo, const int* __restrict__ kv_hi,
    const int* __restrict__ q_order, T* __restrict__ dq, int tq, int tk,
    int num_heads, float sm_scale, int causal) {
  using namespace flash_tc;
  constexpr int BM = kTcRows;               // q rows owned
  constexpr int BN = BwdTile<D>::kDqStep;   // kv rows per step
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [BM][D], later dq
  T* do_s = q_s + BM * D;                   // [BM][D]
  T* k_s = do_s + BM * D;                   // [2][BN][D]
  T* v_s = k_s + 2 * BN * D;                // [2][BN][D]
  int* segk_s = reinterpret_cast<int*>(v_s + 2 * BN * D);  // [2][BN]

  const int qt = q_order[blockIdx.y];  // longest kv range first
  const int q0 = qt * BM;
  const int h = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = q0 + (threadIdx.x >> 5) * 16 + g;  // and row + 8

  const size_t stride = (size_t)num_heads * D;
  const size_t qrow0 = (size_t)q0 * stride + (size_t)h * D;
  const T* kb = k + (size_t)h * D;
  const T* vb = v + (size_t)h * D;
  // each thread's two rows: lse (log2 units) and segment; rows past tq
  // take segment -1, which no column's segment equals
  float lse2[2];
  int segr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    const bool in = r < tq;
    lse2[i] = in ? lse[(size_t)h * tq + r] * kLog2e : 0.0f;
    segr[i] = in ? seg_q[r] : -1;
  }
  const int q_seg = seg_q[q0];
  const bool q_one_seg = q0 + BM <= tq && seg_q[q0 + BM - 1] == q_seg;

  // the plan's kv tiles as rows, clipped to tk
  const int c_lo = kv_lo[qt] * kTcRows;
  const int c_hi = min(kv_hi[qt] * kTcRows, tk);
  const int n_kv = c_hi > c_lo ? (c_hi - c_lo + BN - 1) / BN : 0;

  load_tile_rows<BM, D, kTcThreads>(q_s, q + qrow0, stride, tq - q0);
  load_tile_rows<BM, D, kTcThreads>(do_s, dout + qrow0, stride, tq - q0);
  auto load_kv = [&](int j, int st) {
    const int r0 = c_lo + j * BN;
    const size_t off = (size_t)r0 * stride;
    load_tile_rows<BN, D, kTcThreads>(k_s + st * BN * D, kb + off, stride,
                                      tk - r0);
    load_tile_rows<BN, D, kTcThreads>(v_s + st * BN * D, vb + off, stride,
                                      tk - r0);
    load_words<BN>(segk_s + st * BN, seg_k + r0, tk - r0);
  };
  if (n_kv > 0) load_kv(0, 0);
  cp_async_commit();

  // this CTA's rows of delta, while the copies fly; the dk/dv pass reads
  // them after this kernel
  float dlt[2];
  row_delta<T, D>(dout + (size_t)h * D, o + (size_t)h * D, stride, row - g, tq,
               delta + (size_t)h * tq, dlt);

  const float scale_log2 = sm_scale * kLog2e;
  float acc[D / 2];
  zero(acc);

  for (int j = 0; j < n_kv; ++j) {
    const int st = j & 1;
    if (j + 1 < n_kv) {
      load_kv(j + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_view_async_shared();  // this thread's copies, then everyone's
    __syncthreads();
    const T* ks = k_s + st * BN * D;
    const T* vs = v_s + st * BN * D;
    const int* segc = segk_s + st * BN;

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

    // dS into dp, under the guard; only a step that is not interior
    // compares segments and positions
    const int k0 = c_lo + j * BN;
    const bool interior = q_one_seg && k0 + BN <= tk && segc[0] == q_seg &&
                          segc[BN - 1] == q_seg &&
                          (!causal || q0 >= k0 + BN - 1);
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int cc = 8 * jj + 2 * t + (e & 1);
        float p = exp2f(fminf(s[4 * jj + e] * scale_log2 - lse2[i], 0.0f));
        if (!interior) {
          const bool seen = k0 + cc < tk && segc[cc] == segr[i] &&
                            (!causal || k0 + cc <= row + 8 * i);
          p = seen ? p : 0.0f;
        }
        dp[4 * jj + e] = p * (dp[4 * jj + e] - dlt[i]);
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
  cp_async_wait<0>();  // with an empty range, the q and do copies
  __syncthreads();

  // q_s, which no wgmma reads any more, stages dq; rows past tq are not
  // stored
  store_rows_upto<D, D>(q_s, acc, sm_scale, sm_scale, dq + qrow0, stride, 0,
                        tq - q0);
}

struct Args {
  const void *q, *k, *v, *dout, *o, *lse, *seg_q, *seg_k, *kv_lo, *kv_hi,
      *q_lo, *q_hi;
  void *delta, *order, *dq, *dk, *dv;
  int tq, tk, num_heads;
  float sm_scale;
  int causal;
};

template <int D>
int launch(const Args& a, int block, cudaStream_t stream) {
  using T = float;
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

template <typename T, int D>
int launch_tc(const Args& a, int block, cudaStream_t stream) {
  constexpr size_t smem_dkdv = varlen_dkdv_tc_smem_bytes<D>();
  constexpr size_t smem_dq = varlen_dq_tc_smem_bytes<D>();
  static_assert(smem_dkdv <= flash_tc::kMaxSmem &&
                    smem_dq <= flash_tc::kMaxSmem,
                "a pass's tiles exceed a block's shared memory");
  if (block != kTcRows) return (int)cudaErrorInvalidValue;
  if ((a.tq + kTcRows - 1) / kTcRows > 65535 ||
      (a.tk + kTcRows - 1) / kTcRows > 65535)
    return (int)cudaErrorInvalidValue;  // tiles walk gridDim.y
  cudaError_t err = cudaFuncSetAttribute(
      flash_varlen_bwd_dkdv_kernel_tc<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_varlen_bwd_dq_kernel_tc<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  float* delta = static_cast<float*>(a.delta);
  const int* seg_q = static_cast<const int*>(a.seg_q);
  const int* seg_k = static_cast<const int*>(a.seg_k);
  const int n_k = (a.tk + kTcRows - 1) / kTcRows;
  const int n_q = (a.tq + kTcRows - 1) / kTcRows;
  int* kv_order = static_cast<int*>(a.order);  // [n_k], then q_order [n_q]
  int* q_order = kv_order + n_k;
  // the dq pass first: it writes the delta rows the dk/dv pass reads
  if (a.tq > 0) {
    err = varlen_order::longest_first(static_cast<const int*>(a.kv_lo),
                                      static_cast<const int*>(a.kv_hi), n_q,
                                      q_order, stream);
    if (err != cudaSuccess) return (int)err;
    flash_varlen_bwd_dq_kernel_tc<T, D>
        <<<dim3(a.num_heads, n_q), kTcThreads, smem_dq, stream>>>(
            q, k, v, dout, static_cast<const T*>(a.o), lse, delta, seg_q,
            seg_k, static_cast<const int*>(a.kv_lo),
            static_cast<const int*>(a.kv_hi), q_order,
            static_cast<T*>(a.dq), a.tq, a.tk, a.num_heads, a.sm_scale,
            a.causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (a.tk > 0) {
    err = varlen_order::longest_first(static_cast<const int*>(a.q_lo),
                                      static_cast<const int*>(a.q_hi), n_k,
                                      kv_order, stream);
    if (err != cudaSuccess) return (int)err;
    flash_varlen_bwd_dkdv_kernel_tc<T, D>
        <<<dim3(a.num_heads * BwdTile<D>::kSplit, n_k),
           kTcThreads, smem_dkdv, stream>>>(
            q, k, v, dout, lse, delta, seg_q, seg_k,
            static_cast<const int*>(a.q_lo), static_cast<const int*>(a.q_hi),
            kv_order, static_cast<T*>(a.dk),
            static_cast<T*>(a.dv), a.tq, a.tk, a.num_heads, a.sm_scale,
            a.causal);
  }
  return (int)cudaGetLastError();
}

// the route of `dtype` at head dim D: 0 = float32, the scalar kernels;
// 1 = bfloat16 and 2 = float16, the tensor-core kernels
template <int D>
int dispatch_dtype(const Args& a, int block, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch<D>(a, block, stream);
  if (dtype == 1) return launch_tc<bf16, D>(a, block, stream);
  if (dtype == 2) return launch_tc<fp16, D>(a, block, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v, do, o, dq, dk, dv alike; lse
// and delta fp32 [h, tq]). delta = rowsum(do * o): the float32 route reads
// it (the caller computes it); the bfloat16 route's dq pass writes it from
// do and o and its dk/dv pass reads it, so there the caller only
// allocates it. seg_q [tq] and seg_k [tk] int32; kv_lo / kv_hi per
// q tile and q_lo / q_hi per kv tile, int32, in tiles of `block` tokens,
// which must be the route's tile: 64 for bfloat16; 64 for float32, or 32
// at head_dim 256. order [kv tiles + q tiles] int32 is scratch, where the
// bf16 route writes the orders in which it starts the kv tiles of the
// dk/dv pass and the q tiles of the dq pass (at most 65,535 a side; the
// fp32 route takes them in index order). Returns cudaGetLastError() after
// the launches (0 on success).
int flash_varlen_bwd(const void* q, const void* k, const void* v,
                     const void* dout, const void* o, const void* lse,
                     void* delta, const void* seg_q, const void* seg_k,
                     const void* kv_lo, const void* kv_hi, const void* q_lo,
                     const void* q_hi, void* order, void* dq, void* dk,
                     void* dv, int tq, int tk, int num_heads, int head_dim,
                     int block, float sm_scale, int causal, int dtype,
                     void* stream) {
  if (num_heads <= 0) return 0;
  const Args a{q,     k,     v,    dout, o,     lse,   seg_q, seg_k,
               kv_lo, kv_hi, q_lo, q_hi, delta, order, dq,    dk,
               dv,    tq,    tk,   num_heads,   sm_scale,     causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return dispatch_dtype<64>(a, block, dtype, s);
    case 128:
      return dispatch_dtype<128>(a, block, dtype, s);
    case 256:
      return dispatch_dtype<256>(a, block, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
