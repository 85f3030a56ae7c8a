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
//   - per 64-row q tile, the 64-token kv tiles [kv_lo, kv_hi) that can
//     hold a visible column, computed outside the kernel
//     (ops/cuda_kernels.py varlen_plan, the counterpart of _vl_ranges);
//     tiles outside it are never loaded;
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
// [T, h*d] operand, the static per-head loop, the ones-column row sum and
// the x64-off scope.
//
// What bounds it on the H100: at the main path's shape (16,384 packed
// tokens, h 12, d 64, causal bf16, ~11.4 M visible pairs per head) the
// work is 4 * d flops per visible pair, ~3.5e10 flops, against ~25 MB of
// operands: operations bound it (~35 us at 989 TFLOP/s).
//
// Three routes behind the one C entry, chosen by dtype (nothing is caught,
// and none is a fallback for another):
//
// bf16: flash_varlen_fwd_kernel_tc, tensor cores; the packed-attention
// path runs it. K2's design (flash_fwd.cu, flash_fwd_kernel_tc) over the
// plan's ranges:
//   - one CTA of one warpgroup (128 threads) per (64-row q tile, head),
//     longest kv range first: blockIdx.y walks an order of the q tiles by
//     descending kv_hi - kv_lo, which the C entry computes right before
//     (varlen_order.cuh), and blockIdx.x is the head, so the heaviest
//     tiles of every head start in the first wave (K2 reverses blockIdx.x
//     for the same end; here the tile at a long document's end walks ~31
//     kv tiles, the one at its start one);
//   - the q tile stays resident in shared memory as bf16, and the kv rows
//     [64 kv_lo, min(64 kv_hi, tk)) stream through a 2-stage ring of k, v
//     and seg_k tiles filled by cp.async (flash_tc.cuh: 128-byte-swizzled
//     tiles; the bounded loads zero-fill rows past tq / tk);
//   - kv steps of 64 rows at d = 64 and 128, so a step is one plan tile
//     (K2 steps 128 at d = 64; here the plan stays at 64 tokens on both
//     sides, one plan for K4 and K5, each step's mask test is one plan
//     tile's, and 128-row steps measured slower on the H100: 0.176 against
//     0.146 ms at the packed shape), and 32 rows at d = 256, two steps per
//     plan tile, for the registers (K2's choice);
//   - S = q k^T is a wgmma with both operands in shared memory; the online
//     softmax runs on its fp32 accumulator, with the running max starting
//     at -1e30 and the rescale exp2(min(m - m', 0)) (at the -1e30 scale
//     the fused multiply-subtract leaves a residue of ~1e22 that exp2
//     would turn into inf); p = exp2(s * sm_scale * log2(e) - m') is
//     rounded to bf16 in registers as the A operand of P v, v read
//     through a transposed (MN-major) descriptor;
//   - the mask: a step is interior when its 64 q rows and its kv rows lie
//     in one segment, inside tq and tk, and (causal) wholly below the
//     diagonal; only the other steps compare segment ids (seg_k from the
//     ring, each thread's two row ids in registers) and i >= j;
//   - o leaves through shared memory as 16-byte stores, rows past tq
//     skipped.
// Precision: q, k, v enter the products as given (bf16) and sm_scale *
// log2e multiplies the fp32 scores. The JAX kernel instead rounds the
// scaled q to bf16 (:727-728); at d = 64 and 256 the scale is a power of
// two times log2e, so the two differ by that one rounding of q. p is
// rounded to bf16 before P v as the JAX kernel rounds it (:749); the
// running max, the row sums (of the fp32 p), lse and the accumulator stay
// fp32. Shared memory (varlen_fwd_tc_smem_bytes; a static_assert holds it
// to a block's 232,448 bytes): the q tile, two stages of k and v tiles
// and of the step's seg_k ids: 41,472 bytes at d = 64, 82,432 at d = 128
// and 98,560 at d = 256. chip_smoke.py's environment phase prints each
// instantiation's registers and spills.
//
// fp16 (dtype 2): flash_varlen_fwd_kernel_tc<fp16>, the same kernels
// instantiated for __half (flash_tc.cuh picks the .f16 wgmma from the
// operands' type). Eager AMP O2 in float16 with a loss scaler runs this
// route. The only differences from bf16 are the instruction and the rounding
// of p and o to fp16, to nearest even and never clamped: a value past 65504
// becomes inf, as the JAX kernel's .astype(float16) makes it, so the loss
// scaler sees the overflow. fp16 keeps 3 more mantissa bits than bf16 and 3
// fewer exponent bits.
//
// fp32: flash_varlen_fwd_kernel, the first port's scalar kernel,
// unchanged; it carries the exactness checks (2e-5 against the fp32 plain
// version), which TF32 tensor cores, at about three decimal digits, would
// break. One block of 256 threads per (64-row q tile, head) keeps the q
// tile in shared memory for its whole kv range; four threads share a q
// row, each scoring 16 of a kv tile's 64 columns and owning a quarter of
// the output dims, so the row statistics need two shuffles. Padded row
// strides (D + 1, 64 + 1) keep the shared-memory reads free of bank
// conflicts. The segment ids of the tile's rows and columns sit in shared
// memory beside the operands. Shared memory: 66,816 bytes at d = 64,
// 115,968 at d = 128 and 214,272 at d = 256, held to a block's 232,448 by
// a static_assert. It is bound by its own scalar FMAs and shared-memory
// reads.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_tc.cuh"
#include "varlen_order.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // four threads per q row
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // bytes one H100 block can opt into

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

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

// -- bf16 and fp16 routes: tensor cores -------------------------------------

using bf16 = __nv_bfloat16;
using fp16 = __half;
constexpr int kTcThreads = 128;  // one warpgroup
constexpr int kTcBlockM = 64;    // q rows per CTA: one plan tile, 16 a warp
constexpr int kPlanBlock = 64;   // tokens per tile of the plan's ranges

// kv rows per step: the score accumulator (64 x kBlockN) and the output
// accumulator (64 x D) share a thread's registers
template <int D>
struct FwdTile {
  static constexpr int kBlockN = D == 256 ? 32 : 64;
};

// the q tile and two stages of k and v tiles (bf16) and of seg_k ids
template <int D>
constexpr size_t varlen_fwd_tc_smem_bytes() {
  constexpr size_t N = FwdTile<D>::kBlockN;
  return sizeof(bf16) * ((size_t)kTcBlockM * D + 4 * N * D) +
         sizeof(int) * 2 * N;
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads) flash_varlen_fwd_kernel_tc(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ seg_q,
    const int* __restrict__ seg_k, const int* __restrict__ kv_lo,
    const int* __restrict__ kv_hi, const int* __restrict__ q_order,
    T* __restrict__ o, float* __restrict__ lse, int tq, int tk,
    int num_heads, float sm_scale, int causal) {
  using namespace flash_tc;
  constexpr int BM = kTcBlockM;
  constexpr int BN = FwdTile<D>::kBlockN;
  constexpr int NS = BN / 2;  // score accumulators a thread holds
  constexpr int NO = D / 2;   // output accumulators a thread holds
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);  // [BM][D], later o
  T* k_s = q_s + BM * D;                    // [2][BN][D]
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

  // each thread's two rows' segments; rows past tq take -1, which no
  // column's segment equals
  int segr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    segr[i] = row + 8 * i < tq ? seg_q[row + 8 * i] : -1;
  const int q_seg = seg_q[q0];
  const bool q_one_seg = q0 + BM <= tq && seg_q[q0 + BM - 1] == q_seg;

  // the plan's kv tiles as rows, clipped to tk
  const int c_lo = kv_lo[qt] * kPlanBlock;
  const int c_hi = min(kv_hi[qt] * kPlanBlock, tk);
  const int n_kv = c_hi > c_lo ? (c_hi - c_lo + BN - 1) / BN : 0;

  auto load_kv = [&](int j, int st) {
    const int r0 = c_lo + j * BN;
    const size_t off = (size_t)r0 * stride;
    load_tile_rows<BN, D, kTcThreads>(k_s + st * BN * D, kb + off, stride,
                                      tk - r0);
    load_tile_rows<BN, D, kTcThreads>(v_s + st * BN * D, vb + off, stride,
                                      tk - r0);
    load_words<BN>(segk_s + st * BN, seg_k + r0, tk - r0);
  };
  load_tile_rows<BM, D, kTcThreads>(q_s, q + qrow0, stride, tq - q0);
  if (n_kv > 0) load_kv(0, 0);
  cp_async_commit();

  const float scale_log2 = sm_scale * kLog2e;
  float acc[NO];
  zero(acc);
  // running max (raw scores) of rows g and g + 8, from the finite -1e30
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};  // this lane's share of the row sum

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

    // masked scores become -inf: they never raise the (finite) running
    // max, and exp2(-inf - m) = 0 takes them out of the sums
    const int k0 = c_lo + j * BN;
    const bool interior = q_one_seg && k0 + BN <= tk && segc[0] == q_seg &&
                          segc[BN - 1] == q_seg &&
                          (!causal || q0 >= k0 + BN - 1);
    if (!interior) {
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = 8 * jj + 2 * t + (e & 1);
          const int r = row + (e >> 1) * 8;
          const bool seen = k0 + cc < tk && segc[cc] == segr[e >> 1] &&
                            (!causal || k0 + cc <= r);
          if (!seen) s[4 * jj + e] = -INFINITY;
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj)
        mx = fmaxf(mx, fmaxf(s[4 * jj + 2 * i], s[4 * jj + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float ms = mx * scale_log2;
      // m <= mx, so the exponent is <= 0; the min drops the residue that
      // the fused m * scale_log2 - ms leaves while both sit at the -1e30
      // start (~1e22 at that scale: exp2 would give inf, and inf * 0 NaN)
      const float alpha = exp2f(fminf(m[i] * scale_log2 - ms, 0.0f));
      m[i] = mx;
      float rs = 0.0f;
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[4 * jj + e] = exp2f(s[4 * jj + e] * scale_log2 - ms);
          rs += s[4 * jj + e];
        }
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        acc[4 * jj + 2 * i] *= alpha;
        acc[4 * jj + 2 * i + 1] *= alpha;
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
  cp_async_wait<0>();  // with an empty range, the q tile's copies
  __syncthreads();

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float lc = fmaxf(l[i], 1e-30f);
    inv[i] = 1.0f / lc;
    // a row that saw no key keeps m = -1e30 and l = 0: o = +0 (acc is +0
    // times 1e30) and lse = -1e30, as the scalar route writes them
    const int r = row + 8 * i;
    if (t == 0 && r < tq)
      lse[(size_t)h * tq + r] =
          m[i] == kNegInf ? kNegInf : m[i] * sm_scale + logf(lc);
  }
  // q_s, which no wgmma reads any more, stages o
  store_rows_upto<D, D>(q_s, acc, inv[0], inv[1], o + qrow0, stride, 0,
                        tq - q0);
}

struct Args {
  const void *q, *k, *v, *seg_q, *seg_k, *kv_lo, *kv_hi;
  void *order, *o, *lse;
  int tq, tk, num_heads;
  float sm_scale;
  int causal;
};

template <int D>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static_assert(smem <= kMaxSmem, "the tiles exceed a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_varlen_fwd_kernel<float, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.tq + kBlockQ - 1) / kBlockQ, a.num_heads);
  flash_varlen_fwd_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const int*>(a.seg_q),
      static_cast<const int*>(a.seg_k), static_cast<const int*>(a.kv_lo),
      static_cast<const int*>(a.kv_hi), static_cast<float*>(a.o),
      static_cast<float*>(a.lse), a.tq, a.tk, a.num_heads, a.sm_scale,
      a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_tc(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = varlen_fwd_tc_smem_bytes<D>();
  static_assert(smem <= flash_tc::kMaxSmem,
                "the tiles exceed a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_varlen_fwd_kernel_tc<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (a.tq + kTcBlockM - 1) / kTcBlockM;
  if (n_tiles > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
  err = varlen_order::longest_first(static_cast<const int*>(a.kv_lo),
                                    static_cast<const int*>(a.kv_hi),
                                    n_tiles, static_cast<int*>(a.order),
                                    stream);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.num_heads, n_tiles);
  flash_varlen_fwd_kernel_tc<T, D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.seg_q),
      static_cast<const int*>(a.seg_k), static_cast<const int*>(a.kv_lo),
      static_cast<const int*>(a.kv_hi), static_cast<const int*>(a.order),
      static_cast<T*>(a.o), static_cast<float*>(a.lse), a.tq, a.tk,
      a.num_heads, a.sm_scale, a.causal);
  return (int)cudaGetLastError();
}

// the route of `dtype` at head dim D: 0 = float32, the scalar kernel;
// 1 = bfloat16 and 2 = float16, the tensor-core kernel
template <int D>
int dispatch_dtype(const Args& a, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch<D>(a, stream);
  if (dtype == 1) return launch_tc<bf16, D>(a, stream);
  if (dtype == 2) return launch_tc<fp16, D>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v, o alike; lse fp32 [h, tq]).
// seg_q [tq], seg_k [tk], kv_lo / kv_hi [ceil(tq / 64)] int32, in 64-token
// tiles; order [ceil(tq / 64)] int32 is scratch, where the bf16 route
// writes the order in which it starts the q tiles (at most 65,535; the
// fp32 route takes them in index order). Returns cudaGetLastError() after
// the launches (0 on success).
int flash_varlen_fwd(const void* q, const void* k, const void* v,
                     const void* seg_q, const void* seg_k, const void* kv_lo,
                     const void* kv_hi, void* order, void* o, void* lse,
                     int tq, int tk, int num_heads, int head_dim,
                     float sm_scale, int causal, int dtype, void* stream) {
  if (tq <= 0 || num_heads <= 0) return 0;
  const Args a{q,     k, v,   seg_q, seg_k, kv_lo,     kv_hi,   order,
               o,     lse, tq, tk,   num_heads, sm_scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return dispatch_dtype<64>(a, dtype, s);
    case 128:
      return dispatch_dtype<128>(a, dtype, s);
    case 256:
      return dispatch_dtype<256>(a, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
