// Ragged paged attention for decode (KQ = 1) and k-query speculative
// verify (KQ = k + 1) on Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::_paged_verify_kernel (the
// Pallas TPU kernel behind paged_attention_decode and
// paged_attention_verify_decode).
//
// What it computes, per slot b and head h: query row j (j < KQ) attends
// over the first ctx[b] + j tokens of the slot's paged KV history (no more
// than the table holds), with an online softmax in fp32. ctx[b] == 0 marks
// an inactive slot, whose rows are written as exact (+0) zeros.
//
// Layouts (the data contract the serving engine writes into):
//   q            [B, KQ, H, D]   slot and row strides given, head stride D,
//                                last stride 1 (a column slice of the
//                                packed qkv is read in place)
//   k/v pages    [num_pages, page_size, H*D]   page 0 is the null page
//   block_tables [B, max_pages] int32          padded with page 0
//   context_lens [B] int32
//   out          [B, KQ, H, D]   contiguous, same dtype as q
//
// What bounds it on the H100: bytes, and at serving's small batch the
// latency of the longest slot. Each (slot, head) reads its context's K and
// V rows once and does 4*D flops per row and query row: about 2*KQ flops
// per byte, far below the ~295 flops/byte where the tensor cores would
// start to matter. So the bf16 route aims at parallelism and wide loads:
//
// - Split context (the flash-decoding shape). The grid is (split, slot *
//   head, row group) with heads fastest. A split is a fixed run of whole
//   pages (split_pages, chosen by the wrapper from the page size), so the
//   grid follows the table's extent, a shape, and nothing is read back to
//   the host. At serving's shape (B = 8, H = 12, 64 pages of 16) that is 4
//   splits and 384 CTAs for 132 SMs, and the longest slot's critical path
//   is one split of 256 tokens instead of its whole context. A CTA whose
//   split starts at or past its rows' last visible token writes an empty
//   partial (l = 0) and exits without reading K or V.
// - Inside a split each of the 4 warps walks its own chunks of C tokens
//   (C never crosses a page). A row of one head is D bf16 values, read as
//   16-byte loads by D/8 lanes, so a load instruction covers 32*8/D tokens
//   (4 at D = 64). The chunks stream through a 2-stage cp.async ring per
//   warp: the next chunk's loads are in flight while this one's math runs.
//   Each lane reads back only what it loaded itself, so the loop needs no
//   barrier at all.
// - The KQ query rows live in registers, pre-scaled by sm_scale*log2(e).
//   A score is a reduction over the D/8 lanes of one row (3 to 5 shuffles),
//   not a 32-lane reduction per token. Each group of D/8 lanes keeps its
//   own online softmax (m, l, acc) per query row over the tokens it saw;
//   the groups merge by shuffles, the warps in shared memory, in a fixed
//   order, and the CTA writes its split's (m, l, acc) in fp32 to a
//   workspace the wrapper allocates.
// - A second kernel, behind the same C entry, merges the splits of each
//   (slot, row, head) in split order and writes the output in bf16. Fixed
//   orders everywhere: reruns are bit-identical.
//
// The fp16 route is the same two kernels instantiated for __half: only the
// conversion of the 16-byte loads and of the output differs. The output is
// rounded to nearest even and never clamped.
//
// The fp32 route keeps the first port's scalar kernel (one 128-thread block
// per (slot, head), 32-token tiles staged in shared memory as fp32): the
// fp32 exactness checks run on it.
//
// Not carried over from the TPU kernel: the static head loop, the
// page-group DMA ring and its PDTPU_PAGED_PAGES_PER_STEP knob, and the
// rounding of the scaled q and of p to the input dtype (the products here
// take fp32 q and p).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __half fp16;

constexpr int kThreads = 128;  // four warps, both routes
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplitPages = 16;  // pages of one split (page_size >= 16)
constexpr float kLog2e = 1.4426950408889634f;
// the running max of a row that has seen no token: finite, so that
// exp2(m_old - m_new) and the merges never meet inf - inf
constexpr float kNoMax = -1e30f;

// -- fp32 route: the first port's scalar kernel -------------------------------
constexpr int kTile = 32;  // tokens per staged tile: one warp's width

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, float* __restrict__ out, int kq,
    int num_heads, int head_dim, int page_size, int max_pages,
    long long q_sb, long long q_sj, float sm_scale) {
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
  // row j of this (slot, head): q at q_base + j * q_sj, out at
  // base + j * hd
  const size_t base = (size_t)b * kq * hd + (size_t)h * d;
  const long long q_base = b * q_sb + (long long)h * d;
  const int ctx = context_lens[b];

  if (ctx <= 0) {  // inactive slot: exact (+0) zeros, nothing read
    for (int e = tid; e < kq * d; e += kThreads) {
      const int j = e / d;
      out[base + j * hd + (e - j * d)] = 0.0f;
    }
    return;
  }

  for (int e = tid; e < kq * d; e += kThreads) {
    const int j = e / d;
    q_s[e] = q[q_base + j * q_sj + (e - j * d)] * sm_scale;
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
      k_s[e] = k_pages[off];
      v_s[e] = v_pages[off];
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
    out[base + j * hd + (e - j * d)] = acc[e] / fmaxf(l_s[j], 1e-30f);
  }
}

// -- bf16 and fp16 routes: split context, then combine -------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes when src_bytes is 16; 16 zero bytes (nothing read) when it is
// 0. The memory clobber keeps the compiler from moving this lane's reads
// of the stage it overwrites past the copy.
__device__ __forceinline__ void cp_async_16_zfill(void* dst, const void* src,
                                                  int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 8 16-bit values (16 bytes) of type T as floats
template <typename T>
__device__ __forceinline__ void x8_to_float(const uint4& u, float* f);
template <>
__device__ __forceinline__ void x8_to_float<bf16>(const uint4& u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(p[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
template <>
__device__ __forceinline__ void x8_to_float<fp16>(const uint4& u, float* f) {
  const __half2* p = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __half22float2(p[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// two floats as two T in one register, `lo` in the low half (round to
// nearest even, never clamped: an fp16 value past 65504 becomes inf)
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

// Shapes of the split kernel at head dim D and KQB query rows per CTA.
template <int D, int KQB>
struct Split {
  static constexpr int kLanesPerRow = D / 8;             // 16-byte chunks
  static constexpr int kRowsPerLoad = 32 / kLanesPerRow;  // tokens / load
  static constexpr int kLoads = KQB >= 8 ? 2 : 4;  // loads per lane, chunk
  static constexpr int kChunk = kLoads * kRowsPerLoad;    // tokens
  static constexpr int kChunkElems = kChunk * D;          // one of K or V
  // a ring of 2 stages of K and V chunks per warp, which the warps' merge
  // buffers (acc [KQB][D], m [KQB], l [KQB] each) reuse after the loop;
  // at most 33,024 bytes (D = 256, 8 rows), under the 48 KB a block gets
  // without opting in. 3 and 4 stages measured no faster.
  static constexpr size_t kRingBytes =
      (size_t)kWarps * 2 * 2 * kChunkElems * sizeof(bf16);
  static constexpr size_t kMergeBytes =
      (size_t)kWarps * KQB * (D + 2) * sizeof(float);
  static constexpr size_t kSmem =
      kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
  static_assert(kSmem + kMaxSplitPages * sizeof(int) <= 48 * 1024,
                "split kernel's shared memory exceeds 48 KB");
};

template <typename T, int D, int KQB>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, float* __restrict__ part_acc,
    float2* __restrict__ part_ml, int kq, int num_heads, int page_size,
    int max_pages, long long q_sb, long long q_sj, int split_pages,
    int rows_total, float scale_log2) {
  using S = Split<D, KQB>;
  constexpr int LPR = S::kLanesPerRow;
  constexpr int RPW = S::kRowsPerLoad;
  constexpr int NL = S::kLoads;
  constexpr int C = S::kChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int pages_s[kMaxSplitPages];

  const int split = blockIdx.x;
  const int b = blockIdx.y / num_heads;
  const int h = blockIdx.y - b * num_heads;
  const int j0 = blockIdx.z * KQB;
  const int nrows = min(KQB, kq - j0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane / LPR;   // which token of a load this lane reads
  const int c8 = lane % LPR;    // which 8 columns of the row
  const int ctx = context_lens[b];
  const int extent = max_pages * page_size;
  const int split_tokens = split_pages * page_size;
  const int t_lo = split * split_tokens;
  // this group's last row sees ctx + j0 + nrows - 1 tokens, no row more
  const int n_tok = ctx > 0 ? min(ctx + j0 + nrows - 1, extent) : 0;
  // partial row of (b, j0 + jj, h): row0 + jj * num_heads
  const size_t row0 = ((size_t)b * kq + j0) * num_heads + h;
  float* acc_out = part_acc + (size_t)split * rows_total * D;
  float2* ml_out = part_ml + (size_t)split * rows_total;

  if (t_lo >= n_tok) {  // nothing of this split is visible: empty partial
    if (tid < nrows)
      ml_out[row0 + (size_t)tid * num_heads] = make_float2(kNoMax, 0.0f);
    return;
  }
  const int t_hi = min(t_lo + split_tokens, n_tok);
  if (tid < split_pages)
    pages_s[tid] = split * split_pages + tid < max_pages
                       ? block_tables[(size_t)b * max_pages +
                                      split * split_pages + tid]
                       : 0;

  // query rows in registers, pre-scaled; tokens each row sees
  float qr[KQB][8];
  int n_vis[KQB];
#pragma unroll
  for (int jj = 0; jj < KQB; ++jj) {
    n_vis[jj] = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) qr[jj][e] = 0.0f;
    if (jj < nrows) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          q + b * q_sb + (j0 + jj) * q_sj + (long long)h * D + c8 * 8);
      x8_to_float<T>(u, qr[jj]);
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[jj][e] *= scale_log2;
      n_vis[jj] = min(ctx + j0 + jj, extent);
    }
  }
  float m[KQB], l[KQB], acc[KQB][8];
#pragma unroll
  for (int jj = 0; jj < KQB; ++jj) {
    m[jj] = kNoMax;
    l[jj] = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[jj][e] = 0.0f;
  }
  __syncthreads();  // pages_s

  T* ring = reinterpret_cast<T*>(smem_raw) +
               (size_t)warp * 2 * 2 * S::kChunkElems;
  const size_t hd = (size_t)num_heads * D;
  const int n_chunks = (t_hi - t_lo + C - 1) / C;

  // chunk c of the split into stage st: each lane loads its own NL rows'
  // 8 columns of K and of V; rows past t_hi are zero-filled, not read
  auto load_chunk = [&](int c, int st) {
    const int first = c * C;  // token offset in the split
    const int page = pages_s[first / page_size];
    const int off0 = first % page_size;
    T* kd = ring + st * 2 * S::kChunkElems;
    T* vd = kd + S::kChunkElems;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int tl = i * RPW + grp;
      const bool live = t_lo + first + tl < t_hi;
      const size_t src =
          live ? ((size_t)page * page_size + off0 + tl) * hd +
                     (size_t)h * D + c8 * 8
               : 0;
      cp_async_16_zfill(kd + tl * D + c8 * 8, k_pages + src, live ? 16 : 0);
      cp_async_16_zfill(vd + tl * D + c8 * 8, v_pages + src, live ? 16 : 0);
    }
  };

  int it = 0;
  if (warp < n_chunks) load_chunk(warp, 0);
  cp_async_commit();
  for (int c = warp; c < n_chunks; c += kWarps, ++it) {
    if (c + kWarps < n_chunks) load_chunk(c + kWarps, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    const T* kd = ring + (it & 1) * 2 * S::kChunkElems;
    const T* vd = kd + S::kChunkElems;
    const int tok0 = t_lo + c * C;

    // scores: 8 columns here, summed over the row's LPR lanes
    float s[NL][KQB];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      float kf[8];
      x8_to_float<T>(
          *reinterpret_cast<const uint4*>(kd + (i * RPW + grp) * D + c8 * 8),
          kf);
#pragma unroll
      for (int jj = 0; jj < KQB; ++jj) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot += qr[jj][e] * kf[e];
        s[i][jj] = dot;
      }
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < NL; ++i)
#pragma unroll
        for (int jj = 0; jj < KQB; ++jj)
          s[i][jj] += __shfl_xor_sync(0xffffffffu, s[i][jj], o);

    // online softmax over this lane group's NL tokens, row by row
#pragma unroll
    for (int jj = 0; jj < KQB; ++jj) {
      float mx = m[jj];
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        if (tok0 + i * RPW + grp >= n_vis[jj]) s[i][jj] = -INFINITY;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float alpha = exp2f(m[jj] - mx);
      float psum = 0.0f;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        s[i][jj] = exp2f(s[i][jj] - mx);  // a masked token gives 0
        psum += s[i][jj];
      }
      m[jj] = mx;
      l[jj] = l[jj] * alpha + psum;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[jj][e] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      float vf[8];
      x8_to_float<T>(
          *reinterpret_cast<const uint4*>(vd + (i * RPW + grp) * D + c8 * 8),
          vf);
#pragma unroll
      for (int jj = 0; jj < KQB; ++jj)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[jj][e] += s[i][jj] * vf[e];
    }
  }
  cp_async_wait<0>();

  // merge the warp's lane groups (same columns, other tokens)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int jj = 0; jj < KQB; ++jj) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[jj], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[jj], o);
      const float mx = fmaxf(m[jj], m_o);
      const float a = exp2f(m[jj] - mx);
      const float a_o = exp2f(m_o - mx);
      l[jj] = l[jj] * a + l_o * a_o;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[jj][e], o);
        acc[jj][e] = acc[jj][e] * a + acc_o * a_o;
      }
      m[jj] = mx;
    }
  }

  // merge the warps in shared memory (the ring is free now), in warp order
  __syncthreads();
  float* acc_s = reinterpret_cast<float*>(smem_raw);  // [kWarps][KQB][D]
  float* m_s = acc_s + kWarps * KQB * D;              // [kWarps][KQB]
  float* l_s = m_s + kWarps * KQB;                    // [kWarps][KQB]
  if (grp == 0) {
#pragma unroll
    for (int jj = 0; jj < KQB; ++jj) {
      float4* dst = reinterpret_cast<float4*>(
          acc_s + (warp * KQB + jj) * D + c8 * 8);
      dst[0] = make_float4(acc[jj][0], acc[jj][1], acc[jj][2], acc[jj][3]);
      dst[1] = make_float4(acc[jj][4], acc[jj][5], acc[jj][6], acc[jj][7]);
      if (c8 == 0) {
        m_s[warp * KQB + jj] = m[jj];
        l_s[warp * KQB + jj] = l[jj];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < nrows * D; e += kThreads) {
    const int jj = e / D;
    const int col = e - jj * D;
    float mx = kNoMax;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * KQB + jj]);
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      a += acc_s[(w * KQB + jj) * D + col] * exp2f(m_s[w * KQB + jj] - mx);
    acc_out[(row0 + (size_t)jj * num_heads) * D + col] = a;
  }
  if (tid < nrows) {
    float mx = kNoMax;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * KQB + tid]);
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      sum += l_s[w * KQB + tid] * exp2f(m_s[w * KQB + tid] - mx);
    ml_out[row0 + (size_t)tid * num_heads] = make_float2(mx, sum);
  }
}

// One warp per (slot, row, head): merge the splits' partials in split
// order, skipping empty ones (l = 0), and write acc / l in T; a row with
// no visible token (an inactive slot) gets +0.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(
    const float* __restrict__ part_acc, const float2* __restrict__ part_ml,
    T* __restrict__ out, int rows_total, int n_split) {
  constexpr int DPL = D / 32;  // columns per lane: 2, 4 or 8
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows_total) return;
  float mx = kNoMax;
  for (int s = 0; s < n_split; ++s) {
    const float2 p = part_ml[(size_t)s * rows_total + r];
    if (p.y > 0.0f) mx = fmaxf(mx, p.x);
  }
  float sum = 0.0f;
  float o[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) o[e] = 0.0f;
  for (int s = 0; s < n_split; ++s) {
    const float2 p = part_ml[(size_t)s * rows_total + r];
    if (p.y > 0.0f) {
      const float w = exp2f(p.x - mx);
      sum += p.y * w;
      const float* a =
          part_acc + ((size_t)s * rows_total + r) * D + lane * DPL;
#pragma unroll
      for (int e = 0; e < DPL; e += 2) {
        const float2 x = *reinterpret_cast<const float2*>(a + e);
        o[e] += x.x * w;
        o[e + 1] += x.y * w;
      }
    }
  }
  uint32_t* dst =
      reinterpret_cast<uint32_t*>(out + (size_t)r * D + lane * DPL);
#pragma unroll
  for (int e = 0; e < DPL; e += 2)
    dst[e / 2] = sum > 0.0f ? pack2<T>(o[e] / sum, o[e + 1] / sum)
                            : pack2<T>(0.0f, 0.0f);
}

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* block_tables;
  const int* context_lens;
  void* out;
  float* workspace;
  int batch, kq, num_heads, head_dim, page_size, max_pages, split_pages;
  long long q_sb, q_sj;
  float sm_scale;
};

template <typename T, int D, int KQB>
int launch_split(const Args& a, cudaStream_t stream) {
  const int n_split =
      a.max_pages > 0 ? (a.max_pages + a.split_pages - 1) / a.split_pages : 1;
  const int rows_total = a.batch * a.kq * a.num_heads;
  float* part_acc = a.workspace;  // [n_split][rows_total][D]
  float2* part_ml = reinterpret_cast<float2*>(
      a.workspace + (size_t)n_split * rows_total * D);  // [n_split][rows]
  const dim3 grid(n_split, a.batch * a.num_heads, (a.kq + KQB - 1) / KQB);
  paged_split_kernel<T, D, KQB><<<grid, kThreads, Split<D, KQB>::kSmem,
                                  stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pages),
      static_cast<const T*>(a.v_pages), a.block_tables, a.context_lens,
      part_acc, part_ml, a.kq, a.num_heads, a.page_size, a.max_pages, a.q_sb,
      a.q_sj, a.split_pages, rows_total, a.sm_scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_combine_kernel<T, D><<<(rows_total + kWarps - 1) / kWarps, kThreads,
                               0, stream>>>(part_acc, part_ml,
                                            static_cast<T*>(a.out),
                                            rows_total, n_split);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_16bit(const Args& a, cudaStream_t stream) {
  if (a.kq == 1) return launch_split<T, D, 1>(a, stream);
  if (a.kq <= 4) return launch_split<T, D, 4>(a, stream);
  return launch_split<T, D, 8>(a, stream);  // row groups of 8 past KQ = 8
}

template <typename T>
int launch_split_route(const Args& a, cudaStream_t stream) {
  if (a.head_dim == 64) return launch_16bit<T, 64>(a, stream);
  if (a.head_dim == 128) return launch_16bit<T, 128>(a, stream);
  if (a.head_dim == 256) return launch_16bit<T, 256>(a, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_f32(const Args& a, cudaStream_t stream) {
  // q, acc [kq][d]; k, v tiles [kTile][d]; probs [kq][kTile]; m, l, alpha
  const size_t smem =
      sizeof(float) * (2 * (size_t)a.kq * a.head_dim +
                       2 * (size_t)kTile * a.head_dim +
                       (size_t)a.kq * kTile + 3 * (size_t)a.kq);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_attention_kernel<<<a.batch * a.num_heads, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k_pages),
      static_cast<const float*>(a.v_pages), a.block_tables, a.context_lens,
      static_cast<float*>(a.out), a.kq, a.num_heads, a.head_dim, a.page_size,
      a.max_pages, a.q_sb, a.q_sj, a.sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (scalar kernel; workspace and split_pages unused),
// 1 = bfloat16 or 2 = float16 (split kernel, then combine; workspace holds
// n_split * B * KQ * H * (D + 2) floats, n_split = ceil(max_pages /
// split_pages), split_pages <= 16). q_sb and q_sj are q's slot and row
// strides in elements. Returns cudaGetLastError() after the launches (0 on
// success).
int paged_attention_fwd(const void* q, const void* k_pages,
                        const void* v_pages, const void* block_tables,
                        const void* context_lens, void* out, void* workspace,
                        int batch, int kq, int num_heads, int head_dim,
                        int page_size, int max_pages, long long q_sb,
                        long long q_sj, int split_pages, float sm_scale,
                        int dtype, void* stream) {
  if (batch <= 0 || kq <= 0) return 0;
  const Args a{q, k_pages, v_pages,
               static_cast<const int*>(block_tables),
               static_cast<const int*>(context_lens), out,
               static_cast<float*>(workspace), batch, kq, num_heads,
               head_dim, page_size, max_pages, split_pages, q_sb, q_sj,
               sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(a, s);
  if (split_pages < 1 || split_pages > kMaxSplitPages)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) return launch_split_route<bf16>(a, s);
  if (dtype == 2) return launch_split_route<fp16>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
