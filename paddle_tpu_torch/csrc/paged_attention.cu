// Paged decode attention for Hopper (sm_90a): one query token per row
// against its pages of the KV pool, grouped-query heads in-kernel, each
// row's visible prefix split over blocks (flash-decoding).
//
// Replaces: the bundled Pallas kernel
// jax.experimental.pallas.ops.tpu.paged_attention.paged_attention
// (paged_attention_kernel.py:113, pallas_call at :628), called from
// paddle_tpu/generation.py `paged_decode_attention`. Semantics follow the
// JAX package's reference `_paged_attention_ref`: columns
// t < min(lengths[b], pages_per_seq * page_size) visible, f32 scores
// scaled by 1/sqrt(D), f32 softmax and sums, one rounding to the storage
// type at the end. A row with no visible column gives exactly 0.
//
// Bound on the H100: device-memory bytes. A launch must read each visible
// token's K and V row once per KV head, sum_b len_b * hk * D * 2 * es
// bytes, plus q, out and the page indices; the products are 2 G = 2 H / hk
// operations per byte of K or V, far below the card's ratio of operations
// to bytes. On the main path each of 32 layers has its own pool, so a
// decode step finds its pages cold in device memory; the kernel needs
// tens of KB in flight per SM to cover a latency of about 600 ns at
// 3.35 TB/s, and an arithmetic body fast enough not to fall behind them.
//
// Design (bf16, the serving path: tensor cores):
// - Split over pages: block (split, b, kh), one warp, takes the split-th
//   of n_split runs of whole pages of row b's visible prefix (the host
//   picks n_split from B, hk, the pages per row and the SM count, so that
//   about 8 warps share an SM, without reading `lengths`); a run that is
//   empty writes only m = -inf and l = 0. A second launch merges the
//   per-split (m, l, acc) of every (b, h) with weights exp(m_s - M) (as
//   csrc/mla_decode.cu does).
// - Asynchronous page loads: the warp's chunks of 16 K and V rows go into
//   a ring of 3 stages in shared memory (26 KB) by 16-byte cp.async copies,
//   each token row gathered through its page's physical index (any page
//   size), so two chunks are in flight while one is computed (8 warps,
//   128 KB in flight, an SM); rows past the run are zero-filled by the
//   copy. The run's page indices come first, the queries while the first
//   chunks are on their way. No block barrier: a warp is its own block.
// - Each K and V row is read once for all G query heads of its KV head, on
//   the tensor cores (mma.sync m16n8k16, csrc/tensor_core.cuh): S = q K^T
//   with the G heads as the 16 rows (q held as A fragments in registers,
//   K through ldmatrix), f32 softmax in registers, then O += P V with P
//   as two bf16 terms, hi + lo (16 bits of p, as the attention kernels
//   carry it). On the CUDA cores the body was bounded by its shared-memory
//   and issue rate as much as by the bytes (at G 4, 21 us of arithmetic
//   against 28 us of loads at B 8, 2048 tokens a row, in a chip probe).
// - Rows padded by 16 bytes, so ldmatrix's 8 row addresses hit 32 banks.
// f32 (the wiring checks): the same split and combine on the CUDA cores,
// 8 warps a block through a 2-stage ring of 32-token tiles, lane = token
// for the scores, f32 FMAs throughout.
// Later work: a last-block-done combine would save the second launch
// (about 2 us of device time).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int D = 128;            // head width, fixed
constexpr int MAX_PAGES = 16384;  // page indices of a row held in shared memory
constexpr int MAX_SPLIT = 4096;   // a combine block's weights in shared memory

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// [t_begin, t_end) of block `split` of NS: the split-th run of
// ceil(pages / NS) whole pages of the visible prefix [0, len); empty
// (t_end <= t_begin) past the last page
__device__ __forceinline__ void run_of(int len, int ps, int split, int NS, int& t_begin,
                                       int& t_end) {
  const int n_pg = (len + ps - 1) / ps;
  const int run = (n_pg + NS - 1) / NS;
  const int p_begin = min(n_pg, split * run);
  const int p_end = min(n_pg, p_begin + run);
  t_begin = p_begin * ps;
  t_end = min(len, p_end * ps);
}

namespace tck {               // the bf16 body: one warp a block
constexpr int NT = 32;
constexpr int CH = 16;        // tokens of a chunk: the n of S, the k of P V
constexpr int STAGES = 3;     // chunks in the warp's ring
constexpr int R = D + tc::PAD;  // padded row, bf16 elements
constexpr int CHUNK = 2 * CH * R;  // K then V
constexpr size_t RING_BYTES = sizeof(__nv_bfloat16) * (size_t)STAGES * CHUNK;
}  // namespace tck

namespace f32k {              // the f32 body
constexpr int NT = 256;       // threads per block (8 warps)
constexpr int NW = NT / 32;
constexpr int TOK = 32;       // tokens per tile: one per lane in the scores
constexpr int QD = D / NW;    // columns of the scores each warp sums
constexpr int NQ = NT / (D / 2);  // token quarters of the context: thread
                                  // (q, c) owns columns 2c, 2c + 1
constexpr int TQ = TOK / NQ;      // tokens of a tile per quarter
constexpr int STAGES = 2;
constexpr int RS = D + 4;         // padded row, floats
constexpr size_t RING_BYTES = sizeof(float) * (size_t)STAGES * 2 * TOK * RS;
static_assert(sizeof(float) * NQ * 16 * D <= RING_BYTES, "quarter sums fit the ring");
}  // namespace f32k

template <int G> size_t f32_smem(int pps) {
  using namespace f32k;
  return RING_BYTES + sizeof(float) * ((size_t)G * D + (size_t)NW * G * TOK + (size_t)TOK * G + G) +
         sizeof(int) * (size_t)pps;
}

// bf16 body. Block (split, b, kh), one warp: its run of row b's pages, the
// G query heads of KV head kh; writes the run's (m, l, acc) of each head
// to the partials [B, H, n_split] (acc [B, H, n_split, D]; not written
// for an empty run, whose m = -inf the combine skips).
template <int G>
__global__ void __launch_bounds__(tck::NT)
paged_split_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                      const __nv_bfloat16* __restrict__ vp, const int* __restrict__ lengths,
                      const int* __restrict__ page_indices, float* __restrict__ part_m,
                      float* __restrict__ part_l, float* __restrict__ part_acc, int H,
                      int n_pages, int ps, int pps, float scale) {
  using namespace tck;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][K, V][CH][R]
  int* idx = reinterpret_cast<int*>(smem + RING_BYTES);          // the run's page indices

  const int split = blockIdx.x, b = blockIdx.y, kh = blockIdx.z, NS = gridDim.x;
  const int lane = threadIdx.x, gid = lane >> 2, tig = lane & 3;
  const int len = max(0, min(lengths[b], pps * ps));
  int t_begin, t_end;
  run_of(len, ps, split, NS, t_begin, t_end);
  const int n_chunks = max(0, (t_end - t_begin + CH - 1) / CH);
  const size_t h0 = (size_t)b * H + (size_t)kh * G;  // this block's first head
  if (n_chunks == 0) {                               // an empty run
    if (lane < G) {
      part_m[(h0 + lane) * NS + split] = -INFINITY;
      part_l[(h0 + lane) * NS + split] = 0.f;
    }
    return;
  }
  const int p_begin = t_begin / ps;
  for (int i = lane; i < (t_end - 1) / ps + 1 - p_begin; i += NT)
    idx[i] = page_indices[(size_t)b * pps + p_begin + i];
  __syncwarp();

  const size_t head = (size_t)kh * n_pages;
  // chunk i of the run into ring stage `stage`; rows past the run are
  // zero-filled by the copy
  auto issue = [&](int i, int stage) {
    const int t0 = t_begin + CH * i;
    __nv_bfloat16* ks = ring + stage * CHUNK;
    __nv_bfloat16* vs = ks + CH * R;
#pragma unroll
    for (int k = 0; k < CH * (D / 8) / NT; ++k) {
      const int u = lane + NT * k;
      const int r = u >> 4, c = (u & 15) * 8;
      const int t = t0 + r;
      const bool ok = t < t_end;
      size_t off = 0;
      if (ok) {
        const int pg = t / ps;
        off = ((head + (size_t)idx[pg - p_begin]) * ps + (t - pg * ps)) * D + c;
      }
      tc::cp_async16(ks + r * R + c, kp + off, ok);
      tc::cp_async16(vs + r * R + c, vp + off, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) issue(s, s);
    tc::cp_async_commit();
  }

  // the G query rows as A fragments of 16 rows (zeros past G), per k-step;
  // read while the first chunks are on their way
  uint32_t qa[D / 16][4];
  const __nv_bfloat16* qrow = q + h0 * D;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * tig;
    const uint32_t* r0 = reinterpret_cast<const uint32_t*>(qrow + gid * D + c);
    const uint32_t* r1 = reinterpret_cast<const uint32_t*>(qrow + (gid + 8) * D + c);
    qa[kk][0] = gid < G ? __ldg(r0) : 0u;
    qa[kk][1] = gid + 8 < G ? __ldg(r1) : 0u;
    qa[kk][2] = gid < G ? __ldg(r0 + 4) : 0u;
    qa[kk][3] = gid + 8 < G ? __ldg(r1 + 4) : 0u;
  }

  // o: rows gid (o[.][0..1]) and gid + 8 (o[.][2..3]) of 16 column blocks
  float o[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n_chunks; ++i) {
    tc::cp_async_wait<STAGES - 2>();  // chunk i has landed (this lane's copies)
    __syncwarp();                     // every lane's; chunk i - 1 fully read
    {
      const int nx = i + STAGES - 1;
      if (nx < n_chunks) issue(nx, nx % STAGES);
      tc::cp_async_commit();
    }
    const __nv_bfloat16* ks = ring + (i % STAGES) * CHUNK;
    const __nv_bfloat16* vs = ks + CH * R;
    const int t0 = t_begin + CH * i;

    // S = q K^T: rows the heads, columns the chunk's tokens (two blocks of 8)
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kb[4];
      tc::ldsm_x4(kb, ks + tc::b_off(0, kk * 16, R, lane));
      tc::mma(sc[0], qa[kk], kb[0], kb[1]);
      tc::mma(sc[1], qa[kk], kb[2], kb[3]);
    }
    // online softmax of rows gid and gid + 8; a quad holds a row's 16 tokens
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = t0 + nb * 8 + 2 * tig + e < t_end;
        sc[nb][e] = ok ? sc[nb][e] * scale : -INFINITY;
        sc[nb][2 + e] = ok ? sc[nb][2 + e] * scale : -INFINITY;
        mx0 = fmaxf(mx0, sc[nb][e]);
        mx1 = fmaxf(mx1, sc[nb][2 + e]);
      }
    }
    const float n0 = fmaxf(m0, quad_max(mx0));  // finite: token t0 is visible
    const float n1 = fmaxf(m1, quad_max(mx1));
    const float a0 = expf(m0 - n0), a1 = expf(m1 - n1);  // 0 while m = -inf
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[nb][e] = expf(sc[nb][e] - n0);
        sc[nb][2 + e] = expf(sc[nb][2 + e] - n1);
        s0 += sc[nb][e];
        s1 += sc[nb][2 + e];
      }
    }
    l0 = l0 * a0 + quad_sum(s0);
    l1 = l1 * a1 + quad_sum(s1);
    m0 = n0;
    m1 = n1;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      o[nb][0] *= a0;
      o[nb][1] *= a0;
      o[nb][2] *= a1;
      o[nb][3] *= a1;
    }
    // O += P V: P (heads x 16 tokens) as hi + lo A fragments
    uint32_t ph[4], pl[4];
    tc::a_from_c(ph, pl, sc[0], sc[1]);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t vb[4];
      tc::ldsm_x4_t(vb, vs + tc::bt_off(0, np * 16, R, lane));
      tc::mma(o[2 * np], ph, vb[0], vb[1]);
      tc::mma(o[2 * np], pl, vb[0], vb[1]);
      tc::mma(o[2 * np + 1], ph, vb[2], vb[3]);
      tc::mma(o[2 * np + 1], pl, vb[2], vb[3]);
    }
  }

  // the partial of rows gid and gid + 8, where they are heads
  if (gid < G) {
    float* acc = part_acc + ((h0 + gid) * NS + split) * D + 2 * tig;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<float2*>(acc + nb * 8) = make_float2(o[nb][0], o[nb][1]);
    if (tig == 0) {
      part_m[(h0 + gid) * NS + split] = m0;
      part_l[(h0 + gid) * NS + split] = l0;
    }
  }
  if (gid + 8 < G) {
    float* acc = part_acc + ((h0 + gid + 8) * NS + split) * D + 2 * tig;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<float2*>(acc + nb * 8) = make_float2(o[nb][2], o[nb][3]);
    if (tig == 0) {
      part_m[(h0 + gid + 8) * NS + split] = m1;
      part_l[(h0 + gid + 8) * NS + split] = l1;
    }
  }
}

// f32 body (CUDA cores). Block (split, b, kh): its run of row b's pages,
// the G query heads of KV head kh; writes the run's (m, l, acc) of each
// head to the partials [B, H, n_split] (acc [B, H, n_split, D]).
template <int G>
__global__ void __launch_bounds__(f32k::NT)
paged_split_f32_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                       const float* __restrict__ vp,
                       const int* __restrict__ lengths, const int* __restrict__ page_indices,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_acc, int H, int n_pages, int ps, int pps,
                       float scale) {
  using namespace f32k;
  constexpr int V = 4, R = RS, CPR = D / V;          // 16-byte chunks per row
  constexpr int MK = (G + NW - 1) / NW;              // softmax heads per warp
  extern __shared__ __align__(16) unsigned char smem[];
  float* kv = reinterpret_cast<float*>(smem);                  // [STAGES][K, V][TOK][R]
  float* qs = reinterpret_cast<float*>(smem + RING_BYTES);  // [G][D]
  float* red = qs + G * D;                             // [NW][G][TOK] partial scores
  float* pr = red + NW * G * TOK;                      // [TOK][G] probabilities
  float* al = pr + TOK * G;                            // [G] rescale of this tile
  int* idx = reinterpret_cast<int*>(al + G);           // row b's page indices

  const int split = blockIdx.x, b = blockIdx.y, kh = blockIdx.z, NS = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the row's length, page indices and queries, all in one trip
  const int len = max(0, min(lengths[b], pps * ps));
  for (int i = tid; i < pps; i += NT) idx[i] = page_indices[(size_t)b * pps + i];
  const float* qrow = q + ((size_t)b * H + (size_t)kh * G) * D;  // G rows, contiguous
  for (int i = tid; i < G * D; i += NT) qs[i] = qrow[i];
  int t_begin, t_end;
  run_of(len, ps, split, NS, t_begin, t_end);
  const int n_tiles = max(0, (t_end - t_begin + TOK - 1) / TOK);
  __syncthreads();

  const size_t head = (size_t)kh * n_pages;
  // tile `tile` of the run into ring stage `stage`; rows past the run
  // are zero-filled, so the products below need no guard
  auto issue = [&](int tile, int stage) {
    const int tok0 = t_begin + tile * TOK;
    float* ks = kv + stage * 2 * TOK * R;
    float* vs = ks + TOK * R;
#pragma unroll
    for (int u = tid; u < TOK * CPR; u += NT) {
      const int r = u / CPR, c = u - r * CPR;
      const int t = tok0 + r;
      const bool ok = t < t_end;
      size_t off = 0;
      if (ok) {
        const int pg = t / ps;
        off = ((head + (size_t)idx[pg]) * ps + (t - pg * ps)) * D + c * V;
      }
      tc::cp_async16(ks + r * R + c * V, kp + off, ok);
      tc::cp_async16(vs + r * R + c * V, vp + off, ok);
    }
  };

  float m_run[MK], l_run[MK], acc[G][2];
#pragma unroll
  for (int k = 0; k < MK; ++k) {
    m_run[k] = -INFINITY;
    l_run[k] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < G; ++j) acc[j][0] = acc[j][1] = 0.f;
  const int col = 2 * (tid % (D / 2)), quarter = tid / (D / 2);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) issue(s, s);
    tc::cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    tc::cp_async_wait<STAGES - 2>();  // tile i has landed (this thread's copies)
    __syncthreads();              // everyone's copies; tile i - 1 fully read
    {
      const int nx = i + STAGES - 1;
      if (nx < n_tiles) issue(nx, nx % STAGES);
      tc::cp_async_commit();
    }
    const float* ks = kv + (i % STAGES) * 2 * TOK * R;
    const float* vs = ks + TOK * R;
    const int n = min(TOK, t_end - (t_begin + i * TOK));  // >= 1

    {  // partial scores: lane = token, warp = an eighth of the columns
      float part[G];
#pragma unroll
      for (int j = 0; j < G; ++j) part[j] = 0.f;
      const float* kr = ks + lane * R + warp * QD;
      const float* qw = qs + warp * QD;
#pragma unroll
      for (int c = 0; c < QD / V; ++c) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + c * V);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float4 qv = *reinterpret_cast<const float4*>(qw + j * D + c * V);
          part[j] = fmaf(qv.x, k4.x, part[j]);
          part[j] = fmaf(qv.y, k4.y, part[j]);
          part[j] = fmaf(qv.z, k4.z, part[j]);
          part[j] = fmaf(qv.w, k4.w, part[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) red[(warp * G + j) * TOK + lane] = part[j];
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < MK; ++k) {  // online softmax of head j, one lane per token
      const int j = warp + k * NW;
      if (j < G) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) s += red[(w * G + j) * TOK + lane];
        s = lane < n ? s * scale : -INFINITY;
        const float m_new = fmaxf(m_run[k], warp_max(s));  // finite: n >= 1
        const float p = lane < n ? expf(s - m_new) : 0.f;
        const float alpha = expf(m_run[k] - m_new);         // 0 while m_run = -inf
        l_run[k] = l_run[k] * alpha + warp_sum(p);
        m_run[k] = m_new;
        pr[lane * G + j] = p;
        if (lane == 0) al[j] = alpha;
      }
    }
    __syncthreads();

    // context: thread (quarter, col) adds its quarter of the tile's tokens
    // (p = 0 and zero rows past n) into columns col, col + 1
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float a = al[j];
      acc[j][0] *= a;
      acc[j][1] *= a;
    }
#pragma unroll
    for (int tt = 0; tt < TQ; ++tt) {
      const int t = quarter * TQ + tt;
      const float2 v = *reinterpret_cast<const float2*>(vs + t * R + col);
      const float* pt = pr + t * G;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float p = pt[j];
        acc[j][0] = fmaf(p, v.x, acc[j][0]);
        acc[j][1] = fmaf(p, v.y, acc[j][1]);
      }
    }
  }

  const size_t h0 = (size_t)b * H + (size_t)kh * G;
#pragma unroll
  for (int k = 0; k < MK; ++k) {
    const int j = warp + k * NW;
    if (j < G && lane == 0) {
      part_m[(h0 + j) * NS + split] = m_run[k];
      part_l[(h0 + j) * NS + split] = l_run[k];
    }
  }
  // the quarters' sums meet in the ring's memory, which no copy still fills
  tc::cp_async_wait<0>();
  __syncthreads();
  float* sum = reinterpret_cast<float*>(smem);  // [NQ][G][D]
#pragma unroll
  for (int j = 0; j < G; ++j) {
    sum[(quarter * G + j) * D + col] = acc[j][0];
    sum[(quarter * G + j) * D + col + 1] = acc[j][1];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += NT) {
    float v = 0.f;
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) v += sum[qq * G * D + i];
    const int j = i / D, d = i - j * D;
    part_acc[((h0 + j) * NS + split) * D + d] = v;
  }
}

__device__ __forceinline__ float from_f(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_f(float v, __nv_bfloat16) {
  return __float2bfloat16(v);
}

constexpr int MAX_CG = 8;  // groups of D threads a combine block sums the splits in

// the combine's groups: one while a thread's loop over the splits is short,
// up to MAX_CG for many splits (a row of B 1 spread over the card)
int combine_groups(int n_split) { return n_split <= 32 ? 1 : min(MAX_CG, n_split / 16); }

// Block (h, b), CG = blockDim.x / D groups: out[b, h, :] = sum_s w_s acc_s
// / sum_s w_s l_s with w_s = exp(m_s - max_s m_s) over the splits that saw
// a column (an empty split's acc, never written, is never read); 0 where
// none did. The block weighs the splits in parallel into shared memory;
// thread (g, d) then sums column d of the splits s = g mod CG, eight loads
// at a time in flight.
template <typename T>
__global__ void __launch_bounds__(MAX_CG * D)
paged_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                     const float* __restrict__ part_acc, T* __restrict__ out, int NS) {
  extern __shared__ float ws[];  // [NS]
  __shared__ float red[MAX_CG * D / 32], sums[MAX_CG][D];
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int NT = blockDim.x, CG = NT / D, NWARP = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = ((size_t)b * H + h) * NS;
  float v = -INFINITY;
  for (int s = tid; s < NS; s += NT) v = fmaxf(v, part_m[base + s]);
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float M = -INFINITY;
  for (int w = 0; w < NWARP; ++w) M = fmaxf(M, red[w]);
  __syncthreads();  // red is read; it takes the sums of l next
  float l = 0.f;
  for (int s = tid; s < NS; s += NT) {
    const float m = part_m[base + s];
    const float w = m == -INFINITY ? 0.f : expf(m - M);
    ws[s] = w;
    l = fmaf(w, part_l[base + s], l);
  }
  l = warp_sum(l);
  if (lane == 0) red[warp] = l;
  __syncthreads();
  float L = 0.f;
  for (int w = 0; w < NWARP; ++w) L += red[w];
  const int grp = tid / D, d = tid - grp * D;
  float acc = 0.f;
  for (int s0 = grp; s0 < NS; s0 += 8 * CG) {  // 8 loads in flight a thread
    float w[8], a[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int s = s0 + k * CG;
      w[k] = s < NS ? ws[s] : 0.f;
      a[k] = w[k] != 0.f ? part_acc[(base + s) * D + d] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = fmaf(w[k], a[k], acc);
  }
  if (CG > 1) {  // uniform over the block
    sums[grp][d] = acc;
    __syncthreads();
    if (grp != 0) return;
    for (int g = 1; g < CG; ++g) acc += sums[g][d];
  }
  out[((size_t)b * H + h) * D + d] = from_f(L > 0.f ? acc / L : 0.f, T());
}

// sets the kernel's opt-in shared memory once it needs more than before
template <typename K> int allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return (int)err;
}

template <int G>
int launch_g(const void* q, const void* kp, const void* vp, const int* lengths, const int* pidx,
             float* pm, float* pl, float* pa, void* out, int B, int H, int hk, int n_pages,
             int ps, int pps, int n_split, float scale, bool bf16, cudaStream_t s) {
  const dim3 grid(n_split, B, hk);
  int err;
  if (bf16) {
    static size_t allowed = 0;
    const size_t smem = tck::RING_BYTES + sizeof(int) * (size_t)((pps + n_split - 1) / n_split);
    if ((err = allow_smem(paged_split_tc_kernel<G>, smem, allowed))) return err;
    paged_split_tc_kernel<G><<<grid, tck::NT, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
        static_cast<const __nv_bfloat16*>(vp), lengths, pidx, pm, pl, pa, H, n_pages, ps, pps,
        scale);
    if ((err = (int)cudaGetLastError())) return err;
    paged_combine_kernel<__nv_bfloat16><<<dim3(H, B), D * combine_groups(n_split),
                                         sizeof(float) * n_split, s>>>(
        pm, pl, pa, static_cast<__nv_bfloat16*>(out), n_split);
  } else {
    static size_t allowed = 0;
    const size_t smem = f32_smem<G>(pps);
    if ((err = allow_smem(paged_split_f32_kernel<G>, smem, allowed))) return err;
    paged_split_f32_kernel<G><<<grid, f32k::NT, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(kp),
        static_cast<const float*>(vp), lengths, pidx, pm, pl, pa, H, n_pages, ps, pps, scale);
    if ((err = (int)cudaGetLastError())) return err;
    paged_combine_kernel<float><<<dim3(H, B), D * combine_groups(n_split),
                                 sizeof(float) * n_split, s>>>(
        pm, pl, pa, static_cast<float*>(out), n_split);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, out [B, H, D]; k_pages, v_pages [hk, n_pages, ps, D]; lengths [B] int32;
// page_indices [B, pps] int32, pps <= 16384; partials part_m, part_l
// [B, H, n_split] and part_acc [B, H, n_split, D] f32, scratch;
// 1 <= n_split <= min(max(pps, 1), 4096). dtype: 0 = float32, 1 = bfloat16. Block
// (split, b, kh) takes the split-th of n_split runs of whole pages of row
// b's visible prefix; a second launch combines the runs. Returns
// cudaGetLastError() after the two launches.
extern "C" int pt_paged_attention(const void* q, const void* kp, const void* vp,
                                  const void* lengths, const void* page_indices,
                                  void* part_m, void* part_l, void* part_acc, void* out,
                                  int B, int H, int hk, int n_pages, int ps, int pps,
                                  int n_split, float scale, int dtype, void* stream) {
  if (n_split < 1 || n_split > max(pps, 1) || n_split > MAX_SPLIT || pps > MAX_PAGES ||
      ps < 1 || hk < 1 || H % hk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const int* pidx = static_cast<const int*>(page_indices);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  const bool bf16 = dtype == 1;
  switch (H / hk) {
    case 1: return launch_g<1>(q, kp, vp, len, pidx, pm, pl, pa, out, B, H, hk, n_pages, ps, pps, n_split, scale, bf16, s);
    case 2: return launch_g<2>(q, kp, vp, len, pidx, pm, pl, pa, out, B, H, hk, n_pages, ps, pps, n_split, scale, bf16, s);
    case 4: return launch_g<4>(q, kp, vp, len, pidx, pm, pl, pa, out, B, H, hk, n_pages, ps, pps, n_split, scale, bf16, s);
    case 8: return launch_g<8>(q, kp, vp, len, pidx, pm, pl, pa, out, B, H, hk, n_pages, ps, pps, n_split, scale, bf16, s);
    case 16: return launch_g<16>(q, kp, vp, len, pidx, pm, pl, pa, out, B, H, hk, n_pages, ps, pps, n_split, scale, bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
