// Append attention for Hopper (sm_90a): S queries at offset `pos` against a
// dense KV buffer, grouped-query heads in-kernel, streaming f32 softmax.
//
// Replaces: paddle_tpu/ops/pallas/append_attention.py, `_kernel` (called
// from `_append_jit` / `append_attention`). The same kernel serves the
// forward of paddle_tpu/ops/pallas/flash_attention.py `flash_attention_bshd`
// and of its `splash_hop` (one ring-attention hop, with lse) under the
// splash kernel's three masks, named by `kind` in the C interface:
// - kind 0, the CausalMask at `offset` = pos (pos = s_kv - s_q for
//   `flash_attention_bshd`'s bottom-aligned triangle, the hop's offset for
//   `splash_hop`): query s sees column t <= pos + s;
// - kind 1, the sliding-window LocalMask(window_size=(window - 1, 0),
//   offset=pos) (window > 0): query s sees column t iff
//   pos + s - window < t <= pos + s; a row whose band misses [0, T) (a
//   ring hop's dead row) writes out 0 and lse -inf;
// - kind 2, the FullMask: every query sees every column, for any S and T
//   (s_kv < s_q included); pos is not read. Tiles wholly inside [0, T)
//   skip the per-element mask compare.
//
// Head widths: q/k width DQK and v width DV are template parameters,
// instantiated at (128, 128), the Llama families' heads, and (192, 128),
// DeepSeek's MLA prefill (qk_nope 128 + qk_rope 64 against v 128, which
// the TPU path zero-pads to 256 and 128 lanes; CUDA has no lane rule, so
// the kernel takes the true widths and computes the same function).
//
// Bound on the H100: at prefill (S = T = bucket) the work is the
// 4 * D * (visible query/key pairs) operations of the two products, which
// for a bucket of 1024 is well above the card's ratio of operations to
// bytes: bound by operations. For short chunks against a long buffer it
// becomes bound by the bytes of K and V.
//
// Two bodies, chosen by the dtype in `launch_dtype`:
//
// bf16 (the serving and training paths): `append_attention_tc_kernel`.
// - Products on the tensor cores: mma.sync m16n8k16, bf16 operands, f32
//   accumulators (csrc/tensor_core.cuh). S = q k^T is scaled in f32 (by
//   scale * log2 e, inside the exp2's FMA). P comes out of the S
//   accumulators in registers and is the A operand of P v as it stands, so
//   neither scores nor probabilities touch shared memory. mma.sync, not
//   wgmma: its accumulator layout feeds the next product with no shuffle,
//   and its fragments come from plain padded tiles through ldmatrix, with
//   no descriptor or swizzle mode to get silently wrong. wgmma is the next
//   step for speed.
// - Grid (ceil(g*S / BM), hk, B), batch slowest. When S is a whole number
//   of tiles, a block's linear index picks its head and tile so that the
//   longest causal tiles (the last positions) of every head start first,
//   and the blocks in flight read the K and V of every KV head of one batch
//   row (16 MB at Llama-3-8B's sequence 4096; the L2 holds 50 MB). Heaviest
//   first within each head only left a tail of long tiles of the last
//   heads (the MLA prefill, 512 blocks, is under two waves of the card).
//   Row r of a tile is query position s = r % S of head j = r / S, read
//   from the JAX layout q[B, S, hk, g, D] by index arithmetic, so every K/V
//   tile staged in shared memory serves all g heads of the KV head.
// - A block is 4 warps of 16 query rows (BM = 64), two blocks an SM. Q is
//   copied once into shared memory (bf16, rows padded by 8 elements:
//   conflict-free ldmatrix) and held as A fragments in registers (48 of
//   them at width 192; 245 registers a thread, no spill). K and V stream
//   through a ring of two bf16 stages filled by 16-byte cp.async copies:
//   tile j + 1 loads while tile j computes, one __syncthreads() a tile.
// - Softmax in registers: each thread holds two rows' running max and
//   partial sum; the four lanes of a row combine with __shfl_xor_sync.
//   m_safe = 0 where the max is still -inf, so a row that has seen no
//   column (a ring hop's dead row) gives exp2(-inf) = 0, never NaN: out 0,
//   lse -inf.
// - Masks: only the tiles some row of the block can see are loaded: the
//   loop starts at the tile of the first column of the lowest row's band
//   (with a window) and ends past the last visible column of the highest
//   row (the Pallas kernel's `cond` skip; splash's block-sparse mask info
//   for the LocalMask), so a windowed prefill does O(S * window) work. A
//   warp skips a tile none of its rows sees, and evaluates the per-element
//   compare only on tiles that cross an edge: the diagonal, the band's
//   lower edge, the ragged tail past T, and every tile under `allowed`.
// - Rounding against splash: splash multiplies bf16 q and k with f32
//   accumulation, as here, and takes P v in f32. Here P enters P v as two
//   bf16 terms, hi = bf16(p) and lo = bf16(p - hi) (16 bits of p), in two
//   products: P rounded once to bf16 moved the first rows of a causal
//   prefill past the port's tolerance (2e-3 + 2^-7 |p|), where p is near
//   1 and |v| near 2 (tests/test_torch_flash_rounding.py models both). The
//   second product adds 50% to the tensor-core work at (128, 128), 40% at
//   (192, 128).
//
// f32 (the wiring checks, card against CPU): `append_attention_kernel`,
// the first port's body, kept as it was: f32 FMAs on the CUDA cores from
// padded shared-memory tiles, grid (B, hk, tiles), a BN-column score tile
// and the per-row softmax state in shared memory. TF32 tensor cores would
// not hold those checks' 1e-3 on logits.
//
// Optional f32 logsumexp `lse` [B, H, S] of the scaled scores over the
// visible columns, the residual the flash backward
// (csrc/flash_attention.cu) needs. It is written only when a pointer is
// given, so serving launches skip it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

// ------------------------------------------------------------------- f32 --

constexpr int BM = 64;    // query rows per block
constexpr int BN = 64;    // key rows per tile
constexpr int NT = 256;   // threads per block
constexpr int PS = BN + 1;

// shared memory of the (DQK, DV) instantiation: padded q and k tiles, the
// v tile, scores and three per-row vectors (149 KB at (192, 128))
template <int DQK, int DV> constexpr size_t smem_bytes() {
  return (size_t)(BM * (DQK + 1) + BN * (DQK + 1) + BN * DV + BM * PS + 3 * BM) *
         sizeof(float);
}

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(NT)
append_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const uint8_t* __restrict__ allowed,
                        T* __restrict__ out, float* __restrict__ lse, int S, int T_,
                        int hk, int g, int pos, int window, bool full, float scale) {
  constexpr int QS = DQK + 1;   // padded shared-memory row strides
  constexpr int KS = DQK + 1;
  constexpr int NJ = DV / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [BM][QS]
  float* Ks = Qs + BM * QS;      // [BN][KS]
  float* Vs = Ks + BN * KS;      // [BN][DV]
  float* Ps = Vs + BN * DV;      // [BM][PS] scores, then probabilities
  float* m_s = Ps + BM * PS;     // running max per row
  float* l_s = m_s + BM;         // running sum per row
  float* a_s = l_s + BM;         // rescale factor of the current tile
  __shared__ int lim_s[BM];      // last visible column per row, -1 = no row
  __shared__ int lo_s[BM];       // first visible column per row

  const int b = blockIdx.x, kh = blockIdx.y;
  const int rows = g * S;
  const int r0 = blockIdx.z * BM;
  const int H = hk * g;
  const int tid = threadIdx.x;

  for (int i = tid; i < BM * DQK; i += NT) {
    const int rr = i / DQK, dd = i % DQK, r = r0 + rr;
    float val = 0.f;
    if (r < rows) {
      const int j = r / S, s = r % S;
      val = to_f(q[(((size_t)b * S + s) * H + kh * g + j) * DQK + dd]) * scale;
    }
    Qs[rr * QS + dd] = val;
  }
  if (tid < BM) {
    const int r = r0 + tid;
    lim_s[tid] = r < rows ? (full ? T_ - 1 : pos + r % S) : -1;
    lo_s[tid] = (r < rows && window > 0) ? pos + r % S - window + 1 : 0;
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  // columns past the largest visible one of this tile's rows are skipped,
  // and with a window the tiles wholly below the smallest row's band
  const int r_last = min(r0 + BM, rows) - 1;
  const bool one_head = r0 / S == r_last / S;
  const int s_max = one_head ? r_last % S : S - 1;
  const int s_min = one_head ? r0 % S : 0;
  const int kv_end = full ? T_ : min(T_, pos + s_max + 1);
  const int kv_begin = window > 0 ? max(0, pos + s_min - window + 1) / BN * BN : 0;

  const int tx = tid % 16, ty = tid / 16;  // rows ty + 16i, cols tx + 16j
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BN) {
    if constexpr (DQK == DV) {  // one pass over K and V (the Llama heads)
      for (int i = tid; i < BN * DV; i += NT) {
        const int c = i / DV, dd = i % DV, col = kv0 + c;
        float kv = 0.f, vv = 0.f;
        if (col < T_) {
          const size_t off = (((size_t)b * T_ + col) * hk + kh) * DV + dd;
          kv = to_f(k[off]);
          vv = to_f(v[off]);
        }
        Ks[c * KS + dd] = kv;
        Vs[c * DV + dd] = vv;
      }
    } else {
      for (int i = tid; i < BN * DQK; i += NT) {
        const int c = i / DQK, dd = i % DQK, col = kv0 + c;
        Ks[c * KS + dd] =
            col < T_ ? to_f(k[(((size_t)b * T_ + col) * hk + kh) * DQK + dd]) : 0.f;
      }
      for (int i = tid; i < BN * DV; i += NT) {
        const int c = i / DV, dd = i % DV, col = kv0 + c;
        Vs[c * DV + dd] =
            col < T_ ? to_f(v[(((size_t)b * T_ + col) * hk + kh) * DV + dd]) : 0.f;
      }
    }
    __syncthreads();

    // a full-mask tile wholly inside [0, T) with no column mask: every
    // score is visible
    const bool whole = full && allowed == nullptr && kv0 + BN <= T_;
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DQK; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QS + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KS + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, col = kv0 + c;
        const bool ok = whole || (col < T_ && col <= lim_s[rr] && col >= lo_s[rr] &&
                                  (allowed == nullptr || allowed[(size_t)b * T_ + col] != 0));
        Ps[rr * PS + c] = ok ? sc[i][j] : -INFINITY;
      }
    }
    __syncthreads();

    {  // online softmax: four neighbouring lanes per row
      const int rr = tid >> 2, part = tid & 3;
      float mx = -INFINITY;
      for (int c = part; c < BN; c += 4) mx = fmaxf(mx, Ps[rr * PS + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[rr];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = part; c < BN; c += 4) {
        const float sv = Ps[rr * PS + c];
        const float p = sv == -INFINITY ? 0.f : expf(sv - m_new);
        Ps[rr * PS + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        m_s[rr] = m_new;
        l_s[rr] = l_s[rr] * alpha + sum;
        a_s[rr] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) vv[jj] = Vs[c * DV + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = ty + 16 * i, r = r0 + rr;
    if (r >= rows) continue;
    const int j = r / S, s = r % S;
    const float l = l_s[rr];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = out + (((size_t)b * S + s) * H + kh * g + j) * DV;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) orow[tx + 16 * jj] = from_f<T>(acc[i][jj] * inv);
  }
  if (lse != nullptr && tid < BM && r0 + tid < rows) {
    const int r = r0 + tid, j = r / S, s = r % S;
    const float l = l_s[tid];
    lse[((size_t)b * H + kh * g + j) * S + s] = l > 0.f ? m_s[tid] + logf(l) : -INFINITY;
  }
}

// ------------------------------------------------------------------ bf16 --

// A block is 4 warps of 16 query rows (BM = 64, 128 threads): two blocks
// share an SM (up to 255 registers a thread; 85 KB or 109 KB of shared
// memory each) and fall out of step, so one block's softmax overlaps the
// other's products. Measured on the H100 against 8 warps (one block an SM)
// and against two 16-row m-tiles a warp (each K / V fragment feeding two
// products, but at 255 registers with spills): the fastest at every
// attention row of chip_smoke.py's phase 2.
constexpr int TC_WARPS = 4;             // warps per block
constexpr int TC_BM = TC_WARPS * 16;    // query rows per block
constexpr int TC_BN = 64;               // key rows per tile
constexpr int TC_NT = TC_WARPS * 32;    // threads per block

// shared memory of the bf16 body: the Q tile and two stages of K and V,
// rows padded by tc::PAD (85 KB at (128, 128), 109 KB at (192, 128))
template <int DQK, int DV> constexpr size_t tc_smem_bytes() {
  return (size_t)(TC_BM * (DQK + tc::PAD) + 2 * TC_BN * (DQK + tc::PAD) +
                  2 * TC_BN * (DV + tc::PAD)) *
         sizeof(__nv_bfloat16);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(TC_NT, 2)
append_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const uint8_t* __restrict__ allowed,
                           __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                           int S, int T_, int hk, int g, int pos, int window, bool full,
                           float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int QS = DQK + tc::PAD, VS = DV + tc::PAD;
  constexpr int KQ = DQK / 16;  // k-steps of q k^T
  constexpr int NO = DV / 8;    // C blocks of a warp's output rows
  constexpr int NS = TC_BN / 8; // C blocks of a warp's scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BM][QS]
  bf16* Ks = Qs + TC_BM * QS;                     // [2][BN][QS]
  bf16* Vs = Ks + 2 * TC_BN * QS;                 // [2][BN][VS]

  const int b = blockIdx.z;
  const int rows = g * S, H = hk * g;
  // the longest causal tiles first, over all heads of the batch row: the
  // blocks launch in the order of L, and the L-th takes the (L / H)-th
  // last tile of head L % H (its KV head kh = L % hk), so the last
  // positions of every head start before any head's first ones
  int tile, kh = blockIdx.y;
  if (S % TC_BM == 0) {
    const int per_head = S / TC_BM;
    const int L = blockIdx.y * gridDim.x + blockIdx.x;
    kh = L % H % hk;
    tile = (L % H / hk) * per_head + per_head - 1 - L / H;
  } else {
    tile = gridDim.x - 1 - blockIdx.x;
  }
  const int r0 = tile * TC_BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;

  for (int i = tid; i < TC_BM * (DQK / 8); i += TC_NT) {
    const int rr = i / (DQK / 8), ch = i % (DQK / 8), r = r0 + rr;
    const bool ok = r < rows;
    const bf16* src = q;
    if (ok) src = q + (((size_t)b * S + r % S) * H + kh * g + r / S) * DQK + ch * 8;
    tc::cp_async16(Qs + rr * QS + ch * 8, src, ok);
  }
  auto load_kv = [&](int stage, int kv0) {
    bf16* ks = Ks + stage * TC_BN * QS;
    bf16* vs = Vs + stage * TC_BN * VS;
    for (int i = tid; i < TC_BN * (DQK / 8); i += TC_NT) {
      const int c = i / (DQK / 8), ch = i % (DQK / 8), col = kv0 + c;
      const bool ok = col < T_;
      const bf16* src = ok ? k + (((size_t)b * T_ + col) * hk + kh) * DQK + ch * 8 : k;
      tc::cp_async16(ks + c * QS + ch * 8, src, ok);
    }
    for (int i = tid; i < TC_BN * (DV / 8); i += TC_NT) {
      const int c = i / (DV / 8), ch = i % (DV / 8), col = kv0 + c;
      const bool ok = col < T_;
      const bf16* src = ok ? v + (((size_t)b * T_ + col) * hk + kh) * DV + ch * 8 : v;
      tc::cp_async16(vs + c * VS + ch * 8, src, ok);
    }
  };

  // the tiles some row of the block sees: past the largest visible column
  // of its rows nothing is loaded, nor with a window below the smallest
  // row's band
  const int r_last = min(r0 + TC_BM, rows) - 1;
  const bool one_head = r0 / S == r_last / S;
  const int s_max = one_head ? r_last % S : S - 1;
  const int s_min = one_head ? r0 % S : 0;
  const int kv_end = full ? T_ : min(T_, pos + s_max + 1);
  const int kv_begin = window > 0 ? max(0, pos + s_min - window + 1) / TC_BN * TC_BN : 0;

  if (kv_begin < kv_end) load_kv(0, kv_begin);
  tc::cp_async_commit();

  // this thread's two rows (gid and gid + 8 of the warp's 16): the
  // visible columns are lo <= t <= lim; a row past the last one sees none
  int lim[2], lo[2];
  int lim_min = INT_MAX, lim_max = -1, lo_min = INT_MAX, lo_max = INT_MIN;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = r0 + warp * 16 + gid + 8 * h2;
    lim[h2] = -1;
    lo[h2] = 0;
    if (r < rows) {
      const int s = r % S;
      lim[h2] = full ? T_ - 1 : pos + s;
      lo[h2] = window > 0 ? pos + s - window + 1 : 0;
      lim_min = min(lim_min, lim[h2]);
      lim_max = max(lim_max, lim[h2]);
      lo_min = min(lo_min, lo[h2]);
      lo_max = max(lo_max, lo[h2]);
    }
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {  // the warp's 16 rows
    lim_min = min(lim_min, __shfl_xor_sync(0xffffffffu, lim_min, o));
    lim_max = max(lim_max, __shfl_xor_sync(0xffffffffu, lim_max, o));
    lo_min = min(lo_min, __shfl_xor_sync(0xffffffffu, lo_min, o));
    lo_max = max(lo_max, __shfl_xor_sync(0xffffffffu, lo_max, o));
  }

  tc::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KQ][4];  // q's A fragments, held for the whole loop
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk)
    tc::ldsm_x4(qf[kk], Qs + tc::a_off(warp * 16, kk * 16, QS, lane));

  const float sl2 = scale * 1.4426950408889634f;  // scores in log2 units
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m in log2 units

  int stage = 0;
  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += TC_BN, stage ^= 1) {
    // this tile has landed and every warp is done with the other stage,
    // which then takes the next tile while this one computes
    tc::cp_async_wait<0>();
    __syncthreads();
    if (kv0 + TC_BN < kv_end) {
      load_kv(stage ^ 1, kv0 + TC_BN);
      tc::cp_async_commit();
    }
    // a tile none of the warp's rows sees adds nothing
    if (kv0 > lim_max || kv0 + TC_BN - 1 < lo_min) continue;

    const bf16* ks = Ks + stage * TC_BN * QS;
    const bf16* vs = Vs + stage * TC_BN * VS;
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb[4];
        tc::ldsm_x4(kb, ks + tc::b_off(np * 16, kk * 16, QS, lane));
        tc::mma(sc[2 * np], qf[kk], kb[0], kb[1]);
        tc::mma(sc[2 * np + 1], qf[kk], kb[2], kb[3]);
      }

    // only tiles that cross an edge compare per element
    const bool whole = allowed == nullptr && kv0 + TC_BN <= T_ &&
                       kv0 + TC_BN - 1 <= lim_min && kv0 >= lo_max;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h2 = e >> 1, col = kv0 + n * 8 + 2 * tig + (e & 1);
        if (!whole && !(col < T_ && col <= lim[h2] && col >= lo[h2] &&
                        (allowed == nullptr || allowed[(size_t)b * T_ + col] != 0)))
          sc[n][e] = -INFINITY;
        mx[h2] = fmaxf(mx[h2], sc[n][e]);
      }
    float alpha[2], m_safe[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
      const float m_new = fmaxf(m[h2], mx[h2] * sl2);  // scale > 0
      m_safe[h2] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h2] = exp2f(m[h2] - m_safe[h2]);
      m[h2] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sc[n][e], sl2, -m_safe[e >> 1]));
        sc[n][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) l[h2] = l[h2] * alpha[h2] + rs[h2];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // P v, P as two bf16 terms: the score blocks 2 kk and 2 kk + 1 are the
    // A fragments
#pragma unroll
    for (int kk = 0; kk < TC_BN / 16; ++kk) {
      uint32_t ph[4], pl[4];
      tc::a_from_c(ph, pl, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t vb[4];
        tc::ldsm_x4_t(vb, vs + tc::bt_off(kk * 16, np * 16, VS, lane));
        tc::mma(acc[2 * np], ph, vb[0], vb[1]);
        tc::mma(acc[2 * np + 1], ph, vb[2], vb[3]);
        tc::mma(acc[2 * np], pl, vb[0], vb[1]);
        tc::mma(acc[2 * np + 1], pl, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = r0 + warp * 16 + gid + 8 * h2;
    if (r >= rows) continue;
    const int j = r / S, s = r % S;
    const float inv = l[h2] > 0.f ? 1.f / l[h2] : 0.f;
    bf16* orow = out + (((size_t)b * S + s) * H + kh * g + j) * DV + 2 * tig;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          tc::pack(acc[n][2 * h2] * inv, acc[n][2 * h2 + 1] * inv);
    if (lse != nullptr && tig == 0)
      lse[((size_t)b * H + kh * g + j) * S + s] =
          l[h2] > 0.f ? m[h2] * 0.6931471805599453f + logf(l[h2]) : -INFINITY;
  }
}

template <int DQK, int DV>
int launch_tc(const void* q, const void* k, const void* v, const uint8_t* allowed,
              void* out, float* lse, int B, int S, int T_, int H, int hk, int pos,
              int window, bool full, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  auto kernel = append_attention_tc_kernel<DQK, DV>;
  constexpr size_t smem = tc_smem_bytes<DQK, DV>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int g = H / hk;
  dim3 grid((g * S + TC_BM - 1) / TC_BM, hk, B);
  kernel<<<grid, TC_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), allowed, static_cast<bf16*>(out), lse, S, T_, hk, g,
      pos, window, full, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DQK, int DV>
int launch(const void* q, const void* k, const void* v, const uint8_t* allowed, void* out,
           float* lse, int B, int S, int T_, int H, int hk, int pos, int window,
           bool full, float scale, cudaStream_t stream) {
  auto kernel = append_attention_kernel<T, DQK, DV>;
  constexpr size_t smem = smem_bytes<DQK, DV>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int g = H / hk;
  dim3 grid(B, hk, (g * S + BM - 1) / BM);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      allowed, static_cast<T*>(out), lse, S, T_, hk, g, pos, window, full, scale);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_dtype(const void* q, const void* k, const void* v, const uint8_t* a, void* out,
                 float* l, int B, int S, int T_, int H, int hk, int pos, int window,
                 bool full, float scale, int dtype, cudaStream_t s) {
  if (dtype == 1)
    return launch_tc<DQK, DV>(q, k, v, a, out, l, B, S, T_, H, hk, pos, window, full,
                              scale, s);
  return launch<float, DQK, DV>(q, k, v, a, out, l, B, S, T_, H, hk, pos, window, full,
                                scale, s);
}

}  // namespace

// q [B, S, H, dqk]; k [B, T, hk, dqk]; v [B, T, hk, dv]; out [B, S, H, dv];
// (dqk, dv) is (128, 128) or (192, 128); allowed [B, T] bytes or null;
// lse [B, H, S] f32 or null; kind 0 = causal at pos (window 0), 1 = local
// (window > 0: query s sees only columns pos + s - window < t <= pos + s),
// 2 = full (window 0, pos not read). dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after launch, or cudaErrorInvalidValue for
// widths the kernel is not instantiated at or a kind and window that
// disagree.
extern "C" int pt_append_attention(const void* q, const void* k, const void* v,
                                   const void* allowed, void* out, void* lse, int B,
                                   int S, int T_, int H, int hk, int dqk, int dv, int pos,
                                   int window, float scale, int kind, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* a = static_cast<const uint8_t*>(allowed);
  float* l = static_cast<float*>(lse);
  if (kind < 0 || kind > 2 || (kind == 1) != (window > 0))
    return (int)cudaErrorInvalidValue;
  const bool full = kind == 2;
  if (dqk == 128 && dv == 128)
    return launch_dtype<128, 128>(q, k, v, a, out, l, B, S, T_, H, hk, pos, window, full,
                                  scale, dtype, s);
  if (dqk == 192 && dv == 128)
    return launch_dtype<192, 128>(q, k, v, a, out, l, B, S, T_, H, hk, pos, window, full,
                                  scale, dtype, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
