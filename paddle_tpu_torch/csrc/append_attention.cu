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
// Design (simple and right first):
// - Grid (B, hk, ceil(g*S / BM)). The TPU grid of one cell per (b, kv head)
//   would give 8 blocks at prefill for 132 SMs; here each block takes a
//   tile of BM query rows of the g heads that share one KV head, so every
//   K/V tile staged in shared memory serves all of them.
// - Row r of a tile is query position s = r % S of head j = r / S, read
//   from the JAX layout q[B, S, hk, g, D] by index arithmetic.
// - Loop over KV tiles of BN rows with running max, sum and accumulator in
//   f32. Only the tiles some row of the block can see are loaded: the loop
//   starts at the tile of the first column of the lowest row's band (with
//   a window) and ends past the last visible column of the highest row
//   (the Pallas kernel's `cond` skip; splash's block-sparse mask info for
//   the LocalMask), so a windowed prefill does O(S * window) work. Masked
//   columns are -inf and contribute exactly 0, as in the plain einsum.
// - Products are f32 FMAs on CUDA cores from padded shared-memory tiles
//   (conflict-free reads). The tensor cores (mma.sync / wgmma) and TMA are
//   the next step; this kernel is the correctness baseline.
// - Optional f32 logsumexp `lse` [B, H, S] of the scaled scores over the
//   visible columns, the residual the flash backward
//   (csrc/flash_attention.cu) needs. It is written only when a pointer is
//   given, so serving launches skip it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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
    return launch<__nv_bfloat16, DQK, DV>(q, k, v, a, out, l, B, S, T_, H, hk, pos,
                                          window, full, scale, s);
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
