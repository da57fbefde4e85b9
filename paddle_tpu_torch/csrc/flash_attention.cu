// Flash-attention backward for Hopper (sm_90a): dq, dk, dv with
// grouped-query heads, FlashAttention-2 style, in three launches.
//
// Replaces: the backward of the bundled splash attention kernel that
// paddle_tpu/ops/pallas/flash_attention.py `flash_attention_bshd` builds
// with `make_splash_mha` (`_splash_kernel`): splash's dq and dkv Pallas
// kernels, which its custom VJP runs, under its three masks, named by
// `kind` in the C interface:
// - kind 0, the bottom-aligned CausalMask at pos = s_kv - s_q: q row i sees
//   kv columns j <= i + pos;
// - kind 1, the sliding-window LocalMask(window_size=(window - 1, 0),
//   offset=pos) (window > 0): q row i sees j iff i + pos - window < j <=
//   i + pos;
// - kind 2, the FullMask: every row sees every column, for any S and T
//   (T < S included); pos is not read.
//
// Head widths: q/k width DQK and v width DV are template parameters,
// instantiated at (128, 128), the Llama families' heads, and (192, 128),
// DeepSeek's MLA training (qk_nope 128 + qk_rope 64 against v 128; the TPU
// path zero-pads them to 256 and 128 lanes, deepseek.py:125-143, which
// computes the same function). The window is taken at (128, 128) only.
//
// Inputs: q [B, S, H, DQK], dout and out [B, S, H, DV]; k [B, T, hk, DQK],
// v [B, T, hk, DV]; the f32 logsumexp lse [B, H, S] of the forward
// (csrc/append_attention.cu with an lse pointer and the same window);
// `scale` multiplies q k^T. Outputs dq, dk, dv in the input type; every sum
// runs in f32.
//
// Bound on the H100: operations. The backward recomputes P = exp(scale q k^T
// - lse) twice (once per dk/dv block, once per dq block) and runs five
// products per visible (query, key) pair and head: S (2 * DQK operations)
// and dP (2 * DV) in both kernels, dV (2 * DV), dK and dQ (2 * DQK each)
// once. At S = T = 4096 that is far above the card's ratio of operations to
// bytes.
//
// Design (simple and right first):
// 1. delta = rowsum(dout * out) in f32, [B, H, S]: one warp per row.
// 2. dk/dv: grid (B, hk, ceil(T / BC)). A block keeps its K and V tile in
//    shared memory and loops over the g = H / hk query heads of its KV head
//    (one head for DeepSeek's MLA, which has no GQA) and, for each, over the
//    q tiles that see the tile: from the first one
//    (the diagonal; the first tile under the full mask) to the end, or with
//    a window to the tile of the last row whose band still reaches the
//    tile's last column. It recomputes P
//    and dS = P * (dout v^T - delta) and accumulates dV += P^T dout and
//    dK += dS^T (scale q) in registers. The g heads are summed inside the
//    block: no atomics, the result is deterministic.
// 3. dq: grid (B, H, ceil(S / BR)), last q tiles first. A block keeps its q
//    and dout tile and loops over the KV tiles it sees: from the tile of
//    its first row's band start (0 without a window) to the diagonal (every
//    tile under the full mask), accumulating dQ += dS K; dq = scale * dQ.
// With a window both loops skip the tiles outside the band, so the work is
// O(S * window), as splash's block-sparse mask info makes it. Masked
// entries of P are exactly 0, so they add nothing to any sum. The products
// are f32 FMAs on CUDA cores from padded shared-memory tiles (odd row
// strides: conflict-free reads), as in the forward; tensor cores (mma.sync /
// wgmma) and TMA are later work. At (192, 128) a dk/dv block takes 194 KB of
// shared memory (K and Q at row stride 193, V and dout at 129, P and dS at
// 65) and keeps dK (64 x 192) and dV (64 x 128) in registers, 80 f32 a
// thread; a dq block 178 KB. Both fit under the 227 KB opt-in, one block per
// SM; the grids are (B, 16, T / 64) and (B, 16, S / 64) at V2-Lite's 16
// heads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BR = 64;     // query rows per tile
constexpr int BC = 64;     // key rows per tile
constexpr int NT = 256;    // threads per block (16 x 16)
constexpr int PS = BC + 1; // padded row stride of the [BR, BC] tiles

// shared-memory row strides (padded) and per-thread output columns of the
// (DQK, DV) instantiation, and its two kernels' shared memory
template <int DQK, int DV> struct Widths {
  static_assert(DQK >= DV && DQK % 16 == 0 && DV % 16 == 0, "head widths");
  static constexpr int QS = DQK + 1;  // q and k tiles
  static constexpr int VS = DV + 1;   // v and dout tiles
  static constexpr int NQ = DQK / 16; // dq / dk columns per thread
  static constexpr int NV = DV / 16;  // dv columns per thread
  // K, V, Q, dout tiles + P and dS + lse and delta
  static constexpr size_t dkdv_smem =
      (size_t)(BC * QS + BC * VS + BR * QS + BR * VS + 2 * BR * PS + 2 * BR) *
      sizeof(float);
  // Q, dout, K, V tiles + dS + lse and delta
  static constexpr size_t dq_smem =
      (size_t)(BR * QS + BR * VS + BC * QS + BC * VS + BR * PS + 2 * BR) *
      sizeof(float);
};

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

// rows [row0, row0 + 64) of one head of a [B, n_rows, n_heads, W] tensor
// into a padded f32 tile (row stride W + 1), times `mul`; rows past n_rows
// read as 0
template <int W, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int b,
                                          int row0, int n_rows, int n_heads, int head,
                                          float mul) {
  for (int i = threadIdx.x; i < 64 * W; i += NT) {
    const int rr = i / W, dd = i % W, row = row0 + rr;
    float val = 0.f;
    if (row < n_rows)
      val = to_f(src[(((size_t)b * n_rows + row) * n_heads + head) * W + dd]) * mul;
    dst[rr * (W + 1) + dd] = val;
  }
}

// s[i][j] = sum_d Q[ty + 16 i][d] K[tx + 16 j][d] over DQK and
// p[i][j] = sum_d dO[ty + 16 i][d] V[tx + 16 j][d] over DV, each a 4 x 4
// register tile: both products over the first DV columns, then S alone over
// the rest of q/k's width (none at (128, 128))
template <int DQK, int DV>
__device__ __forceinline__ void two_products(const float* Qs, const float* Ks,
                                             const float* dOs, const float* Vs, int tx,
                                             int ty, float (&s)[4][4], float (&p)[4][4]) {
  constexpr int QS = Widths<DQK, DV>::QS, VS = Widths<DQK, DV>::VS;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = p[i][j] = 0.f;
#pragma unroll 2
  for (int dd = 0; dd < DV; ++dd) {
    float xa[4], ya[4], xb[4], yb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xa[i] = Qs[(ty + 16 * i) * QS + dd];
      xb[i] = dOs[(ty + 16 * i) * VS + dd];
      ya[i] = Ks[(tx + 16 * i) * QS + dd];
      yb[i] = Vs[(tx + 16 * i) * VS + dd];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(xa[i], ya[j], s[i][j]);
        p[i][j] = fmaf(xb[i], yb[j], p[i][j]);
      }
  }
#pragma unroll 2
  for (int dd = DV; dd < DQK; ++dd) {
    float xa[4], ya[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xa[i] = Qs[(ty + 16 * i) * QS + dd];
      ya[i] = Ks[(tx + 16 * i) * QS + dd];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(xa[i], ya[j], s[i][j]);
  }
}

template <typename T, int DV>
__global__ void __launch_bounds__(NT)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int S, int H) {
  const int warp = (blockIdx.x * NT + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (warp >= rows) return;
  // warp = (b * S + s) * H + h, a row of the [B, S, H, DV] layout
  const size_t base = (size_t)warp * DV;
  float acc = 0.f;
#pragma unroll
  for (int dd = lane; dd < DV; dd += 32) acc += to_f(out[base + dd]) * to_f(dout[base + dd]);
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) {
    const int h = warp % H, bs = warp / H, s = bs % S, b = bs / S;
    delta[((size_t)b * H + h) * S + s] = acc;
  }
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int S, int T_, int hk, int g,
                      int pos, int window, bool full, float scale) {
  using W = Widths<DQK, DV>;
  constexpr int QS = W::QS, VS = W::VS, NQ = W::NQ, NV = W::NV;
  extern __shared__ float smem[];
  float* Ks = smem;              // [BC][QS]
  float* Vs = Ks + BC * QS;      // [BC][VS]
  float* Qs = Vs + BC * VS;      // [BR][QS], q * scale
  float* dOs = Qs + BR * QS;     // [BR][VS]
  float* Ps = dOs + BR * VS;     // [BR][PS]
  float* dSs = Ps + BR * PS;     // [BR][PS]
  float* lse_s = dSs + BR * PS;  // [BR]
  float* dl_s = lse_s + BR;      // [BR]

  const int b = blockIdx.x, kh = blockIdx.y, kv0 = blockIdx.z * BC;
  const int H = hk * g;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  load_tile<DQK>(Ks, k, b, kv0, T_, hk, kh, 1.f);
  load_tile<DV>(Vs, v, b, kv0, T_, hk, kh, 1.f);

  // dk[c][d] for d = tx + 16 jj < DQK, dv[c][d] for d = tx + 16 jj < DV,
  // c = ty + 16 i
  float adk[4][NQ], adv[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jj = 0; jj < NQ; ++jj) adk[i][jj] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NV; ++jj) adv[i][jj] = 0.f;
  }

  // the first query row that sees column kv0 is kv0 - pos (row 0 under
  // the full mask); with a window the last one that sees column
  // kv0 + BC - 1 is kv0 + BC - 1 - pos + window - 1
  const int q_first = full ? 0 : max(0, kv0 - pos) / BR * BR;
  const int q_end = window > 0 ? min(S, kv0 + BC - 1 - pos + window) : S;
  for (int j = 0; j < g; ++j) {
    const int h = kh * g + j;
    for (int q0 = q_first; q0 < q_end; q0 += BR) {
      load_tile<DQK>(Qs, q, b, q0, S, H, h, scale);
      load_tile<DV>(dOs, dout, b, q0, S, H, h, 1.f);
      if (tid < BR) {
        const int s = q0 + tid;
        lse_s[tid] = s < S ? lse[((size_t)b * H + h) * S + s] : 0.f;
        dl_s[tid] = s < S ? delta[((size_t)b * H + h) * S + s] : 0.f;
      }
      __syncthreads();

      float sc[4][4], dp[4][4];
      two_products<DQK, DV>(Qs, Ks, dOs, Vs, tx, ty, sc, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = ty + 16 * i, s = q0 + rr;
#pragma unroll
        for (int jc = 0; jc < 4; ++jc) {
          const int c = tx + 16 * jc, col = kv0 + c;
          const bool ok = s < S && col < T_ &&
                          (full || (col <= s + pos &&
                                    (window == 0 || col > s + pos - window)));
          const float p = ok ? expf(sc[i][jc] - lse_s[rr]) : 0.f;
          Ps[rr * PS + c] = p;
          dSs[rr * PS + c] = p * (dp[i][jc] - dl_s[rr]);
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int rr = 0; rr < BR; ++rr) {
        float pv[4], sv[4], ov[NV], qv[NQ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[rr * PS + ty + 16 * i];
          sv[i] = dSs[rr * PS + ty + 16 * i];
        }
#pragma unroll
        for (int jj = 0; jj < NV; ++jj) ov[jj] = dOs[rr * VS + tx + 16 * jj];
#pragma unroll
        for (int jj = 0; jj < NQ; ++jj) qv[jj] = Qs[rr * QS + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int jj = 0; jj < NV; ++jj) adv[i][jj] = fmaf(pv[i], ov[jj], adv[i][jj]);
#pragma unroll
          for (int jj = 0; jj < NQ; ++jj) adk[i][jj] = fmaf(sv[i], qv[jj], adk[i][jj]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = kv0 + ty + 16 * i;
    if (col >= T_) continue;
    const size_t row = ((size_t)b * T_ + col) * hk + kh;
#pragma unroll
    for (int jj = 0; jj < NQ; ++jj) dk[row * DQK + tx + 16 * jj] = from_f<T>(adk[i][jj]);
#pragma unroll
    for (int jj = 0; jj < NV; ++jj) dv[row * DV + tx + 16 * jj] = from_f<T>(adv[i][jj]);
  }
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int S, int T_, int H, int g, int pos, int window,
                    bool full, float scale) {
  using W = Widths<DQK, DV>;
  constexpr int QS = W::QS, VS = W::VS, NQ = W::NQ;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BR][QS], q * scale
  float* dOs = Qs + BR * QS;     // [BR][VS]
  float* Ks = dOs + BR * VS;     // [BC][QS]
  float* Vs = Ks + BC * QS;      // [BC][VS]
  float* dSs = Vs + BC * VS;     // [BR][PS]
  float* lse_s = dSs + BR * PS;  // [BR]
  float* dl_s = lse_s + BR;      // [BR]

  const int b = blockIdx.x, h = blockIdx.y, kh = h / g, hk = H / g;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BR;  // last tiles first
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  load_tile<DQK>(Qs, q, b, q0, S, H, h, scale);
  load_tile<DV>(dOs, dout, b, q0, S, H, h, 1.f);
  if (tid < BR) {
    const int s = q0 + tid;
    lse_s[tid] = s < S ? lse[((size_t)b * H + h) * S + s] : 0.f;
    dl_s[tid] = s < S ? delta[((size_t)b * H + h) * S + s] : 0.f;
  }

  float acc[4][NQ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NQ; ++jj) acc[i][jj] = 0.f;

  // columns past the last row's diagonal are never visible, nor with a
  // window those before the first row's band; the full mask sees them all
  const int kv_end = full ? T_ : min(T_, min(S, q0 + BR) - 1 + pos + 1);
  const int kv_begin = window > 0 ? max(0, q0 + pos - window + 1) / BC * BC : 0;
  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BC) {
    load_tile<DQK>(Ks, k, b, kv0, T_, hk, kh, 1.f);
    load_tile<DV>(Vs, v, b, kv0, T_, hk, kh, 1.f);
    __syncthreads();

    float sc[4][4], dp[4][4];
    two_products<DQK, DV>(Qs, Ks, dOs, Vs, tx, ty, sc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = ty + 16 * i, s = q0 + rr;
#pragma unroll
      for (int jc = 0; jc < 4; ++jc) {
        const int c = tx + 16 * jc, col = kv0 + c;
        const bool ok = s < S && col < T_ &&
                        (full || (col <= s + pos &&
                                  (window == 0 || col > s + pos - window)));
        const float p = ok ? expf(sc[i][jc] - lse_s[rr]) : 0.f;
        dSs[rr * PS + c] = p * (dp[i][jc] - dl_s[rr]);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BC; ++c) {
      float sv[4], kv[NQ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int jj = 0; jj < NQ; ++jj) kv[jj] = Ks[c * QS + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < NQ; ++jj) acc[i][jj] = fmaf(sv[i], kv[jj], acc[i][jj]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    T* row = dq + (((size_t)b * S + s) * H + h) * DQK;
#pragma unroll
    for (int jj = 0; jj < NQ; ++jj) row[tx + 16 * jj] = from_f<T>(acc[i][jj] * scale);
  }
}

template <typename T, int DQK, int DV>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* delta, void* dq, void* dk,
               void* dv, int B, int S, int T_, int H, int hk, int pos, int window,
               bool full, float scale, cudaStream_t stream) {
  using W = Widths<DQK, DV>;
  auto dkdv = flash_bwd_dkdv_kernel<T, DQK, DV>;
  auto dqk = flash_bwd_dq_kernel<T, DQK, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)W::dkdv_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)W::dq_smem);
  if (err != cudaSuccess) return (int)err;
  const int g = H / hk;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);

  const int rows = B * S * H;
  flash_bwd_delta_kernel<T, DV><<<(rows + NT / 32 - 1) / (NT / 32), NT, 0, stream>>>(
      static_cast<const T*>(out), dot, delta, rows, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  dkdv<<<dim3(B, hk, (T_ + BC - 1) / BC), NT, W::dkdv_smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, T_, hk, g,
      pos, window, full, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  dqk<<<dim3(B, H, (S + BR - 1) / BR), NT, W::dq_smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), S, T_, H, g, pos, window, full,
      scale);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_typed(const void* q, const void* k, const void* v, const void* out,
                 const void* dout, const float* lse, float* delta, void* dq, void* dk,
                 void* dv, int B, int S, int T_, int H, int hk, int pos, int window,
                 bool full, float scale, int dtype, cudaStream_t stream) {
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16, DQK, DV>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                              B, S, T_, H, hk, pos, window, full, scale,
                                              stream);
  return launch_bwd<float, DQK, DV>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, T_,
                                    H, hk, pos, window, full, scale, stream);
}

}  // namespace

// q, dq [B, S, H, dqk]; out, dout [B, S, H, dv]; k, dk [B, T, hk, dqk];
// v, dv [B, T, hk, dv]; lse, delta [B, H, S] f32 (delta is scratch, written
// here); kind 0 = causal at pos = T - S (window 0), 1 = local (window > 0:
// the band of the last `window` columns up to the diagonal), 2 = full
// (window 0, pos not read). (dqk, dv_width): (128, 128) or (192, 128), the
// window at (128, 128) only. dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the three launches (the first error stops the
// sequence), or cudaErrorInvalidValue for widths the kernel is not
// instantiated at or a kind and window that disagree.
extern "C" int pt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* out, const void* dout, const void* lse,
                                      void* delta, void* dq, void* dk, void* dv, int B,
                                      int S, int T_, int H, int hk, int pos, int window,
                                      int dqk, int dv_width, float scale, int kind,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (kind < 0 || kind > 2 || (kind == 1) != (window > 0))
    return (int)cudaErrorInvalidValue;
  const bool full = kind == 2;
  if (dqk == 128 && dv_width == 128)
    return launch_typed<128, 128>(q, k, v, out, dout, l, dl, dq, dk, dv, B, S, T_, H, hk,
                                  pos, window, full, scale, dtype, s);
  if (dqk == 192 && dv_width == 128 && window == 0)
    return launch_typed<192, 128>(q, k, v, out, dout, l, dl, dq, dk, dv, B, S, T_, H, hk,
                                  pos, window, full, scale, dtype, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
