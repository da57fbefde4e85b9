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
// Three launches, the same for both bodies, the longest tiles first where
// the work is uneven (in the bf16 body over all heads of a batch row, not
// head by head), deterministic (no atomics: the g heads of a KV head are
// summed inside one block):
// 1. delta = rowsum(dout * out) in f32, [B, H, S]: one warp per row.
// 2. dk/dv: one block per KV tile of a KV head. It keeps its K and V tile
//    in shared memory and loops over the g = H / hk query heads of its KV
//    head (one for DeepSeek's MLA) and, for each, over the q tiles that see
//    the tile: from the first one (the diagonal; the first tile under the
//    full mask) to the end, or with a window to the tile of the last row
//    whose band still reaches the tile's last column. It recomputes P and
//    dS = P * (dout v^T - delta) and accumulates dV += P^T dout and
//    dK += dS^T q in registers; dk = scale * dK.
// 3. dq: one block per q tile of a head. It keeps its q and dout tile and
//    loops over the KV tiles it sees: from the tile of its first row's band
//    start (0 without a window) to the diagonal (every tile under the full
//    mask), accumulating dQ += dS K; dq = scale * dQ.
// With a window both loops skip the tiles outside the band, so the work is
// O(S * window), as splash's block-sparse mask info makes it. Masked
// entries of P are exactly 0, so they add nothing to any sum.
//
// bf16 (training): `flash_bwd_dkdv_tc_kernel`, `flash_bwd_dq_tc_kernel`.
// - Products on the tensor cores: mma.sync m16n8k16, bf16 operands, f32
//   accumulators (csrc/tensor_core.cuh), not wgmma: five products with
//   transposed operands are plain ldmatrix / ldmatrix.trans addressing with
//   mma.sync, where wgmma would need a descriptor and layout for each.
// - Tiles of 64 q rows by 64 keys. Q, dout, K and V are bf16 in shared
//   memory, rows padded by 8 elements; the operand that streams (Q and
//   dout in dk/dv, K and V in dq) runs through two stages filled by
//   16-byte cp.async copies, the next tile loading while this one
//   computes, behind one __syncthreads() a tile.
// - dk/dv block: 8 warps. For S = q k^T and dP = dout v^T a warp takes 16
//   q rows by 32 keys; P = exp2(scale log2e S - log2e lse) and dS are
//   computed in registers and stored to shared memory, and dV += P^T dout,
//   dK += dS^T q read them back through ldmatrix.trans, each warp owning 16
//   keys by half the width: at (192, 128) dK 16 x 96 and dV 16 x 64 in
//   registers, 80 f32 a thread. 139 KB of shared memory at (128, 128), 163
//   KB at (192, 128): one block an SM.
// - dq block: 4 warps of 16 q rows, the whole 64-key tile each: dS stays in
//   registers, its C blocks the A fragments of dQ += dS K (K through
//   ldmatrix.trans). 102 KB and 126 KB of shared memory.
// - Rounding against splash: splash rounds P to bf16 for dV and dS for dK
//   and dQ. Here each enters its products as two bf16 terms, hi = bf16(x)
//   and lo = bf16(x - hi) (16 bits of x): rounded once, the gradients of a
//   causal or windowed training step went outside the port's tolerance
//   (2e-3 + 2^-7 |p|) on the rows that see few keys, where dS's sums cancel
//   (tests/test_torch_flash_rounding.py models both). That adds 40% to the
//   backward's tensor-core work.
//
// f32 (the wiring checks, card against CPU): `flash_bwd_dkdv_kernel`,
// `flash_bwd_dq_kernel`, the first port's bodies, kept as they were: f32
// FMAs on the CUDA cores from padded shared-memory tiles (odd row strides),
// grids (B, hk, T / 64) and (B, H, S / 64), P and dS staged in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

// ------------------------------------------------------------------- f32 --

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

// ------------------------------------------------------------------ bf16 --

constexpr int TB = 64;       // query rows and key rows per tile
constexpr int TC_DKDV_NT = 256;  // 8 warps: 4 row groups of 16 x 2 column halves
constexpr int TC_DQ_NT = 128;    // 4 warps of 16 query rows
constexpr int PP = TB + tc::PAD;  // row stride of the P and dS tiles

template <int DQK, int DV> struct TcWidths {
  static_assert(DQK % 32 == 0 && DV % 32 == 0, "head widths");
  static constexpr int QS = DQK + tc::PAD;  // q and k rows
  static constexpr int VS = DV + tc::PAD;   // v and dout rows
  // K, V; two stages of Q and dO; P and dS, each as hi and lo bf16 terms;
  // two stages of lse and delta (f32): 139 KB at (128, 128), 163 KB at
  // (192, 128)
  static constexpr size_t dkdv_smem =
      (size_t)(TB * QS + TB * VS + 2 * TB * QS + 2 * TB * VS + 4 * TB * PP) *
          sizeof(__nv_bfloat16) +
      4 * TB * sizeof(float);
  // Q, dO; two stages of K and V: 102 KB at (128, 128), 126 KB at (192, 128)
  static constexpr size_t dq_smem =
      (size_t)(TB * QS + TB * VS + 2 * TB * QS + 2 * TB * VS) * sizeof(__nv_bfloat16);
};

// rows [row0, row0 + 64) of one head of a [B, n_rows, n_heads, W] bf16
// tensor into a padded shared tile, asynchronously; rows past n_rows are 0
template <int W>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ src, int b,
                                          int row0, int n_rows, int n_heads, int head,
                                          int nt) {
  for (int i = threadIdx.x; i < TB * (W / 8); i += nt) {
    const int rr = i / (W / 8), ch = i % (W / 8), row = row0 + rr;
    const bool ok = row < n_rows;
    const __nv_bfloat16* from =
        ok ? src + (((size_t)b * n_rows + row) * n_heads + head) * W + ch * 8 : src;
    tc::cp_async16(dst + rr * (W + tc::PAD) + ch * 8, from, ok);
  }
}

// s = A B^T over the width W for one warp: A's 16 rows at a_row0 of the
// tile `a`, B's rows [b_row0, b_row0 + 8 NB) of the tile `bt` (both
// row-major, stride W + PAD), accumulated into NB C blocks
template <int W, int NB>
__device__ __forceinline__ void product_abt(float (&s)[NB][4], const __nv_bfloat16* a,
                                            int a_row0, const __nv_bfloat16* bt,
                                            int b_row0, int lane) {
  constexpr int LD = W + tc::PAD;
#pragma unroll
  for (int n = 0; n < NB; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    uint32_t af[4];
    tc::ldsm_x4(af, a + tc::a_off(a_row0, kk * 16, LD, lane));
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      uint32_t bf[4];
      tc::ldsm_x4(bf, bt + tc::b_off(b_row0 + np * 16, kk * 16, LD, lane));
      tc::mma(s[2 * np], af, bf[0], bf[1]);
      tc::mma(s[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// visible (query s, key col) under the mask of the C interface
__device__ __forceinline__ bool visible(int s, int col, int S, int T_, int pos,
                                        int window, bool full) {
  return s < S && col < T_ &&
         (full || (col <= s + pos && (window == 0 || col > s + pos - window)));
}

// whether every (query, key) of rows [s0, s0 + ns) and columns
// [c0, c0 + 64) is visible: no per-element compare needed
__device__ __forceinline__ bool all_visible(int s0, int ns, int c0, int S, int T_,
                                            int pos, int window, bool full) {
  return s0 + ns <= S && c0 + TB <= T_ &&
         (full || (c0 + TB - 1 <= s0 + pos && (window == 0 || c0 > s0 + ns - 1 + pos - window)));
}

template <int DQK, int DV>
__global__ void __launch_bounds__(TC_DKDV_NT, 1)
flash_bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                         int S, int T_, int hk, int g, int pos, int window, bool full,
                         float scale) {
  using bf16 = __nv_bfloat16;
  using W = TcWidths<DQK, DV>;
  constexpr int QS = W::QS, VS = W::VS;
  constexpr int NK = DQK / 16, NV = DV / 16;  // C blocks of a warp's dK, dV half
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [64][QS]
  bf16* Vs = Ks + TB * QS;                        // [64][VS]
  bf16* Qs = Vs + TB * VS;                        // [2][64][QS]
  bf16* dOs = Qs + 2 * TB * QS;                   // [2][64][VS]
  bf16* Ps = dOs + 2 * TB * VS;                   // [hi, lo][64 q][PP], P
  bf16* dSs = Ps + 2 * TB * PP;                   // [hi, lo][64 q][PP], dS
  float* lse_s = reinterpret_cast<float*>(dSs + 2 * TB * PP);  // [2][64]
  float* dl_s = lse_s + 2 * TB;                             // [2][64]

  // blocks launch in the order of L: the L-th takes KV tile L / hk of KV
  // head L % hk, so the causal mask's longest tiles (the first keys) of
  // every KV head start first
  const int L = blockIdx.y * gridDim.x + blockIdx.x;
  const int kv0 = L / hk * TB, kh = L % hk, b = blockIdx.z;
  const int H = hk * g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // row group, column half

  copy_tile<DQK>(Ks, k, b, kv0, T_, hk, kh, TC_DKDV_NT);
  copy_tile<DV>(Vs, v, b, kv0, T_, hk, kh, TC_DKDV_NT);

  // the first query row that sees column kv0 is kv0 - pos (row 0 under
  // the full mask); with a window the last one that sees column
  // kv0 + 63 is kv0 + 63 - pos + window - 1
  const int q_first = full ? 0 : max(0, kv0 - pos) / TB * TB;
  const int q_end = window > 0 ? min(S, kv0 + TB - 1 - pos + window) : S;
  const int n_qt = q_end > q_first ? (q_end - q_first + TB - 1) / TB : 0;
  const int n_it = g * n_qt;  // (head, q tile) pairs, heads outermost

  auto load_q = [&](int st, int it) {
    const int h = kh * g + it / n_qt, q0 = q_first + (it % n_qt) * TB;
    copy_tile<DQK>(Qs + st * TB * QS, q, b, q0, S, H, h, TC_DKDV_NT);
    copy_tile<DV>(dOs + st * TB * VS, dout, b, q0, S, H, h, TC_DKDV_NT);
    if (tid < TB) {
      const int s = q0 + tid;
      lse_s[st * TB + tid] = s < S ? lse[((size_t)b * H + h) * S + s] * 1.4426950408889634f : 0.f;
      dl_s[st * TB + tid] = s < S ? delta[((size_t)b * H + h) * S + s] : 0.f;
    }
  };
  if (n_it > 0) load_q(0, 0);
  tc::cp_async_commit();

  // dV[16 wm + .., (DV / 2) wn + ..], dK[16 wm + .., (DQK / 2) wn + ..]
  float adv[NV][4], adk[NK][4];
#pragma unroll
  for (int n = 0; n < NV; ++n) adv[n][0] = adv[n][1] = adv[n][2] = adv[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NK; ++n) adk[n][0] = adk[n][1] = adk[n][2] = adk[n][3] = 0.f;
  const float sl2 = scale * 1.4426950408889634f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    // this pair's tiles have landed and every warp is done with the other
    // stage and with P and dS, so the next pair loads while this computes
    tc::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_it) {
      load_q(st ^ 1, it + 1);
      tc::cp_async_commit();
    }
    const int q0 = q_first + (it % n_qt) * TB;
    const bf16* qs = Qs + st * TB * QS;
    const bf16* dos = dOs + st * TB * VS;

    // S and dP for query rows 16 wm + .., key columns 32 wn + ..
    float sc[4][4], dp[4][4];
    product_abt<DQK, 4>(sc, qs, 16 * wm, Ks, 32 * wn, lane);
    product_abt<DV, 4>(dp, dos, 16 * wm, Vs, 32 * wn, lane);
    const bool whole = all_visible(q0, TB, kv0, S, T_, pos, window, full);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int rr = 16 * wm + gid + 8 * h2, s = q0 + rr;
      const float l2 = lse_s[st * TB + rr], dl = dl_s[st * TB + rr];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = 32 * wn + 8 * n + 2 * tig;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = whole || visible(s, kv0 + c + e, S, T_, pos, window, full);
          p[e] = ok ? exp2f(sc[n][2 * h2 + e] * sl2 - l2) : 0.f;
          ds[e] = p[e] * (dp[n][2 * h2 + e] - dl);
        }
        uint32_t hi, lo;
        tc::split(hi, lo, p[0], p[1]);
        *reinterpret_cast<uint32_t*>(Ps + rr * PP + c) = hi;
        *reinterpret_cast<uint32_t*>(Ps + TB * PP + rr * PP + c) = lo;
        tc::split(hi, lo, ds[0], ds[1]);
        *reinterpret_cast<uint32_t*>(dSs + rr * PP + c) = hi;
        *reinterpret_cast<uint32_t*>(dSs + TB * PP + rr * PP + c) = lo;
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T q over the tile's 64 query rows, P and
    // dS each as two bf16 terms
#pragma unroll
    for (int kk = 0; kk < TB / 16; ++kk) {
      // P^T's and dS^T's A fragments: P and dS are stored [q][key], so
      // ldmatrix.trans of the addresses b_off gives for n-major tiles
      const int off = tc::b_off(kk * 16, 16 * wm, PP, lane);
      uint32_t ph[4], pl[4], dh[4], dl[4];
      tc::ldsm_x4_t(ph, Ps + off);
      tc::ldsm_x4_t(pl, Ps + TB * PP + off);
      tc::ldsm_x4_t(dh, dSs + off);
      tc::ldsm_x4_t(dl, dSs + TB * PP + off);
#pragma unroll
      for (int np = 0; np < NV / 2; ++np) {
        uint32_t ob[4];
        tc::ldsm_x4_t(ob, dos + tc::bt_off(kk * 16, (DV / 2) * wn + np * 16, VS, lane));
        tc::mma(adv[2 * np], ph, ob[0], ob[1]);
        tc::mma(adv[2 * np + 1], ph, ob[2], ob[3]);
        tc::mma(adv[2 * np], pl, ob[0], ob[1]);
        tc::mma(adv[2 * np + 1], pl, ob[2], ob[3]);
      }
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t qb[4];
        tc::ldsm_x4_t(qb, qs + tc::bt_off(kk * 16, (DQK / 2) * wn + np * 16, QS, lane));
        tc::mma(adk[2 * np], dh, qb[0], qb[1]);
        tc::mma(adk[2 * np + 1], dh, qb[2], qb[3]);
        tc::mma(adk[2 * np], dl, qb[0], qb[1]);
        tc::mma(adk[2 * np + 1], dl, qb[2], qb[3]);
      }
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int col = kv0 + 16 * wm + gid + 8 * h2;
    if (col >= T_) continue;
    const size_t row = ((size_t)b * T_ + col) * hk + kh;
    bf16* dkr = dk + row * DQK + (DQK / 2) * wn + 2 * tig;
    bf16* dvr = dv + row * DV + (DV / 2) * wn + 2 * tig;
#pragma unroll
    for (int n = 0; n < NK; ++n)
      *reinterpret_cast<uint32_t*>(dkr + 8 * n) =
          tc::pack(adk[n][2 * h2] * scale, adk[n][2 * h2 + 1] * scale);
#pragma unroll
    for (int n = 0; n < NV; ++n)
      *reinterpret_cast<uint32_t*>(dvr + 8 * n) =
          tc::pack(adv[n][2 * h2], adv[n][2 * h2 + 1]);
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(TC_DQ_NT)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int S, int T_, int H, int g, int pos,
                       int window, bool full, float scale) {
  using bf16 = __nv_bfloat16;
  using W = TcWidths<DQK, DV>;
  constexpr int QS = W::QS, VS = W::VS;
  constexpr int NQ = DQK / 8;  // C blocks of a warp's dQ rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][QS]
  bf16* dOs = Qs + TB * QS;                       // [64][VS]
  bf16* Ks = dOs + TB * VS;                       // [2][64][QS]
  bf16* Vs = Ks + 2 * TB * QS;                    // [2][64][VS]

  // the L-th block to launch takes the (L / H)-th last q tile of head
  // L % H: every head's last (longest causal) tiles first
  const int L = blockIdx.y * gridDim.x + blockIdx.x;
  const int h = L % H, b = blockIdx.z, kh = h / g, hk = H / g;
  const int q0 = (gridDim.x - 1 - L / H) * TB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;

  copy_tile<DQK>(Qs, q, b, q0, S, H, h, TC_DQ_NT);
  copy_tile<DV>(dOs, dout, b, q0, S, H, h, TC_DQ_NT);
  // columns past the last row's diagonal are never visible, nor with a
  // window those before the first row's band; the full mask sees them all
  const int kv_end = full ? T_ : min(T_, min(S, q0 + TB) - 1 + pos + 1);
  const int kv_begin = window > 0 ? max(0, q0 + pos - window + 1) / TB * TB : 0;
  auto load_kv = [&](int st, int kv0) {
    copy_tile<DQK>(Ks + st * TB * QS, k, b, kv0, T_, hk, kh, TC_DQ_NT);
    copy_tile<DV>(Vs + st * TB * VS, v, b, kv0, T_, hk, kh, TC_DQ_NT);
  };
  if (kv_begin < kv_end) load_kv(0, kv_begin);
  tc::cp_async_commit();

  // this thread's rows 16 warp + gid (+ 8): lse in log2 units, delta
  float l2[2], dl[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int s = q0 + 16 * warp + gid + 8 * h2;
    l2[h2] = s < S ? lse[((size_t)b * H + h) * S + s] * 1.4426950408889634f : 0.f;
    dl[h2] = s < S ? delta[((size_t)b * H + h) * S + s] : 0.f;
  }
  const int s_lo = q0 + 16 * warp;  // the warp's rows s_lo .. s_lo + 15
  const float sl2 = scale * 1.4426950408889634f;
  float acc[NQ][4];
#pragma unroll
  for (int n = 0; n < NQ; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int st = 0;
  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += TB, st ^= 1) {
    // this tile has landed and every warp is done with the other stage,
    // which then takes the next tile while this one computes
    tc::cp_async_wait<0>();
    __syncthreads();
    if (kv0 + TB < kv_end) {
      load_kv(st ^ 1, kv0 + TB);
      tc::cp_async_commit();
    }
    // a tile none of the warp's rows sees adds nothing
    const bool seen = s_lo < S && (full || (kv0 <= min(s_lo + 15, S - 1) + pos &&
                                            (window == 0 || kv0 + TB - 1 > s_lo + pos - window)));
    if (seen) {
      const bf16* ks = Ks + st * TB * QS;
      const bf16* vs = Vs + st * TB * VS;
      float sc[8][4], dp[8][4];
      product_abt<DQK, 8>(sc, Qs, 16 * warp, ks, 0, lane);
      product_abt<DV, 8>(dp, dOs, 16 * warp, vs, 0, lane);
      const bool whole = all_visible(s_lo, 16, kv0, S, T_, pos, window, full);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h2 = e >> 1;
          const bool ok = whole || visible(s_lo + gid + 8 * h2, kv0 + 8 * n + 2 * tig + (e & 1),
                                           S, T_, pos, window, full);
          const float p = ok ? exp2f(sc[n][e] * sl2 - l2[h2]) : 0.f;
          sc[n][e] = p * (dp[n][e] - dl[h2]);  // dS
        }
      // dQ += dS K, dS as two bf16 terms
#pragma unroll
      for (int kk = 0; kk < TB / 16; ++kk) {
        uint32_t dh[4], dlo[4];
        tc::a_from_c(dh, dlo, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t kb[4];
          tc::ldsm_x4_t(kb, ks + tc::bt_off(kk * 16, np * 16, QS, lane));
          tc::mma(acc[2 * np], dh, kb[0], kb[1]);
          tc::mma(acc[2 * np + 1], dh, kb[2], kb[3]);
          tc::mma(acc[2 * np], dlo, kb[0], kb[1]);
          tc::mma(acc[2 * np + 1], dlo, kb[2], kb[3]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int s = s_lo + gid + 8 * h2;
    if (s >= S) continue;
    bf16* row = dq + (((size_t)b * S + s) * H + h) * DQK + 2 * tig;
#pragma unroll
    for (int n = 0; n < NQ; ++n)
      *reinterpret_cast<uint32_t*>(row + 8 * n) =
          tc::pack(acc[n][2 * h2] * scale, acc[n][2 * h2 + 1] * scale);
  }
}

template <int DQK, int DV>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* out,
                  const void* dout, const float* lse, float* delta, void* dq, void* dk,
                  void* dv, int B, int S, int T_, int H, int hk, int pos, int window,
                  bool full, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  using W = TcWidths<DQK, DV>;
  auto dkdv = flash_bwd_dkdv_tc_kernel<DQK, DV>;
  auto dqk = flash_bwd_dq_tc_kernel<DQK, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)W::dkdv_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)W::dq_smem);
  if (err != cudaSuccess) return (int)err;
  const int g = H / hk;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);

  const int rows = B * S * H;
  flash_bwd_delta_kernel<bf16, DV><<<(rows + NT / 32 - 1) / (NT / 32), NT, 0, stream>>>(
      static_cast<const bf16*>(out), dot, delta, rows, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  dkdv<<<dim3((T_ + TB - 1) / TB, hk, B), TC_DKDV_NT, W::dkdv_smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, T_,
      hk, g, pos, window, full, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  dqk<<<dim3((S + TB - 1) / TB, H, B), TC_DQ_NT, W::dq_smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dq), S, T_, H, g, pos, window, full,
      scale);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_typed(const void* q, const void* k, const void* v, const void* out,
                 const void* dout, const float* lse, float* delta, void* dq, void* dk,
                 void* dv, int B, int S, int T_, int H, int hk, int pos, int window,
                 bool full, float scale, int dtype, cudaStream_t stream) {
  if (dtype == 1)
    return launch_bwd_tc<DQK, DV>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, T_, H,
                                  hk, pos, window, full, scale, stream);
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
