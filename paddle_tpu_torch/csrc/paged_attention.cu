// Paged decode attention for Hopper (sm_90a): one query token per row
// against its pages of the KV pool, grouped-query heads in-kernel.
//
// Replaces: the bundled Pallas kernel
// jax.experimental.pallas.ops.tpu.paged_attention.paged_attention, called
// from paddle_tpu/generation.py `paged_decode_attention`. Semantics follow
// the JAX package's reference `_paged_attention_ref` (scores scaled by
// 1/sqrt(D), columns t < lengths[b] visible).
//
// Bound on the H100: device-memory bytes. Each launch must read
// sum_b lengths[b] * hk * D * 2 (K and V) * es bytes of cache plus q and
// out; the products are 4 * H * D operations per visible token, far below
// the card's ratio of operations to bytes.
//
// Design (simple and right first):
// - Grid (B, hk), 128 threads. Each block loads its row's page indices
//   itself (no scalar prefetch on this card) and walks the visible tokens
//   in chunks of 32, keeping the g query rows of its KV head in shared
//   memory, so every K/V row read from device memory serves all g heads.
// - Scores: one warp per token, lanes split D, shuffle reduction.
//   Online softmax in f32 per query row; then thread d accumulates
//   p * V[t, d] for the g rows, reading each V row once, coalesced.
// - Later work: at small B the grid has B*hk blocks for 132 SMs, so one
//   long row is read by one SM; a split over pages (partial softmax per
//   split, then a combine pass) would spread it over many.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;   // head width, fixed; thread d owns column d
constexpr int CH = 32;   // tokens per chunk (one lane per token in softmax)
constexpr int NW = 4;    // warps per block

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

template <typename T, int G>
__global__ void __launch_bounds__(D)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const int* __restrict__ lengths,
                       const int* __restrict__ page_indices, T* __restrict__ out, int H,
                       int n_pages, int ps, int pps, float scale) {
  __shared__ float qs[G][D];
  __shared__ float sc[G][CH];
  __shared__ int phys_s[CH];
  __shared__ float m_s[G], l_s[G], a_s[G];

  const int b = blockIdx.x, kh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* prow = page_indices + (size_t)b * pps;
  const int len = min(lengths[b], pps * ps);

  for (int i = tid; i < G * D; i += D)
    qs[i / D][i % D] = to_f(q[((size_t)b * H + kh * G + i / D) * D + i % D]) * scale;
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[G];
#pragma unroll
  for (int j = 0; j < G; ++j) acc[j] = 0.f;
  __syncthreads();

  const size_t head_base = (size_t)kh * n_pages;
  for (int t0 = 0; t0 < len; t0 += CH) {
    if (tid < CH) {
      const int t = t0 + tid;
      phys_s[tid] = t < len ? prow[t / ps] : 0;
    }
    __syncthreads();

    for (int tt = warp; tt < CH; tt += NW) {
      const int t = t0 + tt;
      float part[G];
#pragma unroll
      for (int j = 0; j < G; ++j) part[j] = 0.f;
      if (t < len) {  // uniform across the warp
        const T* kr = kp + ((head_base + phys_s[tt]) * ps + t % ps) * D;
#pragma unroll
        for (int e = lane; e < D; e += 32) {
          const float kv = to_f(kr[e]);
#pragma unroll
          for (int j = 0; j < G; ++j) part[j] = fmaf(qs[j][e], kv, part[j]);
        }
#pragma unroll
        for (int j = 0; j < G; ++j)
          for (int o = 16; o > 0; o >>= 1)
            part[j] += __shfl_xor_sync(0xffffffffu, part[j], o);
      }
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < G; ++j) sc[j][tt] = t < len ? part[j] : -INFINITY;
      }
    }
    __syncthreads();

    for (int j = warp; j < G; j += NW) {  // online softmax, one lane per token
      const float sv = sc[j][lane];
      float mx = sv;
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[j];
      const float m_new = fmaxf(m_old, mx);
      const float p = sv == -INFINITY ? 0.f : expf(sv - m_new);
      float sum = p;
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sc[j][lane] = p;
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        m_s[j] = m_new;
        l_s[j] = l_s[j] * alpha + sum;
        a_s[j] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < G; ++j) acc[j] *= a_s[j];
    const int n = min(CH, len - t0);
    for (int tt = 0; tt < n; ++tt) {
      const int t = t0 + tt;
      const float vv = to_f(vp[((head_base + phys_s[tt]) * ps + t % ps) * D + tid]);
#pragma unroll
      for (int j = 0; j < G; ++j) acc[j] = fmaf(sc[j][tt], vv, acc[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < G; ++j) {
    const float l = l_s[j];
    out[((size_t)b * H + kh * G + j) * D + tid] = from_f<T>(l > 0.f ? acc[j] / l : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* lengths,
           const int* page_indices, void* out, int B, int H, int hk, int n_pages, int ps,
           int pps, float scale, cudaStream_t s) {
  const dim3 grid(B, hk);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(kp);
  const T* vv = static_cast<const T*>(vp);
  T* oo = static_cast<T*>(out);
  switch (H / hk) {
    case 1: paged_attention_kernel<T, 1><<<grid, D, 0, s>>>(qq, kk, vv, lengths, page_indices, oo, H, n_pages, ps, pps, scale); break;
    case 2: paged_attention_kernel<T, 2><<<grid, D, 0, s>>>(qq, kk, vv, lengths, page_indices, oo, H, n_pages, ps, pps, scale); break;
    case 4: paged_attention_kernel<T, 4><<<grid, D, 0, s>>>(qq, kk, vv, lengths, page_indices, oo, H, n_pages, ps, pps, scale); break;
    case 8: paged_attention_kernel<T, 8><<<grid, D, 0, s>>>(qq, kk, vv, lengths, page_indices, oo, H, n_pages, ps, pps, scale); break;
    case 16: paged_attention_kernel<T, 16><<<grid, D, 0, s>>>(qq, kk, vv, lengths, page_indices, oo, H, n_pages, ps, pps, scale); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, out [B, H, D]; k_pages, v_pages [hk, n_pages, ps, D]; lengths [B] int32;
// page_indices [B, pps] int32. dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after launch.
extern "C" int pt_paged_attention(const void* q, const void* kp, const void* vp,
                                  const void* lengths, const void* page_indices, void* out,
                                  int B, int H, int hk, int n_pages, int ps, int pps,
                                  float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const int* pidx = static_cast<const int*>(page_indices);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kp, vp, len, pidx, out, B, H, hk, n_pages, ps, pps,
                                 scale, s);
  return launch<float>(q, kp, vp, len, pidx, out, B, H, hk, n_pages, ps, pps, scale, s);
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
