// MLA latent decode attention for Hopper (sm_90a): one absorbed query per
// batch row against the compressed latent cache of DeepSeek's multi-head
// latent attention, streamed once.
//
// Replaces: paddle_tpu/ops/pallas/mla_decode.py, `_kernel` (called from
// `_decode_jit` / `mla_decode_attention`).
//
// What it computes, per batch row b and head h (all math in f32):
//   score[t] = q_lat[b,h,:] . c_kv[b,t,:] + q_pe[b,h,:] . k_pe[b,t,:]
//   visible  = t <= pos[b] and (allowed == null or allowed[b,t] != 0)
//   out[b,h,:] = sum_t softmax(score)[t] * c_kv[b,t,:]   over visible t,
// q_lat and q_pe arriving pre-scaled in f32, the buffers in float32 or
// bfloat16. A row with no visible column returns exactly 0 (the Pallas
// kernel's dead-row rule), not NaN. Columns past pos[b] are never read.
//
// Bound on the H100: the bytes of c_kv and k_pe up to each row's pos
// (576 values per column at DeepSeek-V2 widths) against 16 heads x
// (4 r + 2 dr) f32 operations per column: at 16 heads the f32 operations
// on CUDA cores take longer than the bytes, so it is bound by operations
// unless tensor cores take the two products (a later step).
//
// Design (simple and right first):
// - The TPU kernel runs one grid cell per batch row over the whole buffer
//   held in VMEM. Here B = 8 rows would be 8 blocks for 132 SMs, and all
//   heads share one latent (MQA), so splitting by head would read it once
//   per split. Instead the T axis is split over blocks (split-K, as in
//   flash-decoding): block (split, b) holds all H <= 16 heads' queries in
//   shared memory and streams its chunk of columns in tiles of BN = 32,
//   each tile read from device memory once and used for the scores and
//   the context both (the point of the TPU kernel). It writes a partial
//   (max, sum, context) per head; a second launch combines the partials of
//   a row. The chunks split each row's visible prefix t <= pos[b], not the
//   buffer, into n_split runs of whole tiles, so a row of 1,000 columns in
//   a 4,096-column buffer still spreads over all of its blocks; a block
//   whose chunk is empty writes an empty partial.
// - Scores: warp w owns heads w and w + 8, lane c column c of the tile;
//   the online softmax runs per head across the warp with shuffles. The
//   context: thread i owns latent columns i and i + 256 of every head.
// - Tiles are staged in shared memory in the buffer's own type, rows
//   padded so that 32 lanes reading 32 rows hit 32 banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads per block (8 warps)
constexpr int BN = 32;         // columns per tile: one per lane
constexpr int MAXH = 16;       // heads per block: two per warp
constexpr int MAXR = 2 * NT;   // latent width: two columns per thread
constexpr int MAXDR = 128;     // rope width
constexpr int MAXSPLIT = 256;  // partials per row the combine takes

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// shared row stride in elements: an odd number of 32-bit words
template <typename T> __host__ __device__ constexpr int padded(int n) {
  return sizeof(T) == 4 ? n + 1 : n + 2;
}

template <typename T> size_t smem_bytes(int H, int r, int dr) {
  return sizeof(float) * ((size_t)H * r + (size_t)H * dr + MAXH * (BN + 1) + MAXH) +
         sizeof(T) * ((size_t)BN * padded<T>(r) + (size_t)BN * padded<T>(dr));
}

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

template <typename T>
__global__ void __launch_bounds__(NT)
mla_decode_split_kernel(const float* __restrict__ q_lat, const float* __restrict__ q_pe,
                        const T* __restrict__ ckv, const T* __restrict__ kpe,
                        const int* __restrict__ pos, const uint8_t* __restrict__ allowed,
                        float* __restrict__ part_m, float* __restrict__ part_l,
                        float* __restrict__ part_acc, int H, int T_, int r, int dr) {
  extern __shared__ float smem[];
  float* qs = smem;                       // [H][r]
  float* qps = qs + H * r;                // [H][dr]
  float* ps = qps + H * dr;               // [MAXH][BN + 1] probabilities
  float* al = ps + MAXH * (BN + 1);       // [MAXH] rescale of this tile
  T* cks = reinterpret_cast<T*>(al + MAXH);  // [BN][padded(r)]
  const int RS = padded<T>(r), DS = padded<T>(dr);
  T* kps = cks + BN * RS;                 // [BN][padded(dr)]

  const int split = blockIdx.x, b = blockIdx.y, NS = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this row's visible prefix [0, len) in NS chunks of whole tiles
  const int len = max(0, min(T_, pos[b] + 1));
  const int chunk = ((len + BN - 1) / BN + NS - 1) / NS * BN;
  const int t_begin = split * chunk;
  const int limit = min(len, t_begin + chunk);  // exclusive

  for (int i = tid; i < H * r; i += NT) qs[i] = q_lat[(size_t)b * H * r + i];
  for (int i = tid; i < H * dr; i += NT) qps[i] = q_pe[(size_t)b * H * dr + i];

  const int h0 = warp, h1 = warp + 8;
  float m0 = -INFINITY, l0 = 0.f, m1 = -INFINITY, l1 = 0.f;
  const int d0 = tid, d1 = tid + NT;
  float acc[MAXH][2];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) acc[h][0] = acc[h][1] = 0.f;

  for (int t0 = t_begin; t0 < limit; t0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BN * r; i += NT) {
      const int c = i / r, d = i - c * r, col = t0 + c;
      cks[c * RS + d] = col < limit ? ckv[((size_t)b * T_ + col) * r + d] : zero<T>();
    }
    for (int i = tid; i < BN * dr; i += NT) {
      const int c = i / dr, d = i - c * dr, col = t0 + c;
      kps[c * DS + d] = col < limit ? kpe[((size_t)b * T_ + col) * dr + d] : zero<T>();
    }
    __syncthreads();

    const int col = t0 + lane;
    const bool vis = col < limit &&
                     (allowed == nullptr || allowed[(size_t)b * T_ + col] != 0);
    if (h0 < H) {
      float s0 = 0.f, s1 = 0.f;
      const bool two = h1 < H;
      const T* crow = cks + lane * RS;
      for (int d = 0; d < r; ++d) {
        const float x = to_f(crow[d]);
        s0 = fmaf(qs[h0 * r + d], x, s0);
        if (two) s1 = fmaf(qs[h1 * r + d], x, s1);
      }
      const T* krow = kps + lane * DS;
      for (int d = 0; d < dr; ++d) {
        const float x = to_f(krow[d]);
        s0 = fmaf(qps[h0 * dr + d], x, s0);
        if (two) s1 = fmaf(qps[h1 * dr + d], x, s1);
      }
      // online softmax of head h0 (and h1) across the warp
      {
        const float s = vis ? s0 : -INFINITY;
        const float m_new = fmaxf(m0, warp_max(s));
        const float p = s == -INFINITY ? 0.f : expf(s - m_new);
        const float alpha = m0 == -INFINITY ? 0.f : expf(m0 - m_new);
        l0 = l0 * alpha + warp_sum(p);
        m0 = m_new;
        ps[h0 * (BN + 1) + lane] = p;
        if (lane == 0) al[h0] = alpha;
      }
      if (two) {
        const float s = vis ? s1 : -INFINITY;
        const float m_new = fmaxf(m1, warp_max(s));
        const float p = s == -INFINITY ? 0.f : expf(s - m_new);
        const float alpha = m1 == -INFINITY ? 0.f : expf(m1 - m_new);
        l1 = l1 * alpha + warp_sum(p);
        m1 = m_new;
        ps[h1 * (BN + 1) + lane] = p;
        if (lane == 0) al[h1] = alpha;
      }
    }
    __syncthreads();

    // context: the same c_kv tile the scores were taken from
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < H) {
        const float a = al[h];
        acc[h][0] *= a;
        acc[h][1] *= a;
      }
    }
    for (int c = 0; c < BN; ++c) {
      const float x0 = d0 < r ? to_f(cks[c * RS + d0]) : 0.f;
      const float x1 = d1 < r ? to_f(cks[c * RS + d1]) : 0.f;
#pragma unroll
      for (int h = 0; h < MAXH; ++h) {
        if (h < H) {
          const float p = ps[h * (BN + 1) + c];
          acc[h][0] = fmaf(p, x0, acc[h][0]);
          acc[h][1] = fmaf(p, x1, acc[h][1]);
        }
      }
    }
  }

  const size_t base = ((size_t)b * NS + split) * H;
  if (lane == 0 && h0 < H) {
    part_m[base + h0] = m0;
    part_l[base + h0] = l0;
    if (h1 < H) {
      part_m[base + h1] = m1;
      part_l[base + h1] = l1;
    }
  }
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    if (h < H) {
      if (d0 < r) part_acc[(base + h) * r + d0] = acc[h][0];
      if (d1 < r) part_acc[(base + h) * r + d1] = acc[h][1];
    }
  }
}

// one block per (head, row): weights exp(m_s - M) of the partials that saw
// a visible column, their sum L, out = sum_s w_s acc_s / L (0 when L = 0)
__global__ void __launch_bounds__(128)
mla_decode_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                          const float* __restrict__ part_acc, float* __restrict__ out,
                          int H, int r, int NS) {
  __shared__ float ws[MAXSPLIT];
  __shared__ float inv_s;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t base = (size_t)b * NS * H + h;   // partial s at base + s * H
  if (tid == 0) {
    float M = -INFINITY;
    for (int s = 0; s < NS; ++s) M = fmaxf(M, part_m[base + (size_t)s * H]);
    float L = 0.f;
    for (int s = 0; s < NS; ++s) {
      const float m = part_m[base + (size_t)s * H];
      const float w = m == -INFINITY ? 0.f : expf(m - M);
      ws[s] = w;
      L += w * part_l[base + (size_t)s * H];
    }
    inv_s = L > 0.f ? 1.f / L : 0.f;
  }
  __syncthreads();
  const float inv = inv_s;
  for (int d = tid; d < r; d += blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < NS; ++s) {
      const float w = ws[s];
      if (w != 0.f) v = fmaf(w, part_acc[(base + (size_t)s * H) * r + d], v);
    }
    out[((size_t)b * H + h) * r + d] = v * inv;
  }
}

template <typename T>
int launch(const float* q_lat, const float* q_pe, const void* ckv, const void* kpe,
           const int* pos, const uint8_t* allowed, float* part_m, float* part_l,
           float* part_acc, float* out, int B, int H, int T_, int r, int dr, int n_split,
           cudaStream_t stream) {
  if (H < 1 || H > MAXH || r < 1 || r > MAXR || dr < 0 || dr > MAXDR || n_split < 1 ||
      n_split > MAXSPLIT)
    return (int)cudaErrorInvalidValue;
  auto kernel = mla_decode_split_kernel<T>;
  const size_t smem = smem_bytes<T>(H, r, dr);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_split, B), NT, smem, stream>>>(
      q_lat, q_pe, static_cast<const T*>(ckv), static_cast<const T*>(kpe), pos, allowed,
      part_m, part_l, part_acc, H, T_, r, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mla_decode_combine_kernel<<<dim3(H, B), 128, 0, stream>>>(part_m, part_l, part_acc, out,
                                                             H, r, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// q_lat [B, H, r] f32, q_pe [B, H, dr] f32 (both pre-scaled); ckv [B, T, r]
// and kpe [B, T, dr] of one type, dtype 0 = float32, 1 = bfloat16; pos [B]
// int32; allowed [B, T] bytes or null; partials part_m / part_l
// [B, n_split, H] and part_acc [B, n_split, H, r] f32, scratch; out
// [B, H, r] f32. Block (split, b) takes the split-th of n_split chunks of
// row b's visible prefix. Returns cudaGetLastError() after the two
// launches.
extern "C" int pt_mla_decode(const void* q_lat, const void* q_pe, const void* ckv,
                             const void* kpe, const void* pos, const void* allowed,
                             void* part_m, void* part_l, void* part_acc, void* out, int B,
                             int H, int T_, int r, int dr, int n_split, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ql = static_cast<const float*>(q_lat);
  const float* qp = static_cast<const float*>(q_pe);
  const int* p = static_cast<const int*>(pos);
  const uint8_t* a = static_cast<const uint8_t*>(allowed);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  float* o = static_cast<float*>(out);
  if (dtype == 1)
    return launch<__nv_bfloat16>(ql, qp, ckv, kpe, p, a, pm, pl, pa, o, B, H, T_, r, dr,
                                 n_split, s);
  return launch<float>(ql, qp, ckv, kpe, p, a, pm, pl, pa, o, B, H, T_, r, dr, n_split, s);
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
