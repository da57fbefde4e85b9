// Global gradient norm and clip scale for Hopper (sm_90a).
//
// Replaces: no TPU kernel. ClipGradByGlobalNorm.functional_clip
// (paddle_tpu/optimizer/clip.py:57-68) runs as XLA code inside the JAX
// TrainStep: a sum of squares over every gradient, then the scale
// min(clip_norm / (norm + 1e-6), 1). Eager PyTorch takes a cast, a square
// and a sum per tensor and a chain of scalar kernels; this is the
// hand-written counterpart, two launches for the whole set.
//
// Bound on the H100: device-memory bytes (each gradient read once, 2 bytes
// an element in bf16; a multiply-add an element).
//
// Pass 1 (sumsq_kernel): a table row per tensor (address, element count,
// first block, vector and dtype flags; ops/hopper/grad_norm.py) and one
// block per chunk of CHUNK elements, found by binary search as in
// adam_update.cu; each thread keeps 8 f32 partial sums (one per element of
// its 16-byte vector), adds them in a fixed order, and the block reduces by
// warp shuffles and one shared-memory hop into one partial per chunk.
// Pass 2 (finish_kernel): one block of 1024 threads adds the partials in a
// fixed order (strided runs, then the same tree), takes the square root
// and writes the norm and the clip scale as
//   scale = min(reciprocal(norm + eps) * clip_norm, 1)
// which is what ``clip_norm / (total + 1e-6)`` then ``clamp(max=1)``
// computes in PyTorch (a Python number divided by a tensor is the
// tensor's reciprocal times the number). No float atomics: two calls on
// the same gradients give the same bits. The scale stays on the card,
// where adam_update.cu reads it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int FINISH_THREADS = 1024;
constexpr int64_t CHUNK = 65536;  // ops/hopper/grad_norm.py CHUNK

struct GRow {
  int64_t g, n, meta, pad;
};

// Sum of v over the block (blockDim.x a multiple of 32, at most 1024), in
// one fixed order; valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* partial) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? partial[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

template <typename T>
__device__ __forceinline__ void add_squares(const T* g, int64_t len, bool vec, float (&acc)[8]) {
  constexpr int N = 16 / sizeof(T);
  const int64_t n_vec = vec ? len / 8 : 0;
  for (int64_t i = threadIdx.x; i < n_vec; i += THREADS) {
    const uint4* q = reinterpret_cast<const uint4*>(g + i * 8);
#pragma unroll
    for (int u = 0; u < 8 / N; ++u) {
      const uint4 w = q[u];
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float x;
        if constexpr (sizeof(T) == 2) x = __bfloat162float(e[j]);
        else x = e[j];
        acc[u * N + j] = fmaf(x, x, acc[u * N + j]);
      }
    }
  }
  for (int64_t i = n_vec * 8 + threadIdx.x; i < len; i += THREADS) {
    float x;
    if constexpr (sizeof(T) == 2) x = __bfloat162float(g[i]);
    else x = g[i];
    acc[0] = fmaf(x, x, acc[0]);
  }
}

__global__ void __launch_bounds__(THREADS)
sumsq_kernel(const GRow* __restrict__ table, int n_tensors, float* __restrict__ partials) {
  __shared__ float partial[32];
  const int64_t b = blockIdx.x;
  int lo = 0, hi = n_tensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if ((table[mid].meta >> 2) <= b) lo = mid;
    else hi = mid - 1;
  }
  const GRow r = table[lo];
  const int64_t start = (b - (r.meta >> 2)) * CHUNK;
  const int64_t len = r.n - start < CHUNK ? r.n - start : CHUNK;
  const bool vec = (r.meta >> 1) & 1, bf16 = r.meta & 1;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (bf16) add_squares(reinterpret_cast<const __nv_bfloat16*>(r.g) + start, len, vec, acc);
  else add_squares(reinterpret_cast<const float*>(r.g) + start, len, vec, acc);
  const float t = ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7]));
  const float sum = block_sum(t, partial);
  if (threadIdx.x == 0) partials[b] = sum;
}

__global__ void __launch_bounds__(FINISH_THREADS)
finish_kernel(const float* __restrict__ partials, int64_t n, float clip_norm, float eps,
              float* __restrict__ out) {
  __shared__ float partial[32];
  float t = 0.f;
  for (int64_t i = threadIdx.x; i < n; i += FINISH_THREADS) t += partials[i];
  const float sum = block_sum(t, partial);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn(sum);
    float scale = __fmul_rn(__fdiv_rn(1.f, __fadd_rn(norm, eps)), clip_norm);
    scale = scale > 1.f ? 1.f : scale;  // clamp(max=1); NaN stays NaN
    out[0] = norm;
    out[1] = scale;
  }
}

}  // namespace

// table: n rows of {address, elements, first_block << 2 | vec << 1 | bf16,
// 0}; blocks: the chunks in all (0: no element, the norm is 0); partials:
// `blocks` f32 of scratch; out: two f32, the norm and the scale. Two
// launches on `stream`; returns cudaGetLastError() after the second.
extern "C" int pt_grad_norm(const void* table, int n, long long blocks, void* partials,
                            float clip_norm, float eps, void* out, void* stream) {
  if (n < 0 || blocks < 0 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0) {
    sumsq_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        static_cast<const GRow*>(table), n, static_cast<float*>(partials));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  finish_kernel<<<1, FINISH_THREADS, 0, s>>>(static_cast<const float*>(partials), blocks,
                                             clip_norm, eps, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
