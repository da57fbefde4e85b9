// Fused RMSNorm and residual-add + RMSNorm for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/fused_norm.py, `_rmsnorm_fwd_kernel`
// (called from `rms_norm`, pallas_call at :99) and `_add_rmsnorm_kernel`
// (called from `add_rms_norm`, :193).
//
// Bound on the H100: device-memory bytes. Per launch `rms_norm` moves
// 2*rows*d*es + d*es bytes (x in, out, weight) and `add_rms_norm`
// 4*rows*d*es + d*es (x and residual in, normed and new residual out,
// weight); the arithmetic is a few operations per element, far below the
// card's ratio of operations to bytes. At decode's 8 rows the 64 KB take
// the card 0.02 µs: there a call is bounded by one trip to device memory,
// the launch and the wrapper's host time.
//
// `rms_norm` (one pass): a row group of tpr threads (one warp or a few:
// 32 * ceil(d / (8 * 32 * 4)) in bf16) holds its row in registers, 4
// 16-byte vectors a thread, and the weight's vectors beside them, loaded
// before the reduction so their latency hides behind it; x is read once.
// The f32 sum of squares reduces by warp shuffles, and across the group's
// warps through one shared-memory hop. Blocks hold 128 / tpr rows at
// small d (4 rows a block at d 512 in bf16, 2 at 2048, 1 at 4096), so 8
// rows spread over 2-8 SMs and 4096 rows fill the card. The rows a block
// are an argument (0 keeps that rule): the autotune search
// (ops/hopper/autotune.py) times the powers of two that keep a block
// within 1024 threads, where the JAX package searches its row block. Rows up to 4096
// vectors (d 32768 in bf16, 16384 in f32); the wrapper refuses wider ones.
// `add_rms_norm` (not redesigned yet): one block per row of d / 8 threads,
// the sum of squares, then a second pass over the same row (served from
// L1/L2) that writes the outputs; several rows per block and the row in
// registers are later work, as in `rms_norm`.
// The cast points are the Pallas kernels': the normalised value is
// computed in f32, rounded to the storage type, then multiplied by the
// weight in the storage type; `add_rms_norm` normalises the f32 sum
// x + residual and stores that sum, rounded, as the new residual.
//
// Fused rotate-half RoPE, forward. Replaces: paddle_tpu/ops/pallas/
// fused_norm.py `_rope_kernel` (called from `fused_rope`). x [B, S, H, D]
// (any even D) against f32 cos / sin [S, D]: out = x * cos +
// rotate_half(x) * sin in f32, cast once to the storage type; the output
// is contiguous. Bound by device-memory bytes (x in, out written; the
// tables are read by all B * H rows of a position and stay in L2). One
// thread per V pairs (i, i + D/2) of a row, 16-byte loads when D/2 is a
// multiple of the vector width. The products and the sum are rounded one
// by one (no fused multiply-add), as the plain PyTorch version rounds them,
// so the two agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA and torch do
}

// Sum of `v` over the whole block, returned to every thread.
__device__ float block_sum(float v) {
  __shared__ float partial[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    v = lane < n_warps ? partial[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) partial[0] = v;
  }
  __syncthreads();
  return partial[0];
}

constexpr int RMS_VPT = 4;        // 16-byte vectors of x a thread holds
constexpr int RMS_ROW_THREADS = 128;  // a block's threads at small d

// Block of blockDim.x <= MAXT threads, blockDim.x / tpr rows; row group
// g = threadIdx.x / tpr. MAXT 256 leaves the compiler the registers to
// hold the row without spilling; 1024 takes the widest rows.
template <typename T, int MAXT>
__global__ void __launch_bounds__(MAXT)
rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                int rows, int d, int tpr, float eps) {
  constexpr int N = 16 / sizeof(T);
  __shared__ float partial[32];
  const int n_vec = d / N;
  const int g = threadIdx.x / tpr, rl = threadIdx.x - g * tpr;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / tpr) + g;
  const bool live = row < rows;   // a group past the last row still meets the barrier
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  uint4 xv[RMS_VPT], wv[RMS_VPT];
#pragma unroll
  for (int k = 0; k < RMS_VPT; ++k) {
    const int i = rl + k * tpr;
    if (live && i < n_vec) {
      xv[k] = xr[i];
      wv[k] = __ldg(wr + i);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < RMS_VPT; ++k) {
    if (live && rl + k * tpr < n_vec) {
      const T* e = reinterpret_cast<const T*>(&xv[k]);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float v = to_f(e[j]);
        ss += v * v;
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (tpr > 32) {  // uniform over the block
    const int wpr = tpr >> 5;
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int k = 0; k < wpr; ++k) ss += partial[g * wpr + k];
  }
  if (!live) return;
  const float inv = rsqrtf(ss / d + eps);
  uint4* orow = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
  for (int k = 0; k < RMS_VPT; ++k) {
    const int i = rl + k * tpr;
    if (i < n_vec) {
      uint4 o;
      const T* e = reinterpret_cast<const T*>(&xv[k]);
      const T* we = reinterpret_cast<const T*>(&wv[k]);
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < N; ++j)
        oe[j] = from_f<T>(to_f(from_f<T>(to_f(e[j]) * inv)) * to_f(we[j]));
      orow[i] = o;
    }
  }
}

// rpb: rows a block, 0 for the rule above (what the autotune search starts
// from); any other value must keep the block within 1024 threads
template <typename T>
int launch_rms_norm(const void* x, const void* w, void* out, int rows, int d, float eps,
                    int rpb, cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  const int n_vec = d / N;
  const int tpr = 32 * ((n_vec + 32 * RMS_VPT - 1) / (32 * RMS_VPT));
  if (d % N != 0 || tpr > 1024 || rpb < 0 || tpr * rpb > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rpb == 0) rpb = tpr >= RMS_ROW_THREADS ? 1 : RMS_ROW_THREADS / tpr;
  const int blocks = (rows + rpb - 1) / rpb, threads = tpr * rpb;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (threads <= 256)
    rms_norm_kernel<T, 256><<<blocks, threads, 0, s>>>(xt, wt, ot, rows, d, tpr, eps);
  else
    rms_norm_kernel<T, 1024><<<blocks, threads, 0, s>>>(xt, wt, ot, rows, d, tpr, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
__global__ void add_rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ r,
                                    const T* __restrict__ w, T* __restrict__ out,
                                    T* __restrict__ h_out, int d, float eps) {
  constexpr int N = 16 / sizeof(T);
  const size_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  const uint4* rr = reinterpret_cast<const uint4*>(r + row * d);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  uint4* orow = reinterpret_cast<uint4*>(out + row * d);
  uint4* hrow = reinterpret_cast<uint4*>(h_out + row * d);
  const int n_vec = d / N;

  float ss = 0.f;
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    uint4 xa = xr[i], ra = rr[i];
    const T* xe = reinterpret_cast<const T*>(&xa);
    const T* re = reinterpret_cast<const T*>(&ra);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float h = to_f(xe[k]) + to_f(re[k]);
      ss += h * h;
    }
  }
  const float inv = rsqrtf(block_sum(ss) / d + eps);

  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    uint4 xa = xr[i], ra = rr[i], wa = wr[i], o, hv;
    const T* xe = reinterpret_cast<const T*>(&xa);
    const T* re = reinterpret_cast<const T*>(&ra);
    const T* we = reinterpret_cast<const T*>(&wa);
    T* oe = reinterpret_cast<T*>(&o);
    T* he = reinterpret_cast<T*>(&hv);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float h = to_f(xe[k]) + to_f(re[k]);
      he[k] = from_f<T>(h);
      oe[k] = from_f<T>(to_f(from_f<T>(h * inv)) * to_f(we[k]));
    }
    orow[i] = o;
    hrow[i] = hv;
  }
}

int threads_for(int n_vec) {
  int t = ((n_vec + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T e[V]; };

template <typename T, int V>
__global__ void rope_kernel(const T* __restrict__ x, const float* __restrict__ cos,
                            const float* __restrict__ sin, T* __restrict__ out,
                            int64_t rows, int S, int H, int D) {
  const int half = D / 2, per_row = half / V;
  const int64_t total = rows * per_row;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = idx / per_row;             // (b * S + s) * H + h
    const int i0 = (int)(idx % per_row) * V;
    const int s = (int)((row / H) % S);
    const T* xr = x + row * D;
    const float* c = cos + (size_t)s * D;
    const float* sn = sin + (size_t)s * D;
    const Pack<T, V> a = *reinterpret_cast<const Pack<T, V>*>(xr + i0);
    const Pack<T, V> b = *reinterpret_cast<const Pack<T, V>*>(xr + half + i0);
    Pack<T, V> oa, ob;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = i0 + k;
      const float x1 = to_f(a.e[k]), x2 = to_f(b.e[k]);
      oa.e[k] = from_f<T>(__fadd_rn(__fmul_rn(x1, c[i]), __fmul_rn(-x2, sn[i])));
      ob.e[k] = from_f<T>(__fadd_rn(__fmul_rn(x2, c[half + i]), __fmul_rn(x1, sn[half + i])));
    }
    T* orow = out + row * D;
    *reinterpret_cast<Pack<T, V>*>(orow + i0) = oa;
    *reinterpret_cast<Pack<T, V>*>(orow + half + i0) = ob;
  }
}

template <typename T>
int launch_rope(const void* x, const float* cos, const float* sin, void* out, int64_t rows,
                int S, int H, int D, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = (D / 2) % V == 0;
  const int64_t work = rows * ((D / 2) / (vec ? V : 1));
  const int threads = 256;
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 blocks per SM
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const dim3 grid((unsigned)blocks);
  if (vec)
    rope_kernel<T, V><<<grid, threads, 0, s>>>(xt, cos, sin, ot, rows, S, H, D);
  else
    rope_kernel<T, 1><<<grid, threads, 0, s>>>(xt, cos, sin, ot, rows, S, H, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out [B, S, H, D] (rows = B * S * H); cos, sin [S, D] f32; D even.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
extern "C" int pt_fused_rope(const void* x, const void* cos, const void* sin, void* out,
                             int64_t rows, int S, int H, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cos);
  const float* sn = static_cast<const float*>(sin);
  if (rows == 0) return 0;
  if (dtype == 1) return launch_rope<__nv_bfloat16>(x, c, sn, out, rows, S, H, D, s);
  return launch_rope<float>(x, c, sn, out, rows, S, H, D, s);
}

// x, out [rows, d]; w [d]; d a multiple of the 16-byte vector, at most
// 4096 vectors. dtype: 0 = float32, 1 = bfloat16. rpb: rows a block, 0 for
// the kernel's rule. Returns cudaGetLastError() after launch.
extern "C" int pt_rms_norm(const void* x, const void* w, void* out, int rows, int d,
                           float eps, int dtype, int rpb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_rms_norm<__nv_bfloat16>(x, w, out, rows, d, eps, rpb, s);
  return launch_rms_norm<float>(x, w, out, rows, d, eps, rpb, s);
}

extern "C" int pt_add_rms_norm(const void* x, const void* r, const void* w, void* out,
                               void* h_out, int rows, int d, float eps, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    add_rms_norm_kernel<__nv_bfloat16><<<rows, threads_for(d / 8), 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(r),
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(h_out), d, eps);
  } else {
    add_rms_norm_kernel<float><<<rows, threads_for(d / 4), 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(r),
        static_cast<const float*>(w), static_cast<float*>(out),
        static_cast<float*>(h_out), d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
