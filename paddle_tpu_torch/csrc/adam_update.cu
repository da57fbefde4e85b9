// Multi-tensor Adam / AdamW update for Hopper (sm_90a).
//
// Replaces: no TPU kernel. The JAX package's TrainStep
// (paddle_tpu/jit/__init__.py:218-303) runs Adam.update
// (paddle_tpu/optimizer/optimizer.py:245-261) inside one XLA computation,
// where XLA fuses each parameter's update chain into one loop; eager
// PyTorch runs it as about 17 elementwise kernels a tensor. This kernel is
// the hand-written counterpart of that fusion, over a whole group of
// tensors in one launch.
//
// Bound on the H100: device-memory bytes. Each element is read once and
// written once: with bf16 parameters, f32 masters and bf16 moments (the
// 8B training recipe) g (2 bytes), the master (4), m and v (2 + 2) in, the
// master, m, v and the bf16 parameter out: 20 bytes, against about 15
// f32 operations, far below the card's ratio of operations to bytes.
//
// Design: a table row per tensor (addresses, element count, first block,
// vector and decay flags; ops/hopper/adam_update.py build_table) and a
// grid over (tensor, chunk of CHUNK elements): a block finds its tensor by
// binary search over the rows' first blocks, then its threads walk the
// chunk 8 elements at a time with 16-byte loads and stores (one for 8
// bf16, two for 8 f32) where every address of the tensor is 16-byte
// aligned, and one element at a time over the rest. Each chunk is 32
// steps of 256 threads, so a 4096-wide norm weight is one block and the
// embedding ~8000: every SM holds several blocks, each thread several
// 16-byte loads in flight.
//
// Bits: the operations and their order are the plain version's
// (adam_update_plain), each rounded once as PyTorch rounds it on the CPU:
// __fmul_rn / __fadd_rn / __fsub_rn keep the compiler from contracting a
// product and a sum into one fused multiply-add, __fdiv_rn and __fsqrt_rn
// are IEEE division and square root (the CPU divides exactly, where
// PyTorch on CUDA multiplies by the reciprocal of a scalar), and every
// store to bf16 rounds to nearest even. The scalars arrive as the f32
// values PyTorch rounds the plain version's Python numbers to.
// The optional clip scale (one f32 on the card, written by grad_norm.cu)
// is applied as (g.float() * scale).to(g.dtype) is, so no clipped copy of
// the gradients is made and the host never waits for the norm.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;
constexpr int64_t CHUNK = 65536;  // ops/hopper/adam_update.py CHUNK

struct Row {
  int64_t p, g, master, m, v, vmax, n, meta;
};

struct Hyper {
  float b1, omb1, b2, omb2, eps, lr, bc1, bc2, wdf;
  int l2;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ void ld8(const float* p, float (&x)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float (&x)[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void st8(float* p, const float (&x)[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void st8(__nv_bfloat16* p, const float (&x)[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename T> struct IsBf16 { static constexpr bool value = false; };
template <> struct IsBf16<__nv_bfloat16> { static constexpr bool value = true; };

// torch.maximum: NaN if either operand is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// One element of adam_update_plain. g, w, m, v, vm in f32; w, m, v, vm
// updated in place.
template <typename PT, bool AMS>
__device__ __forceinline__ void adam_elem(float g, float& w, float& m, float& v, float& vm,
                                          const Hyper& h, bool decay, bool clip, float s) {
  if (clip) {
    g = __fmul_rn(g, s);
    if (IsBf16<PT>::value) g = __bfloat162float(__float2bfloat16_rn(g));
  }
  if (decay) {
    if (h.l2) g = __fadd_rn(g, __fmul_rn(w, h.wdf));
    else w = __fmul_rn(w, h.wdf);
  }
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g, h.omb1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g, h.omb2), g));
  float vh = v;
  if (AMS) {
    vm = nan_max(vm, v);
    vh = vm;
  }
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(vh, h.bc2)), h.eps);
  w = __fsub_rn(w, __fdiv_rn(__fmul_rn(__fdiv_rn(m, h.bc1), h.lr), denom));
}

// PT: parameter and gradient type; MT: moment type; MASTER: an f32 master
// holds the value (bf16 parameters); AMS: amsgrad's moment2_max.
template <typename PT, typename MT, bool MASTER, bool AMS>
__global__ void __launch_bounds__(THREADS)
adam_update_kernel(const Row* __restrict__ table, int n_tensors, Hyper h,
                   const float* __restrict__ scale) {
  const int64_t b = blockIdx.x;
  int lo = 0, hi = n_tensors - 1;
  while (lo < hi) {  // the last row whose first block is <= b
    const int mid = (lo + hi + 1) >> 1;
    if ((table[mid].meta >> 2) <= b) lo = mid;
    else hi = mid - 1;
  }
  const Row r = table[lo];
  const int64_t start = (b - (r.meta >> 2)) * CHUNK;
  const int64_t len = r.n - start < CHUNK ? r.n - start : CHUNK;
  const bool decay = r.meta & 1, vec = (r.meta >> 1) & 1;
  const bool clip = scale != nullptr;
  const float s = clip ? *scale : 1.f;
  PT* p = reinterpret_cast<PT*>(r.p) + start;
  const PT* g = reinterpret_cast<const PT*>(r.g) + start;
  float* w = MASTER ? reinterpret_cast<float*>(r.master) + start : nullptr;
  MT* m = reinterpret_cast<MT*>(r.m) + start;
  MT* v = reinterpret_cast<MT*>(r.v) + start;
  MT* vm = AMS ? reinterpret_cast<MT*>(r.vmax) + start : nullptr;

  const int64_t n_vec = vec ? len / VEC : 0;
  for (int64_t i = threadIdx.x; i < n_vec; i += THREADS) {
    const int64_t o = i * VEC;
    float gx[VEC], wx[VEC], mx[VEC], vx[VEC], vmx[VEC];
    ld8(g + o, gx);
    if (MASTER) ld8(w + o, wx);
    else ld8(p + o, wx);
    ld8(m + o, mx);
    ld8(v + o, vx);
    if (AMS) ld8(vm + o, vmx);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      adam_elem<PT, AMS>(gx[k], wx[k], mx[k], vx[k], vmx[k], h, decay, clip, s);
    st8(m + o, mx);
    st8(v + o, vx);
    if (AMS) st8(vm + o, vmx);
    if (MASTER) st8(w + o, wx);
    st8(p + o, wx);
  }
  for (int64_t i = n_vec * VEC + threadIdx.x; i < len; i += THREADS) {
    float wx = MASTER ? w[i] : to_f(p[i]);
    float mx = to_f(m[i]), vx = to_f(v[i]), vmx = AMS ? to_f(vm[i]) : 0.f;
    adam_elem<PT, AMS>(to_f(g[i]), wx, mx, vx, vmx, h, decay, clip, s);
    put(m + i, mx);
    put(v + i, vx);
    if (AMS) put(vm + i, vmx);
    if (MASTER) w[i] = wx;
    put(p + i, wx);
  }
}

template <typename PT, typename MT, bool MASTER, bool AMS>
int launch(const void* table, int n, long long blocks, const Hyper& h, const void* scale,
           cudaStream_t s) {
  adam_update_kernel<PT, MT, MASTER, AMS><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      static_cast<const Row*>(table), n, h, static_cast<const float*>(scale));
  return static_cast<int>(cudaGetLastError());
}

template <typename PT, typename MT>
int launch_flags(bool master, bool ams, const void* table, int n, long long blocks,
                 const Hyper& h, const void* scale, cudaStream_t s) {
  if (master)
    return ams ? launch<PT, MT, true, true>(table, n, blocks, h, scale, s)
               : launch<PT, MT, true, false>(table, n, blocks, h, scale, s);
  return ams ? launch<PT, MT, false, true>(table, n, blocks, h, scale, s)
             : launch<PT, MT, false, false>(table, n, blocks, h, scale, s);
}

}  // namespace

// One launch over a group's table of n tensors and `blocks` chunks.
// ptype / mtype: 0 = float32, 1 = bfloat16; master only with bfloat16
// parameters. Scalars: b1, 1 - b1, b2, 1 - b2, eps, lr, the two bias
// corrections, then the decay factor (1 - lr * wd decoupled, wd as L2).
// scale: null, or one f32 on the card. Returns cudaGetLastError() after
// the launch.
extern "C" int pt_adam_update(const void* table, int n, long long blocks, int ptype,
                              int master, int mtype, int ams, int l2, float b1,
                              float omb1, float b2, float omb2, float eps, float lr,
                              float bc1, float bc2, float wdf, const void* scale,
                              void* stream) {
  if (n <= 0 || blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL || (master && ptype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{b1, omb1, b2, omb2, eps, lr, bc1, bc2, wdf, l2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ptype == 1) {
    if (mtype == 1)
      return launch_flags<__nv_bfloat16, __nv_bfloat16>(master, ams, table, n, blocks, h,
                                                        scale, s);
    return launch_flags<__nv_bfloat16, float>(master, ams, table, n, blocks, h, scale, s);
  }
  if (mtype == 1)
    return launch_flags<float, __nv_bfloat16>(false, ams, table, n, blocks, h, scale, s);
  return launch_flags<float, float>(false, ams, table, n, blocks, h, scale, s);
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
