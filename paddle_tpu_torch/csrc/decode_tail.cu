// The fused decode tail for Hopper (sm_90a): two kernels that turn the
// non-attention work of a decode layer into two launches.
//
// Replaces: paddle_tpu/ops/pallas/decode_tail.py
//   - `_qkv_kernel` (called from `fused_qkv_rope`): rms_norm(x) -> x.Wq,
//     x.Wk, x.Wv with f32 accumulation -> rotate-half RoPE of q and k at
//     each row's position;
//   - `_epilogue_kernel` (called from `fused_epilogue`): attn.Wo with f32
//     accumulation -> cast -> + residual in f32 -> RMSNorm of the f32 sum.
//
// Bound on the H100: device-memory bytes. Each call streams its weights
// once (Llama-3-8B: 50.3 MB for Wq|Wk|Wv, 33.6 MB for Wo in bf16) while the
// activations are a few hundred KB; at R rows a weight element takes part
// in 2R operations, far below the card's ratio of operations to bytes.
//
// Design (a simple kernel that is right; tensor cores are later work):
// - The TPU walks the contraction axis in order on one core and carries f32
//   accumulators between grid steps. Here blocks run in parallel and carry
//   nothing: each block owns 32 output columns for a tile of up to 32 rows
//   and loops over the whole contraction itself. 8 warps split the
//   contraction (warp w takes 32 of each 256-row chunk of the weight); lane j
//   owns column j, so a warp reads a weight row's 32 columns as two or four
//   32-byte sectors, and each weight byte is read once per 32-row tile.
//   The 8 partial sums of a column are added in warp order: no atomics, the
//   same inputs give the same bits.
// - The activations of a chunk (x normed, or attn) are staged in shared
//   memory as f32, [256][rows], so one 16-byte shared load feeds 4 rows'
//   multiply-adds; the next chunk's 32 weights per thread are loaded while
//   the current chunk is summed.
// - fused_qkv_rope: RoPE couples column i of a head with column i + d/2, so
//   a block owns 16 column pairs (i, i + d/2) of one head: columns
//   [h*d + 16p, +16) and [h*d + d/2 + 16p, +16). Grid (H + 2hk) * d/32 by
//   row tiles (Llama-3-8B: 192 blocks). The norm needs each row's sum of
//   squares over all of `hidden` before any product, so every block first
//   reads its rows of x once (from L2) for the f32 scale.
// - fused_epilogue: the RMSNorm spans all `hidden` output columns of a row,
//   which 128 blocks own. Each block writes its columns' f32 sums to a
//   workspace and their per-row sum of squares to a partial slot; the last
//   block of a row tile to arrive (a counter after a fence) adds the
//   partials in block order, so the result does not depend on arrival
//   order, writes `normed` for the whole tile and resets the counter. One
//   launch per call.
// - Cast points are the Pallas bodies': qkv: f32 normalise -> cast ->
//   times the norm weight in the storage type -> f32 sums -> cast -> RoPE
//   in f32 (each product and the sum rounded on their own, as the plain
//   version rounds them) -> cast. Epilogue: the product cast to the
//   storage type, lifted to f32 and added to the f32 residual; the new
//   residual is the cast sum; the norm is taken over the f32 sum.
// Limits: head width a multiple of 32, hidden a multiple of 32, 16-byte
// aligned rows; the wrapper checks them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 32;          // output columns per block
constexpr int KC = 256;           // contraction rows per staged chunk
constexpr int KPW = KC / WARPS;   // contraction rows per warp per chunk
constexpr int MAX_RT = 32;        // rows per block
static_assert((KC * 8) % THREADS == 0, "a staged chunk splits evenly over the threads");

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// x rounded to the storage type and back (the casts of the Pallas bodies)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[r] += sum over the chunk's KPW rows of this warp of a_s[k][r] * w[k].
template <int RT>
__device__ __forceinline__ void chunk_fma(const float* __restrict__ a_s, const float (&w)[KPW],
                                          int warp, float (&acc)[RT]) {
#pragma unroll
  for (int m = 0; m < KPW; ++m) {
    const float4* a4 = reinterpret_cast<const float4*>(a_s + (warp * KPW + m) * RT);
#pragma unroll
    for (int q = 0; q < RT / 4; ++q) {
      const float4 a = a4[q];
      acc[4 * q + 0] = fmaf(a.x, w[m], acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(a.y, w[m], acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(a.z, w[m], acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(a.w, w[m], acc[4 * q + 3]);
    }
  }
}

// this warp's weights of the chunk at k0; rows past K (a short last chunk)
// read as 0
template <typename T>
__device__ __forceinline__ void load_w(const T* __restrict__ W, int ldw, int K, int k0,
                                       int col, int warp, float (&w)[KPW]) {
#pragma unroll
  for (int m = 0; m < KPW; ++m) {
    const int k = k0 + warp * KPW + m;
    w[m] = k < K ? to_f(W[(size_t)k * ldw + col]) : 0.f;
  }
}

// Shared floats of a block: the staged chunk [KC][RT], later reused for
// the warps' sums [WARPS][RT][COLS].
template <int RT>
__host__ __device__ constexpr int smem_floats() {
  return KC * RT > WARPS * RT * COLS ? KC * RT : WARPS * RT * COLS;
}

// The block's product: out[r][j] = sum_k a(r, k) * W[k, col_j] for its
// rows r < RT, where `stage(k0, a_s)` writes a(r, k0 + kk) to a_s[kk][r]
// (0 past the rows or past K).
// Sums of the 8 warps are left in red[warp][r][j] (red aliases a_s).
template <typename T, int RT, typename Stage>
__device__ void block_product(const T* __restrict__ W, int ldw, int K, int col,
                              float* a_s, float* red, Stage stage) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.f;
  float w_cur[KPW], w_nxt[KPW] = {};
  load_w<T>(W, ldw, K, 0, col, warp, w_cur);
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // the previous chunk's readers are done
    stage(k0, a_s);
    __syncthreads();
    if (k0 + KC < K) load_w<T>(W, ldw, K, k0 + KC, col, warp, w_nxt);
    chunk_fma<RT>(a_s, w_cur, warp, acc);
#pragma unroll
    for (int m = 0; m < KPW; ++m) w_cur[m] = w_nxt[m];
  }
  __syncthreads();  // the last chunk's readers are done with a_s
#pragma unroll
  for (int r = 0; r < RT; ++r) red[(warp * RT + r) * COLS + lane] = acc[r];
  __syncthreads();
}

// the sum over warps, in warp order, of column j of row r
template <int RT>
__device__ __forceinline__ float reduced(const float* red, int r, int j) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[(w * RT + r) * COLS + j];
  return s;
}

// ---------------------------------------------------------------- qkv --

struct QkvArgs {
  const void *x, *wn, *wq, *wk, *wv;
  const float *cos, *sin;
  void *q, *k, *v;
  int R, hidden, H, hk, d;
  float eps;
};

// Up to 16 rows a block keeps to 128 registers a thread, so two blocks
// share an SM and a grid of 192 blocks runs in one wave; 32 rows need more.
template <typename T, int RT>
__global__ void __launch_bounds__(THREADS, (RT <= 16 ? 2 : 1))
    fused_qkv_rope_kernel(QkvArgs a) {
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ wn = static_cast<const T*>(a.wn);
  const float* __restrict__ cos = a.cos;
  const float* __restrict__ sin = a.sin;
  const int R = a.R, hidden = a.hidden, H = a.H, hk = a.hk, d = a.d;
  const float eps = a.eps;
  __shared__ __align__(16) float smem[smem_floats<RT>()];
  __shared__ float scale[RT];
  float* a_s = smem;
  float* red = smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * RT;
  const int groups = d / COLS;                 // blocks per head
  const int head = blockIdx.x / groups, p = blockIdx.x % groups;
  const T* W;
  T* out;
  int ldw, base;
  bool rope = true;
  if (head < H) {
    W = static_cast<const T*>(a.wq); out = static_cast<T*>(a.q);
    ldw = H * d; base = head * d;
  } else if (head < H + hk) {
    W = static_cast<const T*>(a.wk); out = static_cast<T*>(a.k);
    ldw = hk * d; base = (head - H) * d;
  } else {
    W = static_cast<const T*>(a.wv); out = static_cast<T*>(a.v);
    ldw = hk * d; base = (head - H - hk) * d; rope = false;
  }
  const int half = d / 2, i_lo = p * (COLS / 2);
  // lane j < 16: column i_lo + j of the head's first half; else its partner
  const int col = base + (lane < 16 ? i_lo + lane : half + i_lo + lane - 16);

  // each row's f32 scale 1 / sqrt(mean(x^2) + eps), over all of hidden
  constexpr int V = 16 / sizeof(T);
  for (int r = warp; r < RT; r += WARPS) {
    float ss = 0.f;
    if (row0 + r < R) {
      const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * hidden);
#pragma unroll 8
      for (int i = lane; i < hidden / V; i += 32) {
        uint4 raw = xr[i];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const float f = to_f(e[u]);
          ss += f * f;
        }
      }
    }
    ss = warp_sum(ss);
    if (lane == 0) scale[r] = rsqrtf(ss / hidden + eps);
  }
  __syncthreads();

  // normed(r, k) = cast(x * scale) * wn[k], rounded to the storage type
  auto stage = [&](int k0, float* s) {
#pragma unroll
    for (int it = 0; it < KC * RT / THREADS; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      const int r = idx % RT, kk = idx / RT;
      const int kx = k0 + kk;
      float val = 0.f;
      if (row0 + r < R && kx < hidden) {
        val = round_to<T>(round_to<T>(to_f(x[(size_t)(row0 + r) * hidden + kx]) * scale[r]) *
                          to_f(wn[kx]));
      }
      s[kk * RT + r] = val;
    }
  };
  block_product<T, RT>(W, ldw, hidden, col, a_s, red, stage);

  // finalize: thread -> (row, pair); cast, then RoPE of the pair in f32
  for (int idx = threadIdx.x; idx < RT * (COLS / 2); idx += THREADS) {
    const int r = idx / (COLS / 2), i = idx % (COLS / 2);
    const int row = row0 + r;
    if (row >= R) continue;
    const float x1 = round_to<T>(reduced<RT>(red, r, i));
    const float x2 = round_to<T>(reduced<RT>(red, r, i + COLS / 2));
    T* orow = out + (size_t)row * ldw + base;
    const int ih = i_lo + i;
    if (rope) {
      const float* c = cos + (size_t)row * d;
      const float* sn = sin + (size_t)row * d;
      orow[ih] = from_f<T>(__fadd_rn(__fmul_rn(x1, c[ih]), __fmul_rn(-x2, sn[ih])));
      orow[half + ih] =
          from_f<T>(__fadd_rn(__fmul_rn(x2, c[half + ih]), __fmul_rn(x1, sn[half + ih])));
    } else {
      orow[ih] = from_f<T>(x1);
      orow[half + ih] = from_f<T>(x2);
    }
  }
}

// ----------------------------------------------------------- epilogue --

struct EpilogueArgs {
  const void *attn, *wo, *res, *wn;
  void *normed, *new_res;
  float *hbuf, *partial;
  unsigned int* counter;
  int R, width, hidden;
  float eps;
};

template <typename T, int RT>
__global__ void __launch_bounds__(THREADS, (RT <= 16 ? 2 : 1))
    fused_epilogue_kernel(EpilogueArgs a) {
  const T* __restrict__ attn = static_cast<const T*>(a.attn);
  const T* __restrict__ res = static_cast<const T*>(a.res);
  const T* __restrict__ wn = static_cast<const T*>(a.wn);
  T* __restrict__ normed = static_cast<T*>(a.normed);
  T* __restrict__ new_res = static_cast<T*>(a.new_res);
  float* __restrict__ hbuf = a.hbuf;
  float* __restrict__ partial = a.partial;
  const int R = a.R, width = a.width, hidden = a.hidden;
  const float eps = a.eps;
  __shared__ __align__(16) float smem[smem_floats<RT>()];
  __shared__ float scale[RT];
  __shared__ bool is_last;
  float* a_s = smem;
  float* red = smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * RT;
  const int n0 = blockIdx.x * COLS, nblk = gridDim.x;

  auto stage = [&](int k0, float* s) {
#pragma unroll
    for (int it = 0; it < KC * RT / THREADS; ++it) {
      const int idx = threadIdx.x + it * THREADS;
      const int r = idx % RT, kk = idx / RT;
      const int kx = k0 + kk;
      s[kk * RT + r] =
          row0 + r < R && kx < width ? to_f(attn[(size_t)(row0 + r) * width + kx]) : 0.f;
    }
  };
  block_product<T, RT>(static_cast<const T*>(a.wo), hidden, width, n0 + lane, a_s, red,
                       stage);

  // h = f32(cast(product)) + f32(residual): stored (f32 and cast), and the
  // row's sum of squares over this block's columns, one warp per row
  for (int r = warp; r < RT; r += WARPS) {
    const int row = row0 + r;
    float hh = 0.f;
    if (row < R) {
      const size_t at = (size_t)row * hidden + n0 + lane;
      const float h = round_to<T>(reduced<RT>(red, r, lane)) + to_f(res[at]);
      new_res[at] = from_f<T>(h);
      hbuf[at] = h;
      hh = h * h;
    }
    hh = warp_sum(hh);
    if (lane == 0 && row < R) partial[(size_t)row * nblk + blockIdx.x] = hh;
  }

  // the last block of this row tile to arrive normalises the whole tile
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(&a.counter[blockIdx.y], 1u) == (unsigned)nblk - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int r = warp; r < RT; r += WARPS) {
    const int row = row0 + r;
    float ss = 0.f;
    if (row < R) {
      // lane l adds blocks l, l + 32, ... in order; then a fixed shuffle tree
      for (int b = lane; b < nblk; b += 32) ss += __ldcg(partial + (size_t)row * nblk + b);
    }
    ss = warp_sum(ss);
    if (lane == 0) scale[r] = rsqrtf(ss / hidden + eps);
  }
  __syncthreads();
  // 4 columns per thread per step, 8 steps' loads in flight
  const int rows = min(RT, R - row0), quads = hidden / 4;
#pragma unroll 8
  for (int idx = threadIdx.x; idx < rows * quads; idx += THREADS) {
    const int r = idx / quads, c = (idx % quads) * 4;
    const size_t at = (size_t)(row0 + r) * hidden + c;
    const float4 h = __ldcg(reinterpret_cast<const float4*>(hbuf + at));
    const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      normed[at + u] = from_f<T>(round_to<T>(hv[u] * scale[r]) * to_f(wn[c + u]));
  }
  if (threadIdx.x == 0) a.counter[blockIdx.y] = 0u;  // ready for the next call
}

int row_tile(int R) { return R <= 8 ? 8 : (R <= 16 ? 16 : MAX_RT); }

// one template instance per (type, rows per block); grid.y walks the rows
template <typename T, int RT>
int launch_qkv(const QkvArgs& a, cudaStream_t s) {
  const dim3 grid((unsigned)((a.H + 2 * a.hk) * (a.d / COLS)),
                  (unsigned)((a.R + RT - 1) / RT));
  fused_qkv_rope_kernel<T, RT><<<grid, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RT>
int launch_epilogue(const EpilogueArgs& a, cudaStream_t s) {
  const dim3 grid((unsigned)(a.hidden / COLS), (unsigned)((a.R + RT - 1) / RT));
  fused_epilogue_kernel<T, RT><<<grid, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int qkv(const QkvArgs& a, cudaStream_t s) {
  const int rt = row_tile(a.R);
  return rt == 8 ? launch_qkv<T, 8>(a, s)
                 : (rt == 16 ? launch_qkv<T, 16>(a, s) : launch_qkv<T, 32>(a, s));
}

template <typename T>
int epilogue(const EpilogueArgs& a, cudaStream_t s) {
  const int rt = row_tile(a.R);
  return rt == 8 ? launch_epilogue<T, 8>(a, s)
                 : (rt == 16 ? launch_epilogue<T, 16>(a, s) : launch_epilogue<T, 32>(a, s));
}

}  // namespace

// x [R, hidden], wn [hidden], wq [hidden, H*d], wk / wv [hidden, hk*d];
// cos / sin [R, d] f32; q [R, H*d], k / v [R, hk*d]. dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int pt_fused_qkv_rope(const void* x, const void* wn, const void* wq, const void* wk,
                                 const void* wv, const void* cos, const void* sin, void* q,
                                 void* k, void* v, int R, int hidden, int H, int hk, int d,
                                 float eps, int dtype, void* stream) {
  if (R == 0) return 0;
  const QkvArgs a{x, wn, wq, wk, wv, static_cast<const float*>(cos),
                  static_cast<const float*>(sin), q, k, v, R, hidden, H, hk, d, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? qkv<__nv_bfloat16>(a, s) : qkv<float>(a, s);
}

// attn [R, width], wo [width, hidden], res [R, hidden], wn [hidden];
// normed, new_res [R, hidden]; hbuf [R, hidden] f32 and partial
// [R, hidden / 32] f32 are scratch; counter holds one zero uint32 per
// 32-row tile and is left at zero. Returns cudaGetLastError().
extern "C" int pt_fused_epilogue(const void* attn, const void* wo, const void* res,
                                 const void* wn, void* normed, void* new_res, void* hbuf,
                                 void* partial, void* counter, int R, int width, int hidden,
                                 float eps, int dtype, void* stream) {
  if (R == 0) return 0;
  const EpilogueArgs a{attn, wo, res, wn, normed, new_res, static_cast<float*>(hbuf),
                       static_cast<float*>(partial), static_cast<unsigned int*>(counter),
                       R, width, hidden, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? epilogue<__nv_bfloat16>(a, s) : epilogue<float>(a, s);
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
