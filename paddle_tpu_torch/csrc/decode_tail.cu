// The fused decode tail for Hopper (sm_90a): two kernels that turn the
// non-attention work of a decode layer into two launches.
//
// Replaces: paddle_tpu/ops/pallas/decode_tail.py
//   - `_qkv_kernel` (:193; `fused_qkv_rope`, pallas_call at :260):
//     rms_norm(x) -> x.Wq, x.Wk, x.Wv with f32 sums -> rotate-half RoPE of
//     q and k at each row's position;
//   - `_epilogue_kernel` (:294; `fused_epilogue`, pallas_call at :347):
//     attn.Wo with f32 sums -> cast -> + residual in f32 -> RMSNorm of the
//     f32 sum.
//
// Bound on the H100: device-memory bytes. Each call streams its weights
// once (Llama-3-8B: 50.3 MB for Wq|Wk|Wv, 33.6 MB for Wo in bf16: 15.1 and
// 10.1 us at 3.35 TB/s) while the activations are a few hundred KB; at R
// rows a weight element takes part in 2R operations, far below the card's
// ratio of operations to bytes. In a decode step each layer's weights come
// cold from device memory, so they must stream at the memory's rate from
// the first microsecond to the last.
//
// What held the first version (CUDA-core bodies, kept below for f32) back,
// and what the bf16 bodies do about it:
//   1. Narrow, scattered loads: lane j owned column j and loaded 2 bytes a
//      row, a warp 64 bytes of a weight row, one chunk in flight a thread.
//      Now weights stream by 16-byte cp.async, 16 neighbouring threads
//      copying one row's two 128-byte runs, into a ring of 6 stages of 32
//      rows by 128 columns (8.7 KB each): every stage is asked for before
//      the block waits on anything, 5 stay in flight, 2-3 blocks an SM.
//   2. No split of the contraction: 192 (qkv) and 128 (epilogue) blocks
//      each walked all of it. Now a work item is a tile of 128 output
//      columns, a slice of whole 32-row chunks of the contraction and a
//      tile of 8, 16 or 32 rows; the host picks the slice count from
//      shapes so that every item is resident at once (Llama-3-8B at R = 8:
//      qkv 48 tiles x 8 slices, epilogue 32 x 12). Slice partials (f32)
//      go to scratch, which stays in L2; after a grid-wide sync they are
//      added in slice order, so two launches on the same inputs give the
//      same bits (no floating-point atomics).
//   3. A serial prologue: every qkv block read all of x for the row scales
//      before its first weight load. Now the grid sums the squares of x by
//      128-column segments (a warp a segment) first, each block arrives at
//      a grid barrier, asks for its x slice and its whole ring, and only
//      then waits; each row's scale is its segments' sums added in a fixed
//      order, and the block's slice of normed rows is written in place in
//      shared memory once, in bf16: round(round(x * scale) * w_norm).
//   4. A serial tail: one epilogue block normalised the whole row tile.
//      Now, after the products, a grid-wide sync; every warp of the grid
//      takes (row, column tile) items: the slices added in order, cast,
//      + residual in f32, the new residual (cast) and the f32 sum stored,
//      the tile's sum of squares of the row published; a second sync; the
//      same items normalised with the row's sums added in tile order.
//   5. CUDA-core arithmetic: 2R f32 FMAs a weight element, about 24 us at
//      R = 32 against a 15 us bytes bound. Now tensor cores, rows on the
//      narrow side ("swap AB"): mma.sync m16n8k16 (csrc/tensor_core.cuh)
//      with 16 weight columns as the A side, from the [in, out] weight by
//      ldmatrix.trans, and 8 activation rows as the N side, so R = 32 (four
//      n tiles) costs about what R = 8 does. bf16 operands are exact (the
//      normed rows are bf16 at the Pallas cast points, attn is bf16), so
//      the sums differ from the plain version only in order.
// Both kernels are cooperative launches (their grid-wide syncs need every
// block resident; a block walks further items if the card holds fewer
// blocks than items). qkv's first barrier is split in two halves on two
// words of persistent state that each launch leaves as it found them.
// Cast points are the Pallas bodies': qkv: f32 normalise -> cast -> times
// the norm weight in the storage type -> f32 sums -> cast -> RoPE in f32
// (each product and the sum rounded on their own, as the plain version
// rounds them) -> cast. Epilogue: the product cast to the storage type,
// lifted to f32 and added to the f32 residual; the new residual is the
// cast sum; the norm is taken over the f32 sum.
// What still holds them back (the row scales before the first product,
// the normalisation after the last: grid-wide dependencies a plain matrix
// product lacks) is in PERF.md.
//
// f32 (the wiring checks): the first version's CUDA-core bodies in full
// f32, each block owning 32 columns for up to 32 rows over the whole
// contraction.
// Limits: head width and hidden multiples of 128, 16-byte aligned rows;
// the wrapper checks them.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace cg = cooperative_groups;


namespace {

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

// sets a kernel's opt-in shared memory once it needs more than before
template <typename K> int allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return (int)err;
}

struct QkvArgs {
  const void *x, *wn, *wq, *wk, *wv;
  const float *cos, *sin;
  void *q, *k, *v;
  float* part;  // bf16 body: partials, then the rows' sums of squares
  unsigned int* barrier;
  int R, hidden, H, hk, d, split;
  float eps;
};

struct EpilogueArgs {
  const void *attn, *wo, *res, *wn;
  void *normed, *new_res;
  float *part, *hbuf, *ss;  // f32 body: no part; ss [R, hidden / 32]
  unsigned int* counter;
  int R, width, hidden, split;
  float eps;
};

// ============================================== f32 bodies (CUDA cores) ==

namespace f32k {

constexpr int THREADS = 256;      // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 32;          // output columns per block
constexpr int KC = 256;           // contraction rows per staged chunk
constexpr int KPW = KC / WARPS;   // contraction rows per warp per chunk
static_assert((KC * 8) % THREADS == 0, "a staged chunk splits evenly over the threads");

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


template <typename T, int RT>
__global__ void __launch_bounds__(THREADS, (RT <= 16 ? 2 : 1))
    fused_epilogue_kernel(EpilogueArgs a) {
  const T* __restrict__ attn = static_cast<const T*>(a.attn);
  const T* __restrict__ res = static_cast<const T*>(a.res);
  const T* __restrict__ wn = static_cast<const T*>(a.wn);
  T* __restrict__ normed = static_cast<T*>(a.normed);
  T* __restrict__ new_res = static_cast<T*>(a.new_res);
  float* __restrict__ hbuf = a.hbuf;
  float* __restrict__ partial = a.ss;
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

int row_tile(int R) { return R <= 8 ? 8 : (R <= 16 ? 16 : 32); }

// one template instance per rows-per-block; grid.y walks the row tiles
template <int RT>
int launch_qkv(const QkvArgs& a, cudaStream_t s) {
  const dim3 grid((unsigned)((a.H + 2 * a.hk) * (a.d / COLS)),
                  (unsigned)((a.R + RT - 1) / RT));
  fused_qkv_rope_kernel<float, RT><<<grid, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int RT>
int launch_epilogue(const EpilogueArgs& a, cudaStream_t s) {
  const dim3 grid((unsigned)(a.hidden / COLS), (unsigned)((a.R + RT - 1) / RT));
  fused_epilogue_kernel<float, RT><<<grid, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int qkv(const QkvArgs& a, cudaStream_t s) {
  const int rt = row_tile(a.R);
  return rt == 8 ? launch_qkv<8>(a, s) : (rt == 16 ? launch_qkv<16>(a, s) : launch_qkv<32>(a, s));
}

int epilogue(const EpilogueArgs& a, cudaStream_t s) {
  const int rt = row_tile(a.R);
  return rt == 8 ? launch_epilogue<8>(a, s)
                 : (rt == 16 ? launch_epilogue<16>(a, s) : launch_epilogue<32>(a, s));
}

}  // namespace f32k

// ============================================ bf16 bodies (tensor cores) ==

namespace tck {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 128;              // 4 warps, each owning 32 of the tile's columns
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 128;                 // output columns of a work item
constexpr int HALF = TILE / 2;            // a tile is two runs of 64 columns
constexpr int KC = 32;                    // contraction rows of a ring stage
constexpr int STAGES = 6;                 // all issued before anything waits
constexpr int LDW = TILE + tc::PAD;       // a stage's row stride in elements
constexpr int STAGE_ELEMS = KC * LDW;
constexpr int MAX_SPLIT = 16;             // slices of the contraction
constexpr int SEG = 128;                  // x columns of one partial sum of squares
static_assert(KC * TILE / 8 % THREADS == 0, "a stage splits evenly into 16-byte copies");

int n_tile_of(int R) { return R <= 8 ? 1 : (R <= 16 ? 2 : 4); }

// dynamic shared memory: the ring, then the item's slice of activation
// rows [RT][slice rows + PAD], then (qkv) the slice of the norm weight, bf16
size_t smem_bytes(int NT, int cps) {
  return sizeof(bf16) *
         ((size_t)STAGES * STAGE_ELEMS + (size_t)8 * NT * (cps * KC + tc::PAD) + cps * KC);
}

// four floats rounded to bf16, as 8 bytes
__device__ __forceinline__ uint2 pack4(const float (&v)[4]) {
  uint2 o;
  o.x = tc::pack(v[0], v[1]);
  o.y = tc::pack(v[2], v[3]);
  return o;
}

// A grid-wide barrier in two halves, for a grid whose blocks are all
// resident (a cooperative launch): thread 0 arrives once the block's
// writes are fenced, the block does other work, then waits. bar[0] counts
// arrivals, bar[1] is the generation; the last to arrive resets the count
// and advances the generation, so the pair is left as the next barrier
// (and the next launch) needs it.
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// every thread: its writes fenced; thread 0: the arrival. Returns (in
// thread 0) the generation to wait past.
__device__ __forceinline__ unsigned grid_arrive(unsigned* bar) {
  __threadfence();
  __syncthreads();
  unsigned gen = 0;
  if (threadIdx.x == 0) {
    gen = load_acquire(bar + 1);
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    }
  }
  return gen;
}

__device__ __forceinline__ void grid_wait(const unsigned* bar, unsigned gen) {
  if (threadIdx.x == 0)
    while (load_acquire(bar + 1) == gen) {
    }
  __syncthreads();
}

struct Item {
  int tile, slice, rtile, k0, nck;  // nck: 32-row chunks of this slice
};

// work item i -> (column tile, slice, row tile); neighbouring blocks take
// neighbouring tiles of one slice, so the rows they stream lie together
__device__ __forceinline__ Item item(int i, int n_tiles, int split, int cps, int n_chunks) {
  Item it;
  it.tile = i % n_tiles;
  const int rest = i / n_tiles;
  it.slice = rest % split;
  it.rtile = rest / split;
  const int c0 = it.slice * cps;
  it.k0 = c0 * KC;
  it.nck = max(0, min(cps, n_chunks - c0));
  return it;
}

// chunk at contraction row k of columns [c_lo, +64) and [c_hi, +64) of W
// into a ring stage: 16 neighbouring threads copy one row's two 128-byte
// runs, 16 bytes each
__device__ __forceinline__ void issue_chunk(bf16* st, const bf16* __restrict__ W, int ldw, int k,
                                            int c_lo, int c_hi) {
#pragma unroll
  for (int u = 0; u < KC * TILE / 8 / THREADS; ++u) {
    const int p = threadIdx.x + u * THREADS, row = p >> 4, j = p & 15;
    const int col = j < 8 ? c_lo + 8 * j : c_hi + 8 * (j - 8);
    tc::cp_async16(st + row * LDW + 8 * j, W + (size_t)(k + row) * ldw + col, true);
  }
}

// rows [row0, row0 + rows) of a [*, ld] matrix, columns [k0, k0 + 8 vecs),
// into act as one copy group (rows past `rows` up to RT zero-filled)
template <int RT>
__device__ __forceinline__ void issue_act(bf16* act, int lda, const bf16* __restrict__ src,
                                          int ld, int row0, int rows, int k0, int vecs) {
  for (int idx = threadIdx.x; idx < RT * vecs; idx += THREADS) {
    const int r = idx / vecs, v = idx - r * vecs;
    const bool ok = r < rows;
    tc::cp_async16(act + r * lda + 8 * v, src + (ok ? (size_t)(row0 + r) * ld + k0 + 8 * v : 0),
                   ok);
  }
  tc::cp_async_commit();
}

// acc += W-stage^T (this warp's 32 columns) x act rows, over the stage's 32
// contraction rows (act columns kbase ..): one ldmatrix of each n tile
// gives the B fragments of both k steps
template <int NT>
__device__ __forceinline__ void mma_chunk(const bf16* st, const bf16* act, int lda, int kbase,
                                          float (&acc)[2][NT][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t b[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    tc::ldsm_x4(b[nt], act + (nt * 8 + (lane & 7)) * lda + kbase + (lane >> 3) * 8);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      uint32_t a[4];
      tc::ldsm_x4_t(a, st + tc::b_off(16 * h, 32 * warp + 16 * mi, LDW, lane));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) tc::mma(acc[mi][nt], a, b[nt][2 * h], b[nt][2 * h + 1]);
    }
  }
}

// An item's product over its slice, in two steps. `start`: after the
// caller's copy group of act rows, every stage of the ring issued, one
// group each. `finish`: `fill` (which may wait for the act group alone and
// write act with plain stores), then a chunk at a time, one barrier each,
// chunk c + STAGES - 1 refilling the stage chunk c - 1 left; leaves the
// ring and act free for the next item.
struct Stream {
  const bf16* W;
  int ldw, c_lo, c_hi;
};

__device__ __forceinline__ void start(const Stream& w, const Item& it, bf16* ring) {
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < it.nck) issue_chunk(ring + s * STAGE_ELEMS, w.W, w.ldw, it.k0 + s * KC, w.c_lo, w.c_hi);
    tc::cp_async_commit();
  }
}

template <int NT, typename Fill>
__device__ __forceinline__ void finish(const Stream& w, const Item& it, bf16* ring,
                                       const bf16* act, int lda, Fill fill,
                                       float (&acc)[2][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
  fill();
  // groups: act, then chunks 0 .. STAGES - 1, then one a step from c = 1,
  // so chunk c is group c + 2 and at most STAGES - 2 may stay in flight
  // (at c = 0 this waits for chunk 1 as well)
  for (int c = 0; c < it.nck; ++c) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c (and act) visible; chunk c - 1's readers done
    if (c > 0) {
      const int nx = c + STAGES - 1;
      if (nx < it.nck)
        issue_chunk(ring + (nx % STAGES) * STAGE_ELEMS, w.W, w.ldw, it.k0 + nx * KC, w.c_lo,
                    w.c_hi);
      tc::cp_async_commit();
    }
    mma_chunk<NT>(ring + (c % STAGES) * STAGE_ELEMS, act, lda, c * KC, acc);
  }
  tc::cp_async_wait<0>();
  __syncthreads();
}

// this item's f32 partial into P [RT][TILE]
template <int NT>
__device__ __forceinline__ void store_partial(float* P, const float (&acc)[2][NT][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int m = 32 * warp + 16 * mi + gid, n = 8 * nt + 2 * tig;
      P[n * TILE + m] = acc[mi][nt][0];
      P[(n + 1) * TILE + m] = acc[mi][nt][1];
      P[n * TILE + m + 8] = acc[mi][nt][2];
      P[(n + 1) * TILE + m + 8] = acc[mi][nt][3];
    }
}

// the sum over slices, in slice order, of 2 (4) neighbouring columns of one
// row's partials (P at the row and column, slices RT * TILE apart), every
// slice's load in flight at once
__device__ __forceinline__ float2 slices2(const float* P, int split, int stride) {
  float2 q[MAX_SPLIT];
#pragma unroll
  for (int s = 0; s < MAX_SPLIT; ++s)
    if (s < split) q[s] = __ldcg(reinterpret_cast<const float2*>(P + (size_t)s * stride));
  float2 v = make_float2(0.f, 0.f);
#pragma unroll
  for (int s = 0; s < MAX_SPLIT; ++s)
    if (s < split) {
      v.x += q[s].x;
      v.y += q[s].y;
    }
  return v;
}

__device__ __forceinline__ float4 slices4(const float* P, int split, int stride) {
  float4 q[MAX_SPLIT];
#pragma unroll
  for (int s = 0; s < MAX_SPLIT; ++s)
    if (s < split) q[s] = __ldcg(reinterpret_cast<const float4*>(P + (size_t)s * stride));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int s = 0; s < MAX_SPLIT; ++s)
    if (s < split) {
      v.x += q[s].x; v.y += q[s].y; v.z += q[s].z; v.w += q[s].w;
    }
  return v;
}

// ---------------------------------------------------------------- qkv --

// a tile of 64 RoPE pairs: its matrix, row stride, first column of its
// head, and whether it is roped
struct QkvTile {
  const bf16* W;
  bf16* out;
  int ldw, base;
  bool rope;
};

__device__ __forceinline__ QkvTile qkv_tile(const QkvArgs& a, int head) {
  const int d = a.d;
  if (head < a.H)
    return {static_cast<const bf16*>(a.wq), static_cast<bf16*>(a.q), a.H * d, head * d, true};
  if (head < a.H + a.hk)
    return {static_cast<const bf16*>(a.wk), static_cast<bf16*>(a.k), a.hk * d,
            (head - a.H) * d, true};
  return {static_cast<const bf16*>(a.wv), static_cast<bf16*>(a.v), a.hk * d,
          (head - a.H - a.hk) * d, false};
}

// A cooperative launch; blocks walk the work items (column tile of 64
// RoPE pairs, slice, row tile). The grid first sums the squares of x in
// 128-column segments (a warp a segment of a row); each block then
// arrives at a grid barrier, asks for its first item's x and norm-weight
// slices and every ring stage, and waits; each item scales its slice of x
// from the segments' sums (in a fixed order), normalises it in place and
// streams its weights. After a grid-wide sync every warp takes (row, tile)
// items: slices added in order, cast, RoPE of the pairs.
template <int NT>
__global__ void __launch_bounds__(THREADS, 3) qkv_tc_kernel(QkvArgs a) {
  constexpr int RT = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* act = ring + STAGES * STAGE_ELEMS;
  __shared__ float scale[RT];
  cg::grid_group grid = cg::this_grid();
  const bf16* __restrict__ x = static_cast<const bf16*>(a.x);
  const bf16* __restrict__ wn = static_cast<const bf16*>(a.wn);
  const int R = a.R, hidden = a.hidden, d = a.d, split = a.split;
  const int n_chunks = hidden / KC, cps = (n_chunks + split - 1) / split;
  const int lda = cps * KC + tc::PAD;
  const int per_head = d / TILE, n_tiles = (a.H + 2 * a.hk) * per_head;
  const int n_items = n_tiles * split * ((R + RT - 1) / RT);
  const int n_seg = hidden / SEG, half = d / 2;
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * WARPS + (threadIdx.x >> 5), n_warps = gridDim.x * WARPS;
  float* ssq = a.part + (size_t)n_items * RT * TILE;  // [R][n_seg]

  auto stream_of = [&](const Item& it) {
    const QkvTile t = qkv_tile(a, it.tile / per_head);
    const int i_lo = HALF * (it.tile % per_head);
    return Stream{t.W, t.ldw, t.base + i_lo, t.base + half + i_lo};
  };
  bf16* wn_s = act + RT * lda;  // the slice of the norm weight
  // an item's slices of x and of the norm weight, one copy group
  auto fetch_act = [&](const Item& it) {
    const int row0 = it.rtile * RT, vecs = it.nck * KC / 8;
    for (int v = threadIdx.x; v < vecs; v += THREADS)
      tc::cp_async16(wn_s + 8 * v, wn + it.k0 + 8 * v, true);
    issue_act<RT>(act, lda, x, hidden, row0, min(RT, R - row0), it.k0, vecs);
  };
  auto run = [&](const Item& it) {
    const int row0 = it.rtile * RT, rows = min(RT, R - row0), vecs = it.nck * KC / 8;
    auto fill = [&]() {
      // the rows' scales: 4 threads a row, each adding every 4th segment,
      // then the four sums in a fixed order
      const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
      float ss = 0.f;
      if (r < rows) {
        const float* sr = ssq + (size_t)(row0 + r) * n_seg;
#pragma unroll 8
        for (int g = q; g < n_seg; g += 4) ss += __ldcg(sr + g);
      }
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      if (q == 0 && r < RT) scale[r] = rsqrtf(ss / hidden + a.eps);
      tc::cp_async_wait<STAGES>();  // the act group (x and the norm weight)
      __syncthreads();
      // the slice normed in place: round(round(x * scale) * w_norm)
      for (int idx = threadIdx.x; idx < rows * vecs; idx += THREADS) {
        const int rr = idx / vecs, v = idx - rr * vecs;
        uint4* at = reinterpret_cast<uint4*>(act + rr * lda + 8 * v);
        const uint4 xv = *at;
        const uint4 wv = *reinterpret_cast<const uint4*>(wn_s + 8 * v);
        const bf16* xe = reinterpret_cast<const bf16*>(&xv);
        const bf16* we = reinterpret_cast<const bf16*>(&wv);
        uint4 o;
        bf16* oe = reinterpret_cast<bf16*>(&o);
        const float sc = scale[rr];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          oe[u] = __float2bfloat16(round_to<bf16>(__bfloat162float(xe[u]) * sc) *
                                   __bfloat162float(we[u]));
        *at = o;
      }
    };
    float acc[2][NT][4];
    finish<NT>(stream_of(it), it, ring, act, lda, fill, acc);
    store_partial<NT>(a.part + ((size_t)(it.rtile * n_tiles + it.tile) * split + it.slice) *
                                   RT * TILE,
                      acc);
  };

  // each row's sum of squares by 128-column segments, a warp a segment,
  // asked for before any weight (x would queue behind the weight stream);
  // the block arrives at the barrier once its sums are stored, asks for
  // its first item's act rows and whole ring, then waits
  for (int i = gwarp; i < R * n_seg; i += n_warps) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(x + (size_t)(i / n_seg) * hidden +
                                                           (i % n_seg) * SEG) + lane);
    const float2 f0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 f1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    const float ss = warp_sum(f0.x * f0.x + f0.y * f0.y + f1.x * f1.x + f1.y * f1.y);
    if (lane == 0) ssq[i] = ss;
  }
  const unsigned gen = grid_arrive(a.barrier);
  // grid <= items: every block has a first item
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const Item it = item(i, n_tiles, split, cps, n_chunks);
    fetch_act(it);
    start(stream_of(it), it, ring);
    if (i == blockIdx.x) grid_wait(a.barrier, gen);
    run(it);
  }
  grid.sync();

  // a warp a (row, tile), 2 pairs a lane: slices in order, cast, RoPE in f32
  for (int i = gwarp; i < R * n_tiles; i += n_warps) {
    const int row = i / n_tiles, tile = i - row * n_tiles;
    const QkvTile t = qkv_tile(a, tile / per_head);
    const int ih = HALF * (tile % per_head) + 2 * lane;
    const float* Pr = a.part + ((size_t)((row / RT) * n_tiles + tile) * split * RT + row % RT) *
                                   TILE + 2 * lane;
    const float2 v1 = slices2(Pr, split, RT * TILE), v2 = slices2(Pr + HALF, split, RT * TILE);
    const float x1[2] = {round_to<bf16>(v1.x), round_to<bf16>(v1.y)};
    const float x2[2] = {round_to<bf16>(v2.x), round_to<bf16>(v2.y)};
    float o1[2], o2[2];
    if (t.rope) {
      const float2 cl = *reinterpret_cast<const float2*>(a.cos + (size_t)row * d + ih);
      const float2 ch = *reinterpret_cast<const float2*>(a.cos + (size_t)row * d + half + ih);
      const float2 sl = *reinterpret_cast<const float2*>(a.sin + (size_t)row * d + ih);
      const float2 sh = *reinterpret_cast<const float2*>(a.sin + (size_t)row * d + half + ih);
      const float c1[2] = {cl.x, cl.y}, c2[2] = {ch.x, ch.y};
      const float s1[2] = {sl.x, sl.y}, s2[2] = {sh.x, sh.y};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        o1[u] = __fadd_rn(__fmul_rn(x1[u], c1[u]), __fmul_rn(-x2[u], s1[u]));
        o2[u] = __fadd_rn(__fmul_rn(x2[u], c2[u]), __fmul_rn(x1[u], s2[u]));
      }
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        o1[u] = x1[u];
        o2[u] = x2[u];
      }
    }
    bf16* orow = t.out + (size_t)row * t.ldw + t.base + ih;
    *reinterpret_cast<uint32_t*>(orow) = tc::pack(o1[0], o1[1]);
    *reinterpret_cast<uint32_t*>(orow + half) = tc::pack(o2[0], o2[1]);
  }
}

// ----------------------------------------------------------- epilogue --

// A cooperative launch: blocks walk the work items (column tile, slice,
// row tile) and store their partials; after a grid-wide sync every warp of
// the grid takes (row, column tile) items: the slices added in order, cast,
// + residual in f32, the new residual and the f32 sum stored, the tile's
// sum of squares of the row published; after a second sync the same items
// are normalised with the row's sums of squares added in tile order.
template <int NT>
__global__ void __launch_bounds__(THREADS, 3) epilogue_tc_kernel(EpilogueArgs a) {
  constexpr int RT = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* act = ring + STAGES * STAGE_ELEMS;
  cg::grid_group grid = cg::this_grid();
  const bf16* __restrict__ res = static_cast<const bf16*>(a.res);
  const bf16* __restrict__ wn = static_cast<const bf16*>(a.wn);
  bf16* __restrict__ normed = static_cast<bf16*>(a.normed);
  bf16* __restrict__ new_res = static_cast<bf16*>(a.new_res);
  const int R = a.R, width = a.width, hidden = a.hidden, split = a.split;
  const int n_chunks = width / KC, cps = (n_chunks + split - 1) / split;
  const int lda = cps * KC + tc::PAD;
  const int n_tiles = hidden / TILE, n_rt = (R + RT - 1) / RT;
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * WARPS + (threadIdx.x >> 5), n_warps = gridDim.x * WARPS;

  for (int i = blockIdx.x; i < n_tiles * split * n_rt; i += gridDim.x) {
    const Item it = item(i, n_tiles, split, cps, n_chunks);
    const int n0 = it.tile * TILE, row0 = it.rtile * RT;
    const Stream w{static_cast<const bf16*>(a.wo), hidden, n0, n0 + HALF};
    issue_act<RT>(act, lda, static_cast<const bf16*>(a.attn), width, row0, min(RT, R - row0),
                  it.k0, it.nck * KC / 8);
    start(w, it, ring);
    float acc[2][NT][4];
    finish<NT>(w, it, ring, act, lda, [] {}, acc);
    store_partial<NT>(a.part + ((size_t)(it.rtile * n_tiles + it.tile) * split + it.slice) * RT *
                                   TILE,
                      acc);
  }
  grid.sync();

  // a warp a (row, tile), 4 columns a lane
  for (int i = gwarp; i < R * n_tiles; i += n_warps) {
    const int row = i / n_tiles, tile = i - row * n_tiles;
    const float* Pr = a.part + ((size_t)((row / RT) * n_tiles + tile) * split * RT + row % RT) *
                                   TILE + 4 * lane;
    const size_t at = (size_t)row * hidden + tile * TILE + 4 * lane;
    const uint2 rr = *reinterpret_cast<const uint2*>(res + at);
    const float4 v = slices4(Pr, split, RT * TILE);
    const float2 r01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rr.x));
    const float2 r23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rr.y));
    const float h[4] = {round_to<bf16>(v.x) + r01.x, round_to<bf16>(v.y) + r01.y,
                        round_to<bf16>(v.z) + r23.x, round_to<bf16>(v.w) + r23.y};
    *reinterpret_cast<uint2*>(new_res + at) = pack4(h);
    *reinterpret_cast<float4*>(a.hbuf + at) = make_float4(h[0], h[1], h[2], h[3]);
    const float hh = warp_sum(h[0] * h[0] + h[1] * h[1] + h[2] * h[2] + h[3] * h[3]);
    if (lane == 0) a.ss[(size_t)row * n_tiles + tile] = hh;
  }
  grid.sync();

  for (int i = gwarp; i < R * n_tiles; i += n_warps) {
    const int row = i / n_tiles, tile = i - row * n_tiles;
    float ss = 0.f;
    for (int t = lane; t < n_tiles; t += 32) ss += __ldcg(a.ss + (size_t)row * n_tiles + t);
    const int c = tile * TILE + 4 * lane;
    const size_t at = (size_t)row * hidden + c;
    const float4 h = __ldcg(reinterpret_cast<const float4*>(a.hbuf + at));
    const uint2 wr = *reinterpret_cast<const uint2*>(wn + c);
    const float sc = rsqrtf(warp_sum(ss) / hidden + a.eps);
    const float2 w01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wr.x));
    const float2 w23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wr.y));
    const float o[4] = {round_to<bf16>(h.x * sc) * w01.x, round_to<bf16>(h.y * sc) * w01.y,
                        round_to<bf16>(h.z * sc) * w23.x, round_to<bf16>(h.w * sc) * w23.y};
    *reinterpret_cast<uint2*>(normed + at) = pack4(o);
  }
}

// A cooperative launch of at most as many blocks as the SMs hold at once
// (a grid-wide sync needs them all resident), each walking the items.
template <typename K, typename Args>
int launch_coop(K kernel, const Args& a, int items, size_t smem, size_t& allowed, size_t& sized,
                int& per_sm, cudaStream_t s) {
  static int n_sm = 0;
  int err = allow_smem(kernel, smem, allowed);
  if (err) return err;
  if (n_sm == 0) {
    int dev = 0;
    if ((err = (int)cudaGetDevice(&dev))) return err;
    if ((err = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)))
      return err;
  }
  if (smem != sized) {
    if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)))
      return err;
    sized = smem;
  }
  const int grid = min(items, per_sm * n_sm);
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  Args args = a;
  void* params[] = {&args};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                          dim3((unsigned)grid), dim3(THREADS), params, smem, s);
}

template <int NT>
int launch_qkv(const QkvArgs& a, cudaStream_t s) {
  static size_t allowed = 0, sized = 0;
  static int per_sm = 0;
  const int n_chunks = a.hidden / KC, cps = (n_chunks + a.split - 1) / a.split;
  const int items = (a.H + 2 * a.hk) * (a.d / TILE) * a.split * ((a.R + 8 * NT - 1) / (8 * NT));
  return launch_coop(qkv_tc_kernel<NT>, a, items, smem_bytes(NT, cps), allowed, sized, per_sm, s);
}

template <int NT>
int launch_epilogue(const EpilogueArgs& a, cudaStream_t s) {
  static size_t allowed = 0, sized = 0;
  static int per_sm = 0;
  const int n_chunks = a.width / KC, cps = (n_chunks + a.split - 1) / a.split;
  const int items = (a.hidden / TILE) * a.split * ((a.R + 8 * NT - 1) / (8 * NT));
  return launch_coop(epilogue_tc_kernel<NT>, a, items, smem_bytes(NT, cps), allowed, sized,
                     per_sm, s);
}

int qkv(const QkvArgs& a, cudaStream_t s) {
  const int nt = n_tile_of(a.R);
  return nt == 1 ? launch_qkv<1>(a, s) : (nt == 2 ? launch_qkv<2>(a, s) : launch_qkv<4>(a, s));
}

int epilogue(const EpilogueArgs& a, cudaStream_t s) {
  const int nt = n_tile_of(a.R);
  return nt == 1 ? launch_epilogue<1>(a, s)
                 : (nt == 2 ? launch_epilogue<2>(a, s) : launch_epilogue<4>(a, s));
}

}  // namespace tck

}  // namespace

// x [R, hidden], wn [hidden], wq [hidden, H*d], wk / wv [hidden, hk*d];
// cos / sin [R, d] f32; q [R, H*d], k / v [R, hk*d]. dtype: 0 = float32,
// 1 = bfloat16. bf16: `split` slices of the contraction (1 <= split <=
// min(16, hidden / 32)); scratch holds the partials [ceil(R / RT) * RT,
// (H + 2 hk) d / 128, split, 128] (RT = 8, 16 or 32 rows, as R), then the
// rows' sums of squares [R, hidden / 128], f32. f32: no scratch. Returns
// the launch's error code. barrier: two uint32, zero when first used, left
// as a next launch needs them.
extern "C" int pt_fused_qkv_rope(const void* x, const void* wn, const void* wq, const void* wk,
                                 const void* wv, const void* cos, const void* sin, void* q,
                                 void* k, void* v, void* scratch, void* barrier, int R,
                                 int hidden, int H, int hk, int d, int split, float eps,
                                 int dtype, void* stream) {
  if (R == 0) return 0;
  const QkvArgs a{x, wn, wq, wk, wv, static_cast<const float*>(cos),
                  static_cast<const float*>(sin), q, k, v, static_cast<float*>(scratch),
                  static_cast<unsigned int*>(barrier), R, hidden, H, hk, d, split, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1) return f32k::qkv(a, s);
  if (split < 1 || split > tck::MAX_SPLIT || split > hidden / tck::KC || hidden % tck::TILE ||
      d % tck::TILE)
    return (int)cudaErrorInvalidValue;
  return tck::qkv(a, s);
}

// attn [R, width], wo [width, hidden], res [R, hidden], wn [hidden];
// normed, new_res [R, hidden]. bf16: `split` slices of the contraction
// (1 <= split <= min(16, width / 32)); scratch holds the partials
// [ceil(R / RT) * RT, hidden / 128, split, 128], then h [R, hidden] and
// the tiles' sums of squares [R, hidden / 128], f32. f32: scratch holds h
// [R, hidden] and the blocks' sums of squares [R, hidden / 32], and
// counter one zero uint32 per 32-row tile, left at zero. Returns the
// launch's error code.
extern "C" int pt_fused_epilogue(const void* attn, const void* wo, const void* res,
                                 const void* wn, void* normed, void* new_res, void* scratch,
                                 void* counter, int R, int width, int hidden, int split,
                                 float eps, int dtype, void* stream) {
  if (R == 0) return 0;
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1) {
    const EpilogueArgs a{attn, wo, res, wn, normed, new_res, nullptr, sc,
                         sc + (size_t)R * hidden, static_cast<unsigned int*>(counter), R, width,
                         hidden, 1, eps};
    return f32k::epilogue(a, s);
  }
  if (split < 1 || split > tck::MAX_SPLIT || split > width / tck::KC || width % tck::TILE ||
      hidden % tck::TILE)
    return (int)cudaErrorInvalidValue;
  const int rt = 8 * tck::n_tile_of(R), n_tiles = hidden / tck::TILE;
  const size_t n_part = (size_t)((R + rt - 1) / rt) * rt * n_tiles * split * tck::TILE;
  const EpilogueArgs a{attn, wo, res, wn, normed, new_res, sc, sc + n_part,
                       sc + n_part + (size_t)R * hidden, nullptr, R, width, hidden, split, eps};
  return tck::epilogue(a, s);
}


extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
