// MLA latent decode attention for Hopper (sm_90a): one absorbed query per
// batch row against the compressed latent cache of DeepSeek's multi-head
// latent attention, streamed once.
//
// Replaces: paddle_tpu/ops/pallas/mla_decode.py, `_kernel` (called from
// `_decode_jit` / `mla_decode_attention`).
//
// What it computes, per batch row b and head h (softmax and sums in f32):
//   score[t] = q_lat[b,h,:] . c_kv[b,t,:] + q_pe[b,h,:] . k_pe[b,t,:]
//   visible  = t <= pos[b] and (allowed == null or allowed[b,t] != 0)
//   out[b,h,:] = sum_t softmax(score)[t] * c_kv[b,t,:]   over visible t,
// q_lat and q_pe arriving pre-scaled in f32, the buffers in float32 or
// bfloat16. A row with no visible column returns exactly 0 (the Pallas
// kernel's dead-row rule), not NaN. Columns past pos[b] are never read.
//
// Bound on the H100: the bytes of c_kv and k_pe up to each row's pos, 576
// bf16 values a column at DeepSeek-V2 widths, against 16 heads x (4 r +
// 2 dr) operations a column, about 30 operations a byte: far below the
// card's ratio for bf16 tensor-core products (about 295), above its ratio
// for f32 FMAs on the CUDA cores (about 20). So the products must run on
// the tensor cores for the bytes to be the limit. A decode step's call
// reads 10-20 MB, a few microseconds at 3.35 TB/s if every SM streams its
// share at once, and an SM takes in only its share of that: the work must
// be spread evenly over all of them. At DeepSeek's widths each 32-column
// tile costs 544 products of m16n8k16 with q and P as hi + lo terms.
// At 128 heads (DeepSeek-V2 and V3) a column costs 8 times the operations
// for the same bytes: with the hi + lo terms, about 480 operations a byte,
// above the tensor cores' ratio, so the products bound those calls. Each
// head tile is a block of its own that reads the run's columns again (from
// L2 after the first): a head tile's grid is a wave of 132 / 8 = 16 blocks,
// no more than one block an SM in all (`grid_blocks`).
//
// Design (bf16 buffers, the serving path):
// - The TPU kernel runs one grid cell per batch row over the whole buffer
//   held in VMEM. Here the visible columns of all rows are cut into runs of
//   whole 32-column tiles, one run a block of a 1-D grid of about one
//   block an SM (flash-decoding, balanced over rows of any lengths). The
//   lengths live on the card, so every block works the plan out from `pos`
//   itself (`plan_tiles`, `find_run`): the fewest tiles a run, at least
//   `min_tiles`, that give no more runs than blocks; rows in order, runs in
//   order. The host sizes the grid from shapes alone (no sync). Blocks past
//   the last run exit at once. A run writes its (max, sum, context) per
//   head to its slot, block 0 each row's first slot and count; a second
//   launch merges a row's runs, each thread its 4 latent columns by an
//   online softmax over the runs, 16 runs' loads in flight at once.
// - Each block holds 16 heads, exactly the m of an m16n8k16 `mma.sync`
//   (csrc/tensor_core.cuh); fewer heads are zero rows of the tile, more
//   are further tiles on the grid's z axis. Every c_kv tile in shared
//   memory feeds both products, S = q_lat C^T + q_pe K_pe^T and O += P C,
//   so the latent is read from memory once, the point of the TPU kernel.
// - Tiles arrive by the Tensor Memory Accelerator: boxes of 32 columns x
//   64 latent (or rope) values, 128-byte swizzled so that `ldmatrix` hits
//   32 banks, nine a tile at DeepSeek's widths, asked for by one lane each
//   of warp 0 into a ring of 5 stages, each stage completing on its
//   mbarrier: the first tile, then (once every warp has asked for its q)
//   the next four, the rest as stages free up. 16-byte copies by every
//   thread, and one bulk copy a row, stalled the computing warps on their
//   issue (chip probes). A run's last tile, where it ends short, is
//   shifted back to end at the run's end (the columns before the run
//   masked), so no copy reads a column past pos; widths short of a box
//   are filled with zeros by the copy.
// - S: the 8 warps split its contraction (latent k-steps of 16 round robin,
//   and each rope k-step in two halves of the tile's columns, so that 36
//   k-steps fall evenly), each holding its q slices as A fragments in
//   registers, hi and lo terms in separate accumulators (independent
//   products in flight), and add their partial scores in a fixed order
//   through shared memory. The online softmax runs in f32, 16 threads a
//   head. O: each warp owns 64 latent columns of the context, f32
//   accumulators in registers. Two block barriers a tile.
// - q and P are f32; each enters its product as two bf16 terms, hi + lo
//   (16 bits of mantissa), against c_kv and k_pe, exact in bf16. One bf16
//   rounding of q or P moves the output past the f32 tolerance the port
//   holds (1e-4 + 1e-4 |p|; tests/test_torch_mla_split.py).
// - No atomics and no state across launches: the same inputs give the
//   same bits, and the two launches may be captured in a CUDA graph.
// f32 buffers (the wiring checks): the first version's CUDA-core body
// under the same plan and combine, 16 heads a block on the same z axis.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int BN = 32;         // columns per tile, both bodies
constexpr int MAXR = 512;      // latent width
constexpr int MAXDR = 128;     // rope width
constexpr int HT = 16;         // heads of a block (a head tile): the m of the bf16 products
constexpr int MAX_HEADS = 128; // heads of either body: 8 head tiles on the grid's z axis
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
// over the 16 lanes of this lane's half of the warp
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// visible columns of row b: t <= pos[b], t < T
__device__ __forceinline__ int visible_len(const int* pos, int b, int T_) {
  return max(0, min(T_, __ldg(pos + b) + 1));
}
__device__ __forceinline__ int row_tiles(const int* pos, int b, int T_) {
  return (visible_len(pos, b, T_) + BN - 1) / BN;
}

// The plan, by one warp (every lane returns the same): tiles a run, the
// fewest that are at least min_tiles and the tiles over the G blocks and
// give no more than G runs in all. If ceil(tiles / G) gives too many, the
// tiles over the blocks left beside one spare run a nonempty row always
// fit (each row's rounding costs at most one run); a grid no larger than
// the nonempty rows gets one run a row.
__device__ int plan_tiles(const int* pos, int B, int T_, int G, int min_tiles, int lane) {
  int total = 0, most = 0, rows = 0;
  for (int b = lane; b < B; b += 32) {
    const int n = row_tiles(pos, b, T_);
    total += n;
    most = max(most, n);
    rows += n > 0;
  }
  total = __reduce_add_sync(FULL, total);  // one instruction each (redux.sync)
  rows = __reduce_add_sync(FULL, rows);
  most = __reduce_max_sync(FULL, most);
  int per = max(min_tiles, (total + G - 1) / G);
  int runs = 0;
  for (int b = lane; b < B; b += 32) runs += (row_tiles(pos, b, T_) + per - 1) / per;
  if (__reduce_add_sync(FULL, runs) > G)
    per = G > rows ? max(per + 1, (total + (G - rows) - 1) / (G - rows)) : most;
  return per;
}

// By one warp: the first run and the number of runs of row `want_row`
// (want_row >= 0), or the row holding run `want_run` (want_row < 0; row
// -1 past the last run). Rows in order, each ceil(tiles / per) runs.
__device__ void find_run(const int* pos, int B, int T_, int per, int want_row, int want_run,
                         int lane, int& row, int& first, int& runs) {
  row = -1;
  first = runs = 0;
  int base = 0;
  for (int c = 0; c < B; c += 32) {
    const int b = c + lane;
    const int n = b < B ? (row_tiles(pos, b, T_) + per - 1) / per : 0;
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    const int excl = base + incl - n;
    const bool hit = want_row >= 0 ? b == want_row
                                   : (b < B && want_run >= excl && want_run < excl + n);
    const unsigned who = __ballot_sync(FULL, hit);
    if (who) {
      const int src = __ffs(who) - 1;
      row = c + src;
      first = __shfl_sync(FULL, excl, src);
      runs = __shfl_sync(FULL, n, src);
      return;
    }
    base += __shfl_sync(FULL, incl, 31);
  }
}

// By one warp: every row's first run and number of runs, [B][2]
__device__ void write_spans(const int* pos, int B, int T_, int per, int lane, int* span) {
  int base = 0;
  for (int c = 0; c < B; c += 32) {
    const int b = c + lane;
    const int n = b < B ? (row_tiles(pos, b, T_) + per - 1) / per : 0;
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    if (b < B) {
      span[2 * b] = base + incl - n;
      span[2 * b + 1] = n;
    }
    base += __shfl_sync(FULL, incl, 31);
  }
}

// Block k's run, by warp 0 into shared memory: {row, t_begin, t_end}, row
// -1 past the last run; block (0, 0, 0) also writes the rows' spans for
// the combine.
__device__ void block_run(const int* pos, int B, int T_, int min_tiles, int lane, int* run,
                          int* span) {
  const int G = gridDim.x, k = blockIdx.x;
  const int per = plan_tiles(pos, B, T_, G, min_tiles, lane);
  if (k == 0 && blockIdx.z == 0) write_spans(pos, B, T_, per, lane, span);
  int row, first, runs;
  find_run(pos, B, T_, per, -1, k, lane, row, first, runs);
  if (lane == 0) {
    run[0] = row;
    if (row >= 0) {
      run[1] = (k - first) * per * BN;
      run[2] = min(visible_len(pos, row, T_), run[1] + per * BN);
    }
  }
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

namespace tck {                // the bf16 body
constexpr int NT = 256;        // threads per block
constexpr int NW = NT / 32;    // warps: the split of S's contraction and of O's columns
constexpr int STAGES = 5;      // tiles in the ring
constexpr int KLW = 4;         // latent k-steps of S a warp owns, at most: 512 / 16 / 8
constexpr int KRW = 2;         // rope half k-steps (16 of the tile's columns), at most:
                               // 2 x 128 / 16 / 8
constexpr int NPW = 4;         // 16-column blocks of O a warp owns, at most: 512 / 16 / 8
constexpr int LDS = BN + 8;    // row stride of the partial scores and of P, floats
static_assert(NT == HT * BN / 2, "the softmax takes two columns a thread");

constexpr int BOXW = 64;       // values a box row holds: 128 bytes, the swizzle's span
constexpr int BOX = BN * BOXW * 2;  // bytes of a box: 32 rows of 128
__host__ __device__ constexpr int boxes(int w) { return (w + BOXW - 1) / BOXW; }
// a stage: the c_kv boxes, then the k_pe boxes, 1024-byte aligned
size_t smem_bytes(int r, int dr) {
  return 1024 + (size_t)STAGES * (boxes(r) + boxes(dr)) * BOX +
         sizeof(float) * ((size_t)NW * HT * LDS + (size_t)HT * LDS + HT);
}

// shared-memory address of the 16 bytes at (row, col), col a multiple of
// 8, of a region of boxes: box col / 64, 128 bytes a row, the 16-byte
// chunks of row `row` XORed with row % 8 (the copy's 128-byte swizzle)
__device__ __forceinline__ uint32_t swz(uint32_t region, int row, int col) {
  return region + (col / BOXW) * BOX + row * (BOXW * 2) + ((((col >> 3) & 7) ^ (row & 7)) << 4);
}
}  // namespace tck

// bf16 body. Block (k, 1, head tile): run k of the plan for heads 16 z ..
// 16 z + 15; writes the run's (m, l, acc) of each head to slot k of the
// partials [G, H] (acc [G, H, r]).
__global__ void __launch_bounds__(tck::NT, 1)
mla_decode_tc_kernel(const float* __restrict__ q_lat, const float* __restrict__ q_pe,
                     const __grid_constant__ CUtensorMap tm_c,
                     const __grid_constant__ CUtensorMap tm_k, const int* __restrict__ pos,
                     const uint8_t* __restrict__ allowed, float* __restrict__ part_m,
                     float* __restrict__ part_l, float* __restrict__ part_acc,
                     int* __restrict__ span, int B, int H, int T_, int r, int dr,
                     int min_tiles) {
  using namespace tck;
  __shared__ int run[3];
  __shared__ __align__(8) uint64_t full[STAGES];  // stage s's tile has landed
  __shared__ __align__(8) uint64_t asked;         // every warp has asked for its q
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the plan by warp 0; beside it the maps and the barriers
  if (warp == 0) {
    block_run(pos, B, T_, min_tiles, lane, run, span);
  } else if (tid == 32) {
    tc::prefetch_tensormap(&tm_c);
    if (dr > 0) tc::prefetch_tensormap(&tm_k);
    for (int s = 0; s < STAGES; ++s) tc::mbar_init(&full[s], 1);
    tc::mbar_init(&asked, NW);
    tc::mbar_init_fence();
  }
  __syncthreads();
  const int b = run[0], t_begin = run[1], t_end = run[2];
  if (b < 0) return;  // past the last run: nothing to write
  const int k = blockIdx.x, h0 = blockIdx.z * HT;

  extern __shared__ __align__(16) unsigned char smem[];
  const int RB = boxes(r), DB = boxes(dr), STAGE = (RB + DB) * BOX;
  const uint32_t ring = (tc::smem_u32(smem) + 1023) & ~1023u;  // [STAGES][c_kv | k_pe boxes]
  float* red = reinterpret_cast<float*>(smem + (ring - tc::smem_u32(smem)) + STAGES * STAGE);
  float* ps = red + NW * HT * LDS;  // [HT][LDS] probabilities of the tile
  float* al = ps + HT * LDS;        // [HT] rescale of the context
  const int gid = lane >> 2, tig = lane & 3;
  const int n_tiles = (t_end - t_begin + BN - 1) / BN;

  // tile i of the run into ring stage i % STAGES, by warp 0: a box a lane,
  // at the tile's first column, or, for a short last tile, BN columns back
  // from the run's end (negative columns come as zeros)
  const void* map_c = &tm_c;
  const void* map_k = &tm_k;
  auto fill = [&](int i) {
    const int stage = i % STAGES, ts = min(t_begin + i * BN, t_end - BN);
    const uint32_t dst = ring + stage * STAGE;
    if (lane == 0) tc::mbar_expect_tx(&full[stage], (uint32_t)STAGE);
    __syncwarp();
    if (lane < RB)
      tc::tma_load_3d(dst + lane * BOX, map_c, lane * BOXW, ts, b, &full[stage]);
    else if (lane < RB + DB)
      tc::tma_load_3d(dst + lane * BOX, map_k, (lane - RB) * BOXW, ts, b, &full[stage]);
  };
  if (warp == 0) fill(0);  // n_tiles >= 1
  // this warp's q slices as hi + lo A fragments, zero past H and the
  // widths: its latent k-steps j = warp + NW m, its rope half k-steps
  // i = warp + NW m (k-step i / 2 against the tile's columns 16 (i % 2) ..
  // + 15). Every load is asked for before any is used.
  const int KL = round16(r) / 16, KR = 2 * (round16(dr) / 16);
  float qv[KLW + KRW][4][2];
#pragma unroll
  for (int m = 0; m < KLW + KRW; ++m) {
    const bool lat = m < KLW;
    const int j = warp + NW * (lat ? m : m - KLW);
    const int w = lat ? r : dr, c0 = 16 * (lat ? j : j / 2);
    const float* src = (lat ? q_lat : q_pe) + ((size_t)b * H + h0) * w;
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // a0..a3: rows gid, gid + 8; columns +0, +8
      const int row = gid + (e & 1) * 8, col = c0 + 2 * tig + (e >> 1) * 8;
      const bool ok = j < (lat ? KL : KR) && h0 + row < H && col < w;
      const float2 x = ok ? *reinterpret_cast<const float2*>(src + (size_t)row * w + col)
                          : make_float2(0.f, 0.f);
      qv[m][e][0] = x.x;
      qv[m][e][1] = x.y;
    }
  }
  // then warp 0 asks for the next tiles (the first went before the
  // queries): an SM takes its bytes in about the order they were asked
  // for, and the queries and the first tile are needed first
  __syncwarp();
  if (lane == 0) tc::mbar_arrive(&asked);
  if (warp == 0) {
    tc::mbar_wait(&asked, 0);
    for (int i = 1; i < STAGES && i < n_tiles; ++i) fill(i);
  }
  uint32_t qh[KLW + KRW][4], ql[KLW + KRW][4];
#pragma unroll
  for (int m = 0; m < KLW + KRW; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) tc::split(qh[m][e], ql[m][e], qv[m][e][0], qv[m][e][1]);

  // the softmax's layout: head hs, columns cs2 and cs2 + 1 of a tile; the
  // 16 threads of a head hold its running max and sum alike
  const int hs = tid >> 4, cs2 = (tid & 15) * 2;
  float m_run = -INFINITY, l_run = 0.f;
  // O: rows gid (o[.][.][0..1]) and gid + 8 (o[.][.][2..3]) of this warp's
  // 16-column blocks q = warp + NW p
  const int NP = round16(r) / 16;
  float o[NPW][2][4];
#pragma unroll
  for (int p = 0; p < NPW; ++p)
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) o[p][nb][0] = o[p][nb][1] = o[p][nb][2] = o[p][nb][3] = 0.f;

  // two block barriers a tile: the partial scores are written (and the
  // last tile, its P and rescale are read: warp 0 refills the last tile's
  // stage), then P is written (and the partial scores are read)
  for (int i = 0; i < n_tiles; ++i) {
    tc::mbar_wait(&full[i % STAGES], (i / STAGES) & 1);  // tile i has landed
    const uint32_t cs = ring + (i % STAGES) * STAGE, ks = cs + RB * BOX;
    const int t0 = t_begin + i * BN, ts = min(t0, t_end - BN);
    // this thread's two columns of the softmax (the tile's columns ts ..,
    // the run's from t0 on), visible or not, asked for before the products
    const int ca = ts + cs2;
    bool v0 = ca >= t0 && ca < t_end, v1 = ca + 1 >= t0 && ca + 1 < t_end;
    if (allowed != nullptr) {
      const uint8_t* arow = allowed + (size_t)b * T_;
      v0 = v0 && arow[ca] != 0;
      v1 = v1 && arow[ca + 1] != 0;
    }

    // this warp's part of S = q_lat C^T + q_pe K_pe^T over its k-steps;
    // the hi and lo terms in their own accumulators, 8 products in flight
    float sh[BN / 8][4], sl[BN / 8][4];
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sh[nb][e] = sl[nb][e] = 0.f;
    const int brow = (lane & 7) + ((lane >> 4) << 3), bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int m = 0; m < KLW; ++m) {
      const int j = warp + NW * m;
      if (j < KL) {
        uint32_t kb[BN / 16][4];
#pragma unroll
        for (int np = 0; np < BN / 16; ++np)
          tc::ldsm_x4(kb[np], swz(cs, 16 * np + brow, 16 * j + bcol));
#pragma unroll
        for (int nb = 0; nb < BN / 8; ++nb)
          tc::mma(sh[nb], qh[m], kb[nb / 2][2 * (nb & 1)], kb[nb / 2][2 * (nb & 1) + 1]);
#pragma unroll
        for (int nb = 0; nb < BN / 8; ++nb)
          tc::mma(sl[nb], ql[m], kb[nb / 2][2 * (nb & 1)], kb[nb / 2][2 * (nb & 1) + 1]);
      }
    }
#pragma unroll
    for (int m = KLW; m < KLW + KRW; ++m) {
      const int i = warp + NW * (m - KLW), half = i & 1;
      if (i < KR) {
        uint32_t kb[4];
        tc::ldsm_x4(kb, swz(ks, 16 * half + brow, 16 * (i / 2) + bcol));
        if (half == 0) {  // warp-uniform: the accumulators stay in registers
          tc::mma(sh[0], qh[m], kb[0], kb[1]);
          tc::mma(sh[1], qh[m], kb[2], kb[3]);
          tc::mma(sl[0], ql[m], kb[0], kb[1]);
          tc::mma(sl[1], ql[m], kb[2], kb[3]);
        } else {
          tc::mma(sh[2], qh[m], kb[0], kb[1]);
          tc::mma(sh[3], qh[m], kb[2], kb[3]);
          tc::mma(sl[2], ql[m], kb[0], kb[1]);
          tc::mma(sl[3], ql[m], kb[2], kb[3]);
        }
      }
    }
    float* rw = red + warp * HT * LDS;
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      *reinterpret_cast<float2*>(rw + gid * LDS + nb * 8 + 2 * tig) =
          make_float2(sh[nb][0] + sl[nb][0], sh[nb][1] + sl[nb][1]);
      *reinterpret_cast<float2*>(rw + (gid + 8) * LDS + nb * 8 + 2 * tig) =
          make_float2(sh[nb][2] + sl[nb][2], sh[nb][3] + sl[nb][3]);
    }
    __syncthreads();
    if (warp == 0 && i > 0 && i + STAGES - 1 < n_tiles) fill(i + STAGES - 1);

    // the warps' parts added in order, then the online softmax of head hs
    {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float2 x = *reinterpret_cast<const float2*>(red + (w * HT + hs) * LDS + cs2);
        s0 += x.x;
        s1 += x.y;
      }
      s0 = v0 ? s0 : -INFINITY;
      s1 = v1 ? s1 : -INFINITY;
      const float m_new = fmaxf(m_run, half_max(fmaxf(s0, s1)));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a head that saw nothing yet
      const float p0 = expf(s0 - m_use), p1 = expf(s1 - m_use);  // 0 where hidden
      const float alpha = expf(m_run - m_use);                   // 0 while m_run = -inf
      l_run = l_run * alpha + half_sum(p0 + p1);
      m_run = m_new;
      *reinterpret_cast<float2*>(ps + hs * LDS + cs2) = make_float2(p0, p1);
      if ((tid & 15) == 0) al[hs] = alpha;
    }
    __syncthreads();

    // O = alpha O + P C: P (16 heads x 32 columns) as hi + lo A fragments,
    // the same c_kv tile as B (k-major: ldmatrix.trans); 8 products in
    // flight
    {
      const float a0 = al[gid], a1 = al[gid + 8];
#pragma unroll
      for (int p = 0; p < NPW; ++p)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          o[p][nb][0] *= a0;
          o[p][nb][1] *= a0;
          o[p][nb][2] *= a1;
          o[p][nb][3] *= a1;
        }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t ph[4], pl[4];
        {
          float c0[4], c1[4];
          const float* r0 = ps + gid * LDS + 16 * kk + 2 * tig;
          const float* r1 = r0 + 8 * LDS;
          const float2 x0 = *reinterpret_cast<const float2*>(r0);
          const float2 x1 = *reinterpret_cast<const float2*>(r1);
          const float2 x2 = *reinterpret_cast<const float2*>(r0 + 8);
          const float2 x3 = *reinterpret_cast<const float2*>(r1 + 8);
          c0[0] = x0.x, c0[1] = x0.y, c0[2] = x1.x, c0[3] = x1.y;
          c1[0] = x2.x, c1[1] = x2.y, c1[2] = x3.x, c1[3] = x3.y;
          tc::a_from_c(ph, pl, c0, c1);
        }
        uint32_t vb[NPW][4];
#pragma unroll
        for (int p = 0; p < NPW; ++p)
          if (warp + NW * p < NP)
            tc::ldsm_x4_t(vb[p], swz(cs, 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                                     16 * (warp + NW * p) + (lane >> 4) * 8));
#pragma unroll
        for (int p = 0; p < NPW; ++p)
          if (warp + NW * p < NP) {
            tc::mma(o[p][0], ph, vb[p][0], vb[p][1]);
            tc::mma(o[p][1], ph, vb[p][2], vb[p][3]);
          }
#pragma unroll
        for (int p = 0; p < NPW; ++p)
          if (warp + NW * p < NP) {
            tc::mma(o[p][0], pl, vb[p][0], vb[p][1]);
            tc::mma(o[p][1], pl, vb[p][2], vb[p][3]);
          }
      }
    }
  }

  // the run's partial of every head of the tile that exists
  const size_t base = (size_t)k * H + h0;  // head h0 + h at base + h
  if ((tid & 15) == 0 && h0 + hs < H) {
    part_m[base + hs] = m_run;
    part_l[base + hs] = l_run;
  }
#pragma unroll
  for (int p = 0; p < NPW; ++p) {
    const int q = warp + NW * p;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const int col = 16 * q + 8 * nb + 2 * tig;
      if (q < NP && col < r) {
        if (h0 + gid < H)
          *reinterpret_cast<float2*>(part_acc + (base + gid) * r + col) =
              make_float2(o[p][nb][0], o[p][nb][1]);
        if (h0 + gid + 8 < H)
          *reinterpret_cast<float2*>(part_acc + (base + gid + 8) * r + col) =
              make_float2(o[p][nb][2], o[p][nb][3]);
      }
    }
  }
}

namespace f32k {               // the f32 body (the first version's)
constexpr int NT = 256;        // threads per block (8 warps)
constexpr int RS_PAD = 1;      // shared row stride r + 1: an odd number of words
// a block's shared memory: its head tile's queries (at most HT heads), P
// and the rescale of the tile, a c_kv and a k_pe tile
size_t smem_bytes(int r, int dr) {
  return sizeof(float) * ((size_t)HT * r + (size_t)HT * dr + HT * (BN + 1) + HT +
                          (size_t)BN * (r + RS_PAD) + (size_t)BN * (dr + RS_PAD));
}
}  // namespace f32k

// f32 body (CUDA cores). Block (k, 1, head tile): run k of the plan for
// heads 16 z .. 16 z + 15 (those below H), as the bf16 body tiles them,
// tiles read synchronously; warp w owns heads w and w + 8 of the tile in
// the scores (lane = column, the online softmax across the warp), thread i
// latent columns i and i + 256 of every head of the tile in the context.
// Writes the partials as the bf16 body does.
__global__ void __launch_bounds__(f32k::NT)
mla_decode_split_kernel(const float* __restrict__ q_lat, const float* __restrict__ q_pe,
                        const float* __restrict__ ckv, const float* __restrict__ kpe,
                        const int* __restrict__ pos, const uint8_t* __restrict__ allowed,
                        float* __restrict__ part_m, float* __restrict__ part_l,
                        float* __restrict__ part_acc, int* __restrict__ span, int B, int H,
                        int T_, int r, int dr, int min_tiles) {
  using namespace f32k;
  __shared__ int run[3];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == 0) block_run(pos, B, T_, min_tiles, lane, run, span);
  __syncthreads();
  const int b = run[0], t_begin = run[1], limit = run[2];
  if (b < 0) return;
  const int hb = blockIdx.z * HT, NH = min(HT, H - hb);  // the tile's first head, its heads

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [NH][r]
  float* qps = qs + HT * r;          // [NH][dr]
  float* ps = qps + HT * dr;         // [HT][BN + 1] probabilities
  float* al = ps + HT * (BN + 1);    // [HT] rescale of this tile
  float* cks = al + HT;              // [BN][r + 1]
  const int RS = r + RS_PAD, DS = dr + RS_PAD;
  float* kps = cks + BN * RS;        // [BN][dr + 1]

  for (int i = tid; i < NH * r; i += NT) qs[i] = q_lat[((size_t)b * H + hb) * r + i];
  for (int i = tid; i < NH * dr; i += NT) qps[i] = q_pe[((size_t)b * H + hb) * dr + i];

  const int h0 = warp, h1 = warp + 8;
  float m0 = -INFINITY, l0 = 0.f, m1 = -INFINITY, l1 = 0.f;
  const int d0 = tid, d1 = tid + NT;
  float acc[HT][2];
#pragma unroll
  for (int h = 0; h < HT; ++h) acc[h][0] = acc[h][1] = 0.f;

  for (int t0 = t_begin; t0 < limit; t0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BN * r; i += NT) {
      const int c = i / r, d = i - c * r, col = t0 + c;
      cks[c * RS + d] = col < limit ? ckv[((size_t)b * T_ + col) * r + d] : 0.f;
    }
    for (int i = tid; i < BN * dr; i += NT) {
      const int c = i / dr, d = i - c * dr, col = t0 + c;
      kps[c * DS + d] = col < limit ? kpe[((size_t)b * T_ + col) * dr + d] : 0.f;
    }
    __syncthreads();

    const int col = t0 + lane;
    const bool vis = col < limit &&
                     (allowed == nullptr || allowed[(size_t)b * T_ + col] != 0);
    if (h0 < NH) {
      float s0 = 0.f, s1 = 0.f;
      const bool two = h1 < NH;
      const float* crow = cks + lane * RS;
      for (int d = 0; d < r; ++d) {
        const float x = crow[d];
        s0 = fmaf(qs[h0 * r + d], x, s0);
        if (two) s1 = fmaf(qs[h1 * r + d], x, s1);
      }
      const float* krow = kps + lane * DS;
      for (int d = 0; d < dr; ++d) {
        const float x = krow[d];
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
    for (int h = 0; h < HT; ++h) {
      if (h < NH) {
        const float a = al[h];
        acc[h][0] *= a;
        acc[h][1] *= a;
      }
    }
    for (int c = 0; c < BN; ++c) {
      const float x0 = d0 < r ? cks[c * RS + d0] : 0.f;
      const float x1 = d1 < r ? cks[c * RS + d1] : 0.f;
#pragma unroll
      for (int h = 0; h < HT; ++h) {
        if (h < NH) {
          const float p = ps[h * (BN + 1) + c];
          acc[h][0] = fmaf(p, x0, acc[h][0]);
          acc[h][1] = fmaf(p, x1, acc[h][1]);
        }
      }
    }
  }

  const size_t base = (size_t)blockIdx.x * H + hb;  // head hb + h at base + h
  if (lane == 0 && h0 < NH) {
    part_m[base + h0] = m0;
    part_l[base + h0] = l0;
    if (h1 < NH) {
      part_m[base + h1] = m1;
      part_l[base + h1] = l1;
    }
  }
#pragma unroll
  for (int h = 0; h < HT; ++h) {
    if (h < NH) {
      if (d0 < r) part_acc[(base + h) * r + d0] = acc[h][0];
      if (d1 < r) part_acc[(base + h) * r + d1] = acc[h][1];
    }
  }
}

constexpr int CT = MAXR / 4;        // threads of a combine block: 4 latent columns each
constexpr int CU = 16;              // runs a thread loads at a time

// Block (h, b): the runs of row b (first slot and count from the split
// launch's block 0), head h, merged in order by an online softmax over
// the runs' (m, l, acc) (a run that saw no visible column has m = -inf and
// adds nothing), CU runs' loads in flight at once. out = acc / L, 0 when
// L = 0 (a dead row, or none of its columns visible).
__global__ void __launch_bounds__(CT)
mla_decode_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                          const float* __restrict__ part_acc, const int* __restrict__ span,
                          float* __restrict__ out, int H, int r) {
  const int h = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  const int first = span[2 * b], runs = span[2 * b + 1];
  float M = -INFINITY, L = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s0 = 0; s0 < runs; s0 += CU) {
    float m[CU], l[CU], a[CU][4];
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      const int s = s0 + u;
      const size_t slot = (size_t)(first + s) * H + h;
      m[u] = s < runs ? part_m[slot] : -INFINITY;
      l[u] = s < runs ? part_l[slot] : 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = c + e * CT;
        a[u][e] = s < runs && d < r ? part_acc[slot * r + d] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      if (m[u] == -INFINITY) continue;
      const float Mn = fmaxf(M, m[u]);
      const float sc = expf(M - Mn), w = expf(m[u] - Mn);  // sc = 0 while M = -inf
      L = L * sc + w * l[u];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = acc[e] * sc + w * a[u][e];
      M = Mn;
    }
  }
  const float inv = L > 0.f ? 1.f / L : 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = c + e * CT;
    if (d < r) out[((size_t)b * H + h) * r + d] = acc[e] * inv;
  }
}

// sets a kernel's opt-in shared memory once it needs more than before
template <typename K> int allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return (int)err;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, looked up once through the runtime
// (no link against the driver library)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the map of a bf16 buffer [B, T, w]: boxes of BN rows x 64 values,
// 128-byte swizzled, zeros past its bounds
int encode_map(CUtensorMap* map, const void* buf, int B, int T_, int w) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)w, (cuuint64_t)T_, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)w * 2, (cuuint64_t)T_ * w * 2};
  const cuuint32_t box[3] = {(cuuint32_t)tck::BOXW, (cuuint32_t)BN, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(buf), dims,
                          strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// q_lat [B, H, r] f32, q_pe [B, H, dr] f32 (both pre-scaled, 8-byte
// aligned); ckv [B, T, r]
// and kpe [B, T, dr] of one type, dtype 0 = float32, 1 = bfloat16 (bf16:
// r and dr multiples of 8, both buffers 16-byte aligned); pos [B] int32;
// allowed [B, T] bytes or null; partials part_m / part_l [G, H] and
// part_acc [G, H, r] f32, span [B, 2] int32, scratch; out [B, H, r] f32.
// G >= B blocks cut the rows' visible prefixes into runs of at least
// min_tiles tiles of 32 columns (`plan_tiles`). Returns cudaGetLastError()
// after the two launches.
extern "C" int pt_mla_decode(const void* q_lat, const void* q_pe, const void* ckv,
                             const void* kpe, const void* pos, const void* allowed,
                             void* part_m, void* part_l, void* part_acc, void* span, void* out,
                             int B, int H, int T_, int r, int dr, int G, int min_tiles,
                             int dtype, void* stream) {
  const bool bf16 = dtype == 1;
  if (B < 1 || T_ < 1 || H < 1 || H > MAX_HEADS || r < 1 || r > MAXR ||
      dr < 0 || dr > MAXDR || G < B || min_tiles < 1 || (bf16 && (r % 8 != 0 || dr % 8 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ql = static_cast<const float*>(q_lat);
  const float* qp = static_cast<const float*>(q_pe);
  const int* p = static_cast<const int*>(pos);
  const uint8_t* a = static_cast<const uint8_t*>(allowed);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  int* sp = static_cast<int*>(span);
  int err;
  if (bf16) {
    static size_t ok_bytes = 0;
    const size_t smem = tck::smem_bytes(r, dr);
    if ((err = allow_smem(mla_decode_tc_kernel, smem, ok_bytes))) return err;
    alignas(64) CUtensorMap tm_c, tm_k;
    if ((err = encode_map(&tm_c, ckv, B, T_, r))) return err;
    if (dr > 0) {
      if ((err = encode_map(&tm_k, kpe, B, T_, dr))) return err;
    } else {
      tm_k = tm_c;  // no rope boxes: never read
    }
    mla_decode_tc_kernel<<<dim3(G, 1, (H + HT - 1) / HT), tck::NT, smem, s>>>(
        ql, qp, tm_c, tm_k, p, a, pm, pl, pa, sp, B, H, T_, r, dr, min_tiles);
  } else {
    static size_t ok_bytes = 0;
    const size_t smem = f32k::smem_bytes(r, dr);
    if ((err = allow_smem(mla_decode_split_kernel, smem, ok_bytes))) return err;
    mla_decode_split_kernel<<<dim3(G, 1, (H + HT - 1) / HT), f32k::NT, smem, s>>>(
        ql, qp, static_cast<const float*>(ckv), static_cast<const float*>(kpe), p, a, pm, pl, pa,
        sp, B, H, T_, r, dr, min_tiles);
  }
  if ((err = (int)cudaGetLastError())) return err;
  mla_decode_combine_kernel<<<dim3(H, B), CT, 0, s>>>(pm, pl, pa, sp, static_cast<float*>(out),
                                                      H, r);
  return (int)cudaGetLastError();
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
