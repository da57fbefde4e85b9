// Warp-level tensor-core and asynchronous-copy helpers for the bf16 bodies
// of the attention kernels (csrc/append_attention.cu, csrc/flash_attention.cu).
//
// Products are `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`:
// bf16 operands, f32 accumulators. Fragments, with gid = lane / 4 and
// tig = lane % 4:
// - A (16 x 16, row-major), four registers of two bf16: a0 (row gid,
//   columns 2 tig, 2 tig + 1), a1 (row gid + 8, the same columns), a2
//   (row gid, columns 2 tig + 8, + 9), a3 (row gid + 8, those columns);
// - B (16 x 8, k by n), two registers: b0 (k 2 tig, 2 tig + 1; n gid),
//   b1 (k 2 tig + 8, + 9; n gid);
// - C (16 x 8 f32), four floats: c0, c1 (row gid, columns 2 tig, + 1),
//   c2, c3 (row gid + 8, the same columns).
// Two neighbouring C blocks of 8 columns are exactly the A fragment of the
// next product over those 16 columns (`a_from_c`), so a probability tile
// never leaves the registers on its way into P v. A C value enters that
// product as two bf16 terms, hi + lo (`split`): one bf16 rounding of P
// (splash's) moves an output by up to 2^-9 |v|, past the port's tolerance
// on rows that see few columns, where hi + lo keeps 16 bits.
//
// Tiles live in shared memory as bf16 rows padded by 8 elements (16
// bytes): with rows of 128 or 192 elements (256 or 384 bytes) the eight
// row addresses of an `ldmatrix` would all fall on the same banks; the
// padding moves each row by 16 bytes, so eight rows cover all 32 banks.
// `ldmatrix ... .trans` gives the B fragment of a tile stored k-major
// (V in P v, dO and Q in the backward's transposed products), and the A
// fragment of a tile stored transposed (P^T and dS^T).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

constexpr int PAD = 8;  // bf16 elements of padding per shared-memory row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; `valid` false writes 16 zero
// bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N groups of this thread are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, register i holds its fragment
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b over one m16n8k16 block
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two floats as hi + lo, each a pair of bf16: hi = bf16(x), lo = bf16(x -
// hi), so hi + lo keeps 16 bits of x's mantissa where bf16 keeps 8
__device__ __forceinline__ void split(uint32_t& hi, uint32_t& lo, float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the A fragments (hi and lo terms) of the 16 columns 16 kk .. 16 kk + 15
// from the C blocks 2 kk and 2 kk + 1 of a row of C blocks
__device__ __forceinline__ void a_from_c(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                         const float (&c0)[4], const float (&c1)[4]) {
  split(hi[0], lo[0], c0[0], c0[1]);
  split(hi[1], lo[1], c0[2], c0[3]);
  split(hi[2], lo[2], c1[0], c1[1]);
  split(hi[3], lo[3], c1[2], c1[3]);
}

// shared-memory offsets (in elements, rows of stride `ld`) of this lane's
// row address for the x4 loads of a 16 x 16 block at (row0, col0):
// - A fragment of a row-major tile (rows = m, columns = k)
__device__ __forceinline__ int a_off(int row0, int col0, int ld, int lane) {
  return (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8;
}
// - B fragments of two neighbouring n blocks from a tile stored n-major
//   (rows = n, columns = k): registers 0, 1 the first block, 2, 3 the next;
//   with .trans, the same addresses give the A fragment of a tile stored
//   transposed (rows = k, columns = m)
__device__ __forceinline__ int b_off(int row0, int col0, int ld, int lane) {
  return (row0 + (lane & 7) + ((lane >> 4) << 3)) * ld + col0 + ((lane >> 3) & 1) * 8;
}
// - with .trans, B fragments of two n blocks from a tile stored k-major
//   (rows = k, columns = n)
__device__ __forceinline__ int bt_off(int row0, int col0, int ld, int lane) {
  return (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + col0 + (lane >> 4) * 8;
}
}  // namespace tc
