// Paged decode attention at head widths 128 and 256: the C entry points of
// the kernels in paged_attention.cuh (design, bound and replaced TPU kernel
// there). The widths of 64 and 96 build from paged_attention_narrow.cu, in
// parallel with this file.

#include "paged_attention.cuh"

// q, out [B, H, D], D = 128 (256 below), H a multiple of hk with 1 <= H / hk <= 16; k_pages,
// v_pages [hk, n_pages, ps, D]; lengths [B] int32;
// page_indices [B, pps] int32, pps <= 16384; partials part_m, part_l
// [B, H, n_split] and part_acc [B, H, n_split, D] f32, scratch;
// 1 <= n_split <= min(max(pps, 1), 4096). dtype: 0 = float32, 1 = bfloat16. Block
// (split, b, kh) takes the split-th of n_split runs of whole pages of row
// b's visible prefix; a second launch combines the runs. Returns
// cudaGetLastError() after the two launches.
extern "C" int pt_paged_attention(const void* q, const void* kp, const void* vp,
                                  const void* lengths, const void* page_indices,
                                  void* part_m, void* part_l, void* part_acc, void* out,
                                  int B, int H, int hk, int n_pages, int ps, int pps,
                                  int n_split, float scale, int dtype, void* stream) {
  return paged_attention<128>(q, kp, vp, lengths, page_indices, part_m, part_l, part_acc, out,
                              B, H, hk, n_pages, ps, pps, n_split, scale, dtype, stream);
}

// the same at head width 256 (Gemma's heads)
extern "C" int pt_paged_attention_256(const void* q, const void* kp, const void* vp,
                                      const void* lengths, const void* page_indices,
                                      void* part_m, void* part_l, void* part_acc, void* out,
                                      int B, int H, int hk, int n_pages, int ps, int pps,
                                      int n_split, float scale, int dtype, void* stream) {
  return paged_attention<256>(q, kp, vp, lengths, page_indices, part_m, part_l, part_acc, out,
                              B, H, hk, n_pages, ps, pps, n_split, scale, dtype, stream);
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
