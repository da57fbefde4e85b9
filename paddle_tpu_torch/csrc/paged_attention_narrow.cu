// Paged decode attention at head widths 64 and 96: the C entry points of
// the kernels in paged_attention.cuh (design, bound and replaced TPU kernel
// there), built apart from paged_attention.cu so that the two compile in
// parallel. Arguments as pt_paged_attention's.

#include "paged_attention.cuh"

// head width 64 (GPT-2, Qwen2.5-0.5B)
extern "C" int pt_paged_attention_64(const void* q, const void* kp, const void* vp,
                                     const void* lengths, const void* page_indices,
                                     void* part_m, void* part_l, void* part_acc, void* out,
                                     int B, int H, int hk, int n_pages, int ps, int pps,
                                     int n_split, float scale, int dtype, void* stream) {
  return paged_attention<64>(q, kp, vp, lengths, page_indices, part_m, part_l, part_acc, out,
                             B, H, hk, n_pages, ps, pps, n_split, scale, dtype, stream);
}

// head width 96 (Phi-3)
extern "C" int pt_paged_attention_96(const void* q, const void* kp, const void* vp,
                                     const void* lengths, const void* page_indices,
                                     void* part_m, void* part_l, void* part_acc, void* out,
                                     int B, int H, int hk, int n_pages, int ps, int pps,
                                     int n_split, float scale, int dtype, void* stream) {
  return paged_attention<96>(q, kp, vp, lengths, page_indices, part_m, part_l, part_acc, out,
                             B, H, hk, n_pages, ps, pps, n_split, scale, dtype, stream);
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
