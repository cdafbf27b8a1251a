// Paged single-token GQA decode attention for Hopper (sm_90a).
//
// Replaces src/repro/kernels/decode_attention/kernel.py:paged_decode_attention_fwd
// (_paged_decode_kernel; line numbers below are that file's).
// Called once per attention layer on every decode tick, through
// repro_torch/kernels/decode_attention/ops.py:paged_decode_attention.
//
// Work: out[b, h] = softmax(q[b, h] . K_b^T * scale) V_b over the first
// kv_len[b] rows of sequence b, where row p of K_b lives at row p % page of
// pool page page_table[b, p / page].  Keys must satisfy p < kv_len, and
// with window > 0 also p > kv_len - 1 - window.  kv_len == 0 gives exactly
// zero (denominator max(l, 1e-30), as at kernel.py:205); NEG_INF is -1e30, not
// -inf, so an all-masked row never produces NaN.  The model passes each
// query's position as well (q_pos), and then the rows are the ones its
// plain attention keeps (decode_split.cuh:key_range).
//
// Bound on the H100: bytes.  Each key and value row the mask keeps is read
// once, 2*sum_b(rows_b)*Hkv*D*sizeof(T) bytes, against 4*sum_b(rows_b)*H*D
// operations, well under one operation per byte.
//
// Design: the split-K body of decode_split.cuh, with each logical row
// addressed through the table (PagedRows).  The TPU kernel reads the table
// and kv_len by scalar prefetch and walks the pages as its sequential
// innermost grid axis; here a block takes kSplitRows logical rows of one
// (b, kv head), whatever the page size, reads the table entries of its
// pages once, and a second kernel combines the splits.  It replaced a
// design of one block a (b, kv head) walking its whole sequence in chunks
// of 32 rows staged as f32 in shared memory, one bf16 element a thread a
// load, which left the card mostly idle.
//
// Scratch page 0: an idle batcher slot's table row is all zero, so its
// keys come from page 0, where the append kernel stores the idle slots'
// rows (the last slot's where two name one row, see paged_kv_append.cu).
// Its output is never returned to a request, but under MoE capacity drops
// its token competes with the busy ones for expert capacity.

#include "decode_split.cuh"

namespace {

using decode_split::PagedRows;

template <typename T, int D, int HG>
__global__ void __launch_bounds__(decode_split::threads<T, D>()) paged_decode_attention_kernel(
    const T* __restrict__ q,             // [B, H, D]
    const T* __restrict__ k_pages,       // [P, page, Hkv, D]
    const T* __restrict__ v_pages,       // [P, page, Hkv, D]
    const int* __restrict__ page_table,  // [B, n_pages]
    const int* __restrict__ kv_len,      // [B]
    const int* __restrict__ q_pos,       // [B] or null
    float* __restrict__ part,            // [B, H, n_splits, D + 2]
    int H, int Hkv, int num_pages, int page_size, int n_pages, int window, int n_splits,
    float sm_scale) {
  PagedRows rows{page_table + (long long)blockIdx.z * n_pages, (long long)blockIdx.y * D,
                 (long long)Hkv * D, page_size, num_pages, 0};
  decode_split::split_pass<T, D, HG>(q, k_pages, v_pages, kv_len, q_pos, part, rows, H, Hkv,
                                     n_pages * page_size, window, n_splits, sm_scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(32 * decode_split::kCombineWarps)
    paged_decode_attention_combine_kernel(const float* __restrict__ part,
                                          const int* __restrict__ kv_len,
                                          const int* __restrict__ q_pos, T* __restrict__ out,
                                          int H, int rows, int window, int n_splits) {
  decode_split::combine_pass<T, D>(part, kv_len, q_pos, out, H, rows, window, n_splits);
}

template <typename T, int D, int HG>
struct Launch {
  static cudaError_t run(const void* q, const void* k_pages, const void* v_pages,
                         const void* page_table, const void* kv_len, const void* q_pos,
                         void* part, void* out, int batch, int H, int Hkv, int num_pages,
                         int page_size, int n_pages, int window, int n_splits, float sm_scale,
                         cudaStream_t stream) {
    const int* qp = static_cast<const int*>(q_pos);
    const int* lens = static_cast<const int*>(kv_len);
    paged_decode_attention_kernel<T, D, HG>
        <<<dim3(n_splits, Hkv, batch), decode_split::threads<T, D>(), 0, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k_pages),
            static_cast<const T*>(v_pages), static_cast<const int*>(page_table), lens, qp,
            static_cast<float*>(part), H, Hkv, num_pages, page_size, n_pages, window, n_splits,
            sm_scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int warps = decode_split::kCombineWarps;
    paged_decode_attention_combine_kernel<T, D>
        <<<dim3((H + warps - 1) / warps, batch), dim3(32, warps), 0, stream>>>(
            static_cast<const float*>(part), lens, qp, static_cast<T*>(out), H,
            n_pages * page_size, window, n_splits);
    return cudaGetLastError();
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  part: f32 scratch [batch, H, n_splits,
// D + 2], n_splits = ceil(n_pages * page_size / kSplitRows).  Returns the
// cudaError_t of the launches (0 on success; cudaErrorInvalidValue for a
// head dim other than 16, 64 or 128, or another n_splits).
extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages, const void* page_table,
                                      const void* kv_len, const void* q_pos, void* part,
                                      void* out, int dtype, int batch, int H, int Hkv, int D,
                                      int num_pages, int page_size, int n_pages, int window,
                                      int n_splits, float sm_scale, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  if (H % Hkv != 0 || n_splits != decode_split::splits_for(n_pages * page_size))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = decode_split::dispatch<Launch, float>(
        D, H / Hkv, q, k_pages, v_pages, page_table, kv_len, q_pos, part, out, batch, H, Hkv,
        num_pages, page_size, n_pages, window, n_splits, sm_scale, s);
  } else if (dtype == 1) {
    err = decode_split::dispatch<Launch, __nv_bfloat16>(
        D, H / Hkv, q, k_pages, v_pages, page_table, kv_len, q_pos, part, out, batch, H, Hkv,
        num_pages, page_size, n_pages, window, n_splits, sm_scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
