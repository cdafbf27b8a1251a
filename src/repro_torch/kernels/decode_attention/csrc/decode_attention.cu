// Dense single-token GQA decode attention for Hopper (sm_90a).
//
// Replaces src/repro/kernels/decode_attention/kernel.py:decode_attention_fwd
// (line 95; _decode_kernel, line numbers below are that file's).  Called
// once per attention layer on every decode tick over a linear KV cache,
// through repro_torch/kernels/decode_attention/ops.py:decode_attention.
//
// Work: out[b, h] = softmax(q[b, h] . K_b^T * scale) V_b over rows
// [max(0, kv_len[b] - window), kv_len[b]) of sequence b's cache rows
// k_cache[b, :, h / G] (all rows below kv_len when window is 0): keys must
// satisfy p < kv_len, and with window > 0 also p > kv_len - 1 - window
// (kernel.py:75-78).  kv_len == 0 gives exactly zero (denominator
// max(l, 1e-30), kernel.py:91); NEG_INF is -1e30, not -inf, so an
// all-masked row never produces NaN.  The model passes each query's
// position as well (q_pos), and then the rows are the ones its plain
// attention keeps (decode_split.cuh:key_range).
//
// Bound on the H100: bytes.  Each key and value row the mask keeps is read
// once, 2*sum_b(rows_b)*Hkv*D*sizeof(T) bytes, against 4*sum_b(rows_b)*H*D
// operations, well under one operation per byte.
//
// Design: the split-K body of decode_split.cuh, shared with
// paged_decode_attention.cu, with each logical row addressed linearly
// (LinearRows).  The TPU kernel walks the cache in blocks of block_k as its
// sequential innermost grid axis, which ties S to a multiple of the block
// (ops.py:align_block_k, a 128-lane rule); here a block takes kSplitRows
// rows of one (b, kv head) and the last split may be short, so any S is
// accepted.  It replaced a design of one block a (b, kv head) walking its
// rows in chunks of 32 staged as f32 in shared memory, 128 blocks on 132
// SMs at the main path's 16 slots.

#include "decode_split.cuh"

namespace {

using decode_split::LinearRows;

template <typename T, int D, int HG>
__global__ void __launch_bounds__(decode_split::threads<T, D>()) decode_attention_kernel(
    const T* __restrict__ q,         // [B, H, D]
    const T* __restrict__ k_cache,   // [B, S, Hkv, D]
    const T* __restrict__ v_cache,   // [B, S, Hkv, D]
    const int* __restrict__ kv_len,  // [B]
    const int* __restrict__ q_pos,   // [B] or null
    float* __restrict__ part,        // [B, H, n_splits, D + 2]
    int S, int H, int Hkv, int window, int n_splits, float sm_scale) {
  LinearRows rows{((long long)blockIdx.z * S * Hkv + blockIdx.y) * D, (long long)Hkv * D};
  decode_split::split_pass<T, D, HG>(q, k_cache, v_cache, kv_len, q_pos, part, rows, H, Hkv, S,
                                     window, n_splits, sm_scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(32 * decode_split::kCombineWarps)
    decode_attention_combine_kernel(const float* __restrict__ part,
                                    const int* __restrict__ kv_len,
                                    const int* __restrict__ q_pos, T* __restrict__ out, int H,
                                    int rows, int window, int n_splits) {
  decode_split::combine_pass<T, D>(part, kv_len, q_pos, out, H, rows, window, n_splits);
}

template <typename T, int D, int HG>
struct Launch {
  static cudaError_t run(const void* q, const void* k_cache, const void* v_cache,
                         const void* kv_len, const void* q_pos, void* part, void* out,
                         int batch, int S, int H, int Hkv, int window, int n_splits,
                         float sm_scale, cudaStream_t stream) {
    const int* qp = static_cast<const int*>(q_pos);
    const int* lens = static_cast<const int*>(kv_len);
    decode_attention_kernel<T, D, HG>
        <<<dim3(n_splits, Hkv, batch), decode_split::threads<T, D>(), 0, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k_cache),
            static_cast<const T*>(v_cache), lens, qp, static_cast<float*>(part), S, H, Hkv,
            window, n_splits, sm_scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int warps = decode_split::kCombineWarps;
    decode_attention_combine_kernel<T, D>
        <<<dim3((H + warps - 1) / warps, batch), dim3(32, warps), 0, stream>>>(
            static_cast<const float*>(part), lens, qp, static_cast<T*>(out), H, S, window,
            n_splits);
    return cudaGetLastError();
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  part: f32 scratch [batch, H, n_splits,
// D + 2], n_splits = ceil(S / kSplitRows).  Returns the cudaError_t of the
// launches (0 on success; cudaErrorInvalidValue for a head dim other than
// 16, 64 or 128, or another n_splits).
extern "C" int decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                const void* kv_len, const void* q_pos, void* part, void* out,
                                int dtype, int batch, int S, int H, int Hkv, int D, int window,
                                int n_splits, float sm_scale, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  if (H % Hkv != 0 || n_splits != decode_split::splits_for(S))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = decode_split::dispatch<Launch, float>(D, H / Hkv, q, k_cache, v_cache, kv_len, q_pos,
                                                part, out, batch, S, H, Hkv, window, n_splits,
                                                sm_scale, s);
  } else if (dtype == 1) {
    err = decode_split::dispatch<Launch, __nv_bfloat16>(D, H / Hkv, q, k_cache, v_cache, kv_len,
                                                        q_pos, part, out, batch, S, H, Hkv,
                                                        window, n_splits, sm_scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
