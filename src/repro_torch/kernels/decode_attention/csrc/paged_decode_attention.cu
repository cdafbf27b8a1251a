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
// -inf, so an all-masked chunk never produces NaN.  The model passes each
// query's position as well (q_pos), and then the rows are the ones its
// plain attention keeps (key_range below).
//
// Bound on the H100: bytes.  Each key and value row the mask keeps is read
// once, 2*sum_b(rows_b)*Hkv*D*sizeof(T) bytes, against 4*sum_b(rows_b)*H*D
// operations, well under one operation per byte.
//
// Design: one block per (b, kv_head), 4 warps.  The TPU kernel reads the
// table and kv_len by scalar prefetch and walks the pages as its
// sequential innermost grid axis; Hopper has no scalar prefetch and runs
// blocks in no order, so each block reads its own kv_len and table row and
// loops over the keys itself.  All G = H / Hkv query heads of the kv head
// (head h belongs to kv head h / G, kernel.py:224) share the block, so each
// K/V row is read from device memory once for the whole group.  Keys go in
// chunks of 32 logical rows (one per lane; a chunk may span pages of any
// size), staged as f32 in shared memory; the block skips every row before
// the window and stops at kv_len, so it reads exactly the rows the mask
// keeps.  An online softmax keeps the running max m, denominator l and
// numerator acc in f32 shared memory.  Split-K over pages with a combine
// pass, cp.async/TMA staging and mma for the products are later work.
//
// Scratch page 0: an idle batcher slot's table row is all zero, so its
// keys come from page 0, where the append kernel stores the idle slots'
// rows (the last slot's where two name one row, see paged_kv_append.cu).
// Its output is never returned to a request, but under MoE capacity drops
// its token competes with the busy ones for expert capacity.
//
// Why clamp on the device: kv_len is clamped into [0, n_pages*page] and
// each page id into [0, P - 1] here, as the reference wrapper clamps
// traced values (src/repro/kernels/decode_attention/ops.py:166-168).  A
// host range check would cost one device-to-host sync per layer per tick;
// the serving batcher checks its host mirrors of the positions and tables
// instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;     // key rows per step: one per lane
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The rows [first, len) a query attends.  Without q_pos the query sits at
// kv_len - 1: rows below kv_len (clamped into [0, rows]), the last `window`
// of them with a window; none when kv_len is 0, which gives exactly zero.
// With q_pos, as the model's plain attention masks (layers._dense_attention):
// rows below kv_len that are at most q_pos and, with a window, above
// q_pos - window; an idle batcher slot's q_pos need not be kv_len - 1.  A
// query left with no row there attends uniformly to all `rows` rows (every
// score 0), as a softmax over an all-masked row of -1e30 scores does.
__device__ __forceinline__ void key_range(int kv_len, const int* q_pos, int rows, int window,
                                          int* first, int* len, bool* uniform) {
  int hi = kv_len < 0 ? 0 : (kv_len > rows ? rows : kv_len);
  int lo;
  *uniform = false;
  if (q_pos == nullptr) {
    lo = (window > 0 && hi > window) ? hi - window : 0;
  } else {
    const int qp = *q_pos;
    hi = qp < hi - 1 ? (qp < 0 ? 0 : qp + 1) : hi;
    lo = (window > 0 && qp - window + 1 > 0) ? qp - window + 1 : 0;
    if (lo >= hi) {
      lo = 0;
      hi = rows;
      *uniform = true;
    }
  }
  *first = lo;
  *len = hi;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_attention_kernel(
    const T* __restrict__ q,             // [B, H, D]
    const T* __restrict__ k_pages,       // [P, page, Hkv, D]
    const T* __restrict__ v_pages,       // [P, page, Hkv, D]
    const int* __restrict__ page_table,  // [B, n_pages]
    const int* __restrict__ kv_len,      // [B]
    const int* __restrict__ q_pos,       // [B] or null
    T* __restrict__ out,                 // [B, H, D]
    int H, int Hkv, int D, int num_pages, int page_size, int n_pages, int window,
    float sm_scale) {
  const int b = blockIdx.x;
  const int h_kv = blockIdx.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* s_q = smem;                        // [G][D]
  float* s_acc = s_q + G * D;               // [G][D] running numerator
  float* s_k = s_acc + G * D;               // [kChunk][D + 1] (padded: no bank conflicts)
  float* s_v = s_k + kChunk * (D + 1);      // [kChunk][D]
  float* s_p = s_v + kChunk * D;            // [G][kChunk] scores, then probabilities
  float* s_m = s_p + G * kChunk;            // [G] running max
  float* s_l = s_m + G;                     // [G] running denominator
  float* s_alpha = s_l + G;                 // [G] rescale factor of this chunk

  // Heads h_kv*G .. h_kv*G + G - 1 are contiguous in q and out.
  const long long q_base = ((long long)b * H + (long long)h_kv * G) * D;
  for (int e = tid; e < G * D; e += kThreads) {
    s_q[e] = to_f32(q[q_base + e]);
    s_acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    s_m[g] = kNegInf;
    s_l[g] = 0.f;
  }

  const int cap = n_pages * page_size;
  int first, len;
  bool uniform;
  key_range(kv_len[b], q_pos ? q_pos + b : nullptr, cap, window, &first, &len, &uniform);
  const int* table = page_table + (long long)b * n_pages;
  const long long row_stride = (long long)Hkv * D;  // elements from one page row to the next
  __syncthreads();

  for (int c0 = (first / kChunk) * kChunk; c0 < len; c0 += kChunk) {
    // 1. Stage the chunk's K and V rows as f32; rows the mask drops are
    //    zero and never read from device memory.
    for (int e = tid; e < kChunk * D; e += kThreads) {
      const int t = e / D;
      const int d = e - t * D;
      const int p = c0 + t;
      float kx = 0.f, vx = 0.f;
      if (p >= first && p < len) {
        int pid = table[p / page_size];
        pid = pid < 0 ? 0 : (pid > num_pages - 1 ? num_pages - 1 : pid);
        const long long off =
            ((long long)pid * page_size + p % page_size) * row_stride + (long long)h_kv * D + d;
        kx = to_f32(k_pages[off]);
        vx = to_f32(v_pages[off]);
      }
      s_k[t * (D + 1) + d] = kx;
      s_v[t * D + d] = vx;
    }
    __syncthreads();

    // 2. Scores, one (query head, key row) pair per thread.
    for (int e = tid; e < G * kChunk; e += kThreads) {
      const int g = e / kChunk;
      const int t = e - g * kChunk;
      const int p = c0 + t;
      float s = kNegInf;
      if (p >= first && p < len) {
        const float* qr = s_q + g * D;
        const float* kr = s_k + t * (D + 1);
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = uniform ? 0.f : dot * sm_scale;
      }
      s_p[e] = s;
    }
    __syncthreads();

    // 3. Online-softmax statistics: one warp per query head, one lane per row.
    for (int g = warp; g < G; g += kWarps) {
      const int p = c0 + lane;
      const bool keep = p >= first && p < len;
      const float s = s_p[g * kChunk + lane];
      float mx = s;
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = s_m[g];
      const float m_cur = fmaxf(m_prev, mx);
      const float pr = keep ? expf(s - m_cur) : 0.f;
      float sum = pr;
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      s_p[g * kChunk + lane] = pr;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        s_alpha[g] = alpha;
        s_l[g] = s_l[g] * alpha + sum;
        s_m[g] = m_cur;
      }
    }
    __syncthreads();

    // 4. Rescale the numerator and add the chunk's weighted values.
    for (int e = tid; e < G * D; e += kThreads) {
      const int g = e / D;
      const int d = e - g * D;
      const float* pr = s_p + g * kChunk;
      float acc = s_acc[e] * s_alpha[g];
      for (int t = 0; t < kChunk; ++t) acc = fmaf(pr[t], s_v[t * D + d], acc);
      s_acc[e] = acc;
    }
    __syncthreads();
  }

  for (int e = tid; e < G * D; e += kThreads) {
    store_from_f32(out + q_base + e, s_acc[e] / fmaxf(s_l[e / D], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* page_table, const void* kv_len, const void* q_pos, void* out,
                   int batch, int H,
                   int Hkv, int D, int num_pages, int page_size, int n_pages, int window,
                   float sm_scale, cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem =
      sizeof(float) * (2 * G * D + kChunk * (D + 1) + kChunk * D + G * kChunk + 3 * G);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(batch, Hkv);
  paged_decode_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int*>(page_table), static_cast<const int*>(kv_len),
      static_cast<const int*>(q_pos), static_cast<T*>(out), H, Hkv, D, num_pages, page_size,
      n_pages, window, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages, const void* page_table,
                                      const void* kv_len, const void* q_pos, void* out,
                                      int dtype, int batch,
                                      int H, int Hkv, int D, int num_pages, int page_size,
                                      int n_pages, int window, float sm_scale,
                                      void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k_pages, v_pages, page_table, kv_len, q_pos, out, batch, H, Hkv, D,
                        num_pages, page_size, n_pages, window, sm_scale, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, kv_len, q_pos, out, batch, H, Hkv,
                                D, num_pages, page_size, n_pages, window, sm_scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
