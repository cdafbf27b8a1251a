// GQA flash attention forward for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py:flash_attention_fwd
// (line 99; _attn_kernel, line numbers below are that file's).  Called once
// per attention layer on every fresh prefill, through
// repro_torch/kernels/flash_attention/ops.py:flash_attention.
//
// Work: out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] * sm_scale)
// v[b, j, h / G] over the keys the masks leave, where query row i sits at
// position q_offset + i and key row j at position j: causal keeps
// j <= q_offset + i, and window > 0 keeps j > q_offset + i - window.  Scores
// are f32 from f32 or bf16 operands; a masked score is -1e30 and its weight
// exactly 0 (kernel.py:91-96); the running max m, denominator l and
// numerator acc are f32, and the output is acc / max(l, 1e-30) rounded to
// q's dtype (kernel.py:103-105), so a row with no key left is exactly zero.
//
// Bound on the H100: a causal call at T = S does 4 * D * H * T(T+1)/2
// operations (two products of length D per kept (row, key) pair) and moves
// (2 * H + 2 * Hkv) * T * D bf16 values: about 0.4 * T operations per byte
// at llama3.2-1b's heads.  Against the card's 989 TFLOP/s (bf16 tensor
// cores) and 3.35 TB/s that is bytes up to T of about 740, so at the main
// path's prompts (T = 32..512), and operations beyond.  This kernel does not
// use the tensor cores yet: its products are f32 FMAs on the CUDA cores
// (67 TFLOP/s), so its own operations limit it from T of about 50 on, well
// above that bound.  wgmma tiles, TMA staging and sharing one K/V tile
// across the G query heads of a KV head are later work.
//
// Design: the TPU kernel runs its grid in order and carries m, l and acc
// across the innermost kv axis in VMEM scratch.  Hopper runs blocks in no
// order, so one block of 128 threads takes one (b, query head, 64-row q
// tile) and loops over the key tiles itself, carrying m, l and acc in
// registers.  It visits only the 64-key tiles that the causal diagonal and
// the window leave for its rows, and masks the ragged ends of T and S, so
// any T and S are accepted (the Pallas kernel asserts tile multiples,
// kernel.py:114-115).  Q, K and V tiles are staged as f32 in shared memory
// (rows padded by one word against bank conflicts).  Thread (ty, tx) of a
// 8 x 16 grid owns query rows ty*8 .. ty*8+7, key columns tx + 16 j of the
// score tile and head columns tx + 16 j of the output; a row's max and sum
// are reduced over its 16 threads with shuffles, and the weights pass
// through shared memory to the value product.
//
// Occupancy: the grid is ceil(T / 64) x H x B blocks, so the main path's
// B = 1 prefill at T = 32..512 runs 32..256 blocks on 132 SMs, and the
// short prompts leave most SMs idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;    // query rows per block
constexpr int kBlockK = 64;    // keys per tile
constexpr int kThreads = 128;  // an 8 x 16 grid of threads
constexpr int kRows = 8;       // query rows per thread
constexpr int kLanes = 16;     // threads sharing one query row
constexpr int kCols = kBlockK / kLanes;  // score columns per thread
constexpr int kPStride = kBlockK + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBlockQ * (D + 1) + kBlockK * D + kBlockQ * kPStride);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q,  // [B, Tq, H, D]
    const T* __restrict__ k,  // [B, S, Hkv, D]
    const T* __restrict__ v,  // [B, S, Hkv, D]
    T* __restrict__ out,      // [B, Tq, H, D]
    int Tq, int S, int H, int Hkv, int causal, int window, int q_offset, float sm_scale) {
  constexpr int DP = D + 1;
  constexpr int kDCols = D / kLanes;  // output columns per thread
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int h_kv = h / (H / Hkv);  // kernel.py:150, head h reads kv head h // G
  const int tid = threadIdx.x;
  const int ty = tid / kLanes;
  const int tx = tid % kLanes;

  extern __shared__ float smem[];
  float* s_q = smem;                // [kBlockQ][DP]
  float* s_k = s_q + kBlockQ * DP;  // [kBlockK][DP]
  float* s_v = s_k + kBlockK * DP;  // [kBlockK][D]
  float* s_p = s_v + kBlockK * D;   // [kBlockQ][kPStride] weights of one tile

  const long long q_stride = (long long)H * D;     // one token to the next in q, out
  const long long kv_stride = (long long)Hkv * D;  // ... and in k, v
  const T* q_head = q + (long long)b * Tq * q_stride + (long long)h * D;
  const T* k_head = k + (long long)b * S * kv_stride + (long long)h_kv * D;
  const T* v_head = v + (long long)b * S * kv_stride + (long long)h_kv * D;
  T* o_head = out + (long long)b * Tq * q_stride + (long long)h * D;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int row = q0 + r;
    s_q[r * DP + d] = row < Tq ? to_f32(q_head[row * q_stride + d]) : 0.f;
  }

  // The keys any row of this tile may attend: [k_begin, k_end).
  const int pos_first = q_offset + q0;
  const int pos_last = q_offset + min(Tq, q0 + kBlockQ) - 1;
  const int k_end = causal ? min(S, pos_last + 1) : S;
  const int k_begin = window > 0 ? max(0, pos_first - window + 1) : 0;

  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDCols; ++c) acc[i][c] = 0.f;
  }
  __syncthreads();

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    // 1. Stage the tile's keys and values as f32; rows past k_end are zero.
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int r = e / D;
      const int d = e - r * D;
      const int key = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (key < k_end) {
        kx = to_f32(k_head[key * kv_stride + d]);
        vx = to_f32(v_head[key * kv_stride + d]);
      }
      s_k[r * DP + d] = kx;
      s_v[r * D + d] = vx;
    }
    __syncthreads();

    // 2. Scores of this thread's 8 rows x 4 keys.
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = s_q[(ty * kRows + i) * DP + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = s_k[(tx + kLanes * j) * DP + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // 3. Masks, then the online softmax of each row over its 16 threads.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty * kRows + i;
      const int qpos = q_offset + row;
      bool keep[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int key = k0 + tx + kLanes * j;
        keep[j] = row < Tq && key < S && (!causal || key <= qpos) &&
                  (window <= 0 || key > qpos - window);
        s[i][j] = keep[j] ? s[i][j] * sm_scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_cur = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_cur);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_cur) : 0.f;
        s_p[(ty * kRows + i) * kPStride + tx + kLanes * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_cur;
#pragma unroll
      for (int c = 0; c < kDCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // 4. acc += p . v over the tile's keys.
#pragma unroll 4
    for (int key = 0; key < kBlockK; ++key) {
      float pv[kRows], vv[kDCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = s_p[(ty * kRows + i) * kPStride + key];
#pragma unroll
      for (int c = 0; c < kDCols; ++c) vv[c] = s_v[key * D + tx + kLanes * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kDCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
    __syncthreads();  // the next tile overwrites s_k, s_v and s_p
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= Tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDCols; ++c)
      store_from_f32(o_head + row * q_stride + tx + kLanes * c, acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int batch, int Tq,
                   int S, int H, int Hkv, int causal, int window, int q_offset, float sm_scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid((Tq + kBlockQ - 1) / kBlockQ, H, batch);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Tq, S, H, Hkv, causal, window, q_offset, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out, int batch,
                       int Tq, int S, int H, int Hkv, int D, int causal, int window,
                       int q_offset, float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, batch, Tq, S, H, Hkv, causal, window, q_offset,
                           sm_scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, batch, Tq, S, H, Hkv, causal, window, q_offset,
                           sm_scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, batch, Tq, S, H, Hkv, causal, window, q_offset,
                            sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {16, 64, 128} (llama3.2-1b and mixtral-8x7b
// SMOKE 16, llama3.2-1b FULL 64, mixtral-8x7b FULL 128; at 128 a block takes 115,456 bytes
// of shared memory, opted in by launch).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int dtype, int batch, int Tq, int S, int H, int Hkv, int D,
                               int causal, int window, int q_offset, float sm_scale,
                               void* stream) {
  if (batch <= 0 || Tq <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float>(q, k, v, out, batch, Tq, S, H, Hkv, D, causal, window, q_offset,
                            sm_scale, s);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(q, k, v, out, batch, Tq, S, H, Hkv, D, causal, window,
                                    q_offset, sm_scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
