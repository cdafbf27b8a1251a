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
// are f32 sums; a masked score is -1e30 and its weight exactly 0
// (kernel.py:91-96); the running max m and denominator l and the output
// accumulator are f32, and the output is acc / max(l, 1e-30) rounded to
// q's dtype (kernel.py:103-105), so a row with no key left is exactly zero.
//
// Bound on the H100: a causal call at T = S does 4 * D * H * T(T+1)/2
// operations (two products of length D per kept (row, key) pair) and moves
// (2 * H + 2 * Hkv) * T * D values once: about 0.4 * T operations per
// byte at llama3.2-1b's heads.  Against the card's 989 TFLOP/s (bf16
// tensor cores) and 3.35 TB/s that is bytes up to T of about 740, so at
// the main path's prompts (T = 32..512), and operations beyond.
//
// Two instantiations, one per dtype.
//
// bf16 (the served models' path): the tensor cores.  The CUDA-core
// kernel below reached 12-14 TFLOP/s at T = 2048, under the 67 TFLOP/s
// the CUDA cores can give, for five reasons: scalar FMAs with 12 shared
// loads per 32 of them, bf16 staged as f32 (115 KB a block at D = 128, one
// block per SM), single-element synchronous loads, the weights passing
// through shared memory, and the G query heads of a KV head each reading
// the same K/V tiles.  This kernel instead:
//  - computes S = Q K^T and O += P V with mma.sync m16n8k16 (bf16
//    operands, f32 accumulation); each of the block's 4 warps owns 16
//    query rows, its Q fragments stay in registers for the whole key loop
//    (ldmatrix), K fragments come by ldmatrix and V's by ldmatrix.trans;
//  - keeps P in registers: the S accumulator fragment is scaled, masked
//    and exponentiated in place and packed to bf16 as the A operand of
//    P V (FlashAttention-2's layout).  P goes as two bf16 terms, its
//    rounding and the rounding of what that misses (about 16 bits), in
//    two products with V: P rounded to bf16 alone moved a short row's
//    output by up to 2^-9 |v|, past the bf16 tolerance's atol of 2e-3 on
//    the card.  The extra product is a third of the tile's mma work; the
//    denominator l sums the f32 weights;
//  - stages K and V as bf16 in a ring of two 64-key stages filled by
//    cp.async (16 bytes a thread, rows past the keys zero-filled, so no
//    stale value reaches P V), the next tile's copy in flight while this
//    tile's products run; rows are padded by 16 bytes, so ldmatrix and
//    the copies meet no bank conflicts.  Q, two stages of K and V: 46,080
//    bytes at D = 64 and 87,040 at D = 128 (opted in above 48 KB);
//  - a block holds 64 query positions of one head, so any G is taken.
//    A block of 64 (position, head) rows holding all four query heads of
//    a KV head, which loads each K/V tile once for the four, timed no
//    faster on the H100 (PERF.md): L2 serves the G heads' re-reads of a
//    tile.  The grid walks the q tiles with the most keys
//    first, and only the tiles on the causal diagonal, the window's edge
//    or the ragged end pay for the mask.
//
// f32 (the SMOKE tests' path): the CUDA cores, as before (TF32 keeps about
// three decimal digits, too few for f32's 1e-5 tolerance).  One block of
// 128 threads per (b, query head, 64-row q tile) loops over the key tiles
// the causal diagonal and the window leave, m, l and acc in registers;
// Q, K and V tiles in shared memory (rows padded by one word); thread
// (ty, tx) of an 8 x 16 grid owns query rows ty*8 .. ty*8+7, key columns
// tx + 16 j and head columns tx + 16 j; row max and sum are reduced over
// 16 threads with shuffles, the weights pass through shared memory.
//
// Both accept any T and S (the Pallas kernel asserts tile multiples,
// kernel.py:114-115): ragged ends are masked and zero-filled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// --- f32: the CUDA cores -------------------------------------------------------

namespace f32 {

constexpr int kBlockQ = 64;    // query rows per block
constexpr int kBlockK = 64;    // keys per tile
constexpr int kThreads = 128;  // an 8 x 16 grid of threads
constexpr int kRows = 8;       // query rows per thread
constexpr int kLanes = 16;     // threads sharing one query row
constexpr int kCols = kBlockK / kLanes;  // score columns per thread
constexpr int kPStride = kBlockK + 1;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBlockQ * (D + 1) + kBlockK * D + kBlockQ * kPStride);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const float* __restrict__ q,  // [B, Tq, H, D]
    const float* __restrict__ k,  // [B, S, Hkv, D]
    const float* __restrict__ v,  // [B, S, Hkv, D]
    float* __restrict__ out,      // [B, Tq, H, D]
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
  const float* q_head = q + (long long)b * Tq * q_stride + (long long)h * D;
  const float* k_head = k + (long long)b * S * kv_stride + (long long)h_kv * D;
  const float* v_head = v + (long long)b * S * kv_stride + (long long)h_kv * D;
  float* o_head = out + (long long)b * Tq * q_stride + (long long)h * D;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int row = q0 + r;
    s_q[r * DP + d] = row < Tq ? q_head[row * q_stride + d] : 0.f;
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
    // 1. Stage the tile's keys and values; rows past k_end are zero.
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int r = e / D;
      const int d = e - r * D;
      const int key = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (key < k_end) {
        kx = k_head[key * kv_stride + d];
        vx = v_head[key * kv_stride + d];
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
    for (int c = 0; c < kDCols; ++c) o_head[row * q_stride + tx + kLanes * c] = acc[i][c] / denom;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int batch, int Tq,
                   int S, int H, int Hkv, int causal, int window, int q_offset, float sm_scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid((Tq + kBlockQ - 1) / kBlockQ, H, batch);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Tq, S, H, Hkv, causal, window, q_offset, sm_scale);
  return cudaGetLastError();
}

}  // namespace f32

// --- bf16: the tensor cores ----------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kTileK = 64;          // keys per tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int kStride = D + 8;  // bf16 per shared row: 16 bytes of padding
  static constexpr int kQ = kRows * kStride;
  static constexpr int kTile = kTileK * kStride;
  // Q (reused for the output tile), then two stages of (K, V)
  static constexpr size_t kBytes = sizeof(bf16) * (kQ + 4 * kTile);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a . b over one 16 x 8 x 16 tile: bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values x0, x1 as two registers of bf16 pairs (x0 in the low
// halves): hi their rounding to bf16, lo the rounding of what hi misses,
// so hi + lo carries about 16 bits of each.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const bf16* __restrict__ q,  // [B, Tq, H, D]
    const bf16* __restrict__ k,  // [B, S, Hkv, D]
    const bf16* __restrict__ v,  // [B, S, Hkv, D]
    bf16* __restrict__ out,      // [B, Tq, H, D]
    int batch, int Tq, int S, int H, int Hkv, int causal, int window, int q_offset,
    float scale_log2) {
  using L = Layout<D>;
  constexpr int kChunks = D / 8;   // 16-byte chunks of a row
  constexpr int kKSteps = D / 16;  // k-steps of Q K^T
  constexpr int kDTiles = D / 8;   // n-tiles of P V

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_kv = s_q + L::kQ;  // stage s: K at s_kv + 2 s kTile, V after it

  // Block -> (q tile, head, b); the q tiles with the most keys first.
  const int n_qtiles = (Tq + kRows - 1) / kRows;
  const int per_tile = H * batch;
  const int tile = n_qtiles - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int rest = static_cast<int>(blockIdx.x) % per_tile;
  const int head = rest % H;
  const int b = rest / H;
  const int h_kv = head / (H / Hkv);  // kernel.py:150
  const int p0 = tile * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t4 = lane & 3;  // fragment column pair

  const long long q_tok = (long long)H * D;     // one token to the next in q, out
  const long long kv_tok = (long long)Hkv * D;  // ... and in k, v
  const bf16* k_head = k + (long long)b * S * kv_tok + (long long)h_kv * D;
  const bf16* v_head = v + (long long)b * S * kv_tok + (long long)h_kv * D;

  // The keys any row of this block may attend: [k_begin, k_end).
  const int pos_first = q_offset + p0;
  const int pos_last = q_offset + min(Tq, p0 + kRows) - 1;
  const int k_end = causal ? min(S, pos_last + 1) : S;
  const int k_begin = window > 0 ? max(0, pos_first - window + 1) : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kTileK - 1) / kTileK : 0;

  for (int e = threadIdx.x; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const int row = p0 + r;
    const bool ok = row < Tq;
    const bf16* src = q + ((long long)b * Tq + (ok ? row : 0)) * q_tok + (long long)head * D;
    cp_async16(smem_u32(s_q + r * L::kStride + c * 8), src + c * 8, ok);
  }
  cp_async_commit();

  auto load_tile = [&](int k0, int stage) {
    bf16* sk = s_kv + stage * 2 * L::kTile;
    bf16* sv = sk + L::kTile;
    for (int e = threadIdx.x; e < kTileK * kChunks; e += kThreads) {
      const int r = e / kChunks, c = e % kChunks;
      const int key = k0 + r;
      const bool ok = key < k_end;
      const long long off = (long long)(ok ? key : 0) * kv_tok + c * 8;
      cp_async16(smem_u32(sk + r * L::kStride + c * 8), k_head + off, ok);
      cp_async16(smem_u32(sv + r * L::kStride + c * 8), v_head + off, ok);
    }
  };
  if (n_tiles > 0) load_tile(k_begin, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed; the first tile may still be in flight
  __syncthreads();

  uint32_t qf[kKSteps][4];  // this warp's 16 rows of Q, for the whole key loop
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks)
    ldmatrix_x4(qf[ks], smem_u32(s_q + (warp * 16 + (lane & 15)) * L::kStride + ks * 16 +
                                 (lane >> 4) * 8));

  float o[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // rows g and g + 8, in log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  const int qpos[2] = {q_offset + p0 + warp * 16 + g, q_offset + p0 + warp * 16 + g + 8};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kTileK;
    if (it + 1 < n_tiles) load_tile(k0 + kTileK, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile it has landed
    __syncthreads();
    const bf16* sk = s_kv + (it & 1) * 2 * L::kTile;
    const bf16* sv = sk + L::kTile;

    // 1. S = Q K^T for the warp's 16 rows x 64 keys: 8 n-tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      uint32_t kb[4][4];  // keys 16 np .. 16 np + 15: two n-tiles each
#pragma unroll
      for (int np = 0; np < 4; ++np)
        ldmatrix_x4(kb[np], smem_u32(sk + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                              L::kStride +
                                          ks * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        mma_bf16(s[2 * np], qf[ks], kb[np][0], kb[np][1]);
        mma_bf16(s[2 * np + 1], qf[ks], kb[np][2], kb[np][3]);
      }
    }

    // 2. Scale to log2 units; mask only a tile on the causal diagonal, the
    // window's edge or the end of the keys.  Element e of n-tile j sits at
    // row g + 8 (e / 2), key k0 + 8 j + 2 t4 + e % 2.
    const bool need_mask = (causal && k0 + kTileK - 1 > pos_first) ||
                           (window > 0 && k0 <= pos_last - window) || k0 + kTileK > k_end;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (need_mask) {
          const int key = k0 + j * 8 + 2 * t4 + (e & 1);
          const int qp = qpos[e >> 1];
          const bool keep =
              key < k_end && (!causal || key <= qp) && (window <= 0 || key > qp - window);
          x = keep ? x : kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }

    // 3. Online softmax; each row's 64 scores lie on the 4 lanes of a quad.
    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      // While a row has kept no key, m is -1e30 like its masked scores;
      // against 0 their weights come out exactly 0, as in kernel.py:95.
      m_use[i] = m_new == kNegInf ? 0.f : m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_use[e >> 1]);
        s[j][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // 4. O += P V: the weights of keys 16 kk .. 16 kk + 15, split into two
    // bf16 terms, are the A operands as their S fragments lie.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4], pb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_bf16(s[2 * kk + (i >> 1)][2 * (i & 1)], s[2 * kk + (i >> 1)][2 * (i & 1) + 1],
                   pa[i], pb[i]);
      uint32_t vb[D / 16][4];  // head columns 16 dp .. 16 dp + 15: two n-tiles each
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp)
        ldmatrix_x4_trans(vb[dp], smem_u32(sv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                                    L::kStride +
                                                dp * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        mma_bf16(o[2 * dp], pa, vb[dp][0], vb[dp][1]);
        mma_bf16(o[2 * dp + 1], pa, vb[dp][2], vb[dp][3]);
        mma_bf16(o[2 * dp], pb, vb[dp][0], vb[dp][1]);
        mma_bf16(o[2 * dp + 1], pb, vb[dp][2], vb[dp][3]);
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }
  cp_async_wait<0>();

  // Row sums over the quad; a row with no kept key has l = 0 and o = 0.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
  __syncthreads();  // every warp has read its Q fragments from s_q
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    bf16* dst = s_q + (warp * 16 + g) * L::kStride + dt * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(dst) =
        __floats2bfloat162_rn(o[dt][0] * inv[0], o[dt][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(dst + 8 * L::kStride) =
        __floats2bfloat162_rn(o[dt][2] * inv[1], o[dt][3] * inv[1]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const int row = p0 + r;
    if (row >= Tq) continue;
    *reinterpret_cast<uint4*>(out + ((long long)b * Tq + row) * q_tok + (long long)head * D +
                              c * 8) =
        *reinterpret_cast<const uint4*>(s_q + r * L::kStride + c * 8);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int batch, int Tq,
                   int S, int H, int Hkv, int causal, int window, int q_offset, float sm_scale,
                   cudaStream_t stream) {
  constexpr size_t smem = Layout<D>::kBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (long long)((Tq + kRows - 1) / kRows) * H * batch;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  flash_attention_kernel<D><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), batch, Tq, S, H, Hkv, causal, window, q_offset,
      sm_scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tc

cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int dtype,
                     int batch, int Tq, int S, int H, int Hkv, int D, int causal, int window,
                     int q_offset, float sm_scale, cudaStream_t s) {
  if (dtype == 0) {
    switch (D) {
      case 16:
        return f32::launch<16>(q, k, v, out, batch, Tq, S, H, Hkv, causal, window, q_offset,
                               sm_scale, s);
      case 64:
        return f32::launch<64>(q, k, v, out, batch, Tq, S, H, Hkv, causal, window, q_offset,
                               sm_scale, s);
      case 128:
        return f32::launch<128>(q, k, v, out, batch, Tq, S, H, Hkv, causal, window, q_offset,
                                sm_scale, s);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16:
        return tc::launch<16>(q, k, v, out, batch, Tq, S, H, Hkv, causal, window, q_offset,
                              sm_scale, s);
      case 64:
        return tc::launch<64>(q, k, v, out, batch, Tq, S, H, Hkv, causal, window, q_offset,
                              sm_scale, s);
      case 128:
        return tc::launch<128>(q, k, v, out, batch, Tq, S, H, Hkv, causal, window, q_offset,
                               sm_scale, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); D in {16, 64, 128}
// (llama3.2-1b and mixtral-8x7b SMOKE 16, llama3.2-1b FULL 64, mixtral-8x7b FULL 128).
// q, k, v and out must be 16-byte aligned for bf16.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int dtype, int batch, int Tq, int S, int H, int Hkv, int D,
                               int causal, int window, int q_offset, float sm_scale,
                               void* stream) {
  if (batch <= 0 || Tq <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(q, k, v, out, dtype, batch, Tq, S, H, Hkv, D, causal,
                                   window, q_offset, sm_scale,
                                   static_cast<cudaStream_t>(stream)));
}
