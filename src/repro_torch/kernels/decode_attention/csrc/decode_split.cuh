// Split-K single-token GQA decode attention for Hopper (sm_90a): the one
// body of decode_attention.cu (B3, a linear cache) and
// paged_decode_attention.cu (B2, pages behind a table).  Each of those
// files keeps only its entry point, its two __global__ kernels (named
// after its wrapper, so a profile tells them apart) and the way a
// logical key row is addressed (LinearRows, PagedRows below).
//
// Work: out[b, h] = softmax(q[b, h] . K_b^T * scale) V_b over the rows
// [first, len) of key_range, with head h on kv head h / G.
//
// Bound on the H100: bytes.  Each kept K and V row is read once, about two
// multiply-adds per byte read, far below the ~295 operations a byte where
// the arithmetic would become the limit.  So the design spreads the bytes
// over the card and keeps them in flight:
//
//  1. Split the keys.  A (b, kv-head) pair's logical rows are cut into
//     splits of kSplitRows; the grid is (splits, Hkv, B), with the number
//     of splits taken from host-known shapes only (ceil(rows / kSplitRows)).
//     At the main path's 1024-row tables that is 16 splits a pair, about 5
//     of them holding rows at ~300 rows: ~640 busy blocks where one block a
//     pair gave 128.  A split may span pages of any size.  A block whose
//     split holds none of the rows [first, len) returns before it reads
//     any K or V, and writes nothing: the combine recomputes key_range and
//     reads only the splits that hold rows, so it needs no empty partial.
//  2. Wide loads straight into registers.  Each lane loads 16 bytes (8
//     bf16 or 4 f32) of one row; a row is D / 8 (bf16) lanes, so one warp
//     load covers 4 rows at D = 64 and 2 at D = 128.  Every lane issues all
//     of its K and V loads (16 rows a warp) before the first product, so a
//     block keeps its whole split in flight; K and V never pass through
//     shared memory.  A split's page-table entries are read once per page,
//     into shared memory, before the loads.
//  3. Products on the CUDA cores in f32: q (a chunk of HG heads) sits in
//     registers, each lane takes its 8 (or 4) products, and a row's dot
//     product is summed across its lanes with __shfl_xor_sync.  mma.sync
//     (m16n8k16, the G heads padded to 16 rows) would use 4 of its 16 rows
//     at G = 4, and the products are not where the time goes: the loads
//     and each block's chain of dependent reads are (chip_smoke.py's
//     profile phases report the split pass and the combine apart).  On
//     the H100, splits of 128 rows, and 3 blocks an SM forced by launch
//     bounds, were no faster; 4 blocks an SM spill at D = 128 and are
//     slower.  64 rows give short sequences more blocks.
//  4. Softmax per split, exact: the split's scores stay in registers, so
//     the block takes their max, then the weights and the weighted values,
//     in one pass each (no rescaling).  Each split writes an f32 partial
//     (acc[D], m, l) for each of its G heads to scratch [B, H, splits,
//     D + 2] that the wrapper allocates and never zeroes.
//  5. Combine, a second kernel, one warp a (b, head): reads the pair's
//     busy partials in split order, m = max m_i, l = sum l_i e^(m_i - m),
//     acc = sum acc_i e^(m_i - m), out = acc / max(l, 1e-30) rounded once
//     to q's dtype.  No atomics touch a value, so a result is the same from
//     run to run, and with equal split boundaries B3 over a cache and B2
//     over its paged copy compute the same numbers.  A query with no row
//     reads no split: exactly 0.  The other combine, by the last block of
//     each pair to finish (a per-pair counter that resets itself), was
//     only slightly faster on the H100 at the main path's shapes; it was
//     not taken, for the state it keeps between calls (counters that must
//     be zero, shared by every stream).
//
// Why clamp on the device: kv_len is clamped into [0, rows] (key_range)
// and each page id into [0, P - 1] (PagedRows) here, as the reference
// wrapper clamps traced values (src/repro/kernels/decode_attention/
// ops.py:112 and :166-168).  A host range check would cost one
// device-to-host sync per layer per tick.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_split {

constexpr int kSplitRows = 64;  // key rows a block; ops.py's SPLIT_ROWS
constexpr float kNegInf = -1e30f;
constexpr int kCombineWarps = 4;  // (b, head) pairs a combine block

// 4 warps of 16 rows; 8 warps of 8 rows where a lane would hold more than
// 256 bytes of K and V (f32 at D = 128), to stay clear of spills.
template <typename T, int D>
__host__ __device__ constexpr int warps() { return D * (int)sizeof(T) > 256 ? 8 : 4; }
template <typename T, int D>
__host__ __device__ constexpr int threads() { return 32 * warps<T, D>(); }

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
// bf16 element 2i is the low half of word i; its f32 value is its bits
// shifted up 16.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

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

// Logical row p of sequence b, kv head h_kv, in a linear cache
// [B, S, Hkv, D]: element offset base + p * stride.
struct LinearRows {
  long long base;    // (b * S * Hkv + h_kv) * D
  long long stride;  // Hkv * D
  __device__ __forceinline__ void stage(int, int, int*, int) {}
  __device__ __forceinline__ long long offset(int p, const int*) const {
    return base + (long long)p * stride;
  }
};

// Logical row p of sequence b through its table row: row p % page of pool
// page table[p / page], the page id clamped into the pool.
struct PagedRows {
  const int* table;  // this sequence's row of the table
  long long head;    // h_kv * D
  long long stride;  // Hkv * D
  int page, num_pages;
  int pg0;  // the first page of the block's rows, set by stage()
  // Threads 0.. read the table entries of the pages rows [lo, hi) lie on,
  // once each, into s_pid (at most kSplitRows of them).
  __device__ __forceinline__ void stage(int lo, int hi, int* s_pid, int tid) {
    pg0 = lo / page;
    if (tid <= (hi - 1) / page - pg0) {
      const int pid = table[pg0 + tid];
      s_pid[tid] = pid < 0 ? 0 : (pid > num_pages - 1 ? num_pages - 1 : pid);
    }
  }
  __device__ __forceinline__ long long offset(int p, const int* s_pid) const {
    const int pg = p / page;
    return ((long long)s_pid[pg - pg0] * page + (p - pg * page)) * stride + head;
  }
};

// One block: split blockIdx.x of kv head blockIdx.y of sequence blockIdx.z,
// heads h_kv*G + g0 .. + HG - 1 at a time.  Writes the partials of the
// rows [lo, hi) the split holds; returns at once when it holds none.
template <typename T, int D, int HG, class Rows>
__device__ __forceinline__ void split_pass(const T* __restrict__ q, const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           const int* __restrict__ kv_len,
                                           const int* __restrict__ q_pos,
                                           float* __restrict__ part, Rows rows_of, int H,
                                           int Hkv, int rows, int window, int n_splits,
                                           float sm_scale) {
  constexpr int kVec = 16 / (int)sizeof(T);     // elements a lane loads
  constexpr int kLanesPerRow = D / kVec;         // lanes of one row
  constexpr int kRowsPerStep = 32 / kLanesPerRow;
  constexpr int kWarps = warps<T, D>();
  constexpr int kThreads = 32 * kWarps;
  constexpr int kRowsPerWarp = kSplitRows / kWarps;
  constexpr int kSteps = kRowsPerWarp / kRowsPerStep;
  static_assert(kLanesPerRow >= 1 && kLanesPerRow <= 32 && 32 % kLanesPerRow == 0,
                "a row must take a power-of-two number of lanes, at most a warp");
  static_assert(kSteps >= 1 && kRowsPerWarp % kRowsPerStep == 0, "rows a warp");

  __shared__ int s_pid[kSplitRows];
  __shared__ float s_max[kWarps][HG];
  __shared__ float s_sum[kWarps][HG];
  __shared__ float s_acc[kWarps][HG][D];

  const int split = blockIdx.x;
  const int h_kv = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = lane / kLanesPerRow;  // row within a warp step
  const int d0 = (lane % kLanesPerRow) * kVec;

  int first, len;
  bool uniform;
  key_range(kv_len[b], q_pos ? q_pos + b : nullptr, rows, window, &first, &len, &uniform);
  const int r0 = split * kSplitRows;
  const int lo = first > r0 ? first : r0;
  const int hi = len < r0 + kSplitRows ? len : r0 + kSplitRows;
  if (lo >= hi) return;  // block-uniform: no barrier is skipped by part of the block

  rows_of.stage(lo, hi, s_pid, tid);
  __syncthreads();

  // All of this lane's K and V loads, before any product.
  uint4 kr[kSteps], vr[kSteps];
  bool keep[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int p = r0 + warp * kRowsPerWarp + s * kRowsPerStep + sub;
    keep[s] = p >= lo && p < hi;
    kr[s] = make_uint4(0u, 0u, 0u, 0u);
    vr[s] = kr[s];
    if (keep[s]) {
      const long long off = rows_of.offset(p, s_pid) + d0;
      kr[s] = __ldg(reinterpret_cast<const uint4*>(k + off));
      vr[s] = __ldg(reinterpret_cast<const uint4*>(v + off));
    }
  }

  for (int g0 = 0; g0 < G; g0 += HG) {
    const int h0 = h_kv * G + g0;  // heads h0 .. h0 + HG - 1, contiguous in q
    float qf[HG][kVec];
#pragma unroll
    for (int j = 0; j < HG; ++j) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(q + ((long long)b * H + h0 + j) * D + d0));
      unpack(u, qf[j]);
    }

    // Scores: each lane its kVec products, summed across the row's lanes.
    float sc[kSteps][HG];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      float kf[kVec];
      unpack(kr[s], kf);
#pragma unroll
      for (int j = 0; j < HG; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot = fmaf(qf[j][e], kf[e], dot);
#pragma unroll
        for (int o = kLanesPerRow / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        sc[s][j] = keep[s] ? (uniform ? 0.f : dot * sm_scale) : kNegInf;
      }
    }

    // The split's max per head: over this lane's rows, the warp's, the block's.
#pragma unroll
    for (int j = 0; j < HG; ++j) {
      float mx = sc[0][j];
#pragma unroll
      for (int s = 1; s < kSteps; ++s) mx = fmaxf(mx, sc[s][j]);
#pragma unroll
      for (int o = kLanesPerRow; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) s_max[warp][j] = mx;
    }
    __syncthreads();
    float m[HG];
#pragma unroll
    for (int j = 0; j < HG; ++j) {
      m[j] = s_max[0][j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) m[j] = fmaxf(m[j], s_max[w][j]);
    }

    // Weights and weighted values; a dropped row weighs exactly 0.
    float l[HG], acc[HG][kVec];
#pragma unroll
    for (int j = 0; j < HG; ++j) {
      l[j] = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[j][e] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      float vf[kVec];
      unpack(vr[s], vf);
#pragma unroll
      for (int j = 0; j < HG; ++j) {
        const float p = keep[s] ? expf(sc[s][j] - m[j]) : 0.f;
        l[j] += p;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[j][e] = fmaf(p, vf[e], acc[j][e]);
      }
    }
    // Sum over the warp's rows (lanes with equal d0), then over the warps.
#pragma unroll
    for (int j = 0; j < HG; ++j) {
#pragma unroll
      for (int o = kLanesPerRow; o < 32; o <<= 1) {
        l[j] += __shfl_xor_sync(0xffffffffu, l[j], o);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], o);
      }
      if (sub == 0) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) s_acc[warp][j][d0 + e] = acc[j][e];
      }
      if (lane == 0) s_sum[warp][j] = l[j];
    }
    __syncthreads();
    float* dst = part + (((long long)b * H + h0) * n_splits + split) * (D + 2);
    const long long head_stride = (long long)n_splits * (D + 2);  // from head h to h + 1
    for (int e = tid; e < HG * D; e += kThreads) {
      const int j = e / D;
      const int d = e - j * D;
      float x = s_acc[0][j][d];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) x += s_acc[w][j][d];
      dst[j * head_stride + d] = x;
    }
    if (tid == 0) {
#pragma unroll
      for (int j = 0; j < HG; ++j) {
        float sum = s_sum[0][j];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) sum += s_sum[w][j];
        dst[j * head_stride + D] = m[j];
        dst[j * head_stride + D + 1] = sum;
      }
    }
    // The next chunk writes s_max before its first barrier, so nothing
    // here reads s_max; s_sum and s_acc are written again only after that
    // barrier, which every thread reaches after these reads.
  }
}

// One warp: head blockIdx.x * kCombineWarps + threadIdx.y of sequence
// blockIdx.y.  The splits that hold rows of [first, len), in order.
template <typename T, int D>
__device__ __forceinline__ void combine_pass(const float* __restrict__ part,
                                             const int* __restrict__ kv_len,
                                             const int* __restrict__ q_pos, T* __restrict__ out,
                                             int H, int rows, int window, int n_splits) {
  constexpr int kPer = (D + 31) / 32;
  const int b = blockIdx.y;
  const int h = blockIdx.x * kCombineWarps + threadIdx.y;
  if (h >= H) return;
  const int lane = threadIdx.x;
  int first, len;
  bool uniform;
  key_range(kv_len[b], q_pos ? q_pos + b : nullptr, rows, window, &first, &len, &uniform);
  const int s_lo = first / kSplitRows;
  const int s_hi = len > first ? (len - 1) / kSplitRows + 1 : s_lo;
  const float* base = part + ((long long)b * H + h) * n_splits * (D + 2);

  float m = kNegInf;
  for (int s = s_lo; s < s_hi; ++s) m = fmaxf(m, base[(long long)s * (D + 2) + D]);
  float l = 0.f, acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  for (int s = s_lo; s < s_hi; ++s) {
    const float* ps = base + (long long)s * (D + 2);
    const float w = expf(ps[D] - m);
    l = fmaf(ps[D + 1], w, l);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = lane + 32 * i;
      if (d < D) acc[i] = fmaf(ps[d], w, acc[i]);
    }
  }
  T* o = out + ((long long)b * H + h) * D;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = lane + 32 * i;
    if (d < D) store_from_f32(o + d, acc[i] / fmaxf(l, 1e-30f));
  }
}

// Calls Launch<T, D, HG>::run(args...) for the head dims the kernels take
// (16, the SMOKE configs'; 64; 128) and the largest HG in {4, 2, 1} that
// divides G.
template <template <typename, int, int> class Launch, typename T, typename... Args>
cudaError_t dispatch(int D, int G, Args... args) {
  const int hg = G % 4 == 0 ? 4 : (G % 2 == 0 ? 2 : 1);
#define DECODE_SPLIT_CASE(DD)                                              \
  if (D == DD) {                                                           \
    if (hg == 4) return Launch<T, DD, 4>::run(args...);                    \
    if (hg == 2) return Launch<T, DD, 2>::run(args...);                    \
    return Launch<T, DD, 1>::run(args...);                                 \
  }
  DECODE_SPLIT_CASE(16)
  DECODE_SPLIT_CASE(64)
  DECODE_SPLIT_CASE(128)
#undef DECODE_SPLIT_CASE
  return cudaErrorInvalidValue;
}

inline int splits_for(int rows) { return (rows + kSplitRows - 1) / kSplitRows; }

}  // namespace decode_split
