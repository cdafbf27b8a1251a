// TCMM nearest-micro-cluster assignment for Hopper (sm_90a).
//
// Replaces src/repro/kernels/tcmm_assign/kernel.py:tcmm_assign_fwd
// (_assign_kernel, pallas_call at kernel.py:63).  Called once per ingested
// point by the TCMM micro-clustering job, through
// repro_torch/kernels/tcmm_assign/ops.py:tcmm_assign.
//
// Inputs: points [N, F] and centroids [M, F], both f32 or both bf16 (cast
// to f32 exactly), and valid [M] bool.  Outputs: idx [N] i32, the nearest
// valid row, and d2 [N] f32, its squared distance
//   d2[n, m] = (pp_n - 2 cross_nm) + cc_m,   +inf where !valid[m],
// ties to the first index, and index 0 with +inf when no row is valid (as
// jnp.argmin and torch.argmin give).
//
// Arithmetic: the same as the plain version (ref.py), bit for bit.  pp, cc
// and cross are summed over f from 0 upward, and every product and sum is
// rounded on its own: __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never
// contracts into an FMA.  The ingest compares d2 with a threshold and takes
// the argmin, and at real scale two rows come within 1e-3 of each other, so
// any other order would sooner or later pick another cluster than the plain
// path does.  The argmin then agrees too: each lane scans its rows in
// ascending order, and lanes and warps reduce on (d2, index) taken
// lexicographically, which is "the first index among the minima".
//
// Design: a block of 8 warps takes 8 points, one warp each.  The block
// stages the centroid table in shared memory in tiles of up to 4096 floats,
// with the tile's mask and |c|^2 of each row beside it, so the table and
// its norms are read and computed once per 8 points instead of once per
// point.  Each thread issues all its loads of a tile (up to 16 values)
// before it stores any of them, so a tile costs one round trip to memory,
// not one per value: at N = 1 the call is little more than that round trip
// and the launch.  Each lane scans the tile's rows strided by 32 and keeps
// its best (d2, index); a warp shuffle reduces the 32 lanes.  The TPU kernel
// instead ran one MXU product per block of points with the whole table in
// VMEM; here F is 4 in the app, so there is no product worth a tensor core,
// and a fixed-order f32 loop is what the bit-exact rule asks for anyway.
//
// Bound on the H100: at the app's shape (N = 1, M = 512, F = 4) the call
// moves about 10 KB and does about 6 thousand operations: the bound is
// nanoseconds, and the launch (a few microseconds) is the whole cost.  At
// N = 4096 the bound is the f32 operations, about 11 per (n, m) pair at F = 4
// (23 M in all, 0.34 us at 67 TFLOP/s).  Later work: fuse the ingest (read
// n and ls, decide, apply the event) into one launch per point.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileFloats = 4096;  // centroid tile in shared memory: 16 KB
constexpr int kMaxTileRows = 1024;  // |c|^2 (4 KB) and the mask (1 KB) beside it
constexpr int kBatch = kTileFloats / kThreads;  // loads a thread has in flight

// A point or centroid value as the f32 the kernel computes in (bf16 widens
// exactly); a mask value stays bool.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bool widen(bool v) { return v; }

// (d, i) comes before (bd, bi): the smaller distance, then the smaller index.
__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// dst[e] = widen(src[e]) for e < count <= kTileFloats, each thread's kBatch
// loads issued before its stores.
template <typename S, typename D>
__device__ __forceinline__ void stage(D* dst, const S* __restrict__ src, int count) {
  D v[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int e = j * kThreads + threadIdx.x;
    v[j] = e < count ? widen(src[e]) : D();
  }
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int e = j * kThreads + threadIdx.x;
    if (e < count) dst[e] = v[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tcmm_assign_kernel(const T* __restrict__ points, const T* __restrict__ centroids,
                       const bool* __restrict__ valid, int* __restrict__ idx_out,
                       float* __restrict__ d2_out, int n, int m, int f) {
  __shared__ float tile[kTileFloats];
  __shared__ float cc[kMaxTileRows];
  __shared__ bool live[kMaxTileRows];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int point = blockIdx.x * kWarps + warp;
  const bool active = point < n;
  const T* p = points + (size_t)(active ? point : 0) * f;

  float pp = 0.f;
  if (active) {
    pp = __fmul_rn(widen(p[0]), widen(p[0]));
    for (int k = 1; k < f; ++k) pp = __fadd_rn(pp, __fmul_rn(widen(p[k]), widen(p[k])));
  }

  float best_d = CUDART_INF_F;
  int best_i = 0x7fffffff;
  const int tile_rows = min(kMaxTileRows, max(1, kTileFloats / f));
  for (int row0 = 0; row0 < m; row0 += tile_rows) {
    const int rows = min(tile_rows, m - row0);
    __syncthreads();  // the previous tile is no longer read
    stage(tile, centroids + (size_t)row0 * f, rows * f);
    stage(live, valid + row0, rows);
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const float* c = tile + (size_t)r * f;
      float acc = __fmul_rn(c[0], c[0]);
      for (int k = 1; k < f; ++k) acc = __fadd_rn(acc, __fmul_rn(c[k], c[k]));
      cc[r] = acc;
    }
    __syncthreads();
    if (!active) continue;
    for (int r = lane; r < rows; r += 32) {
      const int row = row0 + r;
      float d = CUDART_INF_F;
      if (live[r]) {
        const float* c = tile + (size_t)r * f;
        float cross = __fmul_rn(widen(p[0]), c[0]);
        for (int k = 1; k < f; ++k) cross = __fadd_rn(cross, __fmul_rn(widen(p[k]), c[k]));
        d = __fadd_rn(__fsub_rn(pp, __fmul_rn(2.f, cross)), cc[r]);
      }
      if (before(d, row, best_d, best_i)) {
        best_d = d;
        best_i = row;
      }
    }
  }
  if (!active) return;
  for (int off = 16; off > 0; off /= 2) {
    const float od = __shfl_down_sync(0xffffffffu, best_d, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (before(od, oi, best_d, best_i)) {
      best_d = od;
      best_i = oi;
    }
  }
  if (lane == 0) {
    idx_out[point] = best_i;  // a real row: lane 0 scans row 0, and m >= 1
    d2_out[point] = best_d;
  }
}

template <typename T>
cudaError_t launch(const void* points, const void* centroids, const void* valid, int* idx,
                   float* d2, int n, int m, int f, cudaStream_t stream) {
  const int blocks = (n + kWarps - 1) / kWarps;
  tcmm_assign_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(points), static_cast<const T*>(centroids),
      static_cast<const bool*>(valid), idx, d2, n, m, f);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (points and centroids alike).  Returns a
// cudaError_t: cudaErrorInvalidValue for shapes or a dtype it does not take
// (F > 4096 would not fit one row in the tile), else the launch's error.
extern "C" int tcmm_assign(const void* points, const void* centroids, const void* valid,
                           void* idx, void* d2, int dtype, int n, int m, int f, void* stream) {
  if (n < 0 || m <= 0 || f <= 0 || f > kTileFloats) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(points, centroids, valid, static_cast<int*>(idx),
                        static_cast<float*>(d2), n, m, f, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(points, centroids, valid, static_cast<int*>(idx),
                                static_cast<float*>(d2), n, m, f, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
