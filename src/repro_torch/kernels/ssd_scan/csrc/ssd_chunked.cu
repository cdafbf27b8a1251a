// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd_scan/kernel.py:ssd_chunked_fwd (_ssd_kernel,
// pallas_call at kernel.py:102).  Called once per Mamba-2 layer on every
// prefill, through repro_torch/kernels/ssd_scan/ops.py:ssd_chunked.
//
// Inputs: x [B, T, H, P] f32 (dt-scaled), decays a [B, T, H] f32, B and C
// [B, T, N] in the activation dtype (f32 or bf16), shared across heads, and
// an optional initial state [B, H, N, P] f32.  Outputs: y [B, T, H, P] f32
// and the final state [B, H, N, P] f32.  Per chunk of Q steps:
//   cum   = cumsum(log(max(a, 1e-20)))
//   att   = tril(C B^T * exp(cum_t - cum_s))       (masked before the exp)
//   y     = att x + (C * exp(cum)) S_prev
//   S     = exp(cum_Q) S_prev + (B * exp(cum_Q - cum))^T x
// The scan starts from the given initial state.  The reference wrapper runs
// from zero and folds the initial state in afterwards
// (src/repro/kernels/ssd_scan/ops.py:28-40); the scan is linear in its
// state, so the two are equal in exact arithmetic.
//
// Design: one block per (b, h) walks the chunks in order and keeps the
// [N, P] state in shared memory across them.  That loop takes the place of
// the TPU's sequential chunk axis of the grid (kernel.py:46-51): Hopper runs
// blocks in parallel and in no order, so nothing could carry the state from
// one block to the next.  Each chunk stages x, B and C (as f32), the
// cumulative log decays and the Q x Q att tile in shared memory; at N=128,
// P=64, Q=64 that is 166 KB with the state, so the launch raises the
// block's dynamic shared-memory limit first.  Each thread computes 4 x 4
// tiles of every product in registers, reading its operands as float4s:
// C and B are also kept transposed ([N][Q], rows padded by 4 floats so the
// transposing stores do not collide on banks), att transposed, B a second
// time scaled by its decay to the chunk's end.  All four products are
// plain f32 FMA loops in this body: no tensor cores, no library call.
//
// Precision: the cumulative log decays are summed and differenced in f64.
// In f32, exp(cum_t - cum_s) loses about eps * |cum| to cancellation, and
// |cum| reaches hundreds within a chunk of a fast-decaying head: that
// rounding set most of an f32 version's error against an f64 recurrence
// (and most of the plain version's).  It costs Q log/scan steps and Q^2/2
// f64 subtractions per chunk, beside N Q^2 / 2 FMAs.
//
// Bound on the H100: f32 operations (about 2.5 GFLOP against 37 MB of
// traffic for one layer's 2048-step prefill of mamba2-370m); the reference
// keeps the scan in f32, and TF32 tensor cores would not.  This first
// version leaves most of that rate unused: a prefill at B=1 gives H=32
// blocks for 132 SMs, one block of 8 warps per SM, and C B^T is recomputed
// by every head although B and C are shared across heads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // per-block shared-memory limit of sm_90

struct Args {
  const float* x;   // [B, T, H, P]
  const float* a;   // [B, T, H]
  const void* Bm;   // [B, T, N]
  const void* Cm;   // [B, T, N]
  const float* s0;  // [B, H, N, P] or null (zero state)
  float* y;         // [B, T, H, P]
  float* s_out;     // [B, H, N, P]
  int T, H, P, N, Q;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The f32 tiles, then Q f64 cumulative log decays (at a 16-byte aligned
// offset: every tile is a multiple of 4 floats), then two [Q] f32 decays.
size_t smem_bytes(int P, int N, int Q) {
  const size_t ldq = (size_t)Q + 4;
  return sizeof(float) * ((size_t)N * P + (size_t)Q * P + 2 * (size_t)N * ldq +
                          (size_t)Q * N + (size_t)Q * ldq + 2 * (size_t)Q) +
         sizeof(double) * (size_t)Q;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void unpack(const float4 v, float (&out)[4]) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// acc[i][j] += u[i] * v[j]
__device__ __forceinline__ void outer(float (&acc)[4][4], const float4 u4, const float4 v4) {
  float u[4], v[4];
  unpack(u4, u);
  unpack(v4, v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(u[i], v[j], acc[i][j]);
  }
}

// Q, P and N are multiples of 4 (the wrapper checks): every float4 below
// is 16-byte aligned.  One block per SM at most (its shared memory), so the
// launch bounds let each thread keep up to 255 registers.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_chunked_kernel(Args args) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int Tn = args.T, H = args.H, P = args.P, N = args.N, Q = args.Q;
  const int ldq = Q + 4;
  const int QG = Q / 4, PG = P / 4, NG = N / 4;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) float smem[];
  float* s_state = smem;            // [N][P]
  float* s_x = s_state + N * P;     // [Q][P]
  float* s_Ct = s_x + Q * P;        // [N][ldq]: C transposed
  float* s_Bt = s_Ct + N * ldq;     // [N][ldq]: B transposed
  float* s_Bs = s_Bt + N * ldq;     // [Q][N]: B times the decay to the chunk's end
  float* s_attT = s_Bs + Q * N;     // [Q][ldq]: s_attT[s][t] = att[t][s]
  // [Q] log decays, then their inclusive cumsum, in f64
  double* s_cum = reinterpret_cast<double*>(s_attT + Q * ldq);
  float* s_in = reinterpret_cast<float*>(s_cum + Q);  // [Q] exp(cum_t): decay from the chunk's start
  float* s_end = s_in + Q;          // [Q] exp(cum_last - cum_s): decay to its end

  const T* Bm = static_cast<const T*>(args.Bm) + (size_t)b * Tn * N;
  const T* Cm = static_cast<const T*>(args.Cm) + (size_t)b * Tn * N;
  const size_t s_base = ((size_t)b * H + h) * N * P;
  for (int e = tid; e < N * P; e += kThreads) {
    s_state[e] = args.s0 != nullptr ? args.s0[s_base + e] : 0.f;
  }

  for (int t0 = 0; t0 < Tn; t0 += Q) {
    // 1. Stage the chunk: x rows of head h; B and C as f32, each thread
    //    taking 4 steps of one state channel (reads coalesced along N);
    //    the log decays.
    for (int e = tid; e < Q * P; e += kThreads) {
      const int q = e / P, p = e - q * P;
      s_x[e] = args.x[(((size_t)b * Tn + t0 + q) * H + h) * P + p];
    }
    for (int e = tid; e < QG * N; e += kThreads) {
      const int qg = e / N, n = e - qg * N;
      float bv[4], cv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const size_t g = (size_t)(t0 + 4 * qg + k) * N + n;
        bv[k] = to_f32(Bm[g]);
        cv[k] = to_f32(Cm[g]);
        s_Bs[(4 * qg + k) * N + n] = bv[k];
      }
      *reinterpret_cast<float4*>(s_Bt + n * ldq + 4 * qg) = make_float4(bv[0], bv[1], bv[2], bv[3]);
      *reinterpret_cast<float4*>(s_Ct + n * ldq + 4 * qg) = make_float4(cv[0], cv[1], cv[2], cv[3]);
    }
    for (int q = tid; q < Q; q += kThreads) {
      s_cum[q] = logf(fmaxf(args.a[((size_t)b * Tn + t0 + q) * H + h], 1e-20f));
    }
    __syncthreads();

    // 2. Inclusive cumsum of the log decays: warp 0, 32 steps at a time.
    if (tid < 32) {
      double carry = 0.0;
      for (int base = 0; base < Q; base += 32) {
        const int q = base + tid;
        double v = q < Q ? s_cum[q] : 0.0;
        for (int o = 1; o < 32; o <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, v, o);
          if (tid >= o) v += u;
        }
        v += carry;
        if (q < Q) s_cum[q] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();

    // 3. Decay factors, and att[t][s] = (C_t . B_s) exp(cum_t - cum_s) for
    //    s <= t in 4 x 4 tiles.  Above the diagonal cum_t - cum_s > 0 could
    //    overflow: it is never exponentiated, the entry is 0, and tiles
    //    wholly above the diagonal skip the product.
    const double cum_last = s_cum[Q - 1];
    for (int q = tid; q < Q; q += kThreads) {
      s_in[q] = static_cast<float>(exp(s_cum[q]));
      s_end[q] = static_cast<float>(exp(cum_last - s_cum[q]));
    }
    for (int tile = tid; tile < QG * QG; tile += kThreads) {
      const int tg = tile / QG, sg = tile - tg * QG;
      float acc[4][4] = {};
      if (sg <= tg) {
        for (int n = 0; n < N; ++n) {
          outer(acc, ld4(s_Ct + n * ldq + 4 * tg), ld4(s_Bt + n * ldq + 4 * sg));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = 4 * tg + i, s = 4 * sg + j;
            acc[i][j] = s <= t ? acc[i][j] * expf(static_cast<float>(s_cum[t] - s_cum[s])) : 0.f;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<float4*>(s_attT + (4 * sg + j) * ldq + 4 * tg) =
            make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      }
    }
    __syncthreads();

    // 4. y[t][p] = exp(cum_t) sum_n C[t][n] S[n][p] + sum_{s<=t} att[t][s] x[s][p],
    //    from the state entering the chunk, in 4 x 4 tiles; and B scaled by
    //    its decay to the chunk's end for step 5.
    for (int tile = tid; tile < QG * PG; tile += kThreads) {
      const int tg = tile / PG, pg = tile - tg * PG;
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        outer(acc, ld4(s_Ct + n * ldq + 4 * tg), ld4(s_state + n * P + 4 * pg));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = s_in[4 * tg + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= d;
      }
      for (int s = 0; s < 4 * tg + 4; ++s) {  // att is 0 above the diagonal
        outer(acc, ld4(s_attT + s * ldq + 4 * tg), ld4(s_x + s * P + 4 * pg));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* yr = args.y + (((size_t)b * Tn + t0 + 4 * tg + i) * H + h) * P + 4 * pg;
#pragma unroll
        for (int j = 0; j < 4; ++j) yr[j] = acc[i][j];
      }
    }
    for (int e = tid; e < Q * N; e += kThreads) s_Bs[e] *= s_end[e / N];
    __syncthreads();

    // 5. S[n][p] = exp(cum_last) S[n][p] + sum_s B[s][n] exp(cum_last - cum_s) x[s][p],
    //    in 4 x 4 tiles.
    const float chunk_decay = static_cast<float>(exp(cum_last));
    for (int tile = tid; tile < NG * PG; tile += kThreads) {
      const int ng = tile / PG, pg = tile - ng * PG;
      float acc[4][4] = {};
      for (int s = 0; s < Q; ++s) {
        outer(acc, ld4(s_Bs + s * N + 4 * ng), ld4(s_x + s * P + 4 * pg));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4* sp = reinterpret_cast<float4*>(s_state + (4 * ng + i) * P + 4 * pg);
        const float4 old = *sp;
        *sp = make_float4(fmaf(chunk_decay, old.x, acc[i][0]), fmaf(chunk_decay, old.y, acc[i][1]),
                          fmaf(chunk_decay, old.z, acc[i][2]), fmaf(chunk_decay, old.w, acc[i][3]));
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < N * P; e += kThreads) args.s_out[s_base + e] = s_state[e];
}

template <typename T>
cudaError_t launch(const Args& args, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(args.P, args.N, args.Q);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunked_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(args.H, batch);
  ssd_chunked_kernel<T><<<grid, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

// bc_dtype: 0 = float32, 1 = bfloat16 (the type of B and C; everything else
// is float32).  s0 may be null for a zero initial state.  Returns the
// cudaError_t of the launch (0 on success).  Shapes the kernel cannot take
// return cudaErrorInvalidValue without launching: chunk, P or N not a
// multiple of 4, T not a multiple of chunk, or tiles beyond one block's
// shared memory.
extern "C" int ssd_chunked(const void* x, const void* a, const void* B, const void* C,
                           const void* s0, void* y, void* s_out, int bc_dtype, int batch,
                           int T, int H, int P, int N, int chunk, void* stream) {
  if (chunk <= 0 || T < 0 || P <= 0 || N <= 0 || T % chunk != 0 || chunk % 4 != 0 ||
      P % 4 != 0 || N % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  const Args args{static_cast<const float*>(x), static_cast<const float*>(a), B, C,
                  static_cast<const float*>(s0), static_cast<float*>(y),
                  static_cast<float*>(s_out), T, H, P, N, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bc_dtype == 0) {
    err = launch<float>(args, batch, s);
  } else if (bc_dtype == 1) {
    err = launch<__nv_bfloat16>(args, batch, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory one block takes at these sizes, in bytes (ptxas
// reports only static shared memory).
extern "C" int ssd_chunked_smem_bytes(int P, int N, int chunk) {
  return static_cast<int>(smem_bytes(P, N, chunk));
}
