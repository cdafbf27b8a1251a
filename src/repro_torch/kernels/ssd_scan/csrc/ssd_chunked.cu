// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd_scan/kernel.py:ssd_chunked_fwd (_ssd_kernel,
// pallas_call at kernel.py:102).  Called once per Mamba-2 layer on every
// prefill, through repro_torch/kernels/ssd_scan/ops.py:ssd_chunked.
//
// Inputs: x [B, T, H, P] f32 (dt-scaled), decays a [B, T, H] f32, B and C
// [B, T, N] in the activation dtype (f32 or bf16), shared across heads, and
// an optional initial state [B, H, N, P] f32.  Outputs: y [B, T, H, P] f32
// and the final state [B, H, N, P] f32.  Per chunk c of Q steps:
//   cum   = cumsum(log(max(a, 1e-20)))
//   att   = tril(C B^T * exp(cum_t - cum_s))       (masked before the exp)
//   y     = att x + (C * exp(cum)) S_{c-1}
//   S_c   = exp(cum_Q) S_{c-1} + (B * exp(cum_Q - cum))^T x
// from the given initial state, or from zero.  The reference wrapper runs
// from zero and folds the initial state in afterwards
// (src/repro/kernels/ssd_scan/ops.py:28-40); the scan is linear in its
// state, so the two are equal in exact arithmetic.
//
// Design: the state-passing form of the scan, as three passes on the
// stream, so that every chunk of every head is worked on at once:
//   1. chunk pass, grid (H * ceil(N / 32) + ceil(Q / 16), chunks, B), 128
//      threads.  A block (h, slice of 32 state rows) computes its chunk's
//      own contribution dS_c = (B * exp(cum_Q - cum))^T x for those rows,
//      and the first slice of each head writes exp(cum_Q).  The last
//      ceil(Q / 16) blocks of each chunk compute C B^T over 16 rows of the
//      causal half, once per (b, chunk) for all heads, since B and C are
//      shared by the heads.
//   2. state pass, grid (ceil(N P / 1024), H, B), 256 threads, one float4
//      of the state a thread: walks the chunks, S_c = exp(cum_Q) S_{c-1} +
//      dS_c, writes the state entering each chunk over dS_c in place and
//      the final state.  This is the only sequential part, and it is
//      elementwise.
//   3. output pass, grid (H * ceil(Q / 32) * ceil(P / 32), chunks, B), 128
//      threads.  A block takes 32 rows and 32 columns of one head's chunk:
//      y = exp(cum_t) C S_{c-1} + att x, att from the shared C B^T and
//      this head's decays.
// At mamba2-370m's widths (H=32, P=64, N=128, Q=64) and B=1 the chunk pass
// has 132 blocks a chunk and the output pass 128, so even a one-chunk
// prefill gives the card's 132 SMs a block each; the old design had one
// block per (b, h), 32 in all, each walking its chunks in order.  Scratch
// (``work``, f32, allocated by the wrapper): the states [B, H, nc, N, P],
// C B^T [B, nc, Q, Q] and exp(cum_Q) [B, H, nc]; at the served lengths (nc
// <= 8) it stays in the 50 MB L2.  The state and output passes are
// launched as programmatic dependents (sm_90): each starts while the pass
// before it finishes, copies and scans what it reads of the call's own
// inputs, and waits before it reads what that pass wrote.
//
// Each block copies what it reads into shared memory by cp.async (x, the
// states and C B^T 16 bytes at a time, B and C four values at a time in
// their own dtype, the decays 4 bytes at a time), all issued before it
// waits, so that a block makes one round trip to memory (two in the output
// pass: the inputs, then the states and C B^T) where loads into registers
// would wait on each in turn.  It then widens B and C and applies the
// decays in shared memory, and each thread sums a tile in registers from
// vector reads: 4 x 4 of dS, 2 x 4 of C B^T and of y.  All products are
// plain f32 FMA loops in the order the single-block version summed them
// (n, then s, ascending), so every output rounds as that version's did.
// No tensor cores: TF32 rounds every operand to 11 bits, and a 3xTF32
// split ran no faster than these loops on the H100.  No library call.
//
// Precision: the cumulative log decays are summed and differenced in f64,
// in the chunk and output passes alike.  In f32, exp(cum_t - cum_s) loses
// about eps * |cum| to cancellation, and |cum| reaches hundreds within a
// chunk of a fast-decaying head: that rounding set most of an f32
// version's error against an f64 recurrence (and most of the plain
// version's).  It costs Q log/scan steps a block and Q^2/2 f64
// subtractions per output block, beside its FMAs.
//
// Bound on the H100: f32 operations (about 2.5 GFLOP against 37 MB of
// traffic for one layer's 2048-step prefill of mamba2-370m).  The scratch
// moves about 4 x 33.5 MB at that length, which the bound does not count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;  // per-block shared-memory limit of sm_90
constexpr int kChunkThreads = 128;
constexpr int kStateThreads = 256;
constexpr int kOutThreads = 128;
constexpr int kSlice = 32;   // state rows (of N) a chunk-pass block takes
constexpr int kCbRows = 16;  // chunk rows a C B^T block takes
constexpr int kRows = 32;    // chunk rows an output block takes
constexpr int kCols = 32;    // columns of P an output block takes

struct Args {
  const float* x;   // [B, T, H, P]
  const float* a;   // [B, T, H]
  const void* Bm;   // [B, T, N]
  const void* Cm;   // [B, T, N]
  const float* s0;  // [B, H, N, P] or null (zero state)
  float* y;         // [B, T, H, P]
  float* s_out;     // [B, H, N, P]
  float* states;    // [B, H, nc, N, P]: dS_c, then the state entering chunk c
  float* cb;        // [B, nc, Q, Q]: C B^T, rows t >= s only
  float* dec;       // [B, H, nc]: exp(cum_Q)
  int T, H, P, N, Q, nc;
};

size_t cdiv(size_t a, size_t b) { return (a + b - 1) / b; }

// Byte offsets into a block's dynamic shared memory, computed alike on the
// host (the launch's size) and on the device.  With Q, P and N multiples
// of 4 every offset is a multiple of 16 bytes.  ``es`` is the size of one
// value of B and C; their rows are padded by 4 values.
struct ChunkSmem {  // chunk pass
  // dS blocks: x [Q][P] f32, B [Q][kSlice] as given, B times its decay to
  // the chunk's end [Q][kSlice] f32, a [Q] f32, the f64 log decays [Q], the
  // end decays [Q] f32.
  size_t x, b_raw, b, a, cum, end, ds_bytes;
  // C B^T blocks: C rows [kCbRows][N + 4], B rows [Q][N + 4], as given.
  size_t cb_c, cb_b, cb_bytes;
  __host__ __device__ ChunkSmem(int P, int N, int Q, int es) {
    size_t o = 0;
    x = o, o += 4 * (size_t)Q * P;
    b_raw = o, o += (size_t)es * Q * kSlice;
    b = o, o += 4 * (size_t)Q * kSlice;
    a = o, o += 4 * (size_t)Q;
    cum = o, o += 8 * (size_t)Q;
    end = o, o += 4 * (size_t)Q;
    ds_bytes = o;
    cb_c = 0;
    cb_b = (size_t)es * kCbRows * (N + 4);
    cb_bytes = cb_b + (size_t)es * Q * (N + 4);
  }
  __host__ __device__ size_t bytes() const { return ds_bytes > cb_bytes ? ds_bytes : cb_bytes; }
};

struct OutSmem {  // output pass
  // C rows [kRows][N + 4] as given, the state [N][kCols], x [Q][kCols],
  // C B^T rows [kRows][Q + 4] (then att, in place), a [Q], the f64 log
  // decays [Q], exp(cum_t) [kRows].
  size_t c, s, x, att, a, cum, in, bytes;
  __host__ __device__ OutSmem(int N, int Q, int es) {
    size_t o = 0;
    c = o, o += (size_t)es * kRows * (N + 4);
    s = o, o += 4 * (size_t)N * kCols;
    x = o, o += 4 * (size_t)Q * kCols;
    att = o, o += 4 * (size_t)kRows * (Q + 4);
    a = o, o += 4 * (size_t)Q;
    cum = o, o += 8 * (size_t)Q;
    in = o, o += 4 * (size_t)kRows;
    bytes = o;
  }
};

size_t workspace_floats(int batch, int H, int P, int N, int Q, int nc) {
  return (size_t)batch * nc * ((size_t)H * N * P + (size_t)Q * Q + H);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four consecutive values of B or C in shared memory, as f32.
__device__ __forceinline__ float4 to4(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 to4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
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

// acc[i][j] += sum_k u[i][k] * v[j][k], k in ascending order: four steps
// of a product whose operands are both read along the summed axis.
template <int R>
__device__ __forceinline__ void outer4(float (&acc)[R][4], const float (&u)[R][4],
                                       const float (&v)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(u[i][k], v[j][k], acc[i][j]);
    }
  }
}

// BYTES (4, 8 or 16) bytes global -> shared, asynchronous.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Programmatic dependent launch (sm_90): a pass launched after another
// with programmatic stream serialization may start once every block of
// the one before has started (let_next_pass_start), runs what reads only
// the call's inputs, and waits for the pass before to finish, its writes
// visible, before it reads them (wait_for_previous_pass).  The launch and
// the prologue of each pass thus overlap the tail of the one before.
__device__ __forceinline__ void let_next_pass_start() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_previous_pass() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Copy rows [0, rows) x values [0, cols) of a row-major array (row pitch
// ``ld`` values) into shared memory (row pitch ``lds``), four values at a
// time.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int lds, const T* src, size_t ld, int rows,
                                          int cols) {
  const int quads = cols / 4;
  for (int e = threadIdx.x; e < rows * quads; e += blockDim.x) {
    const int r = e / quads, k = 4 * (e - r * quads);
    cp_async<4 * sizeof(T)>(dst + r * lds + k, src + r * ld + k);
  }
}

// a of head h, rows [t0, t0 + len), into shared memory.
__device__ __forceinline__ void copy_decays(float* s_a, const Args& args, int b, int h, int t0,
                                            int len) {
  for (int q = threadIdx.x; q < len; q += blockDim.x) {
    cp_async<4>(s_a + q, args.a + ((size_t)b * args.T + t0 + q) * args.H + h);
  }
}

// s_cum[0, len) = inclusive cumsum of log(max(a, 1e-20)), in f64, by warp
// 0, 32 steps at a time.  Every pass sums in this one order, so they agree
// bit for bit.
__device__ __forceinline__ void cumsum_log_decays(double* s_cum, const float* s_a, int len) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  double carry = 0.0;
  for (int base = 0; base < len; base += 32) {
    const int q = base + lane;
    double v = q < len ? static_cast<double>(logf(fmaxf(s_a[q], 1e-20f))) : 0.0;
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    v += carry;
    if (q < len) s_cum[q] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

template <typename T>
__device__ __forceinline__ T* at(unsigned char* smem, size_t offset) {
  return reinterpret_cast<T*>(smem + offset);
}

// C B^T of rows [r0, r0 + 16) of chunk c, columns s <= t, in tiles of 2
// rows and 4 columns, one a thread (so that no thread sums more than 8
// outputs over all of N).  Tiles wholly above the diagonal are skipped;
// the output pass never reads an entry above it.
template <typename T>
__device__ void chunk_cb(const Args& args, unsigned char* smem, int b, int c, int r0) {
  const int Q = args.Q, N = args.N, ld = N + 4;
  const int rt = min(kCbRows, Q - r0), s_end = r0 + rt;
  const ChunkSmem L(args.P, N, Q, sizeof(T));
  T* s_c = at<T>(smem, L.cb_c);  // [kCbRows][N + 4]
  T* s_b = at<T>(smem, L.cb_b);  // [Q][N + 4]
  const size_t row0 = (size_t)b * args.T + (size_t)c * Q;
  copy_rows(s_c, ld, static_cast<const T*>(args.Cm) + (row0 + r0) * N, N, rt, N);
  copy_rows(s_b, ld, static_cast<const T*>(args.Bm) + row0 * N, N, s_end, N);
  cp_async_wait_all();
  __syncthreads();

  const int SG = s_end / 4;
  float* cb = args.cb + ((size_t)b * args.nc + c) * Q * Q;
  for (int tile = threadIdx.x; tile < (rt / 2) * SG; tile += blockDim.x) {
    const int tp = tile / SG, sg = tile - tp * SG;
    const int t = 2 * tp, s = 4 * sg;
    if (s > r0 + t + 1) continue;
    float acc[2][4] = {};
    for (int n = 0; n < N; n += 4) {
      float cv[2][4], bv[4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) unpack(to4(s_c + (t + i) * ld + n), cv[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) unpack(to4(s_b + (s + j) * ld + n), bv[j]);
      outer4(acc, cv, bv);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<float4*>(cb + (size_t)(r0 + t + i) * Q + s) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// Q, P and N are multiples of 4 (the entry point checks), and the operands
// start on 16-byte boundaries (the wrapper checks): every vector access
// below is aligned.
template <typename T>
__global__ void __launch_bounds__(kChunkThreads) ssd_chunked_chunk_kernel(Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  let_next_pass_start();
  const int c = blockIdx.y, b = blockIdx.z;
  const int Tn = args.T, H = args.H, P = args.P, N = args.N, Q = args.Q;
  const int slices = (N + kSlice - 1) / kSlice;
  if ((int)blockIdx.x >= H * slices) {
    chunk_cb<T>(args, smem, b, c, kCbRows * (blockIdx.x - H * slices));
    return;
  }
  const int h = blockIdx.x / slices, n0 = kSlice * (blockIdx.x - h * slices);
  const int nb = min(kSlice, N - n0);
  const int tid = threadIdx.x, t0 = c * Q;
  const ChunkSmem L(P, N, Q, sizeof(T));
  float* s_x = at<float>(smem, L.x);      // [Q][P]
  T* s_braw = at<T>(smem, L.b_raw);       // [Q][kSlice]
  float* s_b = at<float>(smem, L.b);      // [Q][kSlice]: B times its decay to the end
  float* s_a = at<float>(smem, L.a);      // [Q]
  double* s_cum = at<double>(smem, L.cum);  // [Q]
  float* s_end = at<float>(smem, L.end);  // [Q] exp(cum_last - cum_s)

  copy_rows(s_x, P, args.x + ((size_t)b * Tn + t0) * H * P + (size_t)h * P, (size_t)H * P, Q, P);
  copy_rows(s_braw, kSlice, static_cast<const T*>(args.Bm) + ((size_t)b * Tn + t0) * N + n0,
            N, Q, nb);
  copy_decays(s_a, args, b, h, t0, Q);
  cp_async_wait_all();
  __syncthreads();
  cumsum_log_decays(s_cum, s_a, Q);
  __syncthreads();

  const double cum_last = s_cum[Q - 1];
  for (int q = tid; q < Q; q += kChunkThreads) {
    s_end[q] = static_cast<float>(exp(cum_last - s_cum[q]));
  }
  if (n0 == 0 && tid == 0) {
    args.dec[((size_t)b * H + h) * args.nc + c] = static_cast<float>(exp(cum_last));
  }
  __syncthreads();
  const int KG = nb / 4, PG = P / 4;
  for (int e = tid; e < Q * KG; e += kChunkThreads) {
    const int q = e / KG, k = 4 * (e - q * KG);
    const float4 v = to4(s_braw + q * kSlice + k);
    const float d = s_end[q];
    *reinterpret_cast<float4*>(s_b + q * kSlice + k) =
        make_float4(v.x * d, v.y * d, v.z * d, v.w * d);
  }
  __syncthreads();

  // dS[n][p] = sum_s B[s][n] exp(cum_last - cum_s) x[s][p], in 4 x 4 tiles.
  float* ds = args.states + (((size_t)b * H + h) * args.nc + c) * N * P;
  for (int tile = tid; tile < KG * PG; tile += kChunkThreads) {
    const int kg = tile / PG, pg = tile - kg * PG;
    float acc[4][4] = {};
    for (int s = 0; s < Q; ++s) {
      outer(acc, ld4(s_b + s * kSlice + 4 * kg), ld4(s_x + s * P + 4 * pg));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(ds + (size_t)(n0 + 4 * kg + i) * P + 4 * pg) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// One float4 of one head's state a thread; the chunks' dS are read 8 at a
// time ahead of the dependent updates.
__global__ void __launch_bounds__(kStateThreads) ssd_chunked_state_kernel(Args args) {
  let_next_pass_start();
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t np = (size_t)args.N * args.P;
  const size_t e = 4 * ((size_t)blockIdx.x * kStateThreads + threadIdx.x);
  if (e >= np) return;
  const size_t bh = (size_t)b * args.H + h;
  const int nc = args.nc;
  float4 s = args.s0 != nullptr ? ld4(args.s0 + bh * np + e) : make_float4(0.f, 0.f, 0.f, 0.f);
  wait_for_previous_pass();
  float* st = args.states + bh * nc * np + e;
  const float* dec = args.dec + bh * nc;
  constexpr int kAhead = 8;
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float4 ds[kAhead];
    float d[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < nc) {
        ds[k] = ld4(st + (c0 + k) * np);
        d[k] = dec[c0 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < nc) {
        *reinterpret_cast<float4*>(st + (c0 + k) * np) = s;
        s = make_float4(fmaf(d[k], s.x, ds[k].x), fmaf(d[k], s.y, ds[k].y),
                        fmaf(d[k], s.z, ds[k].z), fmaf(d[k], s.w, ds[k].w));
      }
    }
  }
  *reinterpret_cast<float4*>(args.s_out + bh * np + e) = s;
}

template <typename T>
__global__ void __launch_bounds__(kOutThreads) ssd_chunked_output_kernel(Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.y, b = blockIdx.z;
  const int Tn = args.T, H = args.H, P = args.P, N = args.N, Q = args.Q, ldc = N + 4;
  const int row_tiles = (Q + kRows - 1) / kRows, col_tiles = (P + kCols - 1) / kCols;
  const int h = blockIdx.x / (row_tiles * col_tiles);
  const int rem = blockIdx.x - h * row_tiles * col_tiles;
  const int r0 = kRows * (rem / col_tiles), p0 = kCols * (rem % col_tiles);
  const int rt = min(kRows, Q - r0), pt = min(kCols, P - p0), s_end = r0 + rt;
  const int tid = threadIdx.x, t0 = c * Q;
  // Chunk 0 from a zero state has no inter-chunk term.
  const bool inter = c > 0 || args.s0 != nullptr;
  const OutSmem L(N, Q, sizeof(T));
  T* s_c = at<T>(smem, L.c);              // [kRows][N + 4]: C of the block's rows
  float* s_s = at<float>(smem, L.s);      // [N][kCols]: the state entering the chunk
  float* s_x = at<float>(smem, L.x);      // [Q][kCols]
  float* s_att = at<float>(smem, L.att);  // [kRows][Q + 4]: C B^T of the block's rows, then att
  float* s_a = at<float>(smem, L.a);      // [Q]
  double* s_cum = at<double>(smem, L.cum);  // [Q]
  float* s_in = at<float>(smem, L.in);    // [kRows] exp(cum_t)
  const int lda = Q + 4;

  // the call's inputs first, while the passes before finish
  if (inter) {
    copy_rows(s_c, ldc, static_cast<const T*>(args.Cm) + ((size_t)b * Tn + t0 + r0) * N, N, rt,
              N);
  }
  copy_rows(s_x, kCols, args.x + ((size_t)b * Tn + t0) * H * P + (size_t)h * P + p0,
            (size_t)H * P, s_end, pt);
  copy_decays(s_a, args, b, h, t0, s_end);
  cp_async_wait_all();
  __syncthreads();
  cumsum_log_decays(s_cum, s_a, s_end);

  // then what the chunk and state passes wrote
  wait_for_previous_pass();
  if (inter) {
    copy_rows(s_s, kCols, args.states + (((size_t)b * H + h) * args.nc + c) * N * P + p0, P, N,
              pt);
  }
  copy_rows(s_att, lda, args.cb + (((size_t)b * args.nc + c) * Q + r0) * Q, Q, rt, s_end);
  cp_async_wait_all();
  __syncthreads();

  // att[t][s] = (C_t . B_s) exp(cum_t - cum_s) for s <= t, else 0: above
  // the diagonal cum_t - cum_s > 0 could overflow, and C B^T is not
  // written there; neither is used.
  for (int t = tid; t < rt; t += kOutThreads) s_in[t] = static_cast<float>(exp(s_cum[r0 + t]));
  for (int e = tid; e < rt * s_end; e += kOutThreads) {
    const int t = e / s_end, s = e - t * s_end;
    float* v = s_att + t * lda + s;
    *v = s <= r0 + t ? *v * expf(static_cast<float>(s_cum[r0 + t] - s_cum[s])) : 0.f;
  }
  __syncthreads();

  // y[t][p] = exp(cum_t) sum_n C[t][n] S[n][p] + sum_{s<=t} att[t][s] x[s][p],
  // in tiles of 2 rows and 4 columns, one a thread.
  const int PG = pt / 4;
  for (int tile = tid; tile < (rt / 2) * PG; tile += kOutThreads) {
    const int tp = tile / PG, pg = tile - tp * PG;
    const int t = 2 * tp;
    float acc[2][4] = {};
    float u[2][4], v[4][4];
    if (inter) {
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
#pragma unroll
        for (int i = 0; i < 2; ++i) unpack(to4(s_c + (t + i) * ldc + n), u[i]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // v[j][k] = S[n + k][p_j]
          const float4 w = ld4(s_s + (n + k) * kCols + 4 * pg);
          v[0][k] = w.x;
          v[1][k] = w.y;
          v[2][k] = w.z;
          v[3][k] = w.w;
        }
        outer4(acc, u, v);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float d = s_in[t + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= d;
      }
    }
    // att is 0 above the diagonal: the last step of 4 may pass row t + 1
    const int s_lim = (r0 + t + 2 + 3) & ~3;
#pragma unroll 2
    for (int s = 0; s < s_lim; s += 4) {
#pragma unroll
      for (int i = 0; i < 2; ++i) unpack(ld4(s_att + (t + i) * lda + s), u[i]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // v[j][k] = x[s + k][p_j]
        const float4 w = ld4(s_x + (s + k) * kCols + 4 * pg);
        v[0][k] = w.x;
        v[1][k] = w.y;
        v[2][k] = w.z;
        v[3][k] = w.w;
      }
      outer4(acc, u, v);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* yr = args.y + (((size_t)b * Tn + t0 + r0 + t + i) * H + h) * P + p0 + 4 * pg;
      *reinterpret_cast<float4*>(yr) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Launch a pass that may start before the one before it on the stream
// has finished (see wait_for_previous_pass).
template <typename K>
cudaError_t launch_overlapped(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                              const Args& args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args);
}

template <typename T>
cudaError_t launch(const Args& args, int batch, cudaStream_t stream) {
  const size_t smem1 = ChunkSmem(args.P, args.N, args.Q, sizeof(T)).bytes();
  const size_t smem3 = OutSmem(args.N, args.Q, sizeof(T)).bytes;
  if (smem1 > (size_t)kMaxSmem || smem3 > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(ssd_chunked_chunk_kernel<T>, smem1);
  if (err == cudaSuccess) err = allow_smem(ssd_chunked_output_kernel<T>, smem3);
  if (err != cudaSuccess) return err;
  if (args.nc > 0) {
    const dim3 grid(args.H * cdiv(args.N, kSlice) + cdiv(args.Q, kCbRows), args.nc, batch);
    ssd_chunked_chunk_kernel<T><<<grid, kChunkThreads, smem1, stream>>>(args);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const dim3 grid2(cdiv((size_t)args.N * args.P / 4, kStateThreads), args.H, batch);
  err = launch_overlapped(ssd_chunked_state_kernel, grid2, kStateThreads, 0, stream, args);
  if (err != cudaSuccess) return err;
  if (args.nc > 0) {
    const dim3 grid3(args.H * cdiv(args.Q, kRows) * cdiv(args.P, kCols), args.nc, batch);
    err = launch_overlapped(ssd_chunked_output_kernel<T>, grid3, kOutThreads, smem3, stream, args);
  }
  return err;
}

}  // namespace

// bc_dtype: 0 = float32, 1 = bfloat16 (the type of B and C; everything else
// is float32).  s0 may be null for a zero initial state.  work is f32
// scratch of work_floats elements: batch * nc * (H N P + chunk^2 + H), nc =
// T / chunk (ops.py:workspace_floats).  Returns the cudaError_t of the
// launches (0 on success).  Shapes the kernel cannot take return
// cudaErrorInvalidValue without launching: chunk, P or N not a multiple of
// 4, T not a multiple of chunk, too little scratch, or tiles beyond one
// block's shared memory.
extern "C" int ssd_chunked(const void* x, const void* a, const void* B, const void* C,
                           const void* s0, void* y, void* s_out, void* work,
                           long long work_floats, int bc_dtype, int batch, int T, int H, int P,
                           int N, int chunk, void* stream) {
  if (chunk <= 0 || T < 0 || P <= 0 || N <= 0 || T % chunk != 0 || chunk % 4 != 0 ||
      P % 4 != 0 || N % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  const int nc = T / chunk;
  if (work_floats < 0 ||
      (size_t)work_floats < workspace_floats(batch, H, P, N, chunk, nc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* states = static_cast<float*>(work);
  float* cb = states + (size_t)batch * H * nc * N * P;
  float* dec = cb + (size_t)batch * nc * chunk * chunk;
  const Args args{static_cast<const float*>(x), static_cast<const float*>(a), B, C,
                  static_cast<const float*>(s0), static_cast<float*>(y),
                  static_cast<float*>(s_out), states, cb, dec, T, H, P, N, chunk, nc};
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

// Dynamic shared memory one block of a pass takes at these sizes, in bytes
// (ptxas reports only static shared memory): pass 0 = chunk, 1 = state,
// 2 = output; bc_dtype as for ssd_chunked.
extern "C" int ssd_chunked_smem_bytes(int pass, int bc_dtype, int P, int N, int chunk) {
  if (bc_dtype != 0 && bc_dtype != 1) return -1;
  const int es = bc_dtype == 0 ? 4 : 2;
  switch (pass) {
    case 0: return static_cast<int>(ChunkSmem(P, N, chunk, es).bytes());
    case 1: return 0;
    case 2: return static_cast<int>(OutSmem(N, chunk, es).bytes);
    default: return -1;
  }
}
