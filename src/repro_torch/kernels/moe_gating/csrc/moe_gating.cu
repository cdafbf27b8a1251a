// Fused MoE gating (B5) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/moe_gating/kernel.py:moe_gating_fwd (line 90;
// _gating_kernel, pallas_call at kernel.py:103).  Called once per MoE layer
// on every prefill and decode step, through
// repro_torch/kernels/moe_gating/ops.py:moe_gating.
//
// Work: for router logits x [N, E] (f32), per token
//   p = exp(x - max x) / s,  s summed over e = 0 .. E-1 in order;
//   the top k of p by k rounds of "first maximum, then mask it" (a tie goes
//   to the lowest index, kernel.py:67-84);
//   gates = g / max(g_0 + ... + g_{k-1}, 1e-9);
//   pos = rank-major first-come-first-served place in the chosen expert's
//   capacity buffer within each block of block_n tokens, with per-expert
//   counters carried across blocks in order (kernel.py:70-79);
//   keep = pos < capacity.
// Outputs: idx [N, k] i32, gates [N, k] f32, pos [N, k] i32, keep [N, k]
// bool (one byte).  The arithmetic is the plain version's (ref.py) operation
// for operation: expf (not __expf), IEEE division, sums left to right, no
// multiply-add to contract.  So the probabilities, and with them the chosen
// experts, equal the plain version's on the card bit for bit, and the
// positions follow exactly.
//
// Bound on the H100: bytes, N * E * 4 read and N * k * 13 written: 64 KB
// and 53 KB at N = 2048, E = 8, k = 2, under 0.04 us at 3.35 TB/s; the
// operations (about 3 E k exp and divisions per token) are fewer still.  At
// every served shape the launch and one block's serial walk cost more than
// the bound, so the time is latency.  No single PyTorch call computes B5:
// softmax then topk leaves out the FCFS positions, and topk's order on ties
// is unspecified.
//
// Design: the TPU kernel runs its grid over token blocks in order and keeps
// the per-expert counters in VMEM scratch across grid steps (kernel.py:54-56),
// so FCFS positions fall out of the grid order.  Hopper runs blocks in no
// order, so one block (256 threads) does the whole call:
//   1. one thread per token (strided over N) computes the softmax and the
//      top k in registers, looping over E <= 128, and writes idx and gates;
//   2. the block then walks the logical blocks in order, within each the
//      ranks, within each rank tiles of 256 tokens.  In a tile, each warp
//      groups its lanes by expert (__match_any_sync): a lane's place among
//      the same expert's choices is the number of lower lanes in its group,
//      plus the counts of the lower warps (a per-warp histogram in shared
//      memory), plus the expert's running counter (shared memory).  The
//      tile's histogram is then added to the counters.
// Later speed work (ROADMAP A2): per-block, per-rank histograms over many
// blocks and a scan across them, so that N spreads over the SMs.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxExperts = 128;
constexpr int kMaxTopK = 8;

__global__ void __launch_bounds__(kThreads) moe_gating_kernel(
    const float* __restrict__ logits,  // [N, E]
    int32_t* idx,                      // [N, K], written in phase 1, read in phase 2
    float* __restrict__ gates,         // [N, K]
    int32_t* __restrict__ pos,         // [N, K]
    uint8_t* __restrict__ keep,        // [N, K]
    int N, int E, int K, int capacity, int block_n) {
  __shared__ int s_counts[kMaxExperts];         // running fill of each expert
  __shared__ int s_warp[kWarps * kMaxExperts];  // this tile's choices, by warp and expert
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // 1. Softmax and top k, one thread per token.
  for (int n = tid; n < N; n += kThreads) {
    const float* x = logits + (long long)n * E;
    float m = x[0];
    for (int e = 1; e < E; ++e) m = fmaxf(m, x[e]);
    float s = 0.f;
    for (int e = 0; e < E; ++e) s += expf(x[e] - m);
    int chosen[kMaxTopK];
    float g[kMaxTopK];
#pragma unroll
    for (int r = 0; r < kMaxTopK; ++r) {
      if (r >= K) break;
      float best = -CUDART_INF_F;
      int arg = 0;
      for (int e = 0; e < E; ++e) {
        bool taken = false;
#pragma unroll
        for (int j = 0; j < kMaxTopK; ++j) taken |= (j < r && chosen[j] == e);
        const float p = taken ? -CUDART_INF_F : expf(x[e] - m) / s;
        if (p > best) {  // strict: the first maximum wins
          best = p;
          arg = e;
        }
      }
      chosen[r] = arg;
      g[r] = best;
    }
    float denom = g[0];
#pragma unroll
    for (int r = 1; r < kMaxTopK; ++r)
      if (r < K) denom += g[r];
    denom = fmaxf(denom, 1e-9f);
#pragma unroll
    for (int r = 0; r < kMaxTopK; ++r) {
      if (r >= K) break;
      idx[(long long)n * K + r] = chosen[r];
      gates[(long long)n * K + r] = g[r] / denom;
    }
  }
  for (int e = tid; e < E; e += kThreads) s_counts[e] = 0;
  __syncthreads();  // idx (global) and the counters, visible to the whole block

  // 2. FCFS positions: blocks in order, ranks in order, tiles in order.
  for (int b0 = 0; b0 < N; b0 += block_n) {
    const int b1 = min(N, b0 + block_n);
    for (int r = 0; r < K; ++r) {
      for (int t0 = b0; t0 < b1; t0 += kThreads) {
        const int n = t0 + tid;
        const bool active = n < b1;
        const int a = active ? idx[(long long)n * K + r] : -1;
        for (int i = tid; i < kWarps * E; i += kThreads) s_warp[i] = 0;
        __syncthreads();
        const unsigned peers = __match_any_sync(0xffffffffu, a);
        const int rank = __popc(peers & ((1u << lane) - 1u));
        if (active && rank == 0) s_warp[warp * E + a] = __popc(peers);
        __syncthreads();
        if (active) {
          int p = s_counts[a] + rank;
          for (int w = 0; w < warp; ++w) p += s_warp[w * E + a];
          pos[(long long)n * K + r] = p;
          keep[(long long)n * K + r] = p < capacity ? 1 : 0;
        }
        __syncthreads();  // every read of the counters before they move
        for (int e = tid; e < E; e += kThreads) {
          int add = 0;
          for (int w = 0; w < kWarps; ++w) add += s_warp[w * E + e];
          s_counts[e] += add;
        }
        __syncthreads();  // the counters moved before the next tile reads them
      }
    }
  }
}

}  // namespace

// logits f32 [N, E], 1 <= E <= 128, 1 <= K <= min(E, 8), block_n >= 1.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int moe_gating(const void* logits, void* idx, void* gates, void* pos, void* keep,
                          int N, int E, int K, int capacity, int block_n, void* stream) {
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  if (E < 1 || E > kMaxExperts || K < 1 || K > E || K > kMaxTopK || block_n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  moe_gating_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<int32_t*>(idx),
      static_cast<float*>(gates), static_cast<int32_t*>(pos), static_cast<uint8_t*>(keep), N,
      E, K, capacity, block_n);
  return static_cast<int>(cudaGetLastError());
}
