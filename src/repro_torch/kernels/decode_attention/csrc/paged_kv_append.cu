// Paged KV append for Hopper (sm_90a): each sequence's new K and V rows,
// written in place into the page that holds their position.
//
// Replaces src/repro/kernels/decode_attention/kernel.py:paged_kv_append_fwd
// (_kv_append_kernel; line numbers below are that file's).
// Called once per attention layer on every decode tick, through
// repro_torch/kernels/decode_attention/ops.py:paged_kv_append.
//
// Work: for sequence b, clamp p = pos[b] into [0, n_pages*page - 1], look
// up pid = page_table[b, p / page] (clamped into [0, P - 1]), and copy the
// [Hkv, D] rows k_new[b] and v_new[b] onto row p % page of pools
// k_pages[pid] and v_pages[pid].  Nothing else of the page is touched: the
// Pallas kernel copies the whole page first only because Mosaic output
// windows start undefined (kernel.py:289-296); a CUDA store writes just
// the bytes it names.
//
// Bound on the H100: bytes.  The kernel reads 2*B*Hkv*D*sizeof(T) and
// writes as many; there is no arithmetic.  Grid (B): one block per
// sequence copies its K row, then its V row, each thread moving 16 bytes
// per step when the row and both pointers are 16-byte aligned (true for a
// bf16 row with Hkv*D a multiple of 8 and an f32 row with Hkv*D a multiple
// of 4, since PyTorch allocations are 256-byte aligned), else single
// bytes.  At decode sizes the time is launch latency, not bandwidth.
//
// The copy is dtype-blind: the wrapper checks that the new rows and the
// pools share one dtype and passes the row size in bytes.
//
// Rows named twice: idle batcher slots keep all-zero page-table rows, so
// every idle slot resolves to scratch page 0, and two idle slots at one
// position name the same row.  The last sequence's row lands, as the TPU
// kernel's sequential grid and the reference's indexed update leave it: a
// block stores nothing when a later sequence names its row.  Page 0 is
// never handed to a live request, but an idle slot's attention reads it,
// and under MoE capacity drops an idle slot's token competes with the busy
// ones for expert capacity, so its row must not depend on which store
// lands first.
//
// Why clamp on the device: the indices come from device tensors, and a
// range check on the host would cost one device-to-host sync per layer
// per tick.  The serving batcher checks ranges on its host mirrors
// instead; the clamp only keeps a bad index inside the slot's own table
// row and inside the pool, as the reference wrapper's traced-value clamp
// does (src/repro/kernels/decode_attention/ops.py:201-208).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void copy_row(const char* __restrict__ src, char* __restrict__ dst,
                                         long long row_bytes) {
  const uintptr_t align = (uintptr_t)row_bytes | reinterpret_cast<uintptr_t>(src) |
                          reinterpret_cast<uintptr_t>(dst);
  if ((align & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (long long i = threadIdx.x; i < row_bytes / 16; i += kThreads) d4[i] = s4[i];
  } else {
    for (long long i = threadIdx.x; i < row_bytes; i += kThreads) dst[i] = src[i];
  }
}

// Sequence b's clamped position p and the clamped pool page pid it lands in.
__device__ __forceinline__ void target_row(int b, const int* __restrict__ page_table,
                                           const int* __restrict__ pos, int n_pages,
                                           int num_pages, int page_size, int* p_out,
                                           int* pid_out) {
  const int max_pos = n_pages * page_size - 1;
  int p = pos[b];
  p = p < 0 ? 0 : (p > max_pos ? max_pos : p);
  int pid = page_table[(long long)b * n_pages + p / page_size];
  *p_out = p;
  *pid_out = pid < 0 ? 0 : (pid > num_pages - 1 ? num_pages - 1 : pid);
}

__global__ void __launch_bounds__(kThreads) paged_kv_append_kernel(
    const char* __restrict__ k_new,   // [B, Hkv, D]
    const char* __restrict__ v_new,   // [B, Hkv, D]
    char* __restrict__ k_pages,       // [P, page, Hkv, D]
    char* __restrict__ v_pages,       // [P, page, Hkv, D]
    const int* __restrict__ page_table,  // [B, n_pages]
    const int* __restrict__ pos,         // [B]
    int n_pages, int num_pages, int page_size, long long row_bytes) {
  const int b = blockIdx.x;
  int p, pid;
  target_row(b, page_table, pos, n_pages, num_pages, page_size, &p, &pid);
  for (int later = b + 1; later < (int)gridDim.x; ++later) {  // the last writer wins
    int lp, lpid;
    target_row(later, page_table, pos, n_pages, num_pages, page_size, &lp, &lpid);
    if (lpid == pid && lp % page_size == p % page_size) return;
  }

  const long long src_off = (long long)b * row_bytes;
  const long long dst_off = ((long long)pid * page_size + p % page_size) * row_bytes;
  copy_row(k_new + src_off, k_pages + dst_off, row_bytes);
  copy_row(v_new + src_off, v_pages + dst_off, row_bytes);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_kv_append(const void* k_new, const void* v_new, void* k_pages,
                               void* v_pages, const void* page_table, const void* pos,
                               int batch, int n_pages, int num_pages, int page_size,
                               long long row_bytes, void* stream) {
  if (batch > 0) {
    paged_kv_append_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const char*>(k_new), static_cast<const char*>(v_new),
        static_cast<char*>(k_pages), static_cast<char*>(v_pages),
        static_cast<const int*>(page_table), static_cast<const int*>(pos), n_pages,
        num_pages, page_size, row_bytes);
  }
  return static_cast<int>(cudaGetLastError());
}
