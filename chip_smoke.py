#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and
check it.

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:
  build    compile every CUDA kernel of the port from its ``csrc/`` (one
           nvcc per source, all started together, so the build's time
           stays flat as kernels are added) and read the card's name
           and power limit from nvidia-smi.
  kernels  each kernel against its plain PyTorch version on the card at
           llama3.2-1b FULL widths (B=16, Hkv=8, G=4, D=64, page=16,
           ragged kv_len in 0..2048 with one zero), bf16 and f32, with and
           without a window; then bf16 CUDA-event times (median of 30 after
           warm-up, L2 flushed before each launch) beside the bound, the
           plain version and one library call, at those lengths and at the
           serving phase's (32..544 rows in a 64-page table).
  flash_kernels
           the flash attention kernel (B4: f32 on the CUDA cores, bf16 on
           the tensor cores) against its plain version at llama3.2-1b's
           heads (H=32, Hkv=8, D=64), B=2, f32 and bf16: T=S in {1, 32,
           200, 512, 2048} causal with window 0 and 128, a 64-row chunk at
           q_offset 256 of 320 keys, a case whose every row is masked
           (exactly 0), one non-causal case; bf16 with q scaled by 8
           (large scores); v all ones gives 1 to 1e-4 (f32) and 4e-3
           (bf16).  Then bf16 times at B=1 over the served prompt lengths
           and at T=2048, beside the bound, the plain version and
           scaled_dot_product_attention (SDPA), with 1 and 4 query heads a
           block; B4 must take at most 4x SDPA's time at T=2048 and on
           the served prompts' mean, and its TFLOP/s at T=2048 are read.
  dense_decode_kernels
           the dense decode kernel (B3) against its plain version, f32 and
           bf16, B=16, S in {1024, 1000}, kv_len ragged with 0, S and one
           value past S (held against the plain version at min(kv_len, S)),
           window 0 and 128, and against B2 on a paged copy of the cache;
           then bf16 times at the serving lengths.
  ssd_kernels
           the SSD scan kernel against its plain version at mamba2-370m
           FULL heads (H=32, P=64, N=128, chunk 64), B in {1, 4}, T=2048,
           B and C in bf16 and f32, with and without an initial state;
           then CUDA-event times of kernel and plain version beside the
           bound, at T=2048 and at the mamba_serve phase's prompt lengths.
  smoke    llama3.2-1b SMOKE at f32: prefill + ragged decode logits of the
           kernel path on the card against the plain path on the CPU, on a
           paged and on a linear cache, and the paged and dense batchers'
           tokens on the card against the CPU's.
  serve    the main path: llama3.2-1b FULL (16 layers, seeded random bf16
           weights) behind ContinuousBatcher(slots=16, max_len=1024,
           page 16) on 32 requests (prompts of 32-512 tokens, 32 new tokens
           each).  The launch counters are zeroed just before the run and
           read just after; B1 and B2 must each equal decode ticks x 16
           layers, B4 prefill calls x 16.  Then one decode step's logits,
           kernel path against plain path.
  profile  the same serving run again under torch.profiler: device time
           of each kernel, the decode kernel's HBM bandwidth, the device's
           busy share.
  dense_serve
           the same model and requests behind the dense
           ContinuousBatcher(slots=16, max_len=1024): B3 launches must
           equal decode ticks x 16, B4 prefill calls x 16, B1 and B2 none;
           the tokens against the serve phase's (a reading).
  dense_logits
           serve's one-step logit comparison on a linear cache (B3).
  prefill_logits
           FULL bf16 prefill logits at every position, B=1, prompts of 512
           and 200 tokens, kernel path (B4) against plain path.
  mamba_smoke
           mamba2-370m SMOKE at f32: prefill + decode logits of the kernel
           path on the card against the plain path on the CPU, and the
           dense batcher's tokens on the card against the CPU's.
  mamba_serve
           the mamba2 main path: mamba2-370m FULL (48 layers, seeded
           random bf16 weights, f32 dt_bias/A_log/D) behind the dense
           ContinuousBatcher(slots=16, max_len=1024) on 32 requests
           (prompts of 32-512 tokens, 32 new tokens each).  The scan's
           launch counter is zeroed just before the run and read just
           after; it must equal admissions x 48 layers.
  mamba_logits
           kernel path against plain path over 2048 prompt positions:
           FULL f32 (48 layers), FULL-width bf16 at 2 layers, and FULL
           bf16 at 48 layers against the spread between two valid plain
           paths (chunk 64 and chunk 32), each held to its gate.
  mamba_profile
           the mamba_serve run again under torch.profiler.
  tcmm_kernels
           the TCMM assignment kernel (B7) against its plain version, f32
           and bf16, points and centroids N(0,1)*3: the reference test's
           four (N, M, F, n_valid) cases, the bench shape (4096, 512, 4,
           512) and the main path's (1, 512, 4) with 512, 300 and 0 valid
           rows.  Indices and d2 must be equal bit for bit (both sum in one
           fixed order); 64 copies of centroid 7 map to 7.  Then CUDA-event
           times at (4096, 512, 4) and (1, 512, 4) beside the bound, the
           plain version and a library yardstick (cdist, then a masked min),
           with L2 flushed and, for the kernel, warm as the pipeline meets it.
  tcmm_pipeline
           the TCMM main path: examples/quickstart.py's pipeline at
           T-Drive's taxi count (TrajectorySource(num_taxis=10357), 20,000
           points, 3 partitions each way, TCMMConfig() defaults: M=512,
           threshold 2.0, k=8, macro period 256), micro ReactiveJob of 4
           tasks (jsq) with task 0 killed past a third, macro ReactiveJob of
           2 tasks.  Run on the card (kernel path; B7's counter zeroed just
           before and read just after: one launch per point but the first)
           and again on the CPU (plain path, no launch); every point
           processed once, a restart, the same events and bit-equal state
           on both, the k-means objective of every macro run within 1e-4.
           Then the card run again on its first 2,000 points under
           torch.profiler: device time by kernel, the host's largest
           entries, and the device's share of the card run's wall.
  mixtral_attention_kernels
           B1, B2, B3 and B4 at mixtral-8x7b's heads (H=32, Hkv=8, D=128)
           against their plain versions, f32 and bf16, under TOL (B4 at T
           in {32, 512, 2048}, windows 0 and 128, and bf16 with q scaled by
           8); bf16 times of B1, B2 and B4 at the serving lengths; B4 at
           most 4x SDPA's time at T=2048.
  mixtral_smoke
           mixtral-8x7b SMOKE at f32 (window 16, 4 experts, top 2), dropless
           and at capacity factor 1.25: prefill + ragged decode logits of
           the kernel path on the card against the plain path on the CPU
           (1e-4), and the paged batcher's tokens on 20-40-token prompts
           with a pool tight enough to preempt, equal on both.
  mixtral_logits_f32
           FULL width, 2 layers, f32: a B=1 prefill of 512 tokens and one
           paged decode step over 16 slots, kernel path against plain path
           on the card: max|diff| <= 1e-3 rms(plain), every greedy token
           equal, and every B5 call's idx, pos and keep equal.
  mixtral_serve
           the MoE main path: mixtral-8x7b FULL width cut to 16 of 32
           layers (random bf16 weights, f32 router) behind the paged
           ContinuousBatcher as in serve, on the same 32 requests.  B5
           must equal (ticks + prefill calls) x 16 launches, B1 and B2
           ticks x 16, B4 prefill calls x 16; dropped expert choices per
           tick and the weight bytes a tick reads over its time.
  mixtral_profile
           the same run under torch.profiler: device busy share, B5's
           share of device time and ms per call.
  moe_kernels
           B5 against its plain version: N in {16, 512, 2048}, E=8, k=2,
           at capacity 1.25 and dropless, block_n in {N, 256, 64}; E=16
           k=2; E=128 k=1; ties; the router logits mixtral_serve gave B5
           in its first prefill and first four decode ticks.  idx, pos and
           keep exactly equal, gates to rtol 1e-5 / atol 1e-6; then times
           at the main path's shapes.
  mixtral_logits
           the served weights (bf16, 16 layers): the prefill and decode
           comparison of mixtral_logits_f32; greedy tokens equal wherever
           the plain top-two margin exceeds 2 max|diff|; the rest readings.
Then the per-kernel JSON line, the nvidia-smi line, and the result line.
Exits non-zero, printing no result, without a CUDA device; any failed
check raises.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.apps import tcmm  # noqa: E402
from repro_torch.config import get_arch  # noqa: E402
from repro_torch.configs.tcmm import TCMMConfig  # noqa: E402
from repro_torch.core.reactive import ReactiveJob  # noqa: E402
from repro_torch.data.sources import TrajectorySource  # noqa: E402
from repro_torch.data.topics import MessageLog  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    build,
    flash_attention,
    moe_gating,
    ssd_scan,
    tcmm_assign,
)
from repro_torch.kernels.decode_attention import ops, ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import PagedSpec  # noqa: E402
from repro_torch.serving import ContinuousBatcher, Request  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Both sides of a decode-attention comparison compute in f32 and round
# the output to the input dtype once.  f32: summation order only.  bf16:
# the two f32 values may round to neighbouring bf16 numbers, one ulp
# apart, which is at most 2**-7 of the value; rtol allows two such ulps,
# atol covers outputs near zero (measured max error 2.4e-4..4.9e-4 at
# kv_len 0..2048, where outputs are ~0.04).
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=1.6e-2, atol=2e-3)}
# FULL decode step in bf16, kernel path against plain path, as fractions
# of the plain logits' RMS.  The plain path rounds the softmax weights to
# bf16 before the value product, as the reference does; the decode kernels
# (B2, B3) keep them in f32 and B4 carries them as two bf16 terms (about
# 16 bits).  That difference, carried through 16 layers, read 0.086 (max)
# and 0.0157 (RMS) of the RMS with seed 0; the limits are about 2x.
LOGIT_TOL = dict(max_abs=0.2, rms=0.03)
# B2 and B3 bf16 on the main path (D = 64, and B2 at D = 128) may take at
# most the time of one SDPA call computing the same function, read in the
# same run: no slower than the library.
DECODE_SPEED_GATE = 1.0
KERNELS = {
    "paged_kv_append": dict(
        source="src/repro_torch/kernels/decode_attention/csrc/paged_kv_append.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:302",
        signature=ops.SIGNATURES["paged_kv_append"]),
    "paged_decode_attention": dict(
        source="src/repro_torch/kernels/decode_attention/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:209",
        signature=ops.SIGNATURES["paged_decode_attention"]),
    "decode_attention": dict(
        source="src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:95",
        signature=ops.SIGNATURES["decode_attention"]),
    "flash_attention": dict(
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:99",
        signature=flash_attention.ops.SIGNATURES["flash_attention"]),
    "ssd_chunked": dict(
        source="src/repro_torch/kernels/ssd_scan/csrc/ssd_chunked.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:88",
        signature=ssd_scan.ops.SIGNATURES["ssd_chunked"]),
    "tcmm_assign": dict(
        source="src/repro_torch/kernels/tcmm_assign/csrc/tcmm_assign.cu",
        replaces="src/repro/kernels/tcmm_assign/kernel.py:52",
        signature=tcmm_assign.ops.SIGNATURES["tcmm_assign"]),
    "moe_gating": dict(
        source="src/repro_torch/kernels/moe_gating/csrc/moe_gating.cu",
        replaces="src/repro/kernels/moe_gating/kernel.py:90",
        signature=moe_gating.ops.SIGNATURES["moe_gating"]),
}
LLAMA_KERNELS = ("paged_kv_append", "paged_decode_attention")
LAYERS = 16
MAMBA_LAYERS = 48


def reset_launches() -> None:
    ops.reset_launches()
    flash_attention.reset_launches()
    ssd_scan.reset_launches()
    tcmm_assign.reset_launches()
    moe_gating.reset_launches()


def read_launches() -> dict:
    return {**ops.LAUNCHES, **flash_attention.LAUNCHES, **ssd_scan.LAUNCHES,
            **tcmm_assign.LAUNCHES, **moe_gating.LAUNCHES}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, flush, reps: int = 30, warmup: int = 5) -> float:
    """Median CUDA-event time of ``fn``, with the L2 cache flushed before
    each launch (the decode loop meets each layer's pages cold), or, with
    ``flush=None``, left warm.  Either way the device is busy (flushing, or
    a spin of about 1 ms) while the host enqueues ``fn``, so its wrapper's
    Python and allocations stay out of the measured interval."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        if flush is None:
            torch.cuda._sleep(2_000_000)
        else:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- phase 1 -----------------------------------------------------------------


def phase_build() -> tuple:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build.sources())) as pool:
        reports = {}
        for r in pool.map(lambda name: build.build_all([name]), build.sources()):
            reports.update(r)
    build_s = time.perf_counter() - t0
    for name, meta in KERNELS.items():
        build.load(name, meta["signature"])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    ptxas = {n: [ln.strip() for ln in r.splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
             for n, r in reports.items()}
    emit("build", seconds=build_s, nvidia_smi=smi, ptxas=ptxas,
         device=torch.cuda.get_device_name(0), torch=torch.__version__,
         cuda=torch.version.cuda)
    return smi, ptxas


# --- phase 2 -----------------------------------------------------------------


def decode_inputs(dtype, seed: int, dev, n_pages: int, kv_len: np.ndarray, d: int = 64):
    """llama3.2-1b FULL attention widths: B=16, Hkv=8, G=4, D=64 (mixtral-8x7b
    FULL: D=128), page 16; each sequence owns n_pages shuffled pages, and
    one with kv_len 0 keeps an all-zero table row, as an idle batcher slot
    does."""
    b, hkv, g, page = 16, 8, 4, 16
    gen = torch.Generator(device=dev).manual_seed(seed)
    pool = (1 + b * n_pages, page, hkv, d)
    q = torch.randn((b, hkv * g, d), generator=gen, device=dev).to(dtype)
    kp = torch.randn(pool, generator=gen, device=dev).to(dtype)
    vp = torch.randn(pool, generator=gen, device=dev).to(dtype)
    rng = np.random.default_rng(seed)
    table = (1 + rng.permutation(b * n_pages)).reshape(b, n_pages).astype(np.int32)
    table[kv_len == 0] = 0
    return (q, kp, vp, torch.tensor(table, device=dev),
            torch.tensor(kv_len.astype(np.int32), device=dev))


def model_q_pos(kv_len: np.ndarray, dev) -> torch.Tensor:
    """Query positions as the model passes them with kv_len = cache pos + 1:
    kv_len - 1 for a busy slot.  Rows 2-4 are idle slots, whose batcher
    position (0 after a preemption, else their last request's) is not
    their running cache position: 0, half of kv_len, and 300 past
    kv_len - 1, which with a window of 256 or less leaves no key, so the
    row attends uniformly to every row; row 0 (kv_len 0) has no key
    either."""
    qp = np.maximum(kv_len.astype(np.int64) - 1, 0)
    qp[2], qp[3], qp[4] = 0, kv_len[3] // 2, kv_len[4] - 1 + 300
    return torch.tensor(qp.astype(np.int32), device=dev)


def append_inputs(dtype, seed: int, dev, n_pages: int, kv_len: np.ndarray, d: int = 64):
    _, kp, vp, table, lens = decode_inputs(dtype, seed, dev, n_pages, kv_len, d)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    b, hkv, d = lens.shape[0], kp.shape[2], kp.shape[3]
    k_new = torch.randn((b, hkv, d), generator=gen, device=dev).to(dtype)
    v_new = torch.randn((b, hkv, d), generator=gen, device=dev).to(dtype)
    pos = lens.clamp(max=n_pages * kp.shape[1] - 1)  # write where the next token goes
    return k_new, v_new, kp, vp, table, pos


def check_parity(dev, seed: int, kv_len: np.ndarray, d: int = 64) -> list:
    """Each kernel against its plain version, bf16 and f32; raises on a
    difference beyond TOL (decode) or any difference (append).  B2 runs
    without q_pos (the query at kv_len - 1) and with the model's q_pos,
    idle rows included (``model_q_pos``)."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        q, kp, vp, table, lens = decode_inputs(dtype, seed, dev, 128, kv_len, d)
        for q_pos in (None, model_q_pos(kv_len, dev)):
            for window in (0, 256):
                out = ops.paged_decode_attention(q, kp, vp, table, lens, window=window,
                                                 q_pos=q_pos)
                plain = ref.paged_decode_attention_ref(q, kp, vp, table, lens, window=window,
                                                       q_pos=q_pos)
                torch.cuda.synchronize()
                torch.testing.assert_close(out.float(), plain.float(), **TOL[dtype])
                if q_pos is None and not torch.all(out[kv_len == 0] == 0):
                    raise AssertionError("kv_len == 0 must give exactly zero")
                err = out.float() - plain.float()
                cases.append(dict(kernel="paged_decode_attention", dtype=str(dtype),
                                  window=window, q_pos="none" if q_pos is None else "model",
                                  max_abs_err=err.abs().max().item(),
                                  rms_err_over_rms=(err.pow(2).mean()
                                                    / plain.float().pow(2).mean()).sqrt().item()))
        k_new, v_new, kp, vp, table, pos = append_inputs(dtype, seed + 1, dev, 128, kv_len, d)
        got = ops.paged_kv_append(k_new, v_new, kp.clone(), vp.clone(), table, pos)
        want = ref.paged_kv_append_ref(k_new, v_new, kp.clone(), vp.clone(), table, pos)
        torch.cuda.synchronize()
        # page 0 is scratch: idle slots may race on it, so it is never compared
        err = max((g[1:].float() - w[1:].float()).abs().max().item()
                  for g, w in zip(got, want))
        if err != 0.0:
            raise AssertionError(f"paged_kv_append differs from its plain version: {err}")
        cases.append(dict(kernel="paged_kv_append", dtype=str(dtype), max_abs_err=err))
    return cases


def time_kernels(dev, seed: int, n_pages: int, kv_len: np.ndarray, flush, d: int = 64) -> dict:
    """bf16 times of each kernel, its plain version and one library call,
    with the bound computed from these inputs.  Where every kv_len is
    positive, B2 takes q_pos = kv_len - 1, as the model passes it for busy
    slots; a kv_len 0 row with q_pos would attend to every row, which the
    bound does not count, so such inputs run without q_pos."""
    dtype, rows = torch.bfloat16, {}
    q, kp, vp, table, lens = decode_inputs(dtype, seed, dev, n_pages, kv_len, d)
    qp = lens - 1 if (kv_len > 0).all() else None
    b, h, d = q.shape
    hkv, page = kp.shape[2], kp.shape[1]
    rows_kv = kv_len.astype(np.int64)
    es = q.element_size()
    # K and V rows of every sequence once, q in, out back, kv_len and the
    # table entries the rows need
    n_bytes = (2 * rows_kv.sum() * hkv * d * es + 2 * q.numel() * es
               + 4 * b + 4 * np.ceil(rows_kv / page).sum())
    bnd, by = bound_ms(n_bytes, 4 * rows_kv.sum() * h * d, dtype)
    # library yardstick: SDPA over the gathered dense view, K/V expanded to
    # every query head and the mask built outside the timed call
    s = n_pages * page
    kd = ref.gather_pages(kp, table).permute(0, 2, 1, 3).repeat_interleave(h // hkv, 1)
    vd = ref.gather_pages(vp, table).permute(0, 2, 1, 3).repeat_interleave(h // hkv, 1)
    mask = (torch.arange(s, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows["paged_decode_attention"] = with_ratios(dict(
        kernel_ms=time_ms(lambda: ops.paged_decode_attention(q, kp, vp, table, lens, q_pos=qp),
                          flush),
        plain_ms=time_ms(lambda: ref.paged_decode_attention_ref(q, kp, vp, table, lens,
                                                                q_pos=qp), flush),
        library_ms=time_ms(lambda: sdpa(q4, kd, vd, attn_mask=mask), flush),
        bound_ms=bnd, bound_by=by, bytes=int(n_bytes)))
    del kd, vd

    k_new, v_new, kp, vp, table, pos = append_inputs(dtype, seed + 1, dev, n_pages, kv_len, d)
    n_bytes = 2 * 2 * k_new.numel() * es + 4 * b * 2  # K and V rows read + written; pos, table
    bnd, by = bound_ms(n_bytes, 0, dtype)
    flat_k, flat_v = kp.view(-1, hkv, d), vp.view(-1, hkv, d)
    flat_idx = (table.long()[torch.arange(b, device=dev), pos.long() // page] * page
                + pos.long() % page)

    def library():
        flat_k.index_copy_(0, flat_idx, k_new)
        flat_v.index_copy_(0, flat_idx, v_new)

    rows["paged_kv_append"] = dict(
        kernel_ms=time_ms(lambda: ops.paged_kv_append(k_new, v_new, kp, vp, table, pos),
                          flush),
        plain_ms=time_ms(lambda: ref.paged_kv_append_ref(k_new, v_new, kp, vp, table, pos),
                         flush),
        library_ms=time_ms(library, flush), bound_ms=bnd, bound_by=by, bytes=int(n_bytes))
    return rows


def with_ratios(row: dict) -> dict:
    """A decode timing row with over_sdpa (kernel over library time, the
    speed gate's reading) and bound_over_kernel (the share of the bound
    the kernel reaches)."""
    return dict(row, over_sdpa=row["kernel_ms"] / row["library_ms"],
                bound_over_kernel=row["bound_ms"] / row["kernel_ms"])


def check_decode_speed(name: str, row: dict, where: str) -> None:
    if row["over_sdpa"] > DECODE_SPEED_GATE:
        raise AssertionError(f"{name} bf16 at {where} slower than {DECODE_SPEED_GATE}x SDPA: "
                             f"{row['kernel_ms']} ms against {row['library_ms']} ms")


def phase_kernels(dev, seed: int, flush: torch.Tensor) -> dict:
    rng = np.random.default_rng(seed)
    # ragged kv_len in 0..2048: one empty slot, one full (128 pages of 16)
    wide = rng.integers(1, 2049, size=16)
    wide[0], wide[1] = 0, 2048
    # the serving phase's lengths: prompts of 32..512 plus up to 32 new tokens,
    # in a table of 64 pages (max_len 1024)
    served = rng.integers(32, 513, size=16) + rng.integers(0, 33, size=16)
    cases = check_parity(dev, seed, wide)
    timings = {"kv_len_0_2048": time_kernels(dev, seed, 128, wide, flush),
               "main_path": time_kernels(dev, seed, 64, served, flush)}
    emit("kernels", cases=cases, timings=timings,
         gate=f"B2 bf16 kernel_ms <= {DECODE_SPEED_GATE} x library_ms on the main path",
         note="bf16 times in ms (CUDA events, median of 30, L2 flushed) at B=16 Hkv=8 G=4 "
              "D=64 page=16, B2 at the main path's lengths with q_pos = kv_len - 1; "
              "library: SDPA over the pre-gathered dense view / two index_copy_ calls; "
              "over_sdpa = kernel_ms / library_ms, bound_over_kernel = bound_ms / kernel_ms")
    rows = timings["main_path"]
    check_decode_speed("B2", rows["paged_decode_attention"], "D=64, the main path")
    for name in LLAMA_KERNELS:
        rows[name]["max_abs_err"] = max(c["max_abs_err"] for c in cases
                                        if c["kernel"] == name and c["dtype"] == "torch.bfloat16")
    return rows


# --- B4 and B3: flash_kernels, dense_decode_kernels ------------------------------

LLAMA_HEADS = dict(h=32, hkv=8, d=64)  # llama3.2-1b FULL
SDPA = torch.nn.functional.scaled_dot_product_attention  # timed as a yardstick only
# (T, S, causal, window, q_offset): T = S causal with and without a window,
# a chunk at an offset, one whose every row is masked (output exactly 0),
# and one non-causal case
FLASH_CASES = ([(t, t, True, w, 0) for t in (1, 32, 200, 512, 2048) for w in (0, 128)]
               + [(64, 320, True, 0, 256), (16, 64, True, 32, 128), (200, 200, False, 0, 0)])
# the most B4's bf16 time may be, as a multiple of SDPA's read in the same run
FLASH_SPEED_GATE = 4.0
# |out - 1| with v all ones: f32 sums only; in bf16 the output may round
# to 1's lower neighbour (2**-8 = 3.9e-3 below it) and no further
ONES_TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-3}


def flash_inputs(seed: int, b: int, t: int, s: int, dev, dtype, ones_v: bool = False,
                 heads: dict = LLAMA_HEADS, q_scale: float = 1.0):
    h, hkv, d = heads["h"], heads["hkv"], heads["d"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((b, t, h, d), generator=gen, device=dev) * q_scale).to(dtype)
    k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
    v = (torch.ones((b, s, hkv, d), device=dev, dtype=dtype) if ones_v else
         torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype))
    return q, k, v


def kept_pairs(t: int, s: int, causal: bool, window: int, q_offset: int) -> int:
    """(query row, key) pairs the masks keep: the work B4 must do."""
    qpos = q_offset + np.arange(t, dtype=np.int64)
    hi = np.minimum(s - 1, qpos) if causal else np.full(t, s - 1)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else np.zeros(t, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_work(b: int, t: int, s: int, causal: bool, window: int, q_offset: int,
               elem: int, heads: dict = LLAMA_HEADS) -> tuple:
    """(bytes, operations) of one B4 call: q and out, k and v once each;
    two products (4 operations) of length D per query head and kept pair."""
    h, hkv, d = heads["h"], heads["hkv"], heads["d"]
    n_bytes = b * (2 * t * h * d + 2 * s * hkv * d) * elem
    return n_bytes, b * 4 * d * h * kept_pairs(t, s, causal, window, q_offset)


def flash_case(dev, seed: int, b: int, t: int, s: int, causal: bool, window: int,
               q_offset: int, dtype, heads: dict = LLAMA_HEADS, q_scale: float = 1.0) -> dict:
    """One B4 call against its plain version on the same inputs."""
    q, k, v = flash_inputs(seed, b, t, s, dev, dtype, heads=heads, q_scale=q_scale)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = flash_attention.flash_attention(q, k, v, **kw)
    plain = flash_attention.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    case = dict(dtype=str(dtype), t=t, s=s, causal=causal, window=window, q_offset=q_offset,
                q_scale=q_scale, max_abs_err=(out.float() - plain.float()).abs().max().item(),
                within_tol=bool(torch.allclose(out.float(), plain.float(), **TOL[dtype])))
    if kept_pairs(t, s, causal, window, q_offset) == 0:
        case["exactly_zero"] = bool((out == 0).all())
    return case


def ones_case(dev, seed: int, t: int, window: int, dtype, heads: dict = LLAMA_HEADS) -> dict:
    q, k, v = flash_inputs(seed, 1, t, t, dev, dtype, ones_v=True, heads=heads)
    out = flash_attention.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    err = (out.float() - 1).abs().max().item()
    return dict(dtype=str(dtype), t=t, window=window, max_abs_out_minus_1=err,
                within=err <= ONES_TOL[dtype])


def flash_speed(timings: dict, heads: dict) -> dict:
    """B4's bf16 time over SDPA's at T = 2048 and on the served prompts'
    mean per launch, and both TFLOP/s at T = 2048."""
    t2048, main = timings["t2048"], timings["main_path_per_launch"]
    ops_2048 = flash_work(1, 2048, 2048, True, 0, 0, 2, heads)[1]
    return dict(over_sdpa_t2048=t2048["kernel_ms"] / t2048["library_ms"],
                over_sdpa_main_path=main["kernel_ms"] / main["library_ms"],
                tflops_t2048=ops_2048 / t2048["kernel_ms"] / 1e9,
                sdpa_tflops_t2048=ops_2048 / t2048["library_ms"] / 1e9)


def phase_flash_kernels(dev, seed: int, flush: torch.Tensor) -> dict:
    """B4 against its plain version at llama3.2-1b's heads (B = 2), f32 and
    bf16; then bf16 times at B = 1, causal, q_offset 0, at every served
    prompt length and at T = 2048, held to FLASH_SPEED_GATE x SDPA."""
    cases = [flash_case(dev, seed, 2, *c, dtype) for dtype in (torch.float32, torch.bfloat16)
             for c in FLASH_CASES]
    cases += [flash_case(dev, seed, 2, t, t, True, w, 0, torch.bfloat16, q_scale=8.0)
              for t, w in ((512, 0), (2048, 128))]
    ones = [ones_case(dev, seed + 1, t, w, dtype) for dtype in (torch.float32, torch.bfloat16)
            for t, w in ((512, 0), (2048, 128))]
    bad = ([c for c in cases if not c["within_tol"] or c.get("exactly_zero") is False]
           + [o for o in ones if not o["within"]])
    timings = flash_timings(seed, dev, flush, LLAMA_HEADS)
    speed = flash_speed(timings, LLAMA_HEADS)
    main_path = timings["main_path_per_launch"]
    emit("flash_kernels", cases=cases, v_all_ones=ones, timing=timings, speed=speed,
         tol="f32 rtol=atol=1e-5; bf16 rtol 1.6e-2, atol 2e-3; v all ones: |out - 1| <= "
             "1e-4 (f32), 4e-3 (bf16); rows with no kept key exactly 0; bf16 kernel_ms <= "
             f"{FLASH_SPEED_GATE} x library_ms at T=2048 and on the main path's mean",
         note="ms: CUDA events, median of 30, L2 flushed; B=1, H=32, Hkv=8, D=64, bf16, "
              "causal, q_offset 0; main_path: mean per launch over the 32 served prompt "
              "lengths; bound: max(bytes at 3.35 TB/s, 4*D*H*kept pairs at 989 "
              "TFLOP/s); library: scaled_dot_product_attention(is_causal=True, "
              "enable_gqa=True) on [B, H, T, D] copies; tflops: 4*D*H*kept pairs over ms")
    if bad:
        raise AssertionError(f"flash_attention differs from its plain version: {bad}")
    check_flash_speed(speed, "llama heads")
    return dict(**{k: main_path[k] for k in ("kernel_ms", "plain_ms", "library_ms",
                                             "bound_ms", "bound_by")},
                max_abs_err=max(c["max_abs_err"] for c in cases
                                if c["dtype"] == "torch.bfloat16"))


def check_flash_speed(speed: dict, where: str, keys=("over_sdpa_t2048", "over_sdpa_main_path")):
    slow = {k: speed[k] for k in keys if speed[k] > FLASH_SPEED_GATE}
    if slow:
        raise AssertionError(f"B4 bf16 at {where} slower than {FLASH_SPEED_GATE}x SDPA: {slow}")


def flash_timing(seed: int, t: int, dev, flush, heads: dict) -> dict:
    """bf16 times of B4, its plain version and SDPA at B = 1, causal, T = S."""
    q, k, v = flash_inputs(seed + 2, 1, t, t, dev, torch.bfloat16, heads=heads)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # SDPA's layout
    bnd, by = bound_ms(*flash_work(1, t, t, True, 0, 0, 2, heads), torch.bfloat16)
    return dict(
        kernel_ms=time_ms(lambda: flash_attention.flash_attention(q, k, v), flush),
        plain_ms=time_ms(lambda: flash_attention.attention_ref(q, k, v), flush),
        library_ms=time_ms(lambda: SDPA(qt, kt, vt, is_causal=True, enable_gqa=True), flush),
        bound_ms=bnd, bound_by=by)


def flash_timings(seed: int, dev, flush, heads: dict) -> dict:
    """B4 timed at every served prompt length (and their mean per launch,
    the main path's) and at T = 2048."""
    lens = prompt_lengths(seed)
    per_t = {int(t): flash_timing(seed, int(t), dev, flush, heads)
             for t in sorted(set(lens.tolist()))}
    weights = [int((lens == t).sum()) for t in per_t]
    main_path = {key: sum(w * r[key] for w, r in zip(weights, per_t.values())) / sum(weights)
                 for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    share = {by: sum(w * r["bound_ms"] for w, r in zip(weights, per_t.values())
                     if r["bound_by"] == by) for by in ("bytes", "operations")}
    main_path["bound_by"] = max(share, key=share.get)
    return {"main_path_per_launch": main_path, "t2048": flash_timing(seed, 2048, dev, flush, heads),
            "main_path_by_t": {str(t): r for t, r in per_t.items()}}


def dense_decode_inputs(dtype, seed: int, dev, s: int, kv_len: np.ndarray,
                        heads: dict = LLAMA_HEADS):
    """q [16, H, D] and a linear cache [16, S, Hkv, D], N(0, 1)."""
    h, hkv, d = heads["h"], heads["hkv"], heads["d"]
    b = len(kv_len)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
    kc = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
    vc = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype)
    return q, kc, vc, torch.tensor(kv_len.astype(np.int32), device=dev)


def as_pages(cache: torch.Tensor, page: int = 16):
    """A dense cache [B, S, Hkv, D] as a pool of pages behind a table:
    sequence b's pages are 1 + b*n .. b*n + n (page 0 the scratch page)."""
    b, s = cache.shape[:2]
    n = s // page
    pool = torch.cat([cache.new_zeros((1, page) + cache.shape[2:]),
                      cache.reshape((b * n, page) + cache.shape[2:])])
    table = (1 + torch.arange(b * n, device=cache.device, dtype=torch.int32)).reshape(b, n)
    return pool, table


def phase_dense_decode_kernels(dev, seed: int, flush: torch.Tensor) -> dict:
    """B3 against its plain version (at min(kv_len, S), as the kernel
    clamps) and against B2 over a paged copy of the same cache, at
    B = 16 and llama3.2-1b's heads; then bf16 times at the serving
    lengths."""
    rng = np.random.default_rng(seed + 5)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for s in (1024, 1000):
            kv_len = rng.integers(1, s + 1, size=16)
            kv_len[:3] = (0, s, s + 9)  # empty, full, past the cache
            q, kc, vc, lens = dense_decode_inputs(dtype, seed, dev, s, kv_len)
            for q_pos, window in ((qp, w) for qp in (None, model_q_pos(kv_len, dev))
                                  for w in (0, 128)):
                out = ops.decode_attention(q, kc, vc, lens, window=window, q_pos=q_pos)
                plain = ref.decode_attention_ref(q, kc, vc, lens.clamp(max=s), window=window,
                                                 q_pos=q_pos)
                torch.cuda.synchronize()
                case = dict(dtype=str(dtype), s=s, window=window,
                            q_pos="none" if q_pos is None else "model",
                            max_abs_err=(out.float() - plain.float()).abs().max().item(),
                            within_tol=bool(torch.allclose(out.float(), plain.float(),
                                                           **TOL[dtype])),
                            kv_len_0_exactly_zero=q_pos is not None or bool((out[0] == 0).all()))
                if s % 16 == 0:
                    kp, table = as_pages(kc)
                    vp, _ = as_pages(vc)
                    paged = ops.paged_decode_attention(q, kp, vp, table, lens, window=window,
                                                       q_pos=q_pos)
                    torch.cuda.synchronize()
                    case["max_abs_diff_vs_paged_b2"] = (out.float() - paged.float()).abs().max().item()
                    case["within_tol_vs_paged_b2"] = bool(torch.allclose(
                        out.float(), paged.float(), **TOL[dtype]))
                    case["bit_equal_to_paged_b2"] = bool(torch.equal(out, paged))  # a reading
                cases.append(case)
    bad = [c for c in cases if not c["within_tol"] or not c["kv_len_0_exactly_zero"]
           or c.get("within_tol_vs_paged_b2") is False]

    # timing: the serving phases' lengths (prompts of 32..512 plus up to 32
    # new tokens) in a 1024-row cache, bf16
    served = rng.integers(32, 513, size=16) + rng.integers(0, 33, size=16)
    row = time_dense_decode(dev, seed, served, flush)
    emit("dense_decode_kernels", cases=cases, timing={"main_path": row},
         tol="TOL (f32 rtol=atol=1e-5; bf16 rtol 1.6e-2, atol 2e-3), against the plain "
             "version and against B2 on a paged copy; kv_len 0 rows exactly 0 without "
             "q_pos; with the model's q_pos, idle rows 2-4 (model_q_pos); "
             f"bf16 kernel_ms <= {DECODE_SPEED_GATE} x library_ms on the main path",
         note="ms: CUDA events, median of 30, L2 flushed; B=16, S=1024, H=32, Hkv=8, D=64, "
              "bf16, kv_len 32..544, q_pos = kv_len - 1; bound: bytes of the rows below kv_len, q and out at "
              "3.35 TB/s; library: scaled_dot_product_attention with a boolean mask from "
              "kv_len and enable_gqa=True on [B, Hkv, S, D] copies; bit_equal_to_paged_b2 "
              "is a reading")
    if bad:
        raise AssertionError(f"decode_attention differs from its plain version or B2: {bad}")
    check_decode_speed("B3", row, "D=64, the main path")
    return dict(**{k: row[k] for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                       "bound_by")},
                max_abs_err=max(c["max_abs_err"] for c in cases
                                if c["dtype"] == "torch.bfloat16"))


def time_dense_decode(dev, seed: int, served: np.ndarray, flush,
                      heads: dict = LLAMA_HEADS) -> dict:
    """bf16 times of B3, its plain version and masked SDPA at the served
    lengths in a 1024-row cache, q_pos = kv_len - 1 (busy slots, as the
    model passes them), with the bound from these inputs."""
    q, kc, vc, lens = dense_decode_inputs(torch.bfloat16, seed + 1, dev, 1024, served, heads)
    qp = lens - 1
    b, h, d = q.shape
    hkv = kc.shape[2]
    rows = served.astype(np.int64).sum()
    n_bytes = 2 * rows * hkv * d * 2 + 2 * q.numel() * 2 + 4 * b
    bnd, by = bound_ms(n_bytes, 4 * rows * h * d, torch.bfloat16)
    q4 = q[:, :, None, :]
    kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()  # SDPA's layout
    mask = (torch.arange(1024, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    return with_ratios(dict(
        kernel_ms=time_ms(lambda: ops.decode_attention(q, kc, vc, lens, q_pos=qp), flush),
        plain_ms=time_ms(lambda: ref.decode_attention_ref(q, kc, vc, lens, q_pos=qp), flush),
        library_ms=time_ms(lambda: SDPA(q4, kt, vt, attn_mask=mask, enable_gqa=True), flush),
        bound_ms=bnd, bound_by=by, bytes=int(n_bytes)))


# --- phase 3 -----------------------------------------------------------------


def phase_smoke(dev, seed: int) -> None:
    cfg = get_arch("llama3.2-1b", smoke=True)
    on_card = build_model(cfg, compute_dtype=torch.float32, device=dev)
    on_cpu = build_model(cfg, compute_dtype=torch.float32, device="cpu", use_kernels=False)
    p_card = on_card.init(torch.Generator().manual_seed(seed))  # drawn on the CPU: same numbers
    p_cpu = on_cpu.init(torch.Generator().manual_seed(seed))

    # prefill + three ragged decode steps, teacher-forced, logits compared
    b, t, max_len = 3, 7, 32
    spec = PagedSpec(num_pages=1 + b * 8, page_size=4)
    rng = np.random.default_rng(seed)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, size=(b, t)))
    table = torch.tensor((1 + rng.permutation(b * 8)).reshape(b, 8).astype(np.int32))
    worst = 0.0
    caches = {}
    for name, model, params in (("card", on_card, p_card), ("cpu", on_cpu, p_cpu)):
        d = model.device
        cache = model.init_cache(b, max_len, paged=spec)
        for layer in cache:
            layer["page_table"] = table.to(d)
        logits, cache = model.prefill(params, {"tokens": prompt.to(d)}, cache, last_only=True)
        caches[name] = (model, params, cache, [logits.cpu()])
    pos = torch.tensor([t, t - 3, t - 1], dtype=torch.int32)
    for name, (model, params, cache, outs) in caches.items():
        for layer in cache:
            layer["pos"] = pos.to(model.device)
    tokens = caches["cpu"][3][0][:, -1].argmax(-1)[:, None]
    for step in range(3):
        for name, (model, params, cache, outs) in caches.items():
            logits, cache = model.decode_step(params, tokens.to(model.device), cache,
                                              (pos + step).to(model.device))
            caches[name] = (model, params, cache, outs + [logits.cpu()])
        tokens = caches["cpu"][3][-1][:, -1].argmax(-1)[:, None]
    for a, c in zip(caches["card"][3], caches["cpu"][3]):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)
        worst = max(worst, (a - c).abs().max().item())

    # the paged batcher, with a pool tight enough to preempt
    outputs, counts = [], []
    for model, params in ((on_card, p_card), (on_cpu, p_cpu)):
        bt = ContinuousBatcher(model, params, slots=4, max_len=32,
                               paged=PagedSpec(num_pages=9, page_size=4))
        reqs = [Request(prompt=[i % 5 + 1, i % 3 + 2, 4], max_new_tokens=10) for i in range(8)]
        for r in reqs:
            bt.submit(r)
        bt.run_until_drained()
        outputs.append([r.output for r in reqs])
        counts.append((bt.preemptions, bt.steps, bt.page_pool.leaked()))
    if outputs[0] != outputs[1] or counts[0] != counts[1]:
        raise AssertionError(f"SMOKE batcher on the card differs from the CPU: {counts}")

    # the same on a linear cache: B4 prefill and B3 decode on the card
    reset_launches()
    runs = {}
    for name, model, params in (("card", on_card, p_card), ("cpu", on_cpu, p_cpu)):
        d = model.device
        logits, cache = model.prefill(params, {"tokens": prompt.to(d)},
                                      model.init_cache(b, max_len), last_only=True)
        for layer in cache:
            layer["pos"] = pos.to(d)
        runs[name] = (model, params, cache, [logits.cpu()])
    tokens = runs["cpu"][3][0][:, -1].argmax(-1)[:, None]
    for step in range(3):
        for name, (model, params, cache, outs) in runs.items():
            logits, cache = model.decode_step(params, tokens.to(model.device), cache,
                                              (pos + step).to(model.device))
            runs[name] = (model, params, cache, outs + [logits.cpu()])
        tokens = runs["cpu"][3][-1][:, -1].argmax(-1)[:, None]
    linear_worst = 0.0
    for a, c in zip(runs["card"][3], runs["cpu"][3]):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)
        linear_worst = max(linear_worst, (a - c).abs().max().item())
    linear_launches = {n: read_launches()[n] for n in ("flash_attention", "decode_attention")}
    if linear_launches != {"flash_attention": cfg.num_layers,
                           "decode_attention": 3 * cfg.num_layers}:
        raise AssertionError(f"SMOKE linear-cache launches: {linear_launches}")

    dense_outputs, dense_ticks = [], []
    for model, params in ((on_card, p_card), (on_cpu, p_cpu)):
        bt = ContinuousBatcher(model, params, slots=4, max_len=32)
        reqs = [Request(prompt=[i % 5 + 1, i % 3 + 2, 4] * (1 + i % 4), max_new_tokens=10)
                for i in range(8)]
        for r in reqs:
            bt.submit(r)
        bt.run_until_drained()
        dense_outputs.append([r.output for r in reqs])
        dense_ticks.append(bt.steps)
    if dense_outputs[0] != dense_outputs[1] or dense_ticks[0] != dense_ticks[1]:
        raise AssertionError(f"SMOKE dense batcher on the card differs from the CPU: "
                             f"{dense_ticks}")
    emit("smoke", logits_max_abs_diff=worst, tol="rtol=atol=1e-4 (f32, TF32 off)",
         batcher_tokens_equal=True, preemptions=counts[0][0], ticks=counts[0][1],
         linear_logits_max_abs_diff=linear_worst, linear_launches=linear_launches,
         dense_batcher_tokens_equal=True, dense_ticks=dense_ticks[0])


# --- phase 4 / 5 ------------------------------------------------------------------


def full_requests(cfg, seed: int):
    rng = np.random.default_rng(seed)
    lens = rng.integers(32, 513, size=32)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, size=n).tolist(),
                    max_new_tokens=32) for n in lens]


def full_batcher(model, params):
    return ContinuousBatcher(model, params, slots=16, max_len=1024,
                             paged=PagedSpec(num_pages=1 + 16 * 64, page_size=16))


def timed(fn, acc: list):
    def wrapper(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        acc.append(time.perf_counter() - t0)
        return out
    return wrapper


def phase_serve(model, params, cfg, seed: int, layers: int = LAYERS) -> tuple:
    # warm-up: cuBLAS handles, allocator, first launches
    warm = full_batcher(model, params)
    for r in full_requests(cfg, seed + 100)[:2]:
        r.max_new_tokens = 4
        warm.submit(r)
    warm.run_until_drained()
    del warm

    batcher = full_batcher(model, params)
    prefill_s, decode_s = [], []
    batcher.prefill_step = timed(batcher.prefill_step, prefill_s)
    batcher.decode_step = timed(batcher.decode_step, decode_s)
    reqs = full_requests(cfg, seed)
    for r in reqs:
        batcher.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                          # main path: counters from zero
    t0 = time.perf_counter()
    decoded = batcher.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()                # read right after the run

    check_served(batcher, reqs, cfg)
    if batcher.page_pool.leaked() != 0 or batcher.page_pool.in_use != 0:
        raise AssertionError("pages leaked")
    for name in LLAMA_KERNELS:
        if launches[name] == 0 or launches[name] != batcher.steps * layers:
            raise AssertionError(
                f"{name}: {launches[name]} launches for {batcher.steps} ticks x {layers} layers")
    check_prefill_launches(launches, len(prefill_s), layers)
    stats = dict(
        requests=len(reqs), ticks=batcher.steps, prefill_calls=len(prefill_s),
        decoded_tokens=decoded, launches=launches, preemptions=batcher.preemptions,
        leaked_pages=batcher.page_pool.leaked(),
        page_high_watermark=batcher.page_pool.high_watermark,
        decode_tokens_per_s=decoded / sum(decode_s),
        decode_ms_per_tick=1e3 * statistics.median(decode_s),
        prefill_ms_per_request=1e3 * statistics.mean(prefill_s),
        end_to_end_tokens_per_s=sum(len(r.output) for r in reqs) / wall, wall_s=wall,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    return stats, [r.output for r in reqs]


def check_served(batcher, reqs, cfg) -> None:
    """Every request completed with 32 tokens in the vocabulary."""
    if len(batcher.completed) != len(reqs):
        raise AssertionError(f"{len(batcher.completed)} of {len(reqs)} requests completed")
    for r in reqs:
        if r.fail_reason is not None or len(r.output) != 32:
            raise AssertionError(f"request {r.req_id}: {r.fail_reason}, {r.output}")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.req_id}: token out of range")


def check_prefill_launches(launches: dict, prefill_calls: int, layers: int = LAYERS) -> None:
    """Every prefill (prompts of 32 tokens or more) ran B4 in every layer."""
    if prefill_calls == 0 or launches["flash_attention"] != prefill_calls * layers:
        raise AssertionError(f"flash_attention: {launches['flash_attention']} launches for "
                             f"{prefill_calls} prefill calls x {layers} layers")


def dense_batcher(model, params):
    return ContinuousBatcher(model, params, slots=16, max_len=1024)  # dense mode


def phase_dense_serve(model, params, cfg, seed: int, paged_outputs: list) -> dict:
    """The dense path: the same 32 requests behind the dense batcher, B4 in
    every prefill and B3 in every decode tick; then the tokens against
    the paged serve phase's."""
    warm = dense_batcher(model, params)
    for r in full_requests(cfg, seed + 100)[:2]:
        r.max_new_tokens = 4
        warm.submit(r)
    warm.run_until_drained()
    del warm

    batcher = dense_batcher(model, params)
    prefill_s, decode_s = [], []
    batcher.prefill_step = timed(batcher.prefill_step, prefill_s)
    batcher.decode_step = timed(batcher.decode_step, decode_s)
    reqs = full_requests(cfg, seed)
    for r in reqs:
        batcher.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                          # main path: counters from zero
    t0 = time.perf_counter()
    decoded = batcher.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()                # read right after the run

    check_served(batcher, reqs, cfg)
    if launches["decode_attention"] == 0 or \
            launches["decode_attention"] != batcher.steps * LAYERS:
        raise AssertionError(f"decode_attention: {launches['decode_attention']} launches for "
                             f"{batcher.steps} ticks x {LAYERS} layers")
    check_prefill_launches(launches, len(prefill_s))
    if launches["paged_kv_append"] or launches["paged_decode_attention"]:
        raise AssertionError(f"the dense path reached the paged kernels: {launches}")
    stats = dict(
        requests=len(reqs), ticks=batcher.steps, prefill_calls=len(prefill_s),
        decoded_tokens=decoded, launches=launches,
        decode_tokens_per_s=decoded / sum(decode_s),
        decode_ms_per_tick=1e3 * statistics.median(decode_s),
        prefill_ms_per_request=1e3 * statistics.mean(prefill_s),
        end_to_end_tokens_per_s=sum(len(r.output) for r in reqs) / wall, wall_s=wall,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    stats["agreement_with_paged"] = token_agreement(model, params, cfg, reqs, paged_outputs)
    return stats


def token_agreement(model, params, cfg, reqs, other: list) -> dict:
    """A reading, not a gate: requests whose tokens equal ``other``'s and,
    at each first divergence, the plain path's top-two margin there."""
    plain = build_model(cfg, compute_dtype=model.compute_dtype, device=model.device,
                        use_kernels=False)
    diverged = []
    for r, theirs in zip(reqs, other):
        if r.output == theirs:
            continue
        i = next(j for j, (a, b) in enumerate(zip(r.output, theirs)) if a != b)
        tokens = torch.tensor([r.prompt + r.output[:i]], device=model.device)
        with torch.inference_mode():
            logits, _ = plain.prefill(params, {"tokens": tokens},
                                      plain.init_cache(1, tokens.shape[1]), last_only=True)
        top2 = logits[0, -1].topk(2).values
        diverged.append(dict(request=r.req_id, first_divergence=i,
                             plain_top2_margin=(top2[0] - top2[1]).item()))
    return dict(requests=len(reqs), equal=len(reqs) - len(diverged), diverged=diverged)


def phase_logits(model, params, cfg, seed: int, paged: bool = True) -> dict:
    """One decode step, kernel path against plain path, from one state, on
    a paged cache (B1, B2) or a linear one (B3)."""
    plain = build_model(cfg, compute_dtype=model.compute_dtype, device=model.device,
                        use_kernels=False)
    b, t, max_len, page = 16, 256, 1024, 16
    n_slot = max_len // page
    rng = np.random.default_rng(seed + 7)
    dev = model.device
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, size=(b, t)), device=dev)
    table = torch.tensor((1 + rng.permutation(b * n_slot)).reshape(b, n_slot).astype(np.int32),
                         device=dev)
    if paged:
        cache = model.init_cache(b, max_len, paged=PagedSpec(num_pages=1 + b * n_slot,
                                                              page_size=page))
        for layer in cache:
            layer["page_table"] = table
    else:
        cache = model.init_cache(b, max_len)
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"tokens": prompt}, cache, last_only=True)
        pos = torch.tensor(rng.integers(1, t + 1, size=b).astype(np.int32), device=dev)
        tokens = logits[:, -1].argmax(-1)[:, None]
        copy = [{k: v.clone() for k, v in layer.items()} for layer in cache]
        for layer, layer2 in zip(cache, copy):
            layer["pos"] = pos
            layer2["pos"] = pos.clone()
        k_logits, _ = model.decode_step(params, tokens, cache, pos)
        p_logits, _ = plain.decode_step(params, tokens, copy, pos)
    plain_f, diff = p_logits.float(), (k_logits.float() - p_logits.float())
    top2 = plain_f[:, -1].topk(2, dim=-1).values
    agree = (k_logits[:, -1].argmax(-1) == p_logits[:, -1].argmax(-1)).float().mean().item()
    return dict(max_abs_diff=diff.abs().max().item(), rms_diff=diff.pow(2).mean().sqrt().item(),
                plain_rms=plain_f.pow(2).mean().sqrt().item(),
                plain_max_abs=plain_f.abs().max().item(), greedy_agreement=agree,
                min_top2_margin=(top2[:, 0] - top2[:, 1]).min().item(),
                finite=bool(torch.isfinite(k_logits).all()))


def phase_prefill_logits(model, params, cfg, seed: int) -> dict:
    """Logits at every position of a B = 1 prefill on a linear cache, the
    kernel path (B4) against the plain path, prompts of 512 and 200."""
    plain = build_model(cfg, compute_dtype=model.compute_dtype, device=model.device,
                        use_kernels=False)
    rng = np.random.default_rng(seed + 13)
    out = {}
    for t in (512, 200):
        prompt = torch.tensor(rng.integers(0, cfg.vocab_size, size=(1, t)), device=model.device)
        with torch.inference_mode():
            k_logits, _ = model.prefill(params, {"tokens": prompt}, model.init_cache(1, 1024))
            p_logits, _ = plain.prefill(params, {"tokens": prompt}, plain.init_cache(1, 1024))
        out[f"t{t}"] = compare_logits(k_logits[0].float(), p_logits[0].float())
        del k_logits, p_logits
    return out


def check_prefill_logits(logits: dict) -> None:
    """LOGIT_TOL on every position, and the greedy token equal wherever the
    plain top-two margin exceeds 2 max|diff|."""
    failed = [key for key, r in logits.items()
              if not r["finite"] or r["max_abs_diff"] > LOGIT_TOL["max_abs"] * r["ref_rms"]
              or r["rms_diff"] > LOGIT_TOL["rms"] * r["ref_rms"]
              or r["greedy_equal_where_clear"] != r["clear_positions"]]
    if failed:
        raise AssertionError(f"prefill logits, B4 against plain, fail {failed}: {logits}")


def check_logits(logits: dict) -> None:
    """The kernel path's logits against the plain path's, both in bf16:
    the gates are fractions of the plain logits' RMS, and every greedy
    token must agree."""
    rms = logits["plain_rms"]
    if (not logits["finite"] or logits["max_abs_diff"] > LOGIT_TOL["max_abs"] * rms
            or logits["rms_diff"] > LOGIT_TOL["rms"] * rms
            or logits["greedy_agreement"] != 1.0):
        raise AssertionError(f"kernel-path logits differ from the plain path: {logits}")


def profile_serving(batcher, reqs) -> dict:
    """Serve ``reqs`` under torch.profiler; device time by kernel and in all."""
    from torch.profiler import ProfilerActivity, profile

    for r in reqs:
        batcher.submit(r)
    torch.cuda.synchronize()
    before = read_launches()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        batcher.run_until_drained()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    return dict(ticks=batcher.steps, **device_times(prof, wall, launches_since(before)))


def launches_since(before: dict) -> dict:
    return {name: n - before[name] for name, n in read_launches().items()}


def device_times(prof, wall: float, launches: dict) -> dict:
    """Device time of a profiled run, by kernel and in all.  A kernel's
    time sums every device entry its wrapper launches, each template
    instantiation of ``<name>_kernel`` and, for B2 and B3, of their combine
    pass ``<name>_combine_kernel``; its calls are its wrapper's launches in
    the run (``launches``), so device_ms / calls is per wrapper call
    however many passes it runs."""
    from torch.autograd import DeviceType

    def dev_us(evt):
        for n in ("device_time_total", "cuda_time_total"):
            if hasattr(evt, n):
                return float(getattr(evt, n))
        return 0.0

    # Only device-side entries (kernels, copies, fills): the CPU-side op
    # entries carry their kernels' time as well and would count it twice.
    per_kernel, busy_us, top = {}, 0.0, []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = dev_us(evt)
        busy_us += us
        top.append((us / 1e3, evt.count, evt.key[:90]))
        for name in KERNELS:  # "::" keeps decode_attention apart from paged_...
            for part in ("kernel", "combine_kernel"):
                if f"::{name}_{part}" in evt.key:
                    row = per_kernel.setdefault(name, dict(calls=launches.get(name, 0),
                                                           device_ms=0.0, device_ms_by_pass={}))
                    row["device_ms"] += us / 1e3
                    by_pass = row["device_ms_by_pass"]
                    by_pass[part] = by_pass.get(part, 0.0) + us / 1e3
    # the profiler slows the host, so the busy share under it is a lower
    # bound; device_s against an unprofiled run's wall_s is the other view
    return dict(wall_s=wall, kernels=per_kernel, device_s=busy_us / 1e6,
                top_device_ms=[dict(ms=ms, calls=n, name=k)
                               for ms, n, k in sorted(top)[::-1][:10]],
                device_busy_share_under_profiler=(busy_us / 1e6) / wall if busy_us else None)


def phase_profile(model, params, cfg, seed: int) -> dict:
    batcher = full_batcher(model, params)
    kv_rows = []
    decode = batcher.decode_step

    def decode_counting(params_, tokens, cache, positions):
        active = [s for s in range(batcher.slots) if batcher.active[s] is not None]
        kv_rows.append(int(sum(int(batcher.positions[s]) + 1 for s in active)))
        return decode(params_, tokens, cache, positions)

    batcher.decode_step = decode_counting
    out = profile_serving(batcher, full_requests(cfg, seed))
    hkv, d = cfg.num_kv_heads, cfg.resolved_head_dim
    dec = out["kernels"].get("paged_decode_attention")
    if dec and dec["device_ms"] > 0:
        n_bytes = 2 * sum(kv_rows) * hkv * d * 2 * LAYERS  # bf16 K+V rows of active slots
        out["decode_kernel_hbm_gb_per_s"] = n_bytes / (dec["device_ms"] / 1e3) / 1e9
        out["decode_kernel_ms_per_call"] = dec["device_ms"] / dec["calls"]
    else:
        out["decode_kernel_hbm_gb_per_s"] = None  # not measured: no device time in the trace
    return out


# --- mamba2: ssd_kernels, mamba_smoke, mamba_serve, mamba_logits, mamba_profile --

MAMBA = "mamba2-370m"
SSD_HEADS = dict(h=32, p=64, n=128, chunk=64)  # mamba2-370m FULL
# SSD kernel against its plain version: both compute in f32 from the same
# inputs (B and C rounded to bf16 first in the bf16 cases), in other
# summation orders, so the error scales with the outputs (|y| reaches the
# hundreds here).  Limits on max|err| as fractions of max|plain output|,
# about 2x the largest readings, 1.23e-5 (y) and 2.66e-6 (state) (PERF.md).
SSD_TOL = dict(y=2.5e-5, state=5.5e-6)
# Kernel path against plain path over 2048 prompt positions, as fractions
# of the plain logits' RMS; greedy tokens must agree wherever the plain
# top-two margin exceeds 2 max|diff|, and such positions must be at least
# 90% of all.  Limits at about 2x the readings (PERF.md): f32 at 48
# layers rms 1.0e-4 and max 3.4e-3, 97% of positions clear; bf16 at 2
# layers rms 2.5e-3, all clear.  bf16 at 48 layers: rms(kernel - plain)
# at most 2x rms(plain at chunk 32 - plain), two equally valid plain paths
# (ratio read 1.24).
MAMBA_GATES = {"f32": dict(rms=2e-4, max_abs=7e-3, clear_share=0.9),
               "bf16_2layers": dict(rms=5e-3, clear_share=0.9),
               "bf16_spread": 2.0}


def ssd_inputs(seed: int, b: int, t: int, dev, bc_dtype, state):
    """Scan inputs as a mamba2-370m layer makes them: dt = softplus(N(0,1)),
    a = exp(-dt * linspace(1, 16, H)) (the init's A_log), x = N(0,1) * dt,
    B and C N(0,1) in ``bc_dtype``.  Initial state: none if ``state`` is
    False, N(0,1) if True, and an all-zero tensor (what a prefill passes
    from a fresh cache) if "zero"."""
    h, p, n = SSD_HEADS["h"], SSD_HEADS["p"], SSD_HEADS["n"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.randn((b, t, h), generator=gen, device=dev))
    a = torch.exp(-dt * torch.linspace(1.0, 16.0, h, device=dev))
    x = torch.randn((b, t, h, p), generator=gen, device=dev) * dt[..., None]
    bm = torch.randn((b, t, n), generator=gen, device=dev).to(bc_dtype)
    cm = torch.randn((b, t, n), generator=gen, device=dev).to(bc_dtype)
    s0 = torch.randn((b, h, n, p), generator=gen, device=dev) if state else None
    if state == "zero":
        s0.zero_()
    return x, a, bm, cm, s0


def ssd_f64(x, a, bm, cm, s0) -> tuple:
    """The scan's recurrence, s = a_t s + B_t x_t^T and y_t = C_t . s, one
    step at a time in f64: the exact answer both versions round from."""
    x, a, bm, cm = x.double(), a.double(), bm.double(), cm.double()
    s = (s0.double() if s0 is not None else
         x.new_zeros((x.shape[0], x.shape[2], bm.shape[2], x.shape[3])))
    ys = []
    for i in range(x.shape[1]):
        s = s * a[:, i, :, None, None] + bm[:, i, None, :, None] * x[:, i, :, None, :]
        ys.append(torch.einsum("bn,bhnp->bhp", cm[:, i], s))
    return torch.stack(ys, dim=1), s


def ssd_work(b: int, t: int, bc_bytes: int, state) -> tuple:
    """(bytes, f32 operations) one scan needs, ``state`` as in
    ``ssd_inputs``.  Bytes: x, a, B, C and a given initial state read once,
    y and the final state written once.  Operations, 2 per multiply-add:
    C B^T over its lower triangle once per (b, chunk), since B and C are
    shared by the heads; per (b, h, chunk) att x over its causal half, the
    decay on att, B^T x with the end decay on B; and for every chunk that
    enters with a nonzero state (all but the first when the initial state
    is absent or zero) C S_prev scaled by exp(cum) and the decayed state
    added."""
    h, p, n, q = SSD_HEADS["h"], SSD_HEADS["p"], SSD_HEADS["n"], SSD_HEADS["chunk"]
    nc, tri = t // q, q * (q + 1) // 2
    n_bytes = (4 * b * t * h * p * 2 + 4 * b * t * h + 2 * b * t * n * bc_bytes
               + 4 * b * h * n * p * (2 if state is not False else 1))
    per_chunk = 2 * p * tri + tri + 2 * q * n * p + q * n
    inter = 2 * q * n * p + q * p + 2 * n * p
    n_ops = (b * nc * 2 * n * tri
             + b * h * (nc * per_chunk + (nc if state is True else nc - 1) * inter))
    return n_bytes, n_ops


def prompt_lengths(seed: int) -> np.ndarray:
    """The serving phases' prompt lengths (``full_requests``)."""
    return np.random.default_rng(seed).integers(32, 513, size=32)


def phase_ssd_kernels(dev, seed: int, flush: torch.Tensor, ptxas: list) -> dict:
    q = SSD_HEADS["chunk"]
    before = read_launches()["ssd_chunked"]
    cases = []

    def check(x, a, bm, cm, s0, **label) -> None:
        y, s = ssd_scan.ssd_chunked(x, a, bm, cm, q, s0)
        y_ref, s_ref = ssd_scan.ssd_chunked_ref(x, a, bm, cm, q, s0)
        torch.cuda.synchronize()
        y_err, s_err = (y - y_ref).abs().max().item(), (s - s_ref).abs().max().item()
        y64, s64 = ssd_f64(x, a, bm, cm, s0)
        to_f64 = {f"{out}_{who}_vs_f64": ((got.double() - want).abs().max()
                                          / want.abs().max()).item()
                  for out, want, pair in (("y", y64, (("kernel", y), ("plain", y_ref))),
                                          ("state", s64, (("kernel", s), ("plain", s_ref))))
                  for who, got in pair}
        cases.append(dict(
            **label, bc_dtype=str(bm.dtype),
            y_max_abs_err=y_err, y_max_abs=y_ref.abs().max().item(),
            y_rms_err_over_rms=((y - y_ref).pow(2).mean()
                                / y_ref.pow(2).mean()).sqrt().item(),
            state_max_abs_err=s_err, state_max_abs=s_ref.abs().max().item(),
            **to_f64,  # readings: each version's max|err| over max|exact|
            finite=bool(torch.isfinite(y).all() and torch.isfinite(s).all())))

    for b in (1, 4):
        for bc_dtype in (torch.bfloat16, torch.float32):
            for state in (False, True):
                check(*ssd_inputs(seed, b, 2048, dev, bc_dtype, state),
                      batch=b, t=2048, initial_state=state)

    def timing(b: int, t: int, state) -> dict:
        x, a, bm, cm, s0 = ssd_inputs(seed + 1, b, t, dev, torch.bfloat16, state)
        if state == "zero":  # the main path's own shapes: held to the gate too
            check(x, a, bm, cm, s0, batch=b, t=t, initial_state=state)
        n_bytes, n_ops = ssd_work(b, t, 2, state)
        bnd, by = bound_ms(n_bytes, n_ops, torch.float32)
        return dict(
            kernel_ms=time_ms(lambda: ssd_scan.ssd_chunked(x, a, bm, cm, q, s0), flush),
            plain_ms=time_ms(lambda: ssd_scan.ssd_chunked_ref(x, a, bm, cm, q, s0), flush),
            bound_ms=bnd, bound_by=by, bytes=int(n_bytes), ops=int(n_ops))

    # The model's own calls: B=1, bf16 B and C, the fresh cache's all-zero
    # state, T the prompt padded to a multiple of the chunk.
    padded = -(-prompt_lengths(seed) // q) * q
    per_t = {int(t): timing(1, int(t), "zero") for t in sorted(set(padded.tolist()))}
    weights = [int((padded == t).sum()) for t in per_t]
    main_path = {k: sum(w * r[k] for w, r in zip(weights, per_t.values())) / sum(weights)
                 for k in ("kernel_ms", "plain_ms", "bound_ms")}
    # what bounds most of the launches' summed bound time
    share = {by: sum(w * r["bound_ms"] for w, r in zip(weights, per_t.values())
                     if r["bound_by"] == by) for by in ("bytes", "operations")}
    main_path["bound_by"] = max(share, key=share.get)
    timings = {"b1_t2048": timing(1, 2048, True), "b4_t2048": timing(4, 2048, True),
               "main_path_per_launch": main_path,
               "main_path_by_t": {str(t): r for t, r in per_t.items()}}
    emit("ssd_kernels", cases=cases, tol=f"max|err| <= {SSD_TOL['y']} max|y| (y), "
         f"{SSD_TOL['state']} max|state| (state)",
         launches_parity_and_timing=read_launches()["ssd_chunked"] - before, ptxas=ptxas,
         dynamic_smem_bytes_per_block=ssd_scan.ops.smem_bytes(
             SSD_HEADS["p"], SSD_HEADS["n"], SSD_HEADS["chunk"]),
         timing=timings,
         note="ms: CUDA events, median of 30, L2 flushed; H=32 P=64 N=128 chunk 64, bf16 "
              "B/C; b*_t2048: N(0,1) initial state; main_path: all-zero initial state, "
              "mean per launch over the mamba_serve prompts; bound: bytes at 3.35 TB/s, "
              "f32 operations at 67 TFLOP/s; library: none (no single PyTorch call "
              "computes the scan)")
    bad = [c for c in cases if not c["finite"]
           or c["y_max_abs_err"] > SSD_TOL["y"] * c["y_max_abs"]
           or c["state_max_abs_err"] > SSD_TOL["state"] * c["state_max_abs"]]
    if bad:
        raise AssertionError(f"ssd_chunked differs from its plain version: {bad}")
    return dict(kernel_ms=main_path["kernel_ms"], plain_ms=main_path["plain_ms"],
                bound_ms=main_path["bound_ms"], bound_by=main_path["bound_by"],
                library_ms=None,
                max_abs_err=max(c["y_max_abs_err"] for c in cases
                                if c["bc_dtype"] == "torch.bfloat16"))


def phase_mamba_smoke(dev, seed: int) -> None:
    """SMOKE at f32: the kernel path on the card against the plain path on
    the CPU, for prefill and decode logits and for the dense batcher."""
    cfg = get_arch(MAMBA, smoke=True)
    on_card = build_model(cfg, compute_dtype=torch.float32, device=dev)
    on_cpu = build_model(cfg, compute_dtype=torch.float32, device="cpu", use_kernels=False)
    p_card = on_card.init(torch.Generator().manual_seed(seed))  # drawn on the CPU: same numbers
    p_cpu = on_cpu.init(torch.Generator().manual_seed(seed))
    b, t = 3, 37  # not a multiple of the 16-step chunk
    rng = np.random.default_rng(seed + 3)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, size=(b, t)))
    runs, worst = {}, 0.0
    reset_launches()
    for name, model, params in (("card", on_card, p_card), ("cpu", on_cpu, p_cpu)):
        with torch.inference_mode():
            logits, cache = model.prefill(params, {"tokens": prompt.to(model.device)},
                                          model.init_cache(b, 64))
        runs[name] = (model, params, cache, [logits.cpu()])
    if read_launches()["ssd_chunked"] != cfg.num_layers:
        raise AssertionError(f"SMOKE prefill launched the scan {read_launches()} times")
    tokens = runs["cpu"][3][0][:, -1].argmax(-1)[:, None]
    pos = torch.full((b,), t, dtype=torch.int32)
    for step in range(3):
        for name, (model, params, cache, outs) in runs.items():
            with torch.inference_mode():
                logits, cache = model.decode_step(params, tokens.to(model.device), cache,
                                                  (pos + step).to(model.device))
            runs[name] = (model, params, cache, outs + [logits.cpu()])
        tokens = runs["cpu"][3][-1][:, -1].argmax(-1)[:, None]
    for a, c in zip(runs["card"][3], runs["cpu"][3]):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)
        worst = max(worst, (a - c).abs().max().item())

    outputs, ticks = [], []
    for model, params in ((on_card, p_card), (on_cpu, p_cpu)):
        bt = ContinuousBatcher(model, params, slots=3, max_len=64)
        reqs = [Request(prompt=rng_prompt, max_new_tokens=6)
                for rng_prompt in ([1], [5, 9], list(range(3, 20)), list(range(40, 70)),
                                   [7] * 16, [2, 4, 6, 8, 10], list(range(1, 34)))]
        for r in reqs:
            bt.submit(r)
        bt.run_until_drained()
        outputs.append([r.output for r in reqs])
        ticks.append(bt.steps)
    if outputs[0] != outputs[1] or ticks[0] != ticks[1]:
        raise AssertionError(f"SMOKE dense batcher on the card differs from the CPU: {ticks}")
    emit("mamba_smoke", logits_max_abs_diff=worst, tol="rtol=atol=1e-4 (f32, TF32 off)",
         batcher_tokens_equal=True, ticks=ticks[0])


def phase_mamba_serve(model, params, cfg, seed: int) -> dict:
    warm = dense_batcher(model, params)
    for r in full_requests(cfg, seed + 100)[:2]:
        r.max_new_tokens = 4
        warm.submit(r)
    warm.run_until_drained()
    del warm

    batcher = dense_batcher(model, params)
    prefill_s, decode_s = [], []
    batcher.prefill_step = timed(batcher.prefill_step, prefill_s)
    batcher.decode_step = timed(batcher.decode_step, decode_s)
    reqs = full_requests(cfg, seed)
    for r in reqs:
        batcher.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                          # main path: counters from zero
    t0 = time.perf_counter()
    decoded = batcher.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()                # read right after the run

    admissions = len(prefill_s)
    if len(batcher.completed) != len(reqs) or admissions != len(reqs):
        raise AssertionError(f"{len(batcher.completed)} of {len(reqs)} requests completed "
                             f"after {admissions} admissions")
    for r in reqs:
        if r.fail_reason is not None or len(r.output) != 32:
            raise AssertionError(f"request {r.req_id}: {r.fail_reason}, {r.output}")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.req_id}: token out of range")
    if launches["ssd_chunked"] == 0 or launches["ssd_chunked"] != admissions * MAMBA_LAYERS:
        raise AssertionError(f"ssd_chunked: {launches['ssd_chunked']} launches for "
                             f"{admissions} admissions x {MAMBA_LAYERS} layers")
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    return dict(
        requests=len(reqs), admissions=admissions, ticks=batcher.steps,
        prompt_tokens=prompt_tokens, decoded_tokens=decoded, launches=launches,
        prefill_ms_per_request=1e3 * statistics.mean(prefill_s), prefill_s=sum(prefill_s),
        prefill_tokens_per_s=prompt_tokens / sum(prefill_s),
        decode_ms_per_tick=1e3 * statistics.median(decode_s), decode_s=sum(decode_s),
        decode_tokens_per_s=decoded / sum(decode_s),
        end_to_end_tokens_per_s=sum(len(r.output) for r in reqs) / wall, wall_s=wall,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )


def compare_logits(test: torch.Tensor, ref: torch.Tensor) -> dict:
    """Logits [T, V] of one path against another's."""
    diff = test - ref
    max_diff = diff.abs().max()
    top2 = ref.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    clear = margin > 2 * max_diff
    equal = test.argmax(-1) == ref.argmax(-1)
    return dict(positions=ref.shape[0], max_abs_diff=max_diff.item(),
                rms_diff=diff.pow(2).mean().sqrt().item(),
                ref_rms=ref.pow(2).mean().sqrt().item(), ref_max_abs=ref.abs().max().item(),
                greedy_equal=int(equal.sum()), clear_positions=int(clear.sum()),
                greedy_equal_where_clear=int((equal & clear).sum()),
                min_top2_margin=margin.min().item(), finite=bool(torch.isfinite(test).all()))


def phase_mamba_logits(model, params, cfg, seed: int) -> dict:
    """Prefill logits over 2048 positions, kernel path against plain path."""
    dev = model.device
    rng = np.random.default_rng(seed + 11)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, size=(1, 2048)), device=dev)

    def run(cfg_, params_, dtype, use_kernels):
        m = build_model(cfg_, compute_dtype=dtype, device=dev, use_kernels=use_kernels)
        with torch.inference_mode():
            logits, _ = m.prefill(params_, {"tokens": prompt}, m.init_cache(1, 2048))
        return logits[0].float()

    out = {}
    # f32, FULL width and depth: the model-level correctness gate
    p32 = build_model(cfg, compute_dtype=torch.float32, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    out["f32"] = compare_logits(run(cfg, p32, torch.float32, True),
                                run(cfg, p32, torch.float32, False))
    del p32
    # bf16, FULL width, 2 layers
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    p2 = build_model(cfg2, device=dev).init(torch.Generator(device=dev).manual_seed(seed))
    out["bf16_2layers"] = compare_logits(run(cfg2, p2, torch.bfloat16, True),
                                         run(cfg2, p2, torch.bfloat16, False))
    del p2
    # bf16, FULL width and depth (the served weights), against the spread
    # between two valid plain paths: chunk 64 and chunk 32
    plain64 = run(cfg, params, torch.bfloat16, False)
    out["bf16"] = compare_logits(run(cfg, params, torch.bfloat16, True), plain64)
    cfg32 = dataclasses.replace(cfg, mamba=dataclasses.replace(cfg.mamba, chunk_size=32))
    out["bf16_plain_chunk32"] = compare_logits(run(cfg32, params, torch.bfloat16, False),
                                               plain64)
    return out


def check_mamba_logits(logits: dict) -> None:
    failed = []
    for key in ("f32", "bf16_2layers"):
        r, g = logits[key], MAMBA_GATES[key]
        rms = r["ref_rms"]
        if (not r["finite"] or r["rms_diff"] > g["rms"] * rms
                or ("max_abs" in g and r["max_abs_diff"] > g["max_abs"] * rms)
                or r["greedy_equal_where_clear"] != r["clear_positions"]
                or r["clear_positions"] < g["clear_share"] * r["positions"]):
            failed.append(key)
    spread = logits["bf16_plain_chunk32"]["rms_diff"]
    if (not logits["bf16"]["finite"]
            or logits["bf16"]["rms_diff"] > MAMBA_GATES["bf16_spread"] * spread):
        failed.append("bf16")
    if failed:
        raise AssertionError(f"mamba2 kernel-path logits fail {failed}: {logits}")


# --- TCMM: tcmm_kernels, tcmm_pipeline ----------------------------------------------

TCMM_CASES = [(512, 64, 4, 64), (1024, 512, 8, 100), (256, 16, 128, 16), (512, 128, 4, 1),
              (4096, 512, 4, 512), (1, 512, 4, 512), (1, 512, 4, 300), (1, 512, 4, 0)]
TCMM_POINTS = 20_000
TCMM_TAXIS = 10_357  # T-Drive's taxi count
# points of the profiled rerun: the trace of all 20,000 took about 4 minutes
# to collect and sum; a point's device work barely grows with the table
TCMM_PROFILED_POINTS = 2_000
# the macro k-means objective, card against CPU, relative: the centre sums
# run through cuBLAS on the card and in another order on the CPU
KMEANS_OBJECTIVE_RTOL = 1e-4


def tcmm_inputs(seed: int, n: int, m: int, f: int, n_valid: int, dev, dtype):
    rng = np.random.default_rng(seed)
    pts = torch.tensor((rng.standard_normal((n, f)) * 3).astype(np.float32), device=dev)
    cents = torch.tensor((rng.standard_normal((m, f)) * 3).astype(np.float32), device=dev)
    return pts.to(dtype), cents.to(dtype), torch.arange(m, device=dev) < n_valid


def tcmm_work(n: int, m: int, f: int, elem: int) -> tuple:
    """(bytes, f32 operations) of one assignment: points, centroids and the
    bool mask read once, index and d2 written once; per (n, m) pair F
    products, F-1 sums, the doubling, the subtraction, the addition of |c|^2
    and the comparison (2F + 3), plus |p|^2 and |c|^2 (2F - 1 each)."""
    n_bytes = (n * f + m * f) * elem + m + 8 * n
    n_ops = n * m * (2 * f + 3) + (n + m) * (2 * f - 1)
    return n_bytes, n_ops


def phase_tcmm_kernels(dev, seed: int, flush: torch.Tensor) -> dict:
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for n, m, f, n_valid in TCMM_CASES:
            pts, cents, valid = tcmm_inputs(seed, n, m, f, n_valid, dev, dtype)
            idx, d2 = tcmm_assign.tcmm_assign(pts, cents, valid)
            want_idx, want_d2 = tcmm_assign.tcmm_assign_ref(pts, cents, valid)
            torch.cuda.synchronize()
            finite = torch.isfinite(want_d2)
            cases.append(dict(
                n=n, m=m, f=f, n_valid=n_valid, dtype=str(dtype),
                idx_equal=torch.equal(idx, want_idx), d2_bit_equal=torch.equal(d2, want_d2),
                max_abs_err=(d2[finite] - want_d2[finite]).abs().max().item()
                if finite.any() else 0.0,
                idx_below_n_valid=bool((idx < n_valid).all()) if n_valid else None,
                empty_table_gives_0_inf=(bool((idx == 0).all() and torch.isinf(d2).all())
                                         if n_valid == 0 else None)))
        cents = tcmm_inputs(seed + 1, 1, 32, 4, 32, dev, dtype)[1] * (5 / 3)
        idx, d2 = tcmm_assign.tcmm_assign(cents[7].repeat(64, 1).contiguous(), cents,
                                          torch.ones(32, dtype=torch.bool, device=dev))
        torch.cuda.synchronize()
        cases.append(dict(case="64 copies of centroid 7", dtype=str(dtype),
                          maps_to_7=bool((idx == 7).all()),
                          max_abs_d2=d2.abs().max().item()))
    bad = [c for c in cases if not c.get("maps_to_7", True) or c.get("max_abs_d2", 0.0) > 1e-4
           or c.get("idx_equal") is False or c.get("d2_bit_equal") is False
           or c.get("idx_below_n_valid") is False or c.get("empty_table_gives_0_inf") is False]

    def timing(n: int, m: int, f: int) -> dict:
        pts, cents, valid = tcmm_inputs(seed + 2, n, m, f, m, dev, torch.float32)
        bnd, by = bound_ms(*tcmm_work(n, m, f, 4), torch.float32)
        masked = ~valid[None, :]

        def library():  # no single call computes it: cdist, then a masked min
            return torch.cdist(pts, cents).masked_fill(masked, float("inf")).min(dim=1)

        return dict(
            kernel_ms=time_ms(lambda: tcmm_assign.tcmm_assign(pts, cents, valid), flush),
            # the pipeline meets the table warm in L2 (its centroids were just
            # computed), so the kernel's time without the flush as well
            kernel_ms_l2_warm=time_ms(lambda: tcmm_assign.tcmm_assign(pts, cents, valid),
                                      None),
            plain_ms=time_ms(lambda: tcmm_assign.tcmm_assign_ref(pts, cents, valid), flush),
            library_ms=time_ms(library, flush), bound_ms=bnd, bound_by=by)

    timings = {"n4096_m512_f4": timing(4096, 512, 4), "main_path_n1_m512_f4": timing(1, 512, 4)}
    emit("tcmm_kernels", cases=cases, timing=timings,
         note="f32 times in ms (CUDA events, median of 30, L2 flushed), all rows valid; "
              "bound: bytes at 3.35 TB/s or f32 operations at 67 TFLOP/s; library: "
              "torch.cdist then masked_fill and min (no single call computes the "
              "function; cdist gives distances, not their squares)")
    if bad:
        raise AssertionError(f"tcmm_assign differs from its plain version: {bad}")
    row = timings["main_path_n1_m512_f4"]
    return dict(kernel_ms=row["kernel_ms"], kernel_ms_l2_warm=row["kernel_ms_l2_warm"],
                plain_ms=row["plain_ms"],
                library_ms=row["library_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], max_abs_err=max(c.get("max_abs_err", 0.0)
                                                          for c in cases))


def run_tcmm_pipeline(points, device, n_points: int) -> dict:
    """examples/quickstart.py's pipeline on ``device``, driven on the same
    virtual clock whatever the device, so both runs see one ingest order."""
    log = MessageLog()
    log.create_topic("trajectories", 3)
    log.create_topic("micro-changes", 3)
    for key, point in points[:n_points]:
        log.publish("trajectories", payload=point, key=key)
    cfg = TCMMConfig()
    micro = tcmm.MicroClusterJob(cfg, device=device)
    macro = tcmm.MacroClusterJob(cfg, device=device)
    events, ingest_s, macro_s, kmeans_runs = [], [], [], []

    def micro_call(msg, _call=micro.__call__):
        t0 = time.perf_counter()
        out = _call(msg)
        ingest_s.append(time.perf_counter() - t0)
        events.append(out[0])
        return out

    def macro_call(msg, _call=macro.__call__):
        t0 = time.perf_counter()
        out = _call(msg)
        macro_s.append(time.perf_counter() - t0)
        if out:  # a k-means run: keep what its objective is computed from
            valid = macro.replica.valid()
            kmeans_runs.append((macro.replica.centroids()[valid].cpu().double().numpy(),
                                macro.replica.n[valid].cpu().double().numpy(),
                                macro.macro_centers.astype(np.float64), macro_s[-1]))
        return out

    micro_job = ReactiveJob("micro", log, "trajectories", micro_call,
                            out_topic="micro-changes", initial_tasks=4, scheduler="jsq",
                            heartbeat_timeout=3.0)
    macro_job = ReactiveJob("macro", log, "micro-changes", macro_call, initial_tasks=2,
                            heartbeat_timeout=3.0)
    killed, t = False, 0.0
    t0 = time.perf_counter()
    while micro_job.backlog() or macro_job.backlog() or t == 0.0:
        t += 1.0
        micro_job.step(now=t)
        macro_job.step(now=t)
        if not killed and micro.state.processed > n_points // 3:
            micro_job.tasks[0].alive = False
            killed = True
        if t > 100 * n_points:
            raise AssertionError(f"the TCMM pipeline did not drain in {t:.0f} rounds")
    if micro.state.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(micro=micro, macro=macro, log=log, events=events, wall_s=wall, rounds=t,
                ingest_s=ingest_s, macro_s=macro_s, kmeans_runs=kmeans_runs,
                restarts=sum(e[1] == "restarted" for e in micro_job.supervisor.events),
                committed=micro_job.stage.committed_offsets(),
                ends=log.get("trajectories").end_offsets(),
                changes=log.get("micro-changes").total_messages())


def kmeans_objective(cents: np.ndarray, weights: np.ndarray, centers: np.ndarray) -> float:
    """sum_m w_m min_j |c_m - k_j|^2 in f64."""
    d2 = ((cents[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    return float((weights * d2.min(axis=1)).sum())


def phase_tcmm_pipeline(dev, seed: int, n_points: int = TCMM_POINTS) -> dict:
    points = list(TrajectorySource(num_taxis=TCMM_TAXIS, seed=seed).stream(n_points))
    run_tcmm_pipeline(points, dev, 300)  # warm-up: first launches, allocator, cuBLAS
    torch.cuda.synchronize()
    reset_launches()                          # main path: counters from zero
    card = run_tcmm_pipeline(points, dev, n_points)
    launches = read_launches()                # read right after the run
    reset_launches()
    cpu = run_tcmm_pipeline(points, "cpu", n_points)
    cpu_launches = read_launches()["tcmm_assign"]

    failed = []
    for name, run in (("card", card), ("cpu", cpu)):
        if not (run["micro"].state.processed == n_points == run["macro"].replica.processed
                == run["changes"] and run["committed"] == dict(enumerate(run["ends"]))):
            failed.append(f"{name}: not every point exactly once")
        if run["restarts"] < 1:
            failed.append(f"{name}: no restart")
    if launches["tcmm_assign"] != card["micro"].state.processed - 1 or cpu_launches != 0:
        failed.append(f"B7 launches {launches['tcmm_assign']} on the card (want "
                      f"{card['micro'].state.processed - 1}), {cpu_launches} on the CPU")
    if card["events"] != cpu["events"]:
        first = next(i for i, (a, b) in enumerate(zip(card["events"], cpu["events"]))
                     if a != b) if len(card["events"]) == len(cpu["events"]) else -1
        failed.append(f"events differ (first at {first})")
    state_equal = {k: torch.equal(getattr(card["micro"].state, k).cpu(),
                                  getattr(cpu["micro"].state, k)) for k in ("n", "ls", "ss")}
    if not all(state_equal.values()) or card["micro"].state.num_active != \
            cpu["micro"].state.num_active:
        failed.append(f"micro state differs: {state_equal}")
    objectives, centre_diff = [], 0.0
    if card["macro"].macro_runs != cpu["macro"].macro_runs:
        failed.append(f"macro runs {card['macro'].macro_runs} != {cpu['macro'].macro_runs}")
    else:
        for (c_a, w_a, k_a, _), (c_b, w_b, k_b, _) in zip(card["kmeans_runs"],
                                                          cpu["kmeans_runs"]):
            a, b = kmeans_objective(c_a, w_a, k_a), kmeans_objective(c_b, w_b, k_b)
            objectives.append(abs(a - b) / b)
            centre_diff = max(centre_diff, float(np.abs(k_a - k_b).max()))
        if max(objectives, default=0.0) > KMEANS_OBJECTIVE_RTOL:
            failed.append(f"k-means objective off by {max(objectives)} relative")

    def per_call_us(xs):
        return dict(mean=1e6 * statistics.mean(xs), median=1e6 * statistics.median(xs))

    out = dict(
        points=n_points, taxis=TCMM_TAXIS, num_active=card["micro"].state.num_active,
        macro_runs=card["macro"].macro_runs, launches=launches["tcmm_assign"],
        cpu_launches=cpu_launches, restarts=card["restarts"], rounds=card["rounds"],
        events_equal=card["events"] == cpu["events"], state_bit_equal=state_equal,
        kmeans_objective_max_rel_diff=max(objectives, default=None),
        kmeans_max_centre_diff=centre_diff,
        card=dict(wall_s=card["wall_s"], points_per_s=n_points / card["wall_s"],
                  ingest_us=per_call_us(card["ingest_s"]),
                  macro_event_us=per_call_us(card["macro_s"]),
                  kmeans_run_ms=1e3 * statistics.mean(r[3] for r in card["kmeans_runs"])),
        cpu=dict(wall_s=cpu["wall_s"], points_per_s=n_points / cpu["wall_s"],
                 ingest_us=per_call_us(cpu["ingest_s"]),
                 macro_event_us=per_call_us(cpu["macro_s"]),
                 kmeans_run_ms=1e3 * statistics.mean(r[3] for r in cpu["kmeans_runs"])),
        note="ingest_us: time inside MicroClusterJob.__call__; macro_event_us: inside "
             "MacroClusterJob.__call__; kmeans_run_ms: a macro call that ran k-means "
             "(apply, k-means, readback); host clock")
    if failed:
        emit("tcmm_pipeline", **out, failed=failed)
        raise AssertionError(f"TCMM pipeline: {failed}")
    prof = out["profile"] = profile_tcmm(points, dev, TCMM_PROFILED_POINTS)
    prof["device_us_per_point"] = 1e6 * prof["device_s"] / TCMM_PROFILED_POINTS
    # that device time per point over the unprofiled card run's wall per point
    prof["device_share_of_card_wall_est"] = (prof["device_s"] / TCMM_PROFILED_POINTS
                                             * n_points / card["wall_s"])
    return out


def profile_tcmm(points, dev, n_points: int) -> dict:
    """The card run again on the first ``n_points`` under torch.profiler:
    device time by kernel and in all, and the host's largest entries by
    their own CPU time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = read_launches()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_tcmm_pipeline(points, dev, n_points)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key[:60])
                   for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                  reverse=True)[:10]
    return dict(**device_times(prof, wall, launches_since(before)),
                host_top_self_cpu_ms=[dict(ms=ms, calls=n, name=k) for ms, n, k in host])


# --- mixtral-8x7b: mixtral_attention_kernels, mixtral_smoke, mixtral_logits_f32,
#     mixtral_serve, mixtral_profile, moe_kernels, mixtral_logits ----------------------

MIXTRAL = "mixtral-8x7b"
# 32 -> 16 layers: 16 layers of bf16 weights take 46.4 GB of the card's 80 GB,
# all 32 would take 92.9 GB
MIXTRAL_LAYERS = 16
MIXTRAL_F32_LAYERS = 2  # FULL width in f32: about 12.7 GB
MIXTRAL_HEADS = dict(h=32, hkv=8, d=128)  # mixtral-8x7b FULL
# B5 against its plain version: idx, pos and keep exactly equal, gates to
# the reference test's tolerance (tests/test_kernels.py:362-382)
GATE_TOL = dict(rtol=1e-5, atol=1e-6)
# FULL width, 2 layers, f32 (TF32 off): kernel path against plain path,
# max|diff| as a fraction of the plain logits' RMS
MIXTRAL_F32_TOL = 1e-3
MOE_CASES = [(512, 16, 2, 80, 128), (256, 128, 1, 4, 128)]  # jamba-, llama4-style


def tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tensor_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def reduced(layers: int) -> dict:
    return {"num_layers": f"32 -> {layers}"}


def with_capacity(cfg, capacity_factor: float):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            capacity_factor=capacity_factor))


@contextlib.contextmanager
def routing_capture():
    """Wrap the model's gating function and its plain version; each call
    appends (logits, capacity, (idx, gates, pos, keep)) under its name.
    Only references are kept: no copy, no launch, no sync."""
    calls = {"moe_gating": [], "moe_gating_ref": []}
    real = {name: getattr(moe, name) for name in calls}

    def wrap(name):
        def gating(logits, top_k, capacity, block_n):
            out = real[name](logits, top_k, capacity, block_n=block_n)
            calls[name].append((logits, capacity, out))
            return out
        return gating

    for name in calls:
        setattr(moe, name, wrap(name))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(moe, name, fn)


def routing_agreement(kernel_calls: list, plain_calls: list) -> dict:
    """B5's routing on the kernel path against the plain version's on the
    plain path, call by call (layer by layer)."""
    if len(kernel_calls) != len(plain_calls):
        raise AssertionError(f"{len(kernel_calls)} gating calls against {len(plain_calls)}")
    agree = total = 0
    equal = True
    for (_, _, (ki, _, kp, kk)), (_, _, (pi, _, pp, pk)) in zip(kernel_calls, plain_calls):
        agree += int((ki == pi).sum())
        total += ki.numel()
        equal &= torch.equal(ki, pi) and torch.equal(kp, pp) and torch.equal(kk, pk)
    return dict(calls=len(kernel_calls), choices=total, idx_agree_share=agree / total,
                idx_pos_keep_all_equal=equal)


@contextlib.contextmanager
def routing_forced(kernel_calls: list):
    """Make the plain path route as the kernel path did: its i-th gating
    call returns the kernel path's i-th idx, pos and keep, with the gates
    renormalised from its own probabilities at those experts.  The two
    paths' logits then differ only by what attention and rounding leave,
    and can be held to a limit.  Each call appends (kernel path's router
    logits, own router logits, forced idx, own idx) to count the flips
    its own routing would have made."""
    real = moe.moe_gating_ref
    pending = iter(kernel_calls)
    seen = []

    def gating(logits, top_k, capacity, block_n):
        k_logits, k_capacity, (idx, _, pos, keep) = next(pending)
        if k_capacity != capacity or idx.shape != (logits.shape[0], top_k):
            raise AssertionError("the plain path's gating calls do not follow the kernel path's")
        own = real(logits, top_k, capacity, block_n=block_n)[0]
        g = [moe_gating.ref.probabilities(logits).gather(1, idx.long())[:, r]
             for r in range(top_k)]  # the plain version's arithmetic, left to right
        seen.append((k_logits, logits, idx, own))
        return idx, torch.stack([x / functools.reduce(torch.add, g).clamp(min=1e-9)
                                 for x in g], dim=1), pos, keep

    moe.moe_gating_ref = gating
    try:
        yield seen
    finally:
        moe.moe_gating_ref = real
    if len(seen) != len(kernel_calls):
        raise AssertionError(f"{len(seen)} forced gating calls against {len(kernel_calls)}")


def forced_flips(seen: list) -> dict:
    """Under forced routing, each layer's own choices against the kernel
    path's: the share that agree and, for the flips, the plain router's
    logit gap between its own expert and the forced one, beside the
    largest router-logit difference between the two paths."""
    agree = total = 0
    gap_max = diff_max = 0.0
    for k_logits, logits, idx, own in seen:
        flip = idx != own
        agree += int((~flip).sum())
        total += flip.numel()
        diff_max = max(diff_max, (k_logits - logits).abs().max().item())
        if flip.any():
            gap = logits.gather(1, own.long()) - logits.gather(1, idx.long())
            gap_max = max(gap_max, gap.abs()[flip].max().item())
    return dict(own_idx_agree_share=agree / total, flipped_choices=total - agree,
                choices=total, flip_max_router_gap=gap_max, router_max_abs_diff=diff_max)


def phase_mixtral_attention(dev, seed: int, flush: torch.Tensor) -> dict:
    """B1 and B2 (paged, kv_len 0..2048 with a 0), B3 (linear, kv_len 0..1024
    with a 0) and B4 (T in {32, 512, 2048}, window 0 and 128) at mixtral's
    heads (H=32, Hkv=8, D=128) against their plain versions, f32 and bf16,
    under TOL; then bf16 times of B1, B2, B3 and B4 at the serving lengths,
    B2 held to DECODE_SPEED_GATE (B3 at this width is a reading)."""
    d = MIXTRAL_HEADS["d"]
    rng = np.random.default_rng(seed + 21)
    wide = rng.integers(1, 2049, size=16)
    wide[0], wide[1] = 0, 2048
    paged = check_parity(dev, seed, wide, d)  # raises beyond TOL
    dense, flash = [], []
    for dtype in (torch.float32, torch.bfloat16):
        kv_len = rng.integers(1, 1025, size=16)
        kv_len[:2] = (0, 1024)
        q, kc, vc, lens = dense_decode_inputs(dtype, seed, dev, 1024, kv_len, MIXTRAL_HEADS)
        for q_pos, window in ((qp, w) for qp in (None, model_q_pos(kv_len, dev))
                              for w in (0, 128)):
            out = ops.decode_attention(q, kc, vc, lens, window=window, q_pos=q_pos)
            plain = ref.decode_attention_ref(q, kc, vc, lens, window=window, q_pos=q_pos)
            torch.cuda.synchronize()
            dense.append(dict(dtype=str(dtype), window=window,
                              q_pos="none" if q_pos is None else "model",
                              max_abs_err=(out.float() - plain.float()).abs().max().item(),
                              within_tol=bool(torch.allclose(out.float(), plain.float(),
                                                             **TOL[dtype])),
                              kv_len_0_exactly_zero=(q_pos is not None
                                                     or bool((out[0] == 0).all()))))
        flash += [flash_case(dev, seed, 1, t, t, True, window, 0, dtype, MIXTRAL_HEADS)
                  for t in (32, 512, 2048) for window in (0, 128)]
    flash += [flash_case(dev, seed, 1, 2048, 2048, True, 0, 0, torch.bfloat16, MIXTRAL_HEADS,
                         q_scale=8.0)]
    flash_ones = [ones_case(dev, seed + 1, 2048, 128, dtype, MIXTRAL_HEADS)
                  for dtype in (torch.float32, torch.bfloat16)]
    served = rng.integers(32, 513, size=16) + rng.integers(0, 33, size=16)
    timings = {"paged_main_path": time_kernels(dev, seed, 64, served, flush, d),
               "dense_main_path": time_dense_decode(dev, seed, served, flush, MIXTRAL_HEADS),
               "flash_attention": flash_timings(seed, dev, flush, MIXTRAL_HEADS)}
    speed = flash_speed(timings["flash_attention"], MIXTRAL_HEADS)
    emit("mixtral_attention_kernels", paged=paged, decode_attention=dense,
         flash_attention=flash, flash_v_all_ones=flash_ones, timing=timings, flash_speed=speed,
         tol="TOL (f32 rtol=atol=1e-5; bf16 rtol 1.6e-2, atol 2e-3); kv_len 0 rows exactly 0 "
             "without q_pos; B2 and B3 also with the model's q_pos, idle rows 2-4; B4 v all "
             f"ones as in flash_kernels; B4 bf16 <= {FLASH_SPEED_GATE}x SDPA at T=2048; B2 "
             f"bf16 <= {DECODE_SPEED_GATE}x SDPA on paged_main_path",
         note="H=32, Hkv=8, D=128 (mixtral-8x7b FULL); ms: CUDA events, median of 30, L2 "
              "flushed, bf16; paged_main_path: B=16, page 16, kv_len 32..544 in 64-page "
              "tables, q_pos = kv_len - 1; dense_main_path: B3 at the same lengths in a "
              "1024-row cache, against masked SDPA (a reading); flash_attention: B=1, "
              "causal, the 32 served prompt lengths and T=2048")
    bad = ([c for c in dense if not c["within_tol"] or not c["kv_len_0_exactly_zero"]]
           + [c for c in flash if not c["within_tol"]] + [o for o in flash_ones if not o["within"]])
    if bad:
        raise AssertionError(f"attention kernels at mixtral's heads differ: {bad}")
    check_flash_speed(speed, "mixtral heads", keys=("over_sdpa_t2048",))
    check_decode_speed("B2", timings["paged_main_path"]["paged_decode_attention"],
                       "D=128, the main path")
    return timings


def mixtral_smoke_prompts(rng, n: int) -> list:
    """Prompts of 20..40 tokens, past SMOKE's window of 16."""
    return [rng.integers(0, 512, size=int(rng.integers(20, 41))).tolist() for _ in range(n)]


def phase_mixtral_smoke(dev, seed: int) -> None:
    """mixtral SMOKE at f32 (window 16, 4 experts, top 2), dropless and at
    capacity factor 1.25: prefill + ragged decode logits of the kernel path
    on the card against the plain path on the CPU, over pages, and the
    paged batcher's tokens (a pool tight enough to preempt)."""
    out = {}
    for cf in (0.0, 1.25):
        cfg = with_capacity(get_arch(MIXTRAL, smoke=True), cf)
        on_card = build_model(cfg, compute_dtype=torch.float32, device=dev)
        on_cpu = build_model(cfg, compute_dtype=torch.float32, device="cpu", use_kernels=False)
        p_card = on_card.init(torch.Generator().manual_seed(seed))  # drawn on the CPU
        p_cpu = on_cpu.init(torch.Generator().manual_seed(seed))
        b, t, max_len, page = 3, 24, 48, 4
        n_slot = max_len // page
        rng = np.random.default_rng(seed + 31)
        prompt = torch.tensor(rng.integers(0, cfg.vocab_size, size=(b, t)))
        table = torch.tensor((1 + rng.permutation(b * n_slot)).reshape(b, n_slot).astype(np.int32))
        pos = torch.tensor([t, t - 5, t - 1], dtype=torch.int32)
        reset_launches()
        runs = {}
        for name, model, params in (("card", on_card, p_card), ("cpu", on_cpu, p_cpu)):
            d = model.device
            cache = model.init_cache(b, max_len, paged=PagedSpec(1 + b * n_slot, page))
            for layer in cache:
                layer["page_table"] = table.to(d)
            with torch.inference_mode():
                logits, cache = model.prefill(params, {"tokens": prompt.to(d)}, cache,
                                              last_only=True)
            for layer in cache:
                layer["pos"] = pos.to(d)
            runs[name] = [cache, [logits.cpu()]]
        tokens = runs["cpu"][1][0][:, -1].argmax(-1)[:, None]
        for step in range(3):
            for name, model, params in (("card", on_card, p_card), ("cpu", on_cpu, p_cpu)):
                with torch.inference_mode():
                    logits, runs[name][0] = model.decode_step(
                        params, tokens.to(model.device), runs[name][0],
                        (pos + step).to(model.device))
                runs[name][1].append(logits.cpu())
            tokens = runs["cpu"][1][-1][:, -1].argmax(-1)[:, None]
        worst = 0.0
        for a, c in zip(runs["card"][1], runs["cpu"][1]):
            torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)
            worst = max(worst, (a - c).abs().max().item())
        launches = read_launches()
        want = {"moe_gating": 4 * cfg.num_layers, "flash_attention": cfg.num_layers,
                "paged_decode_attention": 3 * cfg.num_layers}
        if {n: launches[n] for n in want} != want:
            raise AssertionError(f"SMOKE launches {launches}, want {want}")

        outputs, counts = [], []
        for model, params in ((on_card, p_card), (on_cpu, p_cpu)):
            bt = ContinuousBatcher(model, params, slots=3, max_len=64,
                                   paged=PagedSpec(num_pages=17, page_size=4))
            reqs = [Request(prompt=pr, max_new_tokens=8)
                    for pr in mixtral_smoke_prompts(np.random.default_rng(seed + 32), 6)]
            for r in reqs:
                bt.submit(r)
            bt.run_until_drained()
            outputs.append([r.output for r in reqs])
            counts.append((bt.preemptions, bt.steps, bt.page_pool.leaked()))
        if outputs[0] != outputs[1] or counts[0] != counts[1]:
            raise AssertionError(f"mixtral SMOKE batcher (capacity factor {cf}) on the card "
                                 f"differs from the CPU: {counts}")
        out[f"capacity_factor_{cf}"] = dict(
            logits_max_abs_diff=worst, launches={n: launches[n] for n in want},
            batcher_tokens_equal=True, preemptions=counts[0][0], ticks=counts[0][1])
    emit("mixtral_smoke", **out, tol="rtol=atol=1e-4 (f32, TF32 off); batcher tokens equal",
         reduced={"config": "SMOKE (d_model 64, 2 layers, 4 experts, window 16)"})


def mixtral_compare(model, params, cfg, seed: int) -> dict:
    """Kernel path against plain path from one set of params: logits at
    every position of a B = 1 prefill of 512 tokens on a linear cache, and
    one paged decode step over 16 slots from one state; B5's routing on
    the kernel path against the plain version's on the plain path; and
    the same logits with the plain path forced onto the kernel path's
    routing (``routing_forced``)."""
    plain = build_model(cfg, compute_dtype=model.compute_dtype, device=model.device,
                        use_kernels=False)
    dev = model.device
    rng = np.random.default_rng(seed + 17)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, size=(1, 512)), device=dev)
    out = {}
    with torch.inference_mode():
        with routing_capture() as k_calls:
            lg, _ = model.prefill(params, {"tokens": prompt}, model.init_cache(1, 1024))
        k_logits = lg[0].float()
        with routing_capture() as p_calls:
            lg, _ = plain.prefill(params, {"tokens": prompt}, plain.init_cache(1, 1024))
        out["prefill"] = compare_logits(k_logits, lg[0].float())
        out["prefill_routing"] = routing_agreement(k_calls["moe_gating"],
                                                   p_calls["moe_gating_ref"])
        with routing_forced(k_calls["moe_gating"]) as seen:
            lg, _ = plain.prefill(params, {"tokens": prompt}, plain.init_cache(1, 1024))
        out["prefill_forced"] = dict(**compare_logits(k_logits, lg[0].float()),
                                     routing=forced_flips(seen))
        del k_logits, lg, k_calls, p_calls, seen

        b, t, max_len, page = 16, 256, 1024, 16
        n_slot = max_len // page
        tokens = torch.tensor(rng.integers(0, cfg.vocab_size, size=(b, t)), device=dev)
        table = torch.tensor((1 + rng.permutation(b * n_slot)).reshape(b, n_slot)
                             .astype(np.int32), device=dev)
        cache = model.init_cache(b, max_len, paged=PagedSpec(1 + b * n_slot, page))
        for layer in cache:
            layer["page_table"] = table
        lg, cache = model.prefill(params, {"tokens": tokens}, cache, last_only=True)
        pos = torch.tensor(rng.integers(1, t + 1, size=b).astype(np.int32), device=dev)
        nxt = lg[:, -1].argmax(-1)[:, None]
        for layer in cache:
            layer["pos"] = pos
        copies = [[{k: v.clone() for k, v in layer.items()} for layer in cache]
                  for _ in range(2)]  # decode steps write into their cache
        with routing_capture() as k_calls:
            k_logits, _ = model.decode_step(params, nxt, cache, pos)
        with routing_capture() as p_calls:
            p_logits, _ = plain.decode_step(params, nxt, copies[0], pos)
        with routing_forced(k_calls["moe_gating"]) as seen:
            f_logits, _ = plain.decode_step(params, nxt, copies[1], pos)
    out["decode"] = compare_logits(k_logits[:, -1].float(), p_logits[:, -1].float())
    out["decode_routing"] = routing_agreement(k_calls["moe_gating"], p_calls["moe_gating_ref"])
    out["decode_forced"] = dict(**compare_logits(k_logits[:, -1].float(), f_logits[:, -1].float()),
                                routing=forced_flips(seen))
    return out


def phase_mixtral_logits_f32(dev, seed: int) -> None:
    """FULL width, 2 layers, f32: max|diff| <= MIXTRAL_F32_TOL * rms(plain),
    every greedy token equal, every B5 call's idx, pos and keep equal to the
    plain path's."""
    cfg = dataclasses.replace(get_arch(MIXTRAL), num_layers=MIXTRAL_F32_LAYERS)
    model = build_model(cfg, compute_dtype=torch.float32, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    r = mixtral_compare(model, params, cfg, seed)
    emit("mixtral_logits_f32", **r, reduced=reduced(MIXTRAL_F32_LAYERS),
         gates=f"max|diff| <= {MIXTRAL_F32_TOL} * rms(plain); greedy tokens all equal; B5 "
               "idx, pos and keep equal to the plain path's in every call (f32, TF32 off)")
    failed = [key for key in ("prefill", "decode")
              if not r[key]["finite"] or r[key]["greedy_equal"] != r[key]["positions"]
              or r[key]["max_abs_diff"] > MIXTRAL_F32_TOL * r[key]["ref_rms"]]
    failed += [key for key in ("prefill_routing", "decode_routing")
               if not r[key]["idx_pos_keep_all_equal"]]
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"mixtral f32 kernel path against plain path fails {failed}: {r}")


def phase_mixtral_serve(model, params, cfg, seed: int) -> dict:
    """The MoE main path (paged serving, as phase_serve), through the
    entry points as a user calls them; B5 must launch (ticks + prefill
    calls) x 16."""
    stats, _ = phase_serve(model, params, cfg, seed, layers=MIXTRAL_LAYERS)
    launches = stats["launches"]["moe_gating"]
    want = (stats["ticks"] + stats["prefill_calls"]) * MIXTRAL_LAYERS
    if launches == 0 or launches != want:
        raise AssertionError(f"moe_gating: {launches} launches for (ticks + prefill calls) x "
                             f"{MIXTRAL_LAYERS} layers = {want}")
    # every weight a decode tick reads: all but the embedding table, of which
    # it gathers 16 rows (the expert products run over every expert)
    weight_bytes = tensor_bytes(params) - tensor_bytes(params["embed"]["tok"])
    stats.update(
        weight_bytes_per_tick=weight_bytes,
        weight_gb_per_s_per_tick=weight_bytes / (stats["decode_ms_per_tick"] / 1e3) / 1e9)
    return stats


def phase_mixtral_profile(model, params, cfg, seed: int, serve: dict) -> tuple:
    """The serving run again, on the same requests, under the profiler and
    with B5's calls captured (references only: no copy, no sync): device
    times and B5's share of them, the dropped expert choices, and the
    router logits (with their capacities) of the first prefill and the
    first four decode ticks for ``moe_kernels``."""
    with routing_capture() as calls:
        prof = profile_serving(full_batcher(model, params), full_requests(cfg, seed))
    main = calls["moe_gating"]
    if len(main) != serve["launches"]["moe_gating"]:
        raise AssertionError(f"the profiled rerun made {len(main)} gating calls, the served "
                             f"run {serve['launches']['moe_gating']}")
    slots, k = 16, cfg.moe.top_k
    decode = [c for c in main if c[0].shape[0] == slots]  # prompts are 32 tokens or more
    prefill = [c for c in main if c[0].shape[0] != slots]
    dropped = [sum(int((~c[2][3]).sum()) for c in decode[i:i + MIXTRAL_LAYERS])
               for i in range(0, len(decode), MIXTRAL_LAYERS)]
    gating = prof["kernels"].get("moe_gating")
    b2 = prof["kernels"].get("paged_decode_attention")
    prof.update(
        paged_decode_attention_ms_per_call=b2["device_ms"] / b2["calls"] if b2 else None,
        paged_decode_attention_ms_per_decode_tick=(b2["device_ms"] / (b2["calls"] / MIXTRAL_LAYERS)
                                                   if b2 else None),
        moe_gating_ms_per_call=gating["device_ms"] / gating["calls"] if gating else None,
        moe_gating_share_of_device_time=(gating["device_ms"] / 1e3 / prof["device_s"]
                                         if gating else None),
        device_s_over_serve_wall=prof["device_s"] / serve["wall_s"],
        dropped_choices_per_tick=dict(mean=statistics.mean(dropped), max=max(dropped),
                                      of=slots * k * MIXTRAL_LAYERS),
        dropped_choices_prefill=dict(total=sum(int((~c[2][3]).sum()) for c in prefill),
                                     of=sum(c[0].shape[0] * k for c in prefill)),
        decode_capacity_per_expert=decode[0][1])
    captured = ([(c[0], c[1], "first prefill") for c in main[:MIXTRAL_LAYERS]]
                + [(c[0], c[1], "decode ticks 1-4") for c in decode[:4 * MIXTRAL_LAYERS]])
    return prof, captured


def moe_work(n: int, e: int, k: int) -> tuple:
    """(bytes, f32 operations) of one B5 call: logits read once, idx,
    gates, pos (4 bytes each) and keep (1 byte) written once; per token
    the max, the exponentials and their sum (4 E), and per rank the
    probabilities again and the comparisons (3 E), then the gates (2 k)."""
    return n * e * 4 + n * k * 13, n * (4 * e + 3 * e * k + 2 * k)


def phase_moe_kernels(dev, seed: int, flush: torch.Tensor, captured: list,
                      ticks: int) -> dict:
    """B5 against its plain version on the card; then CUDA-event times at
    the main path's shapes (the decode call at N = 16 and every served
    prompt length), weighted by their launches in mixtral_serve."""
    cases = []

    def check(logits, k, cap, block_n, **label) -> None:
        got = moe_gating.moe_gating(logits, k, cap, block_n=block_n)
        want = moe_gating.moe_gating_ref(logits, k, cap,
                                         block_n=moe_gating.ops.block_size(logits.shape[0],
                                                                           block_n))
        torch.cuda.synchronize()
        cases.append(dict(
            **label, n=logits.shape[0], e=logits.shape[1], k=k, capacity=cap, block_n=block_n,
            idx_equal=torch.equal(got[0], want[0]), pos_equal=torch.equal(got[2], want[2]),
            keep_equal=torch.equal(got[3], want[3]),
            gates_within_tol=bool(torch.allclose(got[1], want[1], **GATE_TOL)),
            gates_bit_equal=torch.equal(got[1], want[1]),
            max_abs_err=(got[1] - want[1]).abs().max().item(),
            dropped=int((~want[3]).sum())))

    gen = torch.Generator(device=dev).manual_seed(seed + 41)
    for n in (16, 512, 2048):
        logits = torch.randn((n, 8), generator=gen, device=dev)
        for cap in (int(n * 2 * 1.25 / 8), n * 2):
            for bn in sorted({moe_gating.ops.block_size(n, b) for b in (n, 256, 64)}):
                check(logits, 2, cap, bn)
    for n, e, k, cap, bn in MOE_CASES:
        check(torch.randn((n, e), generator=gen, device=dev), k, cap, bn)
    ties = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, -1.0, 0.0, 2.0],
                         [2.0] * 8, [0.5, -1.0, 0.5, 0.5, 0.0, 0.0, 0.0, 0.0]], device=dev)
    check(ties.repeat(64, 1), 2, 40, 64, case="ties")
    tie_idx = moe_gating.moe_gating(ties, 2, 6, block_n=3)[0]
    torch.cuda.synchronize()
    ties_lowest = tie_idx.tolist() == [[1, 2], [0, 1], [0, 2]]
    for logits, cap, label in captured:
        check(logits, 2, cap, logits.shape[0], case=f"main path: {label}")
    bad = [c for c in cases if not (c["idx_equal"] and c["pos_equal"] and c["keep_equal"]
                                    and c["gates_within_tol"])]

    def timing(n: int) -> dict:
        logits = torch.randn((n, 8), generator=gen, device=dev)
        cap = int(n * 2 * 1.25 / 8)
        bnd, by = bound_ms(*moe_work(n, 8, 2), torch.float32)
        return dict(
            kernel_ms=time_ms(lambda: moe_gating.moe_gating(logits, 2, cap, block_n=n), flush),
            plain_ms=time_ms(lambda: moe_gating.moe_gating_ref(logits, 2, cap, block_n=n),
                             flush),
            bound_ms=bnd, bound_by=by)

    lens = prompt_lengths(seed)
    per_n = {16: timing(16), **{int(t): timing(int(t)) for t in sorted(set(lens.tolist()))}}
    weights = [ticks if n == 16 else int((lens == n).sum()) for n in per_n]
    main_path = {key: sum(w * r[key] for w, r in zip(weights, per_n.values())) / sum(weights)
                 for key in ("kernel_ms", "plain_ms", "bound_ms")}
    timings = {"main_path_per_launch": main_path, "decode_n16": per_n[16],
               "n512": timing(512), "n2048": timing(2048),
               "by_n": {str(n): r for n, r in per_n.items()}}
    emit("moe_kernels", cases=cases, ties_lowest_index=ties_lowest, timing=timings,
         tol="idx, pos and keep exactly equal; gates rtol 1e-5, atol 1e-6",
         note="logits f32 N(0,1), E=8, k=2 unless stated; ms: CUDA events, median of 30, L2 "
              "flushed, at capacity int(N*2*1.25/8) and block_n=N as the model calls it; "
              "main_path: mean per launch over mixtral_serve's calls (decode at N=16, "
              "prefill at each prompt length); bound: bytes N*E*4 + N*k*13 at 3.35 TB/s; "
              "library: none (no single PyTorch call computes B5: softmax then topk "
              "leaves out the FCFS positions, and topk's order on ties is unspecified)")
    if bad or not ties_lowest:
        raise AssertionError(f"moe_gating differs from its plain version: {bad}, "
                             f"ties {tie_idx.tolist()}")
    return dict(kernel_ms=main_path["kernel_ms"], plain_ms=main_path["plain_ms"],
                bound_ms=main_path["bound_ms"], bound_by="bytes", library_ms=None,
                max_abs_err=max(c["max_abs_err"] for c in cases))


def check_mixtral_logits(r: dict) -> None:
    """bf16, 16 layers: the greedy token equal wherever the plain top-two
    margin exceeds 2 max|diff|; and, with the plain path forced onto the
    kernel path's routing, the logits within LOGIT_TOL, as llama's are.
    Free-running, the differences and the routing agreement are readings:
    in bf16 a near-tie in the router may flip one expert choice and change
    the token's later layers wholesale."""
    failed = [key for key in ("prefill", "decode", "prefill_forced", "decode_forced")
              if not r[key]["finite"]
              or r[key]["greedy_equal_where_clear"] != r[key]["clear_positions"]]
    failed += [key for key in ("prefill_forced", "decode_forced")
               if r[key]["max_abs_diff"] > LOGIT_TOL["max_abs"] * r[key]["ref_rms"]
               or r[key]["rms_diff"] > LOGIT_TOL["rms"] * r[key]["ref_rms"]]
    if failed:
        raise AssertionError(f"mixtral bf16 kernel path against plain path fails {failed}: {r}")


def run_mixtral(dev, seed: int, smi: str, started: float) -> tuple:
    """Every mixtral phase, in order; returns B5's row and its launches on
    the main path (mixtral_serve)."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    phase_mixtral_attention(dev, seed, flush)
    del flush
    phase_mixtral_smoke(dev, seed)
    phase_mixtral_logits_f32(dev, seed)
    xcfg = dataclasses.replace(get_arch(MIXTRAL), num_layers=MIXTRAL_LAYERS)
    xmodel = build_model(xcfg)  # bf16 on the card (f32 router), kernels on
    t0 = time.perf_counter()
    xparams = xmodel.init(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    xserve = phase_mixtral_serve(xmodel, xparams, xcfg, seed)
    emit("mixtral_serve", init_s=init_s, **xserve, reduced=reduced(MIXTRAL_LAYERS),
         weight_gb=tensor_bytes(xparams) / 1e9, nvidia_smi=smi,
         note="ContinuousBatcher(slots=16, max_len=1024, page 16), 32 requests of 32-512 "
              "prompt tokens and 32 new tokens, random bf16 weights; "
              "weight_gb_per_s_per_tick: weight bytes a decode tick reads over its median time")
    xprof, captured = phase_mixtral_profile(xmodel, xparams, xcfg, seed, xserve)
    emit("mixtral_profile", **xprof, reduced=reduced(MIXTRAL_LAYERS),
         note="the mixtral_serve requests again under torch.profiler, B5's calls captured; "
              "dropped choices count keep == False")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    row = phase_moe_kernels(dev, seed, flush, captured, xserve["ticks"])
    del flush, captured
    xlogits = mixtral_compare(xmodel, xparams, xcfg, seed)
    emit("mixtral_logits", **xlogits, reduced=reduced(MIXTRAL_LAYERS),
         gates="greedy equal wherever the plain top-2 margin exceeds 2 max|diff| (bf16); "
               f"forced routing: max|diff| <= {LOGIT_TOL['max_abs']} * rms(plain), rms(diff) "
               f"<= {LOGIT_TOL['rms']} * rms(plain); free-running max|diff|, rms(diff) and "
               "routing agreement, and the forced runs' own-routing flips, are readings",
         elapsed_s=time.perf_counter() - started)
    check_mixtral_logits(xlogits)
    del xmodel, xparams
    gc.collect()
    torch.cuda.empty_cache()
    return row, xserve["launches"]["moe_gating"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # references in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    started = time.perf_counter()
    smi, ptxas = phase_build()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    rows = phase_kernels(dev, args.seed, flush)
    rows["flash_attention"] = phase_flash_kernels(dev, args.seed, flush)
    rows["decode_attention"] = phase_dense_decode_kernels(dev, args.seed, flush)
    rows["ssd_chunked"] = phase_ssd_kernels(dev, args.seed, flush, ptxas.get("ssd_chunked"))
    del flush
    phase_smoke(dev, args.seed)

    cfg = get_arch("llama3.2-1b")
    model = build_model(cfg)  # bf16 on the card, kernels on
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    serve, paged_outputs = phase_serve(model, params, cfg, args.seed)
    logits = phase_logits(model, params, cfg, args.seed)
    emit("serve", init_s=init_s, **serve, logits_kernel_vs_plain=logits,
         logits_tol=f"max|diff| <= {LOGIT_TOL['max_abs']} * rms(plain), rms(diff) <= "
                    f"{LOGIT_TOL['rms']} * rms(plain), greedy agreement 1.0 (bf16)")
    check_logits(logits)
    prof = phase_profile(model, params, cfg, args.seed)
    # the same requests ran unprofiled in the serve phase: device time of
    # the trace over that run's wall time estimates its device busy share
    prof["device_s_over_serve_wall"] = prof["device_s"] / serve["wall_s"]
    emit("profile", **prof)
    dense = phase_dense_serve(model, params, cfg, args.seed, paged_outputs)
    emit("dense_serve", **dense,
         note="dense ContinuousBatcher(slots=16, max_len=1024): B4 in every prefill, B3 in "
              "every decode tick; agreement_with_paged is a reading, not a gate")
    dense_logits = phase_logits(model, params, cfg, args.seed, paged=False)
    emit("dense_logits", **dense_logits, logits_tol="as in serve")
    check_logits(dense_logits)
    prefill_logits = phase_prefill_logits(model, params, cfg, args.seed)
    emit("prefill_logits", **prefill_logits,
         gates=f"max|diff| <= {LOGIT_TOL['max_abs']} * rms(plain), rms(diff) <= "
               f"{LOGIT_TOL['rms']} * rms(plain), greedy equal wherever the plain top-2 "
               "margin exceeds 2 max|diff| (bf16, B=1, every position)")
    check_prefill_logits(prefill_logits)
    del model, params
    gc.collect()  # the profile's batcher and its counting wrapper form a cycle
    torch.cuda.empty_cache()

    phase_mamba_smoke(dev, args.seed)
    mcfg = get_arch(MAMBA)
    mmodel = build_model(mcfg)  # bf16 on the card (f32 dt_bias, A_log, D), kernels on
    t0 = time.perf_counter()
    mparams = mmodel.init(torch.Generator(device=dev).manual_seed(args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mserve = phase_mamba_serve(mmodel, mparams, mcfg, args.seed)
    emit("mamba_serve", init_s=init_s, **mserve)
    mlogits = phase_mamba_logits(mmodel, mparams, mcfg, args.seed)
    emit("mamba_logits", **mlogits, gates=MAMBA_GATES,
         note="f32 and bf16_2layers: rms(diff) <= rms * rms(plain) (and max|diff| <= "
              "max_abs * rms(plain) in f32); greedy tokens equal wherever the plain top-2 "
              "margin exceeds 2 max|diff|, at >= clear_share of the positions.  bf16 (48 "
              "layers): rms(diff) <= bf16_spread * rms(plain chunk 32 - plain chunk 64)")
    check_mamba_logits(mlogits)
    mprof = profile_serving(dense_batcher(mmodel, mparams), full_requests(mcfg, args.seed))
    ssd = mprof["kernels"].get("ssd_chunked")
    mprof["ssd_chunked_ms_per_call"] = ssd["device_ms"] / ssd["calls"] if ssd else None
    mprof["device_s_over_serve_wall"] = mprof["device_s"] / mserve["wall_s"]
    emit("mamba_profile", **mprof, elapsed_s=time.perf_counter() - started)
    del mmodel, mparams
    gc.collect()
    torch.cuda.empty_cache()

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows["tcmm_assign"] = phase_tcmm_kernels(dev, args.seed, flush)
    del flush
    pipe = phase_tcmm_pipeline(dev, args.seed)
    pipe["b7_share_of_card_wall"] = {  # launches x kernel time over the card run's wall
        when: pipe["launches"] * rows["tcmm_assign"][key] / 1e3 / pipe["card"]["wall_s"]
        for when, key in (("l2_flushed", "kernel_ms"), ("l2_warm", "kernel_ms_l2_warm"))}
    emit("tcmm_pipeline", **pipe, nvidia_smi=smi, elapsed_s=time.perf_counter() - started)

    rows["moe_gating"], moe_launches = run_mixtral(dev, args.seed, smi, started)

    main_path_launches = {**{n: serve["launches"][n] for n in LLAMA_KERNELS},
                          **{n: dense["launches"][n]
                             for n in ("decode_attention", "flash_attention")},
                          "ssd_chunked": mserve["launches"]["ssd_chunked"],
                          "tcmm_assign": pipe["launches"],
                          "moe_gating": moe_launches}
    kernels = []
    for name, meta in KERNELS.items():
        r = rows[name]
        kernels.append(dict(name=name, route="cuda", source=meta["source"],
                            replaces=meta["replaces"], launches=main_path_launches[name],
                            max_abs_err=r["max_abs_err"], ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
