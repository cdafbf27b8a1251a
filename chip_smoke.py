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
  ssd_kernels
           the SSD scan kernel against its plain version at mamba2-370m
           FULL heads (H=32, P=64, N=128, chunk 64), B in {1, 4}, T=2048,
           B and C in bf16 and f32, with and without an initial state;
           then CUDA-event times of kernel and plain version beside the
           bound, at T=2048 and at the mamba_serve phase's prompt lengths.
  smoke    llama3.2-1b SMOKE at f32: prefill + ragged decode logits of the
           kernel path on the card against the plain path on the CPU, and
           the paged batcher's tokens on the card against the CPU's.
  serve    the main path: llama3.2-1b FULL (16 layers, seeded random bf16
           weights) behind ContinuousBatcher(slots=16, max_len=1024,
           page 16) on 32 requests (prompts of 32-512 tokens, 32 new tokens
           each).  The launch counters are zeroed just before the run and
           read just after; each must equal decode ticks x 16 layers.
           Then one decode step's logits, kernel path against plain path.
  profile  the same serving run again under torch.profiler: device time
           of each kernel, the decode kernel's HBM bandwidth, the device's
           busy share.
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
Then the per-kernel JSON line, the nvidia-smi line, and the result line.
Exits non-zero, printing no result, without a CUDA device; any failed
check raises.
"""

from __future__ import annotations

import argparse
import dataclasses
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
from repro_torch.kernels import build, ssd_scan, tcmm_assign  # noqa: E402
from repro_torch.kernels.decode_attention import ops, ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
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
# bf16 before the value product, as the reference does; the kernel keeps
# them in f32.  That difference, carried through 16 layers, read 0.086
# (max) and 0.0157 (RMS) of the RMS with seed 0; the limits are about 2x.
LOGIT_TOL = dict(max_abs=0.2, rms=0.03)
KERNELS = {
    "paged_kv_append": dict(
        source="src/repro_torch/kernels/decode_attention/csrc/paged_kv_append.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:302",
        signature=ops.SIGNATURES["paged_kv_append"]),
    "paged_decode_attention": dict(
        source="src/repro_torch/kernels/decode_attention/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:209",
        signature=ops.SIGNATURES["paged_decode_attention"]),
    "ssd_chunked": dict(
        source="src/repro_torch/kernels/ssd_scan/csrc/ssd_chunked.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:88",
        signature=ssd_scan.ops.SIGNATURES["ssd_chunked"]),
    "tcmm_assign": dict(
        source="src/repro_torch/kernels/tcmm_assign/csrc/tcmm_assign.cu",
        replaces="src/repro/kernels/tcmm_assign/kernel.py:52",
        signature=tcmm_assign.ops.SIGNATURES["tcmm_assign"]),
}
LLAMA_KERNELS = ("paged_kv_append", "paged_decode_attention")
LAYERS = 16
MAMBA_LAYERS = 48


def reset_launches() -> None:
    ops.reset_launches()
    ssd_scan.reset_launches()
    tcmm_assign.reset_launches()


def read_launches() -> dict:
    return {**ops.LAUNCHES, **ssd_scan.LAUNCHES, **tcmm_assign.LAUNCHES}


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


def decode_inputs(dtype, seed: int, dev, n_pages: int, kv_len: np.ndarray):
    """llama3.2-1b FULL attention widths: B=16, Hkv=8, G=4, D=64, page 16;
    each sequence owns n_pages shuffled pages, and one with kv_len 0
    keeps an all-zero table row, as an idle batcher slot does."""
    b, hkv, g, d, page = 16, 8, 4, 64, 16
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


def append_inputs(dtype, seed: int, dev, n_pages: int, kv_len: np.ndarray):
    _, kp, vp, table, lens = decode_inputs(dtype, seed, dev, n_pages, kv_len)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    b, hkv, d = lens.shape[0], kp.shape[2], kp.shape[3]
    k_new = torch.randn((b, hkv, d), generator=gen, device=dev).to(dtype)
    v_new = torch.randn((b, hkv, d), generator=gen, device=dev).to(dtype)
    pos = lens.clamp(max=n_pages * kp.shape[1] - 1)  # write where the next token goes
    return k_new, v_new, kp, vp, table, pos


def check_parity(dev, seed: int, kv_len: np.ndarray) -> list:
    """Each kernel against its plain version, bf16 and f32; raises on a
    difference beyond TOL (decode) or any difference (append)."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        q, kp, vp, table, lens = decode_inputs(dtype, seed, dev, 128, kv_len)
        for window in (0, 256):
            out = ops.paged_decode_attention(q, kp, vp, table, lens, window=window)
            plain = ref.paged_decode_attention_ref(q, kp, vp, table, lens, window=window)
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), plain.float(), **TOL[dtype])
            if not torch.all(out[kv_len == 0] == 0):
                raise AssertionError("kv_len == 0 must give exactly zero")
            err = out.float() - plain.float()
            cases.append(dict(kernel="paged_decode_attention", dtype=str(dtype), window=window,
                              max_abs_err=err.abs().max().item(),
                              rms_err_over_rms=(err.pow(2).mean()
                                                / plain.float().pow(2).mean()).sqrt().item()))
        k_new, v_new, kp, vp, table, pos = append_inputs(dtype, seed + 1, dev, 128, kv_len)
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


def time_kernels(dev, seed: int, n_pages: int, kv_len: np.ndarray, flush) -> dict:
    """bf16 times of each kernel, its plain version and one library call,
    with the bound computed from these inputs."""
    dtype, rows = torch.bfloat16, {}
    q, kp, vp, table, lens = decode_inputs(dtype, seed, dev, n_pages, kv_len)
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
    rows["paged_decode_attention"] = dict(
        kernel_ms=time_ms(lambda: ops.paged_decode_attention(q, kp, vp, table, lens), flush),
        plain_ms=time_ms(lambda: ref.paged_decode_attention_ref(q, kp, vp, table, lens), flush),
        library_ms=time_ms(lambda: sdpa(q4, kd, vd, attn_mask=mask), flush),
        bound_ms=bnd, bound_by=by, bytes=int(n_bytes))
    del kd, vd

    k_new, v_new, kp, vp, table, pos = append_inputs(dtype, seed + 1, dev, n_pages, kv_len)
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
         note="bf16 times in ms (CUDA events, median of 30, L2 flushed) at B=16 Hkv=8 G=4 "
              "D=64 page=16; library: SDPA over the pre-gathered dense view / two "
              "index_copy_ calls")
    rows = timings["main_path"]
    for name in LLAMA_KERNELS:
        rows[name]["max_abs_err"] = max(c["max_abs_err"] for c in cases
                                        if c["kernel"] == name and c["dtype"] == "torch.bfloat16")
    return rows


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
    emit("smoke", logits_max_abs_diff=worst, tol="rtol=atol=1e-4 (f32, TF32 off)",
         batcher_tokens_equal=True, preemptions=counts[0][0], ticks=counts[0][1])


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


def phase_serve(model, params, cfg, seed: int) -> tuple:
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
    reset_launches()                          # main path: counters from zero
    t0 = time.perf_counter()
    decoded = batcher.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()                # read right after the run

    if len(batcher.completed) != len(reqs):
        raise AssertionError(f"{len(batcher.completed)} of {len(reqs)} requests completed")
    for r in reqs:
        if r.fail_reason is not None or len(r.output) != 32:
            raise AssertionError(f"request {r.req_id}: {r.fail_reason}, {r.output}")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.req_id}: token out of range")
    if batcher.page_pool.leaked() != 0 or batcher.page_pool.in_use != 0:
        raise AssertionError("pages leaked")
    for name in LLAMA_KERNELS:
        if launches[name] == 0 or launches[name] != batcher.steps * LAYERS:
            raise AssertionError(
                f"{name}: {launches[name]} launches for {batcher.steps} ticks x {LAYERS} layers")
    stats = dict(
        requests=len(reqs), ticks=batcher.steps, decoded_tokens=decoded,
        launches=launches, preemptions=batcher.preemptions,
        leaked_pages=batcher.page_pool.leaked(),
        page_high_watermark=batcher.page_pool.high_watermark,
        decode_tokens_per_s=decoded / sum(decode_s),
        decode_ms_per_tick=1e3 * statistics.median(decode_s),
        prefill_ms_per_request=1e3 * statistics.mean(prefill_s),
        end_to_end_tokens_per_s=sum(len(r.output) for r in reqs) / wall, wall_s=wall,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    return stats


def phase_logits(model, params, cfg, seed: int) -> dict:
    """One decode step, kernel path against plain path, from one state."""
    plain = build_model(cfg, compute_dtype=model.compute_dtype, device=model.device,
                        use_kernels=False)
    b, t, max_len, page = 16, 256, 1024, 16
    n_slot = max_len // page
    spec = PagedSpec(num_pages=1 + b * n_slot, page_size=page)
    rng = np.random.default_rng(seed + 7)
    dev = model.device
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, size=(b, t)), device=dev)
    table = torch.tensor((1 + rng.permutation(b * n_slot)).reshape(b, n_slot).astype(np.int32),
                         device=dev)
    cache = model.init_cache(b, max_len, paged=spec)
    for layer in cache:
        layer["page_table"] = table
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
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        batcher.run_until_drained()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    return dict(ticks=batcher.steps, **device_times(prof, wall))


def device_times(prof, wall: float) -> dict:
    """Device time of a profiled run, by kernel and in all."""
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
        for name in KERNELS:
            if f"{name}_kernel" in evt.key:
                per_kernel[name] = dict(calls=evt.count, device_ms=us / 1e3)
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


def mamba_batcher(model, params):
    return ContinuousBatcher(model, params, slots=16, max_len=1024)  # dense mode


def phase_mamba_serve(model, params, cfg, seed: int) -> dict:
    warm = mamba_batcher(model, params)
    for r in full_requests(cfg, seed + 100)[:2]:
        r.max_new_tokens = 4
        warm.submit(r)
    warm.run_until_drained()
    del warm

    batcher = mamba_batcher(model, params)
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

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_tcmm_pipeline(points, dev, n_points)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key[:60])
                   for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                  reverse=True)[:10]
    return dict(**device_times(prof, wall),
                host_top_self_cpu_ms=[dict(ms=ms, calls=n, name=k) for ms, n, k in host])


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
    rows["ssd_chunked"] = phase_ssd_kernels(dev, args.seed, flush, ptxas.get("ssd_chunked"))
    del flush
    phase_smoke(dev, args.seed)

    cfg = get_arch("llama3.2-1b")
    model = build_model(cfg)  # bf16 on the card, kernels on
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    serve = phase_serve(model, params, cfg, args.seed)
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
    mprof = profile_serving(mamba_batcher(mmodel, mparams), full_requests(mcfg, args.seed))
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

    main_path_launches = {**{n: serve["launches"][n] for n in LLAMA_KERNELS},
                          "ssd_chunked": mserve["launches"]["ssd_chunked"],
                          "tcmm_assign": pipe["launches"]}
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
