"""Public wrapper for the flash attention kernel: validation, dispatch
and the launch count.

Dispatch follows the tensors' device.  CPU tensors go to the plain
PyTorch version in ``ref.py``; CUDA tensors launch the hand-written
kernel in ``csrc/flash_attention.cu`` (built by ``kernels/build.py``) or
raise.  There is no fallback: a kernel that fails to build or launch
raises, and nothing is copied to the CPU.  The kernel has two
instantiations: float32 runs on the CUDA cores (f32 FMAs, as TF32 would
miss f32's tolerance), bfloat16 on the tensor cores (``mma.sync`` with
bf16 operands and f32 sums; the weights go to the value product as two
bf16 terms, about 16 bits, since rounded to bf16 alone they move a short
row's output past the bfloat16 tolerance).

Validation keeps the reference wrapper's
(src/repro/kernels/flash_attention/ops.py:32-37): q, k and v are 4-D, k
and v share a shape, and the query heads are a multiple of the KV heads.
The port adds: batch and head size shared by q and k, and on CUDA one
dtype (float32 or bfloat16), contiguous operands and a head size the
kernel is built for, and for bfloat16 16-byte aligned operands (its
copies move 16 bytes).  The Pallas kernel takes its tile sizes as
arguments and asserts that T and S are multiples of them
(kernel.py:114-115); this kernel masks the ragged edges.

``LAUNCHES`` counts kernel launches.  Only a launch on the card counts;
the plain CPU path does not.
"""

from __future__ import annotations

import ctypes as _c
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

LAUNCHES = {"flash_attention": 0}

# argtypes of the C entry point: pointers and the stream as c_void_p.
SIGNATURES = {
    "flash_attention": [
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # q k v out
        _c.c_int, _c.c_int, _c.c_int, _c.c_int,              # dtype B T S
        _c.c_int, _c.c_int, _c.c_int,                        # H Hkv D
        _c.c_int, _c.c_int, _c.c_int,                        # causal window q_offset
        _c.c_float, _c.c_void_p,                             # sm_scale stream
    ],
}

# dtype codes of the C entry point
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# head sizes the kernel is instantiated for: llama3.2-1b and mixtral-8x7b
# SMOKE (16), llama3.2-1b FULL (64), mixtral-8x7b FULL (128)
HEAD_DIMS = (16, 64, 128)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_cuda_operands(q, k, v) -> None:
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtype mismatch: q {q.dtype}, k {k.dtype}, v {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head size {q.shape[3]} not in {HEAD_DIMS}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("bfloat16 q, k and v must be 16-byte aligned")


def flash_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,  # [B, S, Hkv, D]
    causal: bool = True,
    window: int = 0,
    sm_scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """GQA attention forward -> [B, T, H, D] in q's dtype.  Query row i sits
    at position ``q_offset + i``, key row j at position j; a row with no
    key left by the masks is exactly zero."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q,k,v must be [B, T|S, H|Hkv, D]")
    if k.shape != v.shape:
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs {tuple(v.shape)}")
    if q.shape[2] % k.shape[2] != 0:
        raise ValueError("num_heads must be a multiple of num_kv_heads")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} must share batch and head size")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError(f"tensors on different devices: {dev}, {k.device}, {v.device}")
    if dev.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, sm_scale=sm_scale,
                             q_offset=q_offset)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: expected cpu or cuda")

    _check_cuda_operands(q, k, v)
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    fn = build.load("flash_attention", SIGNATURES["flash_attention"])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             _DTYPE_CODE[q.dtype], b, t, s, h, hkv, d, int(bool(causal)), int(window),
             int(q_offset), float(scale), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError_t {err}")
    LAUNCHES["flash_attention"] += 1
    return out
