"""Public wrapper for the fused MoE gating kernel (B5): validation,
dispatch and the launch count.

Dispatch follows the logits' device.  CPU tensors go to the plain PyTorch
version in ``ref.py``; CUDA tensors launch the hand-written kernel in
``csrc/moe_gating.cu`` (built by ``kernels/build.py``) or raise.  There is
no fallback: a kernel that fails to build or launch raises, and nothing is
copied to the CPU.

The contract is the reference wrapper's
(src/repro/kernels/moe_gating/ops.py:14-36) without ``interpret``: ``top_k
<= E``, and ``block_n`` is halved until it divides N.  ``block_n`` is part
of what the function computes: with k > 1 the positions depend on it, and
only ``block_n >= N`` gives the reference model's ``_fcfs_positions``.  On
CUDA the kernel takes contiguous f32 logits with E <= 128 and top_k <= 8;
anything else raises here.

``LAUNCHES`` counts kernel launches.  Only a launch on the card counts; the
plain CPU path does not.
"""

from __future__ import annotations

import ctypes as _c
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.moe_gating.ref import moe_gating_ref

LAUNCHES = {"moe_gating": 0}

# argtypes of the C entry point: pointers and the stream as c_void_p.
SIGNATURES = {
    "moe_gating": [
        _c.c_void_p, _c.c_void_p, _c.c_void_p,  # logits idx gates
        _c.c_void_p, _c.c_void_p,               # pos keep
        _c.c_int, _c.c_int, _c.c_int,           # N E K
        _c.c_int, _c.c_int, _c.c_void_p,        # capacity block_n stream
    ],
}

# the kernel's shared-memory counters and register arrays
MAX_EXPERTS = 128
MAX_TOP_K = 8


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def block_size(n: int, block_n: int) -> int:
    """``block_n`` capped at N and halved until it divides N (at least 1)."""
    bn = max(1, min(block_n, n))
    while n % bn != 0:
        bn //= 2
    return max(bn, 1)


def moe_gating(
    logits: torch.Tensor,  # [N, E]
    top_k: int,
    capacity: int,
    block_n: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (expert idx [N, k] i32, gates [N, k] f32 renormalised,
    capacity positions [N, k] i32, keep [N, k] bool)."""
    if logits.ndim != 2:
        raise ValueError(f"logits must be [N, E], got {tuple(logits.shape)}")
    n, e = logits.shape
    if not 1 <= top_k <= e:
        raise ValueError(f"top_k={top_k} must be in [1, num_experts={e}]")
    if block_n < 1:
        raise ValueError(f"block_n must be positive, got {block_n}")
    bn = block_size(n, block_n)
    dev = logits.device
    if dev.type == "cpu":
        return moe_gating_ref(logits, top_k, capacity, bn)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: expected cpu or cuda")

    if logits.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32 logits, got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    if e > MAX_EXPERTS or top_k > MAX_TOP_K:
        raise ValueError(f"the kernel takes E <= {MAX_EXPERTS} and top_k <= {MAX_TOP_K}, "
                         f"got E={e}, top_k={top_k}")
    idx = torch.empty((n, top_k), dtype=torch.int32, device=dev)
    gates = torch.empty((n, top_k), dtype=torch.float32, device=dev)
    pos = torch.empty((n, top_k), dtype=torch.int32, device=dev)
    keep = torch.empty((n, top_k), dtype=torch.bool, device=dev)
    if n == 0:
        return idx, gates, pos, keep
    fn = build.load("moe_gating", SIGNATURES["moe_gating"])
    err = fn(logits.data_ptr(), idx.data_ptr(), gates.data_ptr(), pos.data_ptr(),
             keep.data_ptr(), n, e, top_k, int(capacity), bn,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_gating kernel launch failed: cudaError_t {err} "
                           f"(N={n}, E={e}, k={top_k}, block_n={bn})")
    LAUNCHES["moe_gating"] += 1
    return idx, gates, pos, keep
