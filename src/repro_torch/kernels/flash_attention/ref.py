"""Plain PyTorch version of the flash attention kernel.

A copy of the reference oracle
(src/repro/kernels/flash_attention/ref.py::attention_ref) with two
changes.  It takes no ``kv_len``: the kernel has none, and every caller
passes the valid keys alone.  And a query row that no key may attend (every key masked) comes out
as exactly zero, as the kernel's running softmax leaves it
(src/repro/kernels/flash_attention/kernel.py:95-96) and as the Pallas
kernel does.  The oracle's bare softmax would instead return the mean
of all values for such a row.  Rows with at least one key agree with
the oracle.  The CPU path of ``ops.py`` runs it, the CPU tests hold it
against the reference, and the on-card smoke run holds the kernel
against it on the same inputs.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,  # [B, S, Hkv, D]
    causal: bool = True,
    window: int = 0,
    sm_scale: Optional[float] = None,
    q_offset: int = 0,  # absolute position of q[:, 0]
) -> torch.Tensor:
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)

    qg = q.reshape(b, t, hkv, g, d).float()
    logits = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * scale

    q_pos = q_offset + torch.arange(t, device=q.device)[:, None]  # [t, 1]
    kv_pos = torch.arange(s, device=q.device)[None, :]  # [1, s]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kv_pos <= q_pos)
    if window > 0:
        mask = mask & (kv_pos > q_pos - window)
    mask = mask[None, None, None, :, :]
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", p, v.float())
    any_valid = mask.any(dim=-1).permute(0, 3, 1, 2)[..., None]  # [1, t, 1, 1, 1]
    out = torch.where(any_valid, out, 0.0)
    return out.reshape(b, t, h, d).to(q.dtype)
