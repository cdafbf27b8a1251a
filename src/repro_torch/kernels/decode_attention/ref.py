"""Plain PyTorch versions of the paged decode kernels.

Each function here computes what its CUDA kernel computes, with
ordinary tensor ops.  The CPU path of ``ops.py`` runs them, the CPU
tests hold them against the reference package, and the on-card smoke
run holds each kernel against them on the same inputs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def decode_attention_ref(
    q: torch.Tensor,        # [B, H, D] one query token per sequence
    k_cache: torch.Tensor,  # [B, S, Hkv, D]
    v_cache: torch.Tensor,  # [B, S, Hkv, D]
    kv_len: torch.Tensor,   # [B] valid prefix lengths
    window: int = 0,
    sm_scale: Optional[float] = None,
    q_pos: Optional[torch.Tensor] = None,  # [B] the query's position
) -> torch.Tensor:
    """Keys p < kv_len; with ``window`` also p > q_pos - window, and with
    ``q_pos`` also p <= q_pos.  Without ``q_pos`` the query sits at
    kv_len - 1, and a row with no key (kv_len 0) is exactly zero, as in the
    TPU kernel.  With ``q_pos`` a row is masked as the model's plain
    attention masks it (``layers._dense_attention``): causal at the query's
    own position, which for an idle batcher slot need not be kv_len - 1,
    and a row with no key left attends uniformly to all S rows, as a
    softmax over an all-masked row does."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, g, d).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * scale
    pos = torch.arange(s, device=q.device)[None, :]
    kl = kv_len.to(torch.int64)[:, None]
    qp = kl - 1 if q_pos is None else q_pos.to(torch.int64)[:, None]
    mask = (pos < kl) & (pos <= qp)
    if window > 0:
        mask = mask & (pos > qp - window)
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    if q_pos is None:
        # kv_len == 0 (fresh slot): no valid position exists, so the output
        # is exactly zero, as the kernel's running softmax never
        # accumulates anything.
        any_valid = mask.any(dim=-1)[:, None, None, None]
        out = torch.where(any_valid, out, 0.0)
    return out.reshape(b, h, d).to(q.dtype)


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Materialize the dense per-sequence cache a page table describes.

    pages [P, page, Hkv, D] + table [B, n] -> [B, n*page, Hkv, D]."""
    b, n = page_table.shape
    page = pages.shape[1]
    dense = pages[page_table.long()]  # [B, n, page, Hkv, D]
    return dense.reshape(b, n * page, *pages.shape[2:])


def paged_decode_attention_ref(
    q: torch.Tensor,           # [B, H, D]
    k_pages: torch.Tensor,     # [P, page, Hkv, D]
    v_pages: torch.Tensor,     # [P, page, Hkv, D]
    page_table: torch.Tensor,  # [B, n] int
    kv_len: torch.Tensor,      # [B] int
    window: int = 0,
    sm_scale: Optional[float] = None,
    q_pos: Optional[torch.Tensor] = None,  # [B] int
) -> torch.Tensor:
    """``decode_attention_ref`` over the dense view of each sequence's
    table row: S = n_pages * page rows."""
    k_dense = gather_pages(k_pages, page_table)
    v_dense = gather_pages(v_pages, page_table)
    return decode_attention_ref(
        q, k_dense, v_dense, kv_len, window=window, sm_scale=sm_scale, q_pos=q_pos
    )


def paged_kv_append_ref(
    k_new: torch.Tensor,       # [B, Hkv, D]
    v_new: torch.Tensor,       # [B, Hkv, D]
    k_pages: torch.Tensor,     # [P, page, Hkv, D] updated in place
    v_pages: torch.Tensor,     # [P, page, Hkv, D] updated in place
    page_table: torch.Tensor,  # [B, n] int
    pos: torch.Tensor,         # [B] int write positions
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write row ``pos[b] % page`` of page ``page_table[b, pos[b] // page]``
    for every sequence, in place, and return the two pools.  A row that
    several sequences name (idle slots on scratch page 0) takes the last
    one's values, as the reference's indexed update leaves it: every
    writer of the row writes those values, so the order of the stores
    does not matter on any device."""
    page = k_pages.shape[1]
    rows = torch.arange(k_new.shape[0], device=k_new.device)
    pos = pos.long()
    target_page = page_table.long()[rows, pos // page]  # [B]
    offset = pos % page
    flat = target_page * page + offset
    last = torch.where(flat[:, None] == flat[None, :], rows[None, :], -1).amax(dim=1)
    k_pages[target_page, offset] = k_new[last].to(k_pages.dtype)
    v_pages[target_page, offset] = v_new[last].to(v_pages.dtype)
    return k_pages, v_pages
