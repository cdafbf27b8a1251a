"""Layer library of the dense decoder: RMSNorm, RoPE, GQA attention over
a paged or linear KV cache, SwiGLU MLP, embeddings.

Attention routes (``attention``):
  * a fresh prefill (``fresh_prefill``: every row starts at position 0 on
    an empty cache) of more than one token with ``use_kernels``: the
    chunk is written to the cache, then the flash attention kernel (B4)
    attends over the chunk's own keys, causal from position 0;
  * a decode step (one token) with ``use_kernels``: the dense decode
    kernel (B3) over a linear cache, the paged append and decode kernels
    (B1, B2) over a paged one;
  * anything else: the chunk is written to the cache and
    ``_dense_attention`` attends over it, the reference semantics.

Plain functions over dicts of tensors, in the reference package's
layouts (``wq [d, h, hd]``, ``wo [h, hd, d]``, caches ``[P, page, Hkv,
hd]``), so each function can be held against its counterpart.  Norm
statistics, attention scores and softmax, and the final logits are f32
whatever the working dtype.

Caches are updated in place (the K/V page pools, the linear cache rows);
each call returns the cache dict with its new ``pos``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ArchConfig, AttentionKind, LayerSpec
from repro_torch.kernels.decode_attention import (
    decode_attention,
    gather_pages,
    paged_decode_attention,
    paged_kv_append,
)
from repro_torch.kernels.flash_attention import flash_attention

Params = Dict[str, Any]
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class PagedSpec:
    """Layout of the shared KV page pool (per attention layer).

    ``num_pages`` counts the whole pool including page 0, which is
    reserved as a scratch page: inactive batcher slots keep an all-zero
    page table, so their masked-out garbage writes land in page 0 and can
    never corrupt a live slot's cache.  Real slots are only ever handed
    pages >= 1 by the serving ``PagePool``.
    """

    num_pages: int
    page_size: int = 16

    def __post_init__(self):
        if self.page_size <= 0:
            raise ValueError(f"page_size must be positive, got {self.page_size}")
        if self.num_pages < 2:
            raise ValueError(
                "num_pages must be >= 2 (page 0 is the reserved scratch page)"
            )

    def pages_per_slot(self, max_len: int) -> int:
        return -(-max_len // self.page_size)


# ---------------------------------------------------------------------------
# init helpers: draws on the generator's device, then moves and casts
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * std).to(device=device, dtype=dtype)


def dense_init(gen, shape: Tuple[int, ...], dtype, device, fan_in: int) -> torch.Tensor:
    return _normal(gen, shape, 1.0 / math.sqrt(max(fan_in, 1)), dtype, device)


def embed_init(gen, shape: Tuple[int, ...], dtype, device) -> torch.Tensor:
    return _normal(gen, shape, 0.02, dtype, device)


# ---------------------------------------------------------------------------
# norms / rotary
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with the ``1 + weight`` scale (weights start at zero)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         head_dim: int) -> torch.Tensor:
    """Rotary embedding, split-halves form. x: [B, T, H, D], positions: [B, T]."""
    half = head_dim // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    angles = positions[..., None].float() * freqs  # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attention(gen, cfg: ArchConfig, dtype, device) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": dense_init(gen, (d, h, hd), dtype, device, d),
        "wk": dense_init(gen, (d, hkv, hd), dtype, device, d),
        "wv": dense_init(gen, (d, hkv, hd), dtype, device, d),
        "wo": dense_init(gen, (h, hd, d), dtype, device, h * hd),
    }


def _attn_weights_mask(q_pos, kv_pos, window: int) -> torch.Tensor:
    """[B, 1, Tq, Tkv] causal (and windowed) mask, True = attend."""
    q = q_pos[:, :, None]
    k = kv_pos[:, None, :]
    ok = k <= q
    if window > 0:
        ok = ok & (k > q - window)
    return ok[:, None, :, :]


def attention(
    params: Params,
    x: torch.Tensor,          # [B, Tq, D]
    positions: torch.Tensor,  # [B, Tq]
    cfg: ArchConfig,
    spec: LayerSpec,
    cache: Params,            # paged {"k_pages","v_pages","page_table","pos"}
                              # or linear {"k","v": [B, S, Hkv, hd], "pos"}
    use_kernels: bool = True,
    fresh_prefill: bool = False,
    decode_idx: Optional[Params] = None,
) -> Tuple[torch.Tensor, Params]:
    """Causal GQA self-attention against a KV cache.

    ``fresh_prefill`` states that every row starts at position 0 on an
    empty cache (``Model.prefill``), so the chunk's own keys are all it
    may attend: the flash kernel's causal mask at ``q_offset=0``.
    ``decode_idx`` is ``decode_indices(cache)`` on a decode step with
    kernels (one token, ``use_kernels``), which the forward pass takes
    once for all its layers.

    Returns (output [B, Tq, D], cache with the chunk written and ``pos``
    advanced by Tq)."""
    hd = cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    b, tq, _ = x.shape
    window = spec.window if spec.attention == AttentionKind.SLIDING else 0
    flash = use_kernels and fresh_prefill and tq > 1

    q = torch.einsum("btd,dhk->bthk", x, params["wq"])
    k = torch.einsum("btd,dhk->bthk", x, params["wk"])
    v = torch.einsum("btd,dhk->bthk", x, params["wv"]).contiguous()  # B4 takes contiguous
    q = rope(q, positions, cfg.rope_theta, hd)
    k = rope(k, positions, cfg.rope_theta, hd)

    if "page_table" in cache:
        out, new_cache = _paged_attention(q, k, v, positions, window, cache,
                                          use_kernels, flash, decode_idx)
    else:
        # Linear cache: write the chunk at each row's own position (ragged
        # under continuous batching).  The start is clamped so the chunk
        # fits, as the reference's dynamic_update_slice clamps it.
        cache_k, cache_v, cache_pos = cache["k"], cache["v"], cache["pos"]
        s = cache_k.shape[1]
        start = cache_pos.clamp(0, s - tq).long()
        rows = (start[:, None] + torch.arange(tq, device=x.device)[None, :])
        idx = rows[:, :, None, None].expand(b, tq, hkv, hd)
        cache_k.scatter_(1, idx, k.to(cache_k.dtype))
        cache_v.scatter_(1, idx, v.to(cache_v.dtype))
        if flash:
            out = flash_attention(q, k, v, causal=True, window=window)
        elif tq == 1 and use_kernels:
            # q_pos masks causally and sets the window, as _dense_attention
            # does (an idle slot's position need not be its cache position)
            out = decode_attention(q[:, 0], cache_k, cache_v, decode_idx["kv_len"],
                                   window=window, q_pos=positions[:, 0])
            out = out[:, None].to(v.dtype)
        else:
            kv_pos = torch.arange(s, dtype=positions.dtype,
                                  device=x.device)[None, :].expand(b, s)
            valid = kv_pos < (cache_pos[:, None] + tq)
            qg = q.reshape(b, tq, hkv, h // hkv, hd)
            out = _dense_attention(qg, cache_k, cache_v, positions, kv_pos, valid, window)
        new_cache = {"k": cache_k, "v": cache_v, "pos": cache_pos + tq}

    out = out.reshape(b, tq, h, hd)
    y = torch.einsum("bthk,hkd->btd", out, params["wo"])
    return y, new_cache


def _dense_attention(qg, k, v, positions, kv_pos, valid, window: int) -> torch.Tensor:
    """Materializes the [Tq, S] scores.  Products are taken in f32, which
    for bf16 operands is the reference's bf16-operand / f32-accumulate
    einsum; the probabilities are rounded to v's dtype before the value
    product, as the reference rounds them."""
    b, tq, hkv, groups, hd = qg.shape
    logits = torch.einsum("bthgk,bshk->bhgts", qg.float(), k.float()) / math.sqrt(hd)
    mask = _attn_weights_mask(positions, kv_pos, window)  # [B,1,Tq,Tkv]
    mask = mask & valid[:, None, None, :]
    mask = mask[:, :, None, :, :]  # [B,1,1,Tq,Tkv] broadcasting over (hkv, g)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgts,bshk->bthgk", probs.float(), v.float())
    return out.to(v.dtype)


def _scatter_to_pages(pages: torch.Tensor, new: torch.Tensor,
                      flat_idx: torch.Tensor) -> None:
    """Write token rows into a page pool at flat (page*size+offset) slots,
    in place.  pages [P, page, Hkv, hd], new [N, Hkv, hd], flat_idx [N]."""
    flat = pages.view(pages.shape[0] * pages.shape[1], *pages.shape[2:])
    flat.index_copy_(0, flat_idx, new.to(pages.dtype))


def _paged_attention(
    q: torch.Tensor,          # [B, Tq, H, hd] (post-rope)
    k: torch.Tensor,          # [B, Tq, Hkv, hd] (post-rope)
    v: torch.Tensor,          # [B, Tq, Hkv, hd]
    positions: torch.Tensor,  # [B, Tq]
    window: int,
    cache: Params,
    use_kernels: bool,
    flash: bool,
    decode_idx: Optional[Params],
) -> Tuple[torch.Tensor, Params]:
    """Attention against a paged KV cache.

    Decode (Tq == 1) with ``use_kernels`` runs the two kernels: the
    in-place append into the page the slot's table points at, then
    flash-decoding that follows the page table.  Otherwise the chunk is
    scattered into the pool; with ``flash`` (a fresh prefill) the flash
    kernel then attends over the chunk's own keys, and without it the
    chunk attends over the gathered dense view: the reference
    semantics."""
    b, tq, h, hd = q.shape
    hkv = k.shape[2]
    k_pages, v_pages = cache["k_pages"], cache["v_pages"]
    page_table, cache_pos = cache["page_table"], cache["pos"]
    page = k_pages.shape[1]
    n_slot = page_table.shape[1]
    s_slot = n_slot * page
    kv_len = cache_pos + tq

    if tq == 1 and use_kernels:
        paged_kv_append(k[:, 0], v[:, 0], k_pages, v_pages, decode_idx["write_table"],
                        decode_idx["write_pos"])
        out = paged_decode_attention(
            q[:, 0], k_pages, v_pages, page_table, decode_idx["kv_len"], window=window,
            q_pos=positions[:, 0],
        )
        out = out[:, None].to(v.dtype)  # [B, 1, H, hd]
    else:
        rows = torch.arange(b, device=q.device)
        pos_bt = (cache_pos[:, None]
                  + torch.arange(tq, dtype=cache_pos.dtype, device=q.device)[None, :])
        in_range = pos_bt < s_slot  # overlong chunks: clamp to scratch page 0
        page_ids = torch.where(
            in_range,
            page_table[rows[:, None], (pos_bt // page).clamp(0, n_slot - 1).long()],
            0,
        )
        flat_idx = (page_ids.long() * page + (pos_bt % page).long()).reshape(-1)
        _scatter_to_pages(k_pages, k.reshape(b * tq, hkv, hd), flat_idx)
        _scatter_to_pages(v_pages, v.reshape(b * tq, hkv, hd), flat_idx)
        if flash:
            out = flash_attention(q, k, v, causal=True, window=window)
        else:
            k_dense = gather_pages(k_pages, page_table)
            v_dense = gather_pages(v_pages, page_table)
            kv_pos = torch.arange(s_slot, dtype=positions.dtype,
                                  device=q.device)[None, :].expand(b, s_slot)
            valid = kv_pos < kv_len[:, None]
            qg = q.reshape(b, tq, hkv, h // hkv, hd)
            out = _dense_attention(qg, k_dense, v_dense, positions, kv_pos, valid, window)

    new_cache = {
        "k_pages": k_pages,
        "v_pages": v_pages,
        "page_table": page_table,
        "pos": kv_len,
    }
    return out, new_cache


def decode_indices(cache: Params) -> Params:
    """What a decode step's kernels index with, from one attention layer's
    linear or paged cache.  Every attention layer of a model holds the same
    positions and page table, so a forward pass takes these once.

    An idle batcher slot's position runs on past its cache, as the
    reference's does.  There every row is valid (``kv_len`` is clamped to
    the cache's rows), and the reference's scatter puts a paged slot's row
    in scratch page 0 at ``pos % page``: B1 gets a zeroed table row
    (``write_table``) and ``pos`` modulo the row's length (``write_pos``)
    for such a slot."""
    pos = cache["pos"]
    if "page_table" not in cache:
        return {"kv_len": (pos + 1).clamp(max=cache["k"].shape[1])}
    table = cache["page_table"]
    rows = table.shape[1] * cache["k_pages"].shape[1]
    return {"kv_len": (pos + 1).clamp(max=rows),
            "write_table": table * (pos < rows)[:, None],
            "write_pos": pos % rows}


def init_attention_cache(
    cfg: ArchConfig, batch: int, max_len: int, dtype, device,
    paged: Optional[PagedSpec] = None,
) -> Params:
    """A full-length linear cache, or with ``paged`` a shared page pool
    plus per-slot page tables (the table rows start at 0, pointing at the
    reserved scratch page; the serving layer assigns real pages at
    admission)."""
    hd = cfg.resolved_head_dim
    zeros = dict(dtype=dtype, device=device)
    pos = torch.zeros((batch,), dtype=torch.int32, device=device)
    if paged is not None:
        n_slot = paged.pages_per_slot(max_len)
        pool = (paged.num_pages, paged.page_size, cfg.num_kv_heads, hd)
        return {
            "k_pages": torch.zeros(pool, **zeros),
            "v_pages": torch.zeros(pool, **zeros),
            "page_table": torch.zeros((batch, n_slot), dtype=torch.int32,
                                      device=device),
            "pos": pos,
        }
    return {
        "k": torch.zeros((batch, max_len, cfg.num_kv_heads, hd), **zeros),
        "v": torch.zeros((batch, max_len, cfg.num_kv_heads, hd), **zeros),
        "pos": pos,
    }


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg: ArchConfig, dtype, device) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_init(gen, (d, ff), dtype, device, d),
        "w_up": dense_init(gen, (d, ff), dtype, device, d),
        "w_down": dense_init(gen, (ff, d), dtype, device, ff),
    }


def mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU."""
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    return (F.silu(gate) * up) @ params["w_down"]


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def init_embedding(gen, cfg: ArchConfig, dtype, device) -> Params:
    p = {"tok": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(gen, (cfg.d_model, cfg.vocab_size), dtype, device)
    return p


def embed(params: Params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = params["tok"][tokens.long()]
    if cfg.tie_embeddings:
        # The reference scales tied embeddings by sqrt(d_model), gemma
        # style, for every tied model, llama3.2-1b included.  Hugging
        # Face's Llama does not; the port follows the reference.
        x = x * math.sqrt(cfg.d_model)
    return x


def unembed(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Logits as f32 sums of working-dtype products, as the reference's
    ``preferred_element_type=f32`` einsum takes them: a bf16 logit is
    never rounded to bf16.  On the card the bf16 product accumulates and
    writes f32 (``out_dtype``) without copying the table up, which would
    copy the largest matrix of the model on every call.  The CPU has no
    such kernel, so there the operands are widened; products of bf16
    values are exact in f32."""
    w = params["tok"].t() if cfg.tie_embeddings else params["unembed"]
    if x.dtype == torch.float32:
        return x @ w
    if x.device.type == "cpu":
        return x.float() @ w.float()
    logits = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    return logits.reshape(*x.shape[:-1], w.shape[-1])
