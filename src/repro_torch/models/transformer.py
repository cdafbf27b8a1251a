"""Decoder over ``ArchConfig``: attention blocks and Mamba-2 blocks.

Depth is a Python loop over layers, with one param dict and one cache
dict per layer, each built for its layer's ``LayerSpec``.  (The
reference scans over params stacked ``[n_periods, ...]`` per pattern
position; ``models/convert.py`` unstacks them.)  Built here: self-
attention (full, or sliding as a window mask) with a SwiGLU or MoE FFN,
and Mamba-2 blocks with no FFN; other block kinds (cross-attention, a
Mamba block with an FFN) raise.

An attention layer's cache is the attention cache itself (linear, or
paged with ``paged``); a Mamba layer's is ``{"mamba": {"conv", "ssm"}}``.
Paged caches are attention-only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config.base import ArchConfig, AttentionKind, FFNKind, LayerSpec
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE

Params = Dict[str, Any]


def check_supported(cfg: ArchConfig) -> None:
    """A SLIDING layer runs on a linear or paged cache with its window as
    a mask, which is what the reference's serving computes: its batcher
    never builds the ring cache (``slot_pos``), and the port has none."""
    for i in range(cfg.num_layers):
        spec = cfg.layer_spec(i)
        if spec.is_mamba:
            ok = cfg.mamba is not None and spec.ffn == FFNKind.NONE
        else:
            ok = (spec.attention in (AttentionKind.FULL, AttentionKind.SLIDING)
                  and (spec.ffn == FFNKind.DENSE
                       or (spec.ffn == FFNKind.MOE and cfg.moe is not None)))
        if not ok:
            raise NotImplementedError(
                f"{cfg.name} layer {i} ({spec}): only self-attention (full or "
                "sliding) + SwiGLU or MoE blocks and FFN-less Mamba-2 blocks "
                "are ported"
            )


def init_block(gen, cfg: ArchConfig, spec: LayerSpec, dtype, device) -> Params:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    p: Params = {"norm_attn": zeros()}
    if spec.is_mamba:
        p["mamba"] = M.init_mamba(gen, cfg, dtype, device)
    else:
        p["attn"] = L.init_attention(gen, cfg, dtype, device)
    if spec.ffn != FFNKind.NONE:
        p["norm_ffn"] = zeros()
        if spec.ffn == FFNKind.MOE:
            p["moe"] = MOE.init_moe(gen, cfg, dtype, device)
        else:
            p["mlp"] = L.init_mlp(gen, cfg, dtype, device)
    return p


def apply_block(
    params: Params,
    spec: LayerSpec,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ArchConfig,
    cache: Params,
    use_kernels: bool,
    fresh_prefill: bool = False,
    decode_idx: Optional[Params] = None,
) -> Tuple[torch.Tensor, Params]:
    h = L.rms_norm(x, params["norm_attn"], cfg.norm_eps)
    if spec.is_mamba:
        y, mc = M.mamba_block(params["mamba"], h, cfg, cache["mamba"], use_kernels)
        new_cache = {"mamba": mc}
    else:
        y, new_cache = L.attention(params["attn"], h, positions, cfg, spec, cache,
                                   use_kernels, fresh_prefill, decode_idx)
    x = x + y
    if spec.ffn != FFNKind.NONE:
        h = L.rms_norm(x, params["norm_ffn"], cfg.norm_eps)
        if spec.ffn == FFNKind.MOE:
            x = x + MOE.moe_ffn(params["moe"], h, cfg.moe, use_kernels)
        else:
            x = x + L.mlp(params["mlp"], h)
    return x, new_cache


def init_params(gen, cfg: ArchConfig, dtype, device) -> Params:
    return {
        "embed": L.init_embedding(gen, cfg, dtype, device),
        "layers": [init_block(gen, cfg, cfg.layer_spec(i), dtype, device)
                   for i in range(cfg.num_layers)],
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
    }


def init_cache(
    cfg: ArchConfig, batch: int, max_len: int, dtype, device,
    paged: Optional[L.PagedSpec] = None,
) -> List[Params]:
    caches = []
    for i in range(cfg.num_layers):
        if cfg.layer_spec(i).is_mamba:
            if paged is not None:
                raise ValueError(
                    f"{cfg.name}: paged caches are attention-only; serve Mamba "
                    "layers with a dense cache")
            caches.append({"mamba": M.init_mamba_cache(cfg, batch, dtype, device)})
        else:
            caches.append(L.init_attention_cache(cfg, batch, max_len, dtype, device,
                                                 paged=paged))
    return caches


def forward(
    params: Params,
    cfg: ArchConfig,
    tokens: torch.Tensor,     # [B, T]
    cache: List[Params],
    start_pos: torch.Tensor,  # [B] position of tokens[:, 0]
    use_kernels: bool = True,
    compute_dtype=torch.bfloat16,
    logits_positions: str = "all",  # "all" | "last"
    fresh_prefill: bool = False,
) -> Tuple[torch.Tensor, List[Params]]:
    """Returns (logits [B, T or 1, V] f32, per-layer caches).

    ``logits_positions="last"`` unembeds only the final position, the
    serving-prefill path.  ``fresh_prefill`` states that ``start_pos`` is
    0 in every row and the caches are empty, as ``Model.prefill``
    guarantees; only then may attention take the flash kernel, whose
    query offset is one number for the whole batch."""
    b, t = tokens.shape
    x = L.embed(params["embed"], tokens, cfg).to(compute_dtype)
    positions = (start_pos.to(torch.int32)[:, None]
                 + torch.arange(t, dtype=torch.int32, device=tokens.device)[None])
    # a decode step's kernel indices, the same in every attention layer
    attn_cache = next((c for c in cache if "pos" in c), None)
    decode_idx = (L.decode_indices(attn_cache)
                  if t == 1 and use_kernels and attn_cache is not None else None)
    new_cache = []
    for i, (layer_params, layer_cache) in enumerate(zip(params["layers"], cache)):
        x, nc = apply_block(layer_params, cfg.layer_spec(i), x, positions, cfg,
                            layer_cache, use_kernels, fresh_prefill, decode_idx)
        new_cache.append(nc)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logits_positions == "last":
        x = x[:, -1:, :]
    return L.unembed(params["embed"], x, cfg), new_cache
