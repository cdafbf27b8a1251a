"""Decoder-only transformer over ``ArchConfig``: dense blocks.

Depth is a Python loop over layers, with one param dict and one cache
dict per layer.  (The reference scans over params stacked ``[n_periods,
...]`` per pattern position; ``models/convert.py`` unstacks them.)  Only
dense attention + SwiGLU blocks are built here; other block kinds raise.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config.base import ArchConfig, AttentionKind, FFNKind, LayerSpec
from repro_torch.models import layers as L

Params = Dict[str, Any]


def check_supported(cfg: ArchConfig) -> None:
    for i in range(cfg.num_layers):
        spec = cfg.layer_spec(i)
        if (spec.is_mamba or spec.ffn != FFNKind.DENSE
                or spec.attention not in (AttentionKind.FULL, AttentionKind.SLIDING)):
            raise NotImplementedError(
                f"{cfg.name} layer {i} ({spec}): only dense self-attention + "
                "SwiGLU blocks are ported"
            )


def init_block(gen, cfg: ArchConfig, dtype, device) -> Params:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return {
        "norm_attn": zeros(),
        "attn": L.init_attention(gen, cfg, dtype, device),
        "norm_ffn": zeros(),
        "mlp": L.init_mlp(gen, cfg, dtype, device),
    }


def apply_block(
    params: Params,
    spec: LayerSpec,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ArchConfig,
    cache: Params,
    use_kernels: bool,
) -> Tuple[torch.Tensor, Params]:
    h = L.rms_norm(x, params["norm_attn"], cfg.norm_eps)
    y, new_cache = L.attention(params["attn"], h, positions, cfg, spec, cache,
                               use_kernels)
    x = x + y
    h = L.rms_norm(x, params["norm_ffn"], cfg.norm_eps)
    return x + L.mlp(params["mlp"], h), new_cache


def init_params(gen, cfg: ArchConfig, dtype, device) -> Params:
    return {
        "embed": L.init_embedding(gen, cfg, dtype, device),
        "layers": [init_block(gen, cfg, dtype, device)
                   for _ in range(cfg.num_layers)],
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
    }


def init_cache(
    cfg: ArchConfig, batch: int, max_len: int, dtype, device,
    paged: Optional[L.PagedSpec] = None,
) -> List[Params]:
    return [
        L.init_attention_cache(cfg, batch, max_len, dtype, device, paged=paged)
        for _ in range(cfg.num_layers)
    ]


def forward(
    params: Params,
    cfg: ArchConfig,
    tokens: torch.Tensor,     # [B, T]
    cache: List[Params],
    start_pos: torch.Tensor,  # [B] position of tokens[:, 0]
    use_kernels: bool = True,
    compute_dtype=torch.bfloat16,
    logits_positions: str = "all",  # "all" | "last"
) -> Tuple[torch.Tensor, List[Params]]:
    """Returns (logits [B, T or 1, V] f32, per-layer caches).

    ``logits_positions="last"`` unembeds only the final position, the
    serving-prefill path."""
    b, t = tokens.shape
    x = L.embed(params["embed"], tokens, cfg).to(compute_dtype)
    positions = (start_pos.to(torch.int32)[:, None]
                 + torch.arange(t, dtype=torch.int32, device=tokens.device)[None])
    new_cache = []
    for i, (layer_params, layer_cache) in enumerate(zip(params["layers"], cache)):
        x, nc = apply_block(layer_params, cfg.layer_spec(i), x, positions, cfg,
                            layer_cache, use_kernels)
        new_cache.append(nc)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logits_positions == "last":
        x = x[:, -1:, :]
    return L.unembed(params["embed"], x, cfg), new_cache
