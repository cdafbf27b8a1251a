"""Serving steps: prefill and single-token decode over the model's KV
caches, under ``torch.inference_mode()``.  The continuous batcher drives
them."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models.zoo import Model

Params = Any


def make_prefill_step(model: Model) -> Callable:
    @torch.inference_mode()
    def prefill_step(
        params: Params, batch: Dict[str, torch.Tensor], cache: List[Params]
    ) -> Tuple[torch.Tensor, List[Params]]:
        # last_only: unembed a single position, not the whole prompt.
        logits, cache = model.prefill(params, batch, cache, last_only=True)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok, cache

    return prefill_step


def make_decode_step(
    model: Model, temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> Callable:
    """Greedy decode, or with ``temperature > 0`` a draw from
    softmax(logits / temperature) using ``generator``."""
    if temperature > 0 and generator is None:
        raise ValueError("temperature > 0 needs an explicit torch.Generator")

    @torch.inference_mode()
    def decode_step(
        params: Params,
        tokens: torch.Tensor,     # [B, 1] current tokens
        cache: List[Params],
        positions: torch.Tensor,  # [B]
    ) -> Tuple[torch.Tensor, List[Params]]:
        logits, cache = model.decode_step(params, tokens, cache, positions)
        last = logits[:, -1, :]
        if temperature > 0:
            probs = torch.softmax(last / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            next_tok = torch.argmax(last, dim=-1)
        return next_tok.to(torch.int32), cache

    return decode_step
