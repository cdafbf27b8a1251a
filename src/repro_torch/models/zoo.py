"""Model facade: build an architecture from its ArchConfig and expose the
serving entry points (param init, cache init, prefill, decode step).

Device: every entry point runs on ``device``, which defaults to
``"cuda"``.  Without a CUDA device, a model built with the default
raises; the CPU runs only when the caller passes ``device="cpu"``.

Dtype policy: params live in ``compute_dtype``, cast once when they are
made or loaded, except the Mamba leaves ``dt_bias``, ``A_log`` and ``D``
and the MoE router, which stay f32 as in the reference.  On the card
that is bf16: weights, activations, KV pages and Mamba conv states are
bf16, and norm statistics, attention scores, softmax, router logits and
gates, the SSD scan and its state, and logits stay f32.  The reference keeps f32 params beside bf16
activations, and JAX promotes each such product to f32; copied to the card, that would
read every weight at twice the bytes in a bandwidth-bound decode.  The
CPU parity tests run both packages at f32 throughout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.config.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import PagedSpec

Params = Dict[str, Any]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain path on the CPU"
        )
    return dev


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    compute_dtype: torch.dtype = torch.bfloat16
    device: Union[str, torch.device] = "cuda"
    # Attention (flash prefill, dense and paged decode), the Mamba prefill
    # scan and the MoE gating through the CUDA kernels (their plain
    # versions on the CPU); False takes the scatter + gather +
    # dense-attention path, the plain chunked scan and the plain gating
    # instead, the reference semantics the kernel path is held against.
    use_kernels: bool = True

    def __post_init__(self):
        T.check_supported(self.cfg)
        object.__setattr__(self, "device", resolve_device(self.device))

    # -- params / cache -----------------------------------------------------
    def init(self, generator: torch.Generator) -> Params:
        """Random params from ``generator``.  The numbers are drawn on the
        generator's device, so one seed gives the same weights on any
        model device."""
        return T.init_params(generator, self.cfg, self.compute_dtype, self.device)

    def init_cache(self, batch: int, max_len: int,
                   paged: Optional[PagedSpec] = None) -> List[Params]:
        return T.init_cache(self.cfg, batch, max_len, self.compute_dtype,
                            self.device, paged=paged)

    # -- entry points ---------------------------------------------------------
    def prefill(
        self,
        params: Params,
        batch: Dict[str, torch.Tensor],
        cache: List[Params],
        last_only: bool = False,
    ) -> Tuple[torch.Tensor, List[Params]]:
        """Every row starts at position 0, on an empty ``cache``: a fresh
        prefill, which attention may serve with the flash kernel.

        Requires every attention layer's ``cache["pos"]`` to be 0, as
        ``init_cache`` makes it: the flash kernel attends over the chunk
        alone, so a cache that already holds rows would give other logits
        than the plain path.  A CPU cache is checked (``ValueError``); a
        card cache is not, since reading it would sync the device."""
        for i, layer in enumerate(cache):
            pos = layer.get("pos")
            if pos is not None and pos.device.type == "cpu" and bool((pos != 0).any()):
                raise ValueError(
                    f"prefill needs an empty cache; layer {i} has pos {pos.tolist()}")
        tokens = batch["tokens"]
        start = torch.zeros((tokens.shape[0],), dtype=torch.int32, device=tokens.device)
        return T.forward(
            params, self.cfg, tokens, cache, start,
            use_kernels=self.use_kernels, compute_dtype=self.compute_dtype,
            logits_positions="last" if last_only else "all", fresh_prefill=True,
        )

    def decode_step(
        self,
        params: Params,
        tokens: torch.Tensor,     # [B, 1]
        cache: List[Params],
        positions: torch.Tensor,  # [B]
    ) -> Tuple[torch.Tensor, List[Params]]:
        return T.forward(
            params, self.cfg, tokens, cache, positions,
            use_kernels=self.use_kernels, compute_dtype=self.compute_dtype,
        )


def build_model(
    cfg: ArchConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    device: Union[str, torch.device] = "cuda",
    use_kernels: bool = True,
) -> Model:
    return Model(cfg=cfg, compute_dtype=compute_dtype, device=device,
                 use_kernels=use_kernels)
