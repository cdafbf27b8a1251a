"""Architecture descriptions and their registry.

The port's own copy of the reference package's config types, trimmed to
what the ported paths read: the attention / FFN kinds, the MoE layer's
``MoEConfig``, the Mamba-2 block's ``MambaConfig``, one ``LayerSpec`` per
depth-pattern position, and ``ArchConfig``.  Configs are frozen
dataclasses; each file in ``repro_torch/configs/`` registers a full-size
config and a reduced ``smoke`` variant for CPU tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Dict, Optional, Tuple


class AttentionKind(str, Enum):
    FULL = "full"                # dense causal attention
    SLIDING = "sliding"          # sliding-window (SWA)
    NONE = "none"                # attention-free (SSM layer)
    CROSS = "cross"              # encoder-decoder cross attention


class FFNKind(str, Enum):
    DENSE = "dense"
    MOE = "moe"
    NONE = "none"


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # Auxiliary load-balance loss weight (Switch-style).
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class MambaConfig:
    """Mamba-2 SSD block hyperparameters."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 64


@dataclass(frozen=True)
class LayerSpec:
    """One (possibly repeated) layer 'flavor' in the depth pattern."""

    attention: AttentionKind = AttentionKind.FULL
    ffn: FFNKind = FFNKind.DENSE
    window: int = 0              # >0 for sliding-window layers
    is_mamba: bool = False


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | vlm | hybrid | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # Depth pattern: layer i uses pattern[i % len(pattern)]. Default: all-FULL.
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    max_seq_len: int = 131072
    rope_theta: float = 500000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    supports_long_context: bool = False
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    def layer_spec(self, i: int) -> LayerSpec:
        return self.pattern[i % len(self.pattern)]


# --- registry ---------------------------------------------------------------

_ARCHS: Dict[str, Tuple[ArchConfig, ArchConfig]] = {}


def register_arch(full: ArchConfig, smoke: ArchConfig) -> ArchConfig:
    _ARCHS[full.name] = (full, smoke)
    return full


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (registers everything)

    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_ARCHS)}")
    full, small = _ARCHS[name]
    return small if smoke else full

