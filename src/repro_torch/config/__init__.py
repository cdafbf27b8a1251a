from repro_torch.config.base import (
    ArchConfig,
    AttentionKind,
    FFNKind,
    LayerSpec,
    get_arch,
    register_arch,
)
