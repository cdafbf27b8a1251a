from repro_torch.config.base import (
    ArchConfig,
    AttentionKind,
    FFNKind,
    LayerSpec,
    MambaConfig,
    MoEConfig,
    get_arch,
    register_arch,
)
