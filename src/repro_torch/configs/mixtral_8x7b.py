"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention (W=4096).
[arXiv:2401.04088; hf]

Values are the reference package's, field for field.  On a linear or
paged cache the window is a mask (keys at positions > q - W), as the
reference's serving computes it; no ring cache is built.
"""

from repro_torch.config.base import (
    ArchConfig,
    AttentionKind,
    FFNKind,
    LayerSpec,
    MoEConfig,
    register_arch,
)

FULL = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    pattern=(
        LayerSpec(attention=AttentionKind.SLIDING, ffn=FFNKind.MOE, window=4096),
    ),
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
    max_seq_len=131072,
    rope_theta=1_000_000.0,
    supports_long_context=True,
    notes="SWA window 4096 bounds decode KV; long_500k runs. "
    "MoE dispatch = the paper's message-distribution problem on-chip.",
)

SMOKE = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    pattern=(
        LayerSpec(attention=AttentionKind.SLIDING, ffn=FFNKind.MOE, window=16),
    ),
    moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=0.0),
    max_seq_len=256,
    supports_long_context=True,
)

register_arch(FULL, SMOKE)
