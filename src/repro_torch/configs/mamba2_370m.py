"""mamba2-370m [ssm]: 48L d_model=1024, attention-free, vocab=50280,
ssm_state=128 -- SSD (state-space duality) blocks. [arXiv:2405.21060;
unverified]

Values are the reference package's, field for field.
"""

from repro_torch.config.base import (
    ArchConfig,
    AttentionKind,
    FFNKind,
    LayerSpec,
    MambaConfig,
    register_arch,
)

FULL = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=1,       # unused: attention-free
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    head_dim=64,
    pattern=(
        LayerSpec(attention=AttentionKind.NONE, ffn=FFNKind.NONE, is_mamba=True),
    ),
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=64),
    max_seq_len=1048576,
    tie_embeddings=True,
    supports_long_context=True,
    notes="attention-free; the paper's attention-oriented shape notes do "
    "not apply -- all shapes run on the SSD path.",
)

SMOKE = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=3,
    d_model=64,
    num_heads=1,
    num_kv_heads=1,
    d_ff=0,
    vocab_size=512,
    head_dim=16,
    pattern=(
        LayerSpec(attention=AttentionKind.NONE, ffn=FFNKind.NONE, is_mamba=True),
    ),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk_size=16),
    max_seq_len=512,
    tie_embeddings=True,
    supports_long_context=True,
)

register_arch(FULL, SMOKE)
