"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256. [hf:meta-llama/Llama-3.2-1B; unverified]

Values are the reference package's, field for field.
"""

from repro_torch.config.base import ArchConfig, register_arch

FULL = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=64,
    max_seq_len=131072,
    rope_theta=500_000.0,
    tie_embeddings=True,
    supports_long_context=False,
    notes="long_500k skipped: pure full attention.",
)

SMOKE = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    head_dim=16,
    max_seq_len=256,
    tie_embeddings=True,
)

register_arch(FULL, SMOKE)
