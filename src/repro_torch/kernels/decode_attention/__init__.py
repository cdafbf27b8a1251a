from repro_torch.kernels.decode_attention.ops import (
    LAUNCHES,
    decode_attention,
    paged_decode_attention,
    paged_kv_append,
    reset_launches,
)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    gather_pages,
    paged_decode_attention_ref,
    paged_kv_append_ref,
)
