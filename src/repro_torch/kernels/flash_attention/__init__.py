from repro_torch.kernels.flash_attention.ops import LAUNCHES, flash_attention, reset_launches
from repro_torch.kernels.flash_attention.ref import attention_ref
