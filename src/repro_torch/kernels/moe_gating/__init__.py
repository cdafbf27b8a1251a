from repro_torch.kernels.moe_gating.ops import LAUNCHES, moe_gating, reset_launches
from repro_torch.kernels.moe_gating.ref import moe_gating_ref
