from repro_torch.kernels.tcmm_assign.ops import LAUNCHES, reset_launches, tcmm_assign
from repro_torch.kernels.tcmm_assign.ref import tcmm_assign_ref
