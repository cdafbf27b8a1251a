from repro_torch.kernels.ssd_scan.ops import LAUNCHES, reset_launches, ssd_chunked
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref, ssd_sequential_ref
