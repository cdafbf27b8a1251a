"""Public wrapper for the TCMM assignment kernel: validation, dispatch and
the launch count.

Dispatch follows the tensors' device.  CPU tensors go to the plain
PyTorch version in ``ref.py``; CUDA tensors launch the hand-written
kernel in ``csrc/tcmm_assign.cu`` (built by ``kernels/build.py``) or
raise.  There is no fallback: a kernel that fails to build or launch
raises, and nothing is copied to the CPU.

The contract is the reference wrapper's
(src/repro/kernels/tcmm_assign/ops.py:14-30) without its TPU tiling
arguments (``block_n``, ``interpret``), which do not change results.  On
CUDA the kernel takes points and centroids of one dtype, float32 or
bfloat16, and a bool mask, all contiguous; anything else raises here.
Its d2 equals the plain version's bit for bit (both sum in the order
``ref.py`` states), so its indices do too.

``LAUNCHES`` counts kernel launches.  Only a launch on the card counts;
the plain CPU path does not.
"""

from __future__ import annotations

import ctypes as _c
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.tcmm_assign.ref import tcmm_assign_ref

LAUNCHES = {"tcmm_assign": 0}

# argtypes of the C entry point: pointers and the stream as c_void_p.
SIGNATURES = {
    "tcmm_assign": [
        _c.c_void_p, _c.c_void_p, _c.c_void_p,   # points centroids valid
        _c.c_void_p, _c.c_void_p,                # idx d2
        _c.c_int, _c.c_int, _c.c_int, _c.c_int,  # dtype N M F
        _c.c_void_p,                             # stream
    ],
}

# dtype codes of points and centroids at the C entry point
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# one row of centroids must fit the kernel's shared-memory tile
MAX_FEATURES = 4096


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_shapes(points, centroids, valid) -> None:
    if points.ndim != 2 or centroids.ndim != 2 or points.shape[1] != centroids.shape[1]:
        raise ValueError(
            f"points [N, F] and centroids [M, F] must share F, got "
            f"{tuple(points.shape)} and {tuple(centroids.shape)}")
    if centroids.shape[0] == 0 or points.shape[1] == 0:
        raise ValueError(f"need M >= 1 and F >= 1, got centroids {tuple(centroids.shape)}")
    if valid.shape != (centroids.shape[0],) or valid.dtype != torch.bool:
        raise ValueError(
            f"valid must be bool [M] = [{centroids.shape[0]}], got {valid.dtype} "
            f"{tuple(valid.shape)}")
    if not (points.is_floating_point() and centroids.is_floating_point()):
        raise TypeError(f"points and centroids must be float, got {points.dtype} "
                        f"and {centroids.dtype}")


def _check_cuda_operands(points, centroids, valid) -> None:
    if points.dtype not in _DTYPE_CODE or centroids.dtype != points.dtype:
        raise TypeError(
            f"points and centroids must share float32 or bfloat16 on CUDA, got "
            f"{points.dtype} and {centroids.dtype}")
    if points.shape[1] > MAX_FEATURES:
        raise ValueError(f"F={points.shape[1]} exceeds the kernel's {MAX_FEATURES}")
    for name, t in (("points", points), ("centroids", centroids), ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def tcmm_assign(
    points: torch.Tensor,     # [N, F]
    centroids: torch.Tensor,  # [M, F]
    valid: torch.Tensor,      # [M] bool: live micro-clusters
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (nearest index [N] i32, squared distance [N] f32)."""
    _check_shapes(points, centroids, valid)
    dev = points.device
    for t in (centroids, valid):
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type == "cpu":
        return tcmm_assign_ref(points, centroids, valid)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: expected cpu or cuda")

    _check_cuda_operands(points, centroids, valid)
    n, f = points.shape
    m = centroids.shape[0]
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    d2 = torch.empty((n,), dtype=torch.float32, device=dev)
    fn = build.load("tcmm_assign", SIGNATURES["tcmm_assign"])
    err = fn(points.data_ptr(), centroids.data_ptr(), valid.data_ptr(), idx.data_ptr(),
             d2.data_ptr(), _DTYPE_CODE[points.dtype], n, m, f,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tcmm_assign kernel launch failed: cudaError_t {err} "
                           f"(N={n}, M={m}, F={f})")
    LAUNCHES["tcmm_assign"] += 1
    return idx, d2
