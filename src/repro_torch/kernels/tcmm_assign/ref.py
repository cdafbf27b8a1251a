"""Plain PyTorch version of the TCMM nearest-micro-cluster assignment.

A port of the reference package's ``tcmm_assign_ref``
(src/repro/kernels/tcmm_assign/ref.py): for points ``[N, F]`` and
centroids ``[M, F]`` (any float type, cast to f32) and a validity mask
``[M]`` (bool),

    d2[n, m] = |p_n|^2 - 2 p_n . c_m + |c_m|^2     (f32, +inf where invalid)

and it returns the argmin over m as i32 (the first index on ties; index 0
with +inf when no row is valid) and the minimum d2 as f32.

The summation order is fixed, so that the CUDA kernel can repeat it bit
for bit:

    pp    = p_0 p_0 + p_1 p_1 + ... + p_{F-1} p_{F-1}     (left to right)
    cc    = c_0 c_0 + c_1 c_1 + ...                        (the same)
    cross = p_0 c_0 + p_1 c_1 + ...                        (the same)
    d2    = (pp - 2 cross) + cc

with every product and every sum rounded to f32 on its own (no fused
multiply-add).  It is written as a loop over F of elementwise ops: a
``matmul`` or a ``sum`` would leave the order to the library.  A decision
of the TCMM ingest (merge or spawn) compares d2 with a threshold, and at
real scale two rows come within 1e-3 of each other, so a kernel that
summed in another order would sooner or later choose another cluster.
"""

from __future__ import annotations

from typing import Tuple

import torch


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """|x_i|^2 per row of ``x`` [R, F] f32, summed over F left to right."""
    acc = x[:, 0] * x[:, 0]
    for f in range(1, x.shape[1]):
        acc = acc + x[:, f] * x[:, f]
    return acc


def squared_distances(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """d2 [N, M] = (|p|^2 - 2 p.c) + |c|^2 for f32 ``p`` [N, F] and ``c``
    [M, F], in the fixed order above."""
    cross = p[:, None, 0] * c[None, :, 0]
    for f in range(1, p.shape[1]):
        cross = cross + p[:, None, f] * c[None, :, f]
    return (squared_norms(p)[:, None] - 2.0 * cross) + squared_norms(c)[None, :]


def tcmm_assign_ref(
    points: torch.Tensor,     # [N, F]
    centroids: torch.Tensor,  # [M, F]
    valid: torch.Tensor,      # [M] bool: live micro-clusters
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (nearest index [N] i32, squared distance [N] f32)."""
    d2 = squared_distances(points.float(), centroids.float())
    d2 = torch.where(valid[None, :], d2, torch.full_like(d2, float("inf")))
    idx = torch.argmin(d2, dim=1)
    best = torch.gather(d2, 1, idx[:, None])[:, 0]
    return idx.to(torch.int32), best
