"""Plain PyTorch versions of the Mamba-2 SSD scan: the chunked algorithm
that the CUDA kernel computes, and the O(T) sequential oracle.

Ports of the reference package's ``ssd_chunked_ref`` and
``ssd_sequential_ref`` (src/repro/models/mamba2.py:82-184), in its
layouts: x ``[B, T, H, P]`` (dt-scaled), decays a ``[B, T, H]`` in (0, 1],
B and C ``[B, T, N]`` shared across heads.  Everything is computed in
f32 whatever the input dtype; both return (y ``[B, T, H, P]``, final
state ``[B, H, N, P]``), f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_chunked_ref(
    x: torch.Tensor,   # [B, T, H, P]
    a: torch.Tensor,   # [B, T, H]
    B: torch.Tensor,   # [B, T, N]
    C: torch.Tensor,   # [B, T, N]
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, N, P]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan: quadratic attention-like work inside chunks of
    ``chunk`` steps, a linear recurrence over the chunk states."""
    b, t, h, p = x.shape
    n = B.shape[-1]
    q = chunk
    if t % q != 0:
        raise ValueError(f"T={t} must be a multiple of chunk={q}")
    nc = t // q

    xc = x.float().reshape(b, nc, q, h, p)
    Bc = B.float().reshape(b, nc, q, n)
    Cc = C.float().reshape(b, nc, q, n)
    log_a = torch.log(a.float().reshape(b, nc, q, h).clamp(min=1e-20))
    cum = torch.cumsum(log_a, dim=2)  # [b,nc,q,h] inclusive

    # intra-chunk: att[t, s] = (C_t . B_s) * exp(cum_t - cum_s), s <= t.
    # Mask BEFORE exp: above the diagonal rel is positive and can overflow
    # to inf, and inf * 0 would make a NaN.
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [b,nc,q,q,h]
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(rel.masked_fill(~tri[None, None, :, :, None], float("-inf")))
    cb = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)
    att = cb[..., None] * decay  # [b,nc,q,s,h]
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", att, xc)

    # each chunk's own state: step s decays to the chunk's end
    end_decay = torch.exp(cum[:, :, -1:, :] - cum)  # [b,nc,q,h]
    states = torch.einsum("bcsn,bcsh,bcshp->bchnp", Bc, end_decay, xc)

    # inter-chunk recurrence; keep the state entering each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])  # [b,nc,h]
    s = (initial_state.float() if initial_state is not None
         else torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device))
    entering = []
    for c in range(nc):
        entering.append(s)
        s = states[:, c] + chunk_decay[:, c, :, None, None] * s
    entering = torch.stack(entering, dim=1)  # [b,nc,h,n,p]

    # inter-chunk output: y[t] = C_t . (decay from chunk start to t * S_entering)
    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cc, torch.exp(cum), entering)
    return (y_intra + y_inter).reshape(b, t, h, p), s


def ssd_sequential_ref(
    x: torch.Tensor, a: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(T) sequential oracle: s = a_t s + B_t x_t^T, y_t = C_t . s."""
    b, t, h, p = x.shape
    n = B.shape[-1]
    s = (initial_state.float() if initial_state is not None
         else torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device))
    ys = []
    for i in range(t):
        s = (s * a[:, i].float()[:, :, None, None]
             + torch.einsum("bn,bhp->bhnp", B[:, i].float(), x[:, i].float()))
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, i].float(), s))
    return torch.stack(ys, dim=1), s
