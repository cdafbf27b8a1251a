"""Plain PyTorch version of the fused MoE gating function (B5).

A port of the reference package's ``moe_gating_ref``
(src/repro/kernels/moe_gating/ref.py).  For router logits ``[N, E]`` it
returns, for each token's top-k choices: the expert index, the gate
(renormalised over the top k), the position in that expert's capacity
buffer, and whether the position is below ``capacity``.

Positions are first come, first served, rank-major within each block of
``block_n`` tokens: the block's rank-0 choices claim capacity before any
of its rank-1 choices, and blocks go in order with the per-expert counts
carried across.  With ``block_n >= N`` that is the reference model's
``_fcfs_positions``; with a smaller block and k > 1 it is not (a later
block's rank-0 choice comes after an earlier block's rank-1 choice).

The top k are picked as the TPU kernel picks them
(src/repro/kernels/moe_gating/kernel.py:67-84): k rounds of ``argmax``
over the probabilities, the winner masked to ``-inf`` after each, so a tie
goes to the lowest index (``torch.argmax`` returns the first maximum;
``torch.topk`` promises no order on ties).

The arithmetic is fixed so that the CUDA kernel repeats it bit for bit:
``p = exp(x - max) / s`` with ``s`` summed over the experts left to right,
and the gates renormalised by ``max(g_0 + ... + g_{k-1}, 1e-9)``, summed
left to right.  Equal probabilities then pick equal experts on both.
"""

from __future__ import annotations

from typing import Tuple

import torch


def probabilities(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of ``logits`` [N, E], in f32, with the
    denominator summed over E left to right."""
    x = logits.float()
    ex = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    s = ex[:, 0]
    for e in range(1, ex.shape[1]):
        s = s + ex[:, e]
    return ex / s[:, None]


def top_k_gates(probs: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx [N, k] i32, renormalised gates [N, k] f32) by k rounds of argmax."""
    remaining = probs.clone()
    idx_cols, gate_cols = [], []
    for _ in range(top_k):
        a = remaining.argmax(dim=-1)
        gate_cols.append(remaining.gather(1, a[:, None])[:, 0])
        idx_cols.append(a)
        remaining.scatter_(1, a[:, None], float("-inf"))
    denom = gate_cols[0]
    for g in gate_cols[1:]:
        denom = denom + g
    denom = denom.clamp(min=1e-9)
    gates = torch.stack([g / denom for g in gate_cols], dim=1)
    return torch.stack(idx_cols, dim=1).to(torch.int32), gates


def fcfs_positions(idx: torch.Tensor, num_experts: int, block_n: int) -> torch.Tensor:
    """Rank-major FCFS positions [N, k] i32, block by block with the
    per-expert counts carried across blocks."""
    n, k = idx.shape
    counts = torch.zeros((num_experts,), dtype=torch.int64, device=idx.device)
    pos = torch.zeros((n, k), dtype=torch.int64, device=idx.device)
    for start in range(0, n, block_n):
        for kk in range(k):
            onehot = torch.nn.functional.one_hot(
                idx[start:start + block_n, kk].long(), num_experts)  # [bn, E]
            within = onehot.cumsum(dim=0) - onehot
            pos[start:start + block_n, kk] = ((counts[None, :] + within) * onehot).sum(-1)
            counts = counts + onehot.sum(dim=0)
    return pos.to(torch.int32)


def moe_gating_ref(
    logits: torch.Tensor,  # [N, E]
    top_k: int,
    capacity: int,
    block_n: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (idx [N, k] i32, gates [N, k] f32, pos [N, k] i32, keep [N, k] bool)."""
    n, e = logits.shape
    block_n = max(1, min(block_n, n))
    idx, gates = top_k_gates(probabilities(logits), top_k)
    pos = fcfs_positions(idx, e, block_n)
    return idx, gates, pos, pos < capacity
