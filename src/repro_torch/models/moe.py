"""Mixture-of-Experts FFN with capacity-based dispatch (Mixtral / Switch
style): the reference's ``moe_ffn_scatter`` (src/repro/models/moe.py:88-157).

Tokens are placed into per-expert buffers of ``capacity`` rows by an
indexed scatter and combined back by an indexed gather, with the
rank-major first-come-first-served capacity contract: O(n k d) data
movement.  The reference's default ``moe_ffn`` builds one-hot dispatch
and combine tensors instead, O(n e cap d); the two give the same output
(tests/test_moe_impls.py), so the port keeps one.

Routing: router logits in f32 from the input cast to f32, then the fused
gating function (B5): the CUDA kernel with ``use_kernels`` on the card,
its plain version otherwise.  It is called with ``block_n = N``, the one
block size at which its positions equal the reference's
``_fcfs_positions``, which the reference's model path uses.  The expert
products are plain ``bmm`` calls, as the reference leaves its einsums to
XLA.

The Switch auxiliary load-balance loss is training's, and waits for the
port's training slice; serving does not compute it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.config.base import ArchConfig, MoEConfig
from repro_torch.kernels.moe_gating import moe_gating, moe_gating_ref
from repro_torch.models.layers import dense_init

Params = Dict[str, Any]


def init_moe(gen, cfg: ArchConfig, dtype, device) -> Params:
    """The router stays f32 whatever ``dtype`` is, as in the reference."""
    assert cfg.moe is not None
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    return {
        "router": dense_init(gen, (d, e), torch.float32, device, d),
        "w_gate": dense_init(gen, (e, d, ff), dtype, device, d),
        "w_up": dense_init(gen, (e, d, ff), dtype, device, d),
        "w_down": dense_init(gen, (e, ff, d), dtype, device, ff),
    }


def _capacity(tokens: int, moe: MoEConfig) -> int:
    if moe.capacity_factor <= 0:
        # dropless: the worst case routes every choice to one expert
        return tokens * moe.top_k
    cap = int(tokens * moe.top_k * moe.capacity_factor / moe.num_experts)
    return max(cap, 1)


def moe_ffn(params: Params, x: torch.Tensor, moe: MoEConfig,
            use_kernels: bool = True) -> torch.Tensor:
    """x [B, T, D] -> [B, T, D] in x's dtype.  Every token of the call
    competes for one capacity: in a decode step that includes idle slots,
    as in the reference."""
    b, t, d = x.shape
    e, k = moe.num_experts, moe.top_k
    n = b * t
    xf = x.reshape(n, d)
    logits = xf.float() @ params["router"].float()  # [n, e] f32
    cap = _capacity(n, moe)
    gating = moe_gating if use_kernels else moe_gating_ref
    gate_idx, gate_vals, pos, keep = gating(logits, k, cap, block_n=n)

    # scatter the kept choices into expert buffers [e * cap, d]; a dropped
    # choice lands on the spare row e * cap, which is never read
    flat_slot = torch.where(keep, gate_idx.long() * cap + pos.long(), e * cap)
    buffers = xf.new_zeros((e * cap + 1, d))
    buffers[flat_slot.reshape(-1)] = xf.repeat_interleave(k, dim=0)
    expert_in = buffers[: e * cap].view(e, cap, d)

    h = F.silu(torch.bmm(expert_in, params["w_gate"])) * torch.bmm(expert_in, params["w_up"])
    expert_out = torch.bmm(h, params["w_down"]).view(e * cap, d)

    # gather back and combine with the gates of the kept choices
    picked = expert_out[flat_slot.clamp(max=e * cap - 1).reshape(-1)].view(n, k, d)
    w = (gate_vals * keep.float()).to(picked.dtype)
    y = torch.einsum("nkd,nk->nd", picked, w)
    return y.reshape(b, t, d).to(x.dtype)
