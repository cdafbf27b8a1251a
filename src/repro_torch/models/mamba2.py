"""Mamba-2 SSD block (state-space duality), chunked formulation.

The port's copy of the reference's block (src/repro/models/mamba2.py:28-80,
186-266), in its layouts and dtypes.  Prefill runs the chunked scan: the
CUDA kernel through ``kernels/ssd_scan/ops.py:ssd_chunked`` (its plain
version on the CPU), or with ``use_kernels=False`` the plain chunked scan
directly.  Decode (one token against a cache) is a single state update
in plain torch, as in the reference, which has no kernel for it.

Dtypes: ``dt_bias``, ``A_log`` and ``D`` are float32 whatever the working
dtype, as in the reference's init; a bf16 ``A_log`` would change every
decay.  The scan and its state (the ``ssm`` cache) are float32; the conv
cache is in the working dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ArchConfig
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_chunked_ref
from repro_torch.models.layers import dense_init

Params = Dict[str, Any]

# leaves that stay float32 whatever the working dtype
F32_LEAVES = ("dt_bias", "A_log", "D")


def _dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    m = cfg.mamba
    d_in = m.expand * cfg.d_model
    return d_in, d_in // m.head_dim, m.head_dim, m.d_state


def init_mamba(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> Params:
    m = cfg.mamba
    d = cfg.d_model
    d_in, h, _, n = _dims(cfg)
    d_xbc = d_in + 2 * n  # the conv runs over concat(x, B, C)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # fused input projection -> [z, x, B, C, dt]
        "in_proj": dense_init(gen, (d, d_in + d_xbc + h), dtype, device, d),
        "conv_w": dense_init(gen, (m.d_conv, d_xbc), dtype, device, m.d_conv),
        "conv_b": torch.zeros((d_xbc,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((h,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),  # A = -exp(A_log)
        "D": torch.ones((h,), **f32),
        "norm_w": torch.zeros((d_in,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, (d_in, d), dtype, device, d_in),
    }


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    d_in, h, _, n = _dims(cfg)
    z, xbc, dt = torch.split(proj, [d_in, d_in + 2 * n, h], dim=-1)
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time, xbc [B, T, C], w [K, C], as the
    reference's unrolled taps (not ``F.conv1d``: cuDNN would run an f32
    convolution in TF32).  Returns (silu(out) [B, T, C], new state
    [B, K-1, C])."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]), dtype=xbc.dtype,
                            device=xbc.device)
    full = torch.cat([state.to(xbc.dtype), xbc], dim=1)  # [B, T+K-1, C]
    t = xbc.shape[1]
    out = torch.zeros_like(xbc)
    for i in range(k):  # K is tiny (4)
        out = out + full[:, i:i + t, :] * w[i][None, None, :]
    out = out + b[None, None, :]
    return F.silu(out), full[:, full.shape[1] - (k - 1):, :]


def mamba_block(
    params: Params,
    u: torch.Tensor,  # [B, T, D]
    cfg: ArchConfig,
    cache: Optional[Params] = None,  # {"conv": [B, K-1, C], "ssm": [B, H, N, P] f32}
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """The full Mamba-2 block.  Returns (out [B, T, D], new cache or None)."""
    m = cfg.mamba
    d_in, h, p, n = _dims(cfg)
    bsz, t, _ = u.shape

    proj = u @ params["in_proj"]
    z, xbc, dt = _split_proj(cfg, proj)
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 cache["conv"] if cache is not None else None)
    x, B, C = torch.split(xbc, [d_in, n, n], dim=-1)
    x = x.reshape(bsz, t, h, p)

    dt = F.softplus(dt.float() + params["dt_bias"])  # [B, T, H]
    A = -torch.exp(params["A_log"])  # [H]
    a = torch.exp(dt * A[None, None, :])  # decay in (0, 1)
    x_dt = x.float() * dt[..., None]

    ssm_state = cache["ssm"] if cache is not None else None
    if t == 1 and cache is not None:
        # decode: one state update
        state = (ssm_state.float() * a[:, 0, :, None, None]
                 + torch.einsum("bn,bhp->bhnp", B[:, 0].float(), x_dt[:, 0]))
        y = torch.einsum("bn,bhnp->bhp", C[:, 0].float(), state)[:, None]  # [B,1,H,P]
        final_state = state
    else:
        # Pad T to a multiple of the chunk with inert steps: x=0 adds
        # nothing to the state, a=1 leaves the decay alone, B=C=0.
        pad = (-t) % m.chunk_size
        x_c, a_c, B_c, C_c = x_dt, a, B.contiguous(), C.contiguous()
        if pad:
            x_c = F.pad(x_dt, (0, 0, 0, 0, 0, pad))
            a_c = F.pad(a, (0, 0, 0, pad), value=1.0)
            B_c = F.pad(B, (0, 0, 0, pad))
            C_c = F.pad(C, (0, 0, 0, pad))
        scan = ssd_chunked if use_kernels else ssd_chunked_ref
        y, final_state = scan(x_c, a_c, B_c, C_c, m.chunk_size, ssm_state)
        if pad:
            y = y[:, :t]

    y = y + params["D"][None, None, :, None] * x.float()
    y = y.reshape(bsz, t, d_in).to(u.dtype)
    # gated RMSNorm (the reference's): norm(y * silu(z)) * (1 + norm_w)
    y = y * F.silu(z)
    var = y.float().square().mean(dim=-1, keepdim=True)
    y = (y.float() * torch.rsqrt(var + 1e-6)).to(u.dtype)
    y = y * (1.0 + params["norm_w"].to(u.dtype))
    out = y @ params["out_proj"]

    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv, "ssm": final_state.to(cache["ssm"].dtype)}
    return out, new_cache


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype, device) -> Params:
    m = cfg.mamba
    d_in, h, p, n = _dims(cfg)
    return {
        "conv": torch.zeros((batch, m.d_conv - 1, d_in + 2 * n), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, h, n, p), dtype=torch.float32, device=device),
    }
