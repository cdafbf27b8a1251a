"""Load the reference package's params into the port's layout.

The input is the reference ``Model.init`` pytree with every leaf turned
into a numpy array (a plain nested dict/list, so this module needs no
JAX).  There, block params are stacked ``[n_periods, ...]`` per pattern
position under ``"periods"``, with ``num_layers % len(pattern)``
unstacked ``"remainder"`` blocks after them; layer ``i < n_periods *
plen`` is ``periods[i % plen][...][i // plen]``.  The port keeps one dict
per layer.  Every array keeps its layout (``wq [d, h, hd]``, ``wo [h,
hd, d]``, ``w_gate [d, ff]``, ``tok [V, d]``, ``in_proj [d, e]``,
``conv_w [K, C]``, and an MoE layer's ``router [d, e]``, ``w_gate`` and
``w_up [e, d, ff]``, ``w_down [e, ff, d]``): no transpose.  The Mamba
leaves ``dt_bias``, ``A_log`` and ``D`` and the MoE ``router`` stay float32
whatever ``dtype`` is, as in the reference's init.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch.config.base import ArchConfig
from repro_torch.models.mamba2 import F32_LEAVES
from repro_torch.models.transformer import check_supported

# leaves kept in f32 whatever the params' dtype
F32_KEYS = F32_LEAVES + ("router",)

Params = Dict[str, Any]


def _tensors(tree: Any, fn, key: str = "") -> Any:
    """``fn(leaf, key)`` on every leaf, ``key`` being the leaf's dict key."""
    if isinstance(tree, dict):
        return {k: _tensors(v, fn, k) for k, v in tree.items()}
    return fn(tree, key)


def params_from_jax(
    tree: Params,
    cfg: ArchConfig,
    dtype: torch.dtype = torch.bfloat16,
    device: Union[str, torch.device] = "cuda",
) -> Params:
    """Reference params (numpy leaves) -> the port's params, cast once to
    ``dtype`` on ``device``."""
    check_supported(cfg)

    def to_t(a, key: str = "") -> torch.Tensor:
        return torch.tensor(np.asarray(a, dtype=np.float32)).to(
            device=device, dtype=torch.float32 if key in F32_KEYS else dtype)

    plen = len(cfg.pattern)
    n_periods = cfg.num_layers // plen
    layers = []
    for i in range(cfg.num_layers):
        if i < n_periods * plen:
            stacked = tree["periods"][i % plen]
            layers.append(_tensors(stacked, lambda a, k, p=i // plen: to_t(a[p], k)))
        else:
            layers.append(_tensors(tree["remainder"][i - n_periods * plen], to_t))
    return {
        "embed": _tensors(tree["embed"], to_t),
        "layers": layers,
        "final_norm": to_t(tree["final_norm"]),
    }
