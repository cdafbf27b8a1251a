"""Public wrappers for the decode kernels, paged and dense: validation,
dispatch and launch counts.

Dispatch follows the tensors' device.  CPU tensors go to the plain
PyTorch versions in ``ref.py``; CUDA tensors launch the hand-written
kernels in ``csrc/`` (built by ``kernels/build.py``) or raise.  There is no
fallback: a kernel that fails to build or launch raises, and nothing is
copied to the CPU.

Validation keeps the reference wrapper's contract
(src/repro/kernels/decode_attention/ops.py:38-61):

  * ``kv_len`` / ``pos`` / ``page_table`` must be integer-typed; a float
    length is a ``TypeError``, never a silent cast.
  * On the CPU, out-of-range values raise ``ValueError``: ``kv_len >
    n_pages * page`` (or ``> S`` for a dense cache) would attend rows
    that do not exist, and a page id past the pool would read another
    allocation.
  * The dense wrapper takes no ``block_k``: the kernel picks its own
    chunks, so S need not be a multiple of the TPU's 128 lanes
    (``align_block_k``, src/repro/kernels/decode_attention/ops.py:63-80).
  * On CUDA the values are not inspected.  Reading them would cost one
    device-to-host sync per layer per decode tick.  The kernels clamp on
    the device instead, as the reference clamps traced values
    (src/repro/kernels/decode_attention/ops.py:166-168 and :207-208),
    and the serving batcher range-checks its host copies of the
    positions and page tables before each tick.

Scratch page 0: idle batcher slots keep all-zero table rows, so their
appends all land in page 0, and their attention reads it.  Page 0 is
never handed to a live request.  Two idle slots at one position name the
same row; the last slot's row lands, on the card and in the plain
version alike, because under MoE capacity drops an idle slot's token
competes with the busy ones for expert capacity and must not depend on
the order of two stores.

``LAUNCHES`` counts kernel launches by name.  Only a launch on the card
counts; the plain CPU path does not.
"""

from __future__ import annotations

import ctypes as _c
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    paged_decode_attention_ref,
    paged_kv_append_ref,
)

LAUNCHES = {"paged_kv_append": 0, "paged_decode_attention": 0, "decode_attention": 0}

# argtypes of each C entry point: every pointer and the stream as
# c_void_p (a bare int would be cut to 32 bits), sizes as c_int.
SIGNATURES = {
    "paged_kv_append": [
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # k_new v_new k_pages v_pages
        _c.c_void_p, _c.c_void_p,                            # page_table pos
        _c.c_int, _c.c_int, _c.c_int, _c.c_int,              # batch n_pages num_pages page
        _c.c_longlong, _c.c_void_p,                          # row_bytes stream
    ],
    "paged_decode_attention": [
        _c.c_void_p, _c.c_void_p, _c.c_void_p,               # q k_pages v_pages
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # page_table kv_len q_pos out
        _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # dtype batch H Hkv D
        _c.c_int, _c.c_int, _c.c_int, _c.c_int,              # num_pages page n_pages window
        _c.c_float, _c.c_void_p,                             # sm_scale stream
    ],
    "decode_attention": [
        _c.c_void_p, _c.c_void_p, _c.c_void_p,               # q k_cache v_cache
        _c.c_void_p, _c.c_void_p, _c.c_void_p,               # kv_len q_pos (or NULL) out
        _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # dtype batch S H Hkv
        _c.c_int, _c.c_int, _c.c_float, _c.c_void_p,         # D window sm_scale stream
    ],
}

# dtype codes of the C entry points
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _require_int(name: str, t: torch.Tensor) -> None:
    if t.dtype.is_floating_point or t.dtype.is_complex or t.dtype == torch.bool:
        raise TypeError(
            f"{name} must be integer-typed (got {t.dtype}); a float "
            "length would be truncated silently"
        )


def _check_q_pos(q_pos: Optional[torch.Tensor], kv_len: torch.Tensor) -> None:
    if q_pos is not None:
        _require_int("q_pos", q_pos)
        if q_pos.shape != kv_len.shape:
            raise ValueError(f"q_pos must be [B] like kv_len, got {tuple(q_pos.shape)}")


def _check_range(name: str, t: torch.Tensor, upper: int) -> None:
    """CPU tensors only: values must lie in [0, upper]."""
    if t.numel() == 0:
        return
    lo, hi = int(t.min()), int(t.max())
    if lo < 0:
        raise ValueError(f"{name} has negative entries (min={lo})")
    if hi > upper:
        raise ValueError(
            f"{name} exceeds the cache: max={hi} > {upper}; the kernel "
            "would silently attend rows that do not exist"
        )


def _device_of(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}: expected cpu or cuda")
    return dev


def _check_cuda_operands(data, pools) -> None:
    """Dtype and layout the kernels take; raises on anything else."""
    dtype = pools[0].dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"kernels take float32 or bfloat16 pools, got {dtype}")
    for t in (*data, *pools):
        if t.dtype != dtype:
            raise TypeError(f"dtype mismatch: {t.dtype} vs pool {dtype}")
    for t in pools:
        if not t.is_contiguous():
            raise ValueError("page pools and caches must be contiguous")


def _int32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def decode_attention(
    q: torch.Tensor,        # [B, H, D]
    k_cache: torch.Tensor,  # [B, S, Hkv, D]
    v_cache: torch.Tensor,  # [B, S, Hkv, D]
    kv_len: torch.Tensor,   # [B] int
    window: int = 0,
    sm_scale: Optional[float] = None,
    q_pos: Optional[torch.Tensor] = None,  # [B] int
) -> torch.Tensor:
    """Single-token GQA attention over a dense cache -> [B, H, D]: each
    sequence attends its first ``kv_len`` rows (with ``window``, the last
    ``window`` of them); ``kv_len == 0`` gives exactly zero.  With
    ``q_pos``, masks as the model's plain attention does (``ref.py``)."""
    if q.ndim != 3:
        raise ValueError("q must be [B, H, D] (one token per sequence)")
    if q.shape[1] % k_cache.shape[2] != 0:
        raise ValueError("num_heads must be a multiple of num_kv_heads")
    if (k_cache.ndim != 4 or k_cache.shape != v_cache.shape
            or k_cache.shape[0] != q.shape[0] or k_cache.shape[3] != q.shape[2]):
        raise ValueError("k_cache / v_cache must be [B, S, Hkv, D] matching q")
    if kv_len.shape != (q.shape[0],):
        raise ValueError(f"kv_len must be [B], got {tuple(kv_len.shape)}")
    _require_int("kv_len", kv_len)
    _check_q_pos(q_pos, kv_len)
    s = k_cache.shape[1]
    dev = _device_of(q, k_cache, v_cache, kv_len, *([] if q_pos is None else [q_pos]))
    if dev.type == "cpu":
        _check_range("kv_len", kv_len, s)
        return decode_attention_ref(q, k_cache, v_cache, kv_len, window=window,
                                    sm_scale=sm_scale, q_pos=q_pos)

    _check_cuda_operands((q,), (k_cache, v_cache))
    b, h, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    q = q.contiguous()
    lens = _int32(kv_len)
    out = torch.empty_like(q)
    fn = build.load("decode_attention", SIGNATURES["decode_attention"])
    qp = None if q_pos is None else _int32(q_pos)
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        None if qp is None else qp.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype], b, s,
        h, k_cache.shape[2], d, int(window), float(scale), _stream(dev),
    )
    _check_launch("decode_attention", err)
    LAUNCHES["decode_attention"] += 1
    return out


def paged_decode_attention(
    q: torch.Tensor,           # [B, H, D]
    k_pages: torch.Tensor,     # [P, page, Hkv, D]
    v_pages: torch.Tensor,     # [P, page, Hkv, D]
    page_table: torch.Tensor,  # [B, n_pages] int
    kv_len: torch.Tensor,      # [B] int
    window: int = 0,
    sm_scale: Optional[float] = None,
    q_pos: Optional[torch.Tensor] = None,  # [B] int
) -> torch.Tensor:
    """Single-token GQA attention through the page table -> [B, H, D], as
    ``decode_attention`` over each table row's n_pages * page rows."""
    if q.ndim != 3:
        raise ValueError("q must be [B, H, D] (one token per sequence)")
    if q.shape[1] % k_pages.shape[2] != 0:
        raise ValueError("num_heads must be a multiple of num_kv_heads")
    if page_table.ndim != 2 or page_table.shape[0] != q.shape[0]:
        raise ValueError(
            f"page_table must be [B, n_pages], got {tuple(page_table.shape)} "
            f"for batch {q.shape[0]}"
        )
    if kv_len.shape != (q.shape[0],):
        raise ValueError(f"kv_len must be [B], got {tuple(kv_len.shape)}")
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != q.shape[2]:
        raise ValueError("k_pages / v_pages must be [P, page, Hkv, D] matching q")
    _require_int("kv_len", kv_len)
    _require_int("page_table", page_table)
    _check_q_pos(q_pos, kv_len)
    n_pages, page_size, num_pages = page_table.shape[1], k_pages.shape[1], k_pages.shape[0]
    dev = _device_of(q, k_pages, v_pages, page_table, kv_len,
                     *([] if q_pos is None else [q_pos]))
    if dev.type == "cpu":
        _check_range("kv_len", kv_len, n_pages * page_size)
        _check_range("page_table", page_table, num_pages - 1)
        return paged_decode_attention_ref(
            q, k_pages, v_pages, page_table, kv_len, window=window, sm_scale=sm_scale,
            q_pos=q_pos,
        )

    _check_cuda_operands((q,), (k_pages, v_pages))
    b, h, d = q.shape
    hkv = k_pages.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    q = q.contiguous()
    table, lens = _int32(page_table), _int32(kv_len)
    qp = None if q_pos is None else _int32(q_pos)
    out = torch.empty_like(q)
    fn = build.load("paged_decode_attention", SIGNATURES["paged_decode_attention"])
    err = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), table.data_ptr(),
        lens.data_ptr(), None if qp is None else qp.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], b, h, hkv, d, num_pages, page_size, n_pages, int(window),
        float(scale), _stream(dev),
    )
    _check_launch("paged_decode_attention", err)
    LAUNCHES["paged_decode_attention"] += 1
    return out


def paged_kv_append(
    k_new: torch.Tensor,       # [B, Hkv, D]
    v_new: torch.Tensor,       # [B, Hkv, D]
    k_pages: torch.Tensor,     # [P, page, Hkv, D] updated in place
    v_pages: torch.Tensor,     # [P, page, Hkv, D] updated in place
    page_table: torch.Tensor,  # [B, n_pages] int
    pos: torch.Tensor,         # [B] int write positions (kv_len before append)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write each sequence's new K/V row into its page, in place; returns
    the two pools (the same tensors)."""
    if k_new.ndim != 3 or v_new.shape != k_new.shape:
        raise ValueError("k_new / v_new must be [B, Hkv, D] (one token per sequence)")
    if k_pages.shape != v_pages.shape or k_pages.shape[2:] != k_new.shape[1:]:
        raise ValueError("k_pages / v_pages must be [P, page, Hkv, D] matching k_new")
    if page_table.ndim != 2 or page_table.shape[0] != k_new.shape[0]:
        raise ValueError(
            f"page_table must be [B, n_pages], got {tuple(page_table.shape)} "
            f"for batch {k_new.shape[0]}"
        )
    if pos.shape != (k_new.shape[0],):
        raise ValueError(f"pos must be [B], got {tuple(pos.shape)}")
    _require_int("pos", pos)
    _require_int("page_table", page_table)
    n_pages, page_size, num_pages = page_table.shape[1], k_pages.shape[1], k_pages.shape[0]
    dev = _device_of(k_new, v_new, k_pages, v_pages, page_table, pos)
    if dev.type == "cpu":
        _check_range("pos", pos, n_pages * page_size - 1)
        _check_range("page_table", page_table, num_pages - 1)
        return paged_kv_append_ref(k_new, v_new, k_pages, v_pages, page_table, pos)

    _check_cuda_operands((k_new, v_new), (k_pages, v_pages))
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    table, pos32 = _int32(page_table), _int32(pos)
    b = k_new.shape[0]
    row_bytes = k_new.shape[1] * k_new.shape[2] * k_new.element_size()
    fn = build.load("paged_kv_append", SIGNATURES["paged_kv_append"])
    err = fn(
        k_new.data_ptr(), v_new.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        table.data_ptr(), pos32.data_ptr(), b, n_pages, num_pages, page_size,
        row_bytes, _stream(dev),
    )
    _check_launch("paged_kv_append", err)
    LAUNCHES["paged_kv_append"] += 1
    return k_pages, v_pages
