"""Public wrapper for the SSD chunked-scan kernel: validation, dispatch and
the launch count.

Dispatch follows the tensors' device.  CPU tensors go to the plain
PyTorch version in ``ref.py``; CUDA tensors launch the hand-written
kernel in ``csrc/ssd_chunked.cu`` (built by ``kernels/build.py``) or
raise.  There is no fallback: a kernel that fails to build or launch
raises, and nothing is copied to the CPU.

The contract is the reference wrapper's
(src/repro/kernels/ssd_scan/ops.py:14-41): ``T % chunk != 0`` is a
``ValueError``, and a nonzero ``initial_state`` gives what its linear
fold gives (the kernel starts its scan from that state; equal in exact
arithmetic).  On CUDA the kernel takes x, a and the state in float32 and
B, C in float32 or bfloat16, all contiguous; anything else raises here.
The operands must also start on 16-byte boundaries (the kernel reads them
16 bytes at a time).  The kernel itself refuses shapes it cannot tile
(chunk, P and N must be multiples of 4, and each pass's tiles must fit
one block's shared memory), and the wrapper raises on that refusal too.

The kernel runs as three passes (chunk, state, output) over an f32
scratch that the wrapper allocates here (``workspace_floats``).
``LAUNCHES`` counts wrapper calls that launched the kernel, one per call
however many passes it ran.  Only a launch on the card counts; the plain
CPU path does not.
"""

from __future__ import annotations

import ctypes as _c
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref

LAUNCHES = {"ssd_chunked": 0}

# argtypes of the C entry point: pointers and the stream as c_void_p.
SIGNATURES = {
    "ssd_chunked": [
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # x a B C
        _c.c_void_p, _c.c_void_p, _c.c_void_p,               # initial_state y final_state
        _c.c_void_p, _c.c_longlong,                          # scratch, its f32 elements
        _c.c_int, _c.c_int, _c.c_int, _c.c_int,              # bc_dtype batch T H
        _c.c_int, _c.c_int, _c.c_int, _c.c_void_p,           # P N chunk stream
    ],
    "ssd_chunked_smem_bytes": [_c.c_int] * 5,  # pass bc_dtype P N chunk
}

# the kernel's passes, in launch order, by their index at the C entry points
PASSES = ("chunk", "state", "output")

# dtype codes of B and C at the C entry point
_BC_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def smem_bytes(p: int, n: int, chunk: int,
               bc_dtype: torch.dtype = torch.bfloat16) -> Dict[str, int]:
    """Dynamic shared memory one block of each pass takes, by pass, with B
    and C in ``bc_dtype``, from the kernel's own library (built first if
    need be: needs nvcc)."""
    fn = build.load("ssd_chunked", SIGNATURES["ssd_chunked_smem_bytes"],
                    symbol="ssd_chunked_smem_bytes")
    return {name: fn(i, _BC_DTYPE_CODE[bc_dtype], p, n, chunk)
            for i, name in enumerate(PASSES)}


def workspace_floats(b: int, t: int, h: int, p: int, n: int, chunk: int) -> int:
    """f32 elements of the kernel's scratch, laid out as the C source
    reads it: the state entering each chunk [B, H, nc, N, P], C B^T
    [B, nc, chunk, chunk] and each chunk's total decay [B, H, nc]."""
    return b * (t // chunk) * (h * n * p + chunk * chunk + h)


def _check_shapes(x, a, B, C, chunk, initial_state) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be [B, T, H, P], got {tuple(x.shape)}")
    b, t, h, p = x.shape
    if a.shape != (b, t, h):
        raise ValueError(f"a must be [B, T, H] = {(b, t, h)}, got {tuple(a.shape)}")
    if B.ndim != 3 or B.shape[:2] != (b, t) or C.shape != B.shape:
        raise ValueError(
            f"B and C must be [B, T, N] with B, T = {(b, t)}, got "
            f"{tuple(B.shape)} and {tuple(C.shape)}")
    if initial_state is not None and initial_state.shape != (b, h, B.shape[2], p):
        raise ValueError(
            f"initial_state must be [B, H, N, P] = {(b, h, B.shape[2], p)}, got "
            f"{tuple(initial_state.shape)}")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if t % chunk != 0:
        raise ValueError(f"T={t} must be a multiple of chunk={chunk}")


def _check_cuda_operands(x, a, B, C, initial_state) -> None:
    for name, t in (("x", x), ("a", a), ("initial_state", initial_state)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on CUDA, got {t.dtype}")
    if B.dtype not in _BC_DTYPE_CODE or C.dtype != B.dtype:
        raise TypeError(
            f"B and C must share float32 or bfloat16, got {B.dtype} and {C.dtype}")
    for name, t in (("x", x), ("a", a), ("B", B), ("C", C),
                    ("initial_state", initial_state)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def ssd_chunked(
    x: torch.Tensor,   # [B, T, H, P] (dt-scaled)
    a: torch.Tensor,   # [B, T, H] decay
    B: torch.Tensor,   # [B, T, N]
    C: torch.Tensor,   # [B, T, N]
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, N, P]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, T, H, P] f32, final_state [B, H, N, P] f32)."""
    _check_shapes(x, a, B, C, chunk, initial_state)
    tensors = [t for t in (x, a, B, C, initial_state) if t is not None]
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type == "cpu":
        return ssd_chunked_ref(x, a, B, C, chunk, initial_state)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: expected cpu or cuda")

    _check_cuda_operands(x, a, B, C, initial_state)
    b, t, h, p = x.shape
    n = B.shape[2]
    y = torch.empty_like(x)
    final = torch.empty((b, h, n, p), dtype=torch.float32, device=dev)
    # never zeroed: each pass writes what the next one reads
    work = torch.empty(workspace_floats(b, t, h, p, n, chunk), dtype=torch.float32, device=dev)
    fn = build.load("ssd_chunked", SIGNATURES["ssd_chunked"])
    err = fn(
        x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
        initial_state.data_ptr() if initial_state is not None else None,
        y.data_ptr(), final.data_ptr(), work.data_ptr(), work.numel(),
        _BC_DTYPE_CODE[B.dtype], b, t, h, p, n, chunk,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"ssd_chunked kernel launch failed: cudaError_t {err} (chunk={chunk}, "
            f"P={p}, N={n}; 1 = a shape the kernel cannot tile)")
    LAUNCHES["ssd_chunked"] += 1
    return y, final
