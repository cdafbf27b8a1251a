"""Build and load the port's CUDA kernels.

Every ``kernels/<package>/csrc/<name>.cu`` exposes one plain C entry
point, ``<name>``, and is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library ``build/kernels/lib<name>.so`` at the repository root,
then loaded with ``ctypes``.  A library is rebuilt when its source, or
any header (``*.cuh``) beside it in ``csrc/``, is newer.  Nothing is
built when a module is imported: the first launch builds what it needs,
and ``build_all`` builds every kernel, one ``nvcc`` after another.  Each kernel package keeps the ``argtypes`` of
its entry points beside its wrappers (``SIGNATURES`` in its ``ops.py``).
A library may export a second C function beside its entry point
(``load``'s ``symbol``): ``ssd_chunked_smem_bytes`` reports the dynamic
shared memory one SSD block takes, which ``ptxas -v`` does not report.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
NVCC_CANDIDATES = ("nvcc", "/usr/local/cuda/bin/nvcc")

_loaded: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    for candidate in NVCC_CANDIDATES:
        found = shutil.which(candidate)
        if found:
            return found
    raise RuntimeError(
        f"nvcc not found (tried {', '.join(NVCC_CANDIDATES)}): the CUDA "
        "kernels cannot be built on this machine"
    )


def sources() -> Dict[str, Path]:
    """Every kernel source of the port, by entry-point name."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def _lib(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(lib: Path, src: Path) -> bool:
    """Missing, or older than its source or a header its source may include."""
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in (src, *src.parent.glob("*.cuh")))
    return lib.stat().st_mtime < newest


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (default: every kernel of the port) that
    are missing or stale.  Returns ``{name: nvcc's output}``, which holds
    the ``-Xptxas -v`` register, shared-memory and spill report; raises
    ``RuntimeError`` with that output if a build fails."""
    srcs = sources()
    todo = [n for n in (names or list(srcs)) if _stale(_lib(n), srcs[n])]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    reports = {}
    for name in todo:
        lib = _lib(name)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])],
                              capture_output=True, text=True)
        reports[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"kernel build failed: {name} (nvcc exit {proc.returncode})\n{reports[name]}")
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return reports


def load(name: str, argtypes: Sequence, symbol: Optional[str] = None) -> ctypes._CFuncPtr:
    """A C function of kernel ``name``'s library (by default its entry
    point, ``name`` itself), built first if missing or stale, with its
    ``argtypes`` set and an ``int`` result (``cudaError_t`` for an entry
    point)."""
    symbol = symbol or name
    fn = _loaded.get(symbol)
    if fn is None:
        build_all([name])
        fn = getattr(ctypes.CDLL(str(_lib(name))), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _loaded[symbol] = fn
    return fn
