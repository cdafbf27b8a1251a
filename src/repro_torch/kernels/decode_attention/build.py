"""Build and load the decode-attention CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``build/kernels/`` at the repository root, then loaded with ``ctypes``.
A library is rebuilt when its source is newer.  Nothing is built when the
module is imported: the first launch builds what it needs, and
``build_all`` builds every kernel at once, one ``nvcc`` per source, all
started together.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_c = ctypes
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
        _c.c_void_p, _c.c_void_p, _c.c_void_p,               # page_table kv_len out
        _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # dtype batch H Hkv D
        _c.c_int, _c.c_int, _c.c_int, _c.c_int,              # num_pages page n_pages window
        _c.c_float, _c.c_void_p,                             # sm_scale stream
    ],
}

NVCC_CANDIDATES = ("nvcc", "/usr/local/cuda/bin/nvcc")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for candidate in NVCC_CANDIDATES:
        found = shutil.which(candidate)
        if found:
            return found
    raise RuntimeError(
        f"nvcc not found (tried {', '.join(NVCC_CANDIDATES)}): the CUDA "
        "kernels cannot be built on this machine"
    )


def _paths(name: str):
    return CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (default: every kernel of the package)
    that are missing or stale, in parallel.  Returns ``{name: nvcc's
    output}``, which holds the ``-Xptxas -v`` register and spill report;
    raises ``RuntimeError`` with that output if any build fails."""
    names = [n for n in (names or list(SIGNATURES)) if _stale(n)]
    if not names:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, lib = _paths(name)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, lib)
    reports, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if missing or stale."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_paths(name)[1]))
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib
