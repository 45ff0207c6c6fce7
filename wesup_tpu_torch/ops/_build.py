"""Build ``wesup_tpu_torch/csrc/*.cu`` with nvcc and load it with ctypes.

The library is compiled on first use, for ``sm_90a``, into
``wesup_tpu_torch/_build/`` under a name keyed by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is not.  The
kernels have a plain C interface (pointers and the stream as ``void*``), so
the build needs no PyTorch headers and takes seconds.  Nothing here runs at
import time: only the CUDA branch of a wrapper calls :func:`library`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures of the kernels' launch functions (csrc/cellpool.cu): K1, K2
# and their backward bodies K3, K4
_SIGNATURES = {
    "wesup_cell_pool0": [_P] * 7 + [_I] * 7 + [_P],
    "wesup_cell_pool_stage": [_P] * 9 + [_I] * 11 + [_P],
    "wesup_cell_pool0_bwd": [_P] * 3 + [_I] * 6 + [_P],
    "wesup_cell_pool_stage_bwd": [_P] * 5 + [_I] * 11 + [_P],
}


class BuildInfo:
    """What the last build did: its library path, seconds and nvcc log."""

    path: Path | None = None
    seconds: float = 0.0
    log: str = ""


_lib = None
info = BuildInfo()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the sources (if this hash was not built yet); return the .so."""
    sources = sorted(SOURCE_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libwesup_cuda_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           *map(str, sources)], capture_output=True, text=True)
    info.seconds = time.perf_counter() - t0
    info.log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{info.log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        path = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        info.path = path
        _lib = lib
    return _lib
