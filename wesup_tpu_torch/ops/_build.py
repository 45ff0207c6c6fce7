"""Build ``wesup_tpu_torch/csrc/*.cu`` with nvcc and load it with ctypes.

The library is compiled on first use, for ``sm_90a``, into
``wesup_tpu_torch/_build/`` under a name keyed by a hash of the sources,
their shared header (``csrc/rows.cuh``) and the flags, so an edited source
is rebuilt and an unchanged one is not.  Each source is compiled by its own
nvcc process, all started together, and the objects are linked into one
shared library.  The kernels have a plain C
interface (pointers and the stream as ``void*``), so the build needs no
PyTorch headers and takes seconds.  Nothing here runs at import time: only
the CUDA branch of a wrapper calls :func:`library`.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures of the kernels' launch functions: K1, K2 and their backward
# bodies K3, K4 (csrc/cellpool.cu), K5 (csrc/pooling.cu), K6 and its
# backward K8 (csrc/adjoint.cu), K7 (csrc/pool.cu)
_SIGNATURES = {
    "wesup_cell_pool0": [_P] * 7 + [_I] * 7 + [_P],
    "wesup_cell_pool_stage": [_P] * 9 + [_I] * 11 + [_P],
    "wesup_cell_pool0_bwd": [_P] * 3 + [_I] * 6 + [_P],
    "wesup_cell_pool_stage_bwd": [_P] * 5 + [_I] * 11 + [_P],
    "wesup_segment_sum": [_P] * 4 + [_I] * 5 + [_P],
    "wesup_adjoint_pool_stage": [_P] * 3 + [_L] * 4 + [_P] * 4 + [_I] * 6
    + [_P],
    "wesup_adjoint_pool_stage_bwd": [_P] * 2 + [_L] * 3 + [_P] * 6
    + [_I] * 8 + [_P],
    "wesup_fused_relu_pool_pad": [_P] * 2 + [_I] * 6 + [_P],
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
    # headers too: an edited csrc/*.cuh rebuilds the sources that include it
    for src in sorted(SOURCE_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libwesup_cuda_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    info.log = "".join(f"== {src.name}\n{log}"
                       for src, log in zip(sources, logs))
    failed = [src.name for src, proc in zip(sources, procs)
              if proc.returncode != 0]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        info.log += link.stdout + link.stderr
        if link.returncode != 0:
            failed = ["link"]
    info.seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{info.log}")
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
