"""ctypes bindings for the host kernels of ``wesup_tpu_torch/csrc/wesup_native.cpp``.

A copy of ``wesup_tpu.native`` whose library is built by the port itself:
on first use, with the host's C++ compiler (``$CXX``, else ``g++``) and
the flags of ``csrc/Makefile`` (``$CXXFLAGS``, else ``-O3 -march=native
-fPIC -std=c++17 -Wall``), into ``wesup_tpu_torch/_build/`` under a name
keyed by a hash of the compiler, the flags and the source; the finished
file is moved into place atomically, so processes that build at once
never load half a file.  A failed build raises ``RuntimeError`` with the
compiler's log: there is no quiet fallback.

Provided:
    label8(mask)             -- 8-connectivity CCL (skimage.label semantics),
                                labels numbered in raster order
    edt_sq(mask)             -- exact squared EDT to the nonzero set (f32)
    hausdorff(a, b)          -- symmetric Hausdorff, O(N) via two EDTs
    flip_small_regions(m, t) -- evaluation postprocess region flipping

and their plain scipy versions ``label8_plain``, ``edt_sq_plain`` and
``hausdorff_plain`` (the plain ``flip_small_regions`` is
``ops.morphology.flip_small_regions``), against which the tests and
``chip_smoke.py`` hold the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "wesup_native.cpp"
BUILD_DIR = _PKG / "_build"
DEFAULT_CXXFLAGS = "-O3 -march=native -fPIC -std=c++17 -Wall"

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.c_int32
_SIGNATURES = {
    "ccl_label": (ctypes.c_int32, [_U8P, _I32, _I32, _I32P]),
    "edt_sq": (None, [_U8P, _I32, _I32, _F32P]),
    "hausdorff_dist": (ctypes.c_double, [_U8P, _U8P, _I32, _I32]),
    "flip_small_regions": (None, [_U8P, _I32, _I32, ctypes.c_int64]),
}

_lock = threading.Lock()
_lib = None


def _command(out: Path) -> list:
    cxx = shlex.split(os.environ.get("CXX") or "g++")
    flags = shlex.split(os.environ.get("CXXFLAGS") or DEFAULT_CXXFLAGS)
    return [*cxx, *flags, "-shared", "-o", str(out), str(SOURCE)]


def build() -> Path:
    """Compile the library if this source, compiler and flags were not
    built yet; return its path."""
    probe = _command(Path("OUT"))
    digest = hashlib.sha256(" ".join(probe).encode())
    digest.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libwesup_native_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp.so"
    try:
        proc = subprocess.run(_command(tmp), capture_output=True, text=True)
    except OSError as ex:  # the compiler itself is missing
        raise RuntimeError(f"cannot build {SOURCE.name}: {ex}") from ex
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {SOURCE.name} failed (exit {proc.returncode}): "
            f"{' '.join(_command(tmp))}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                for name, (restype, argtypes) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                _lib = lib
    return _lib


def _as_u8(mask) -> np.ndarray:
    m = np.ascontiguousarray(np.asarray(mask) > 0, dtype=np.uint8)
    if m.ndim != 2:
        raise ValueError(f"expected 2-D mask, got shape {m.shape}")
    return m


def _ptr(array, kind):
    return array.ctypes.data_as(kind)


def label8(mask) -> np.ndarray:
    """(H, W) int32 labels of the 8-connected components of ``mask > 0``."""
    lib = library()
    m = _as_u8(mask)
    h, w = m.shape
    out = np.empty((h, w), np.int32)
    lib.ccl_label(_ptr(m, _U8P), h, w, _ptr(out, _I32P))
    return out


def edt_sq(mask) -> np.ndarray:
    """(H, W) f32 squared distance of each pixel to the nearest pixel of
    ``mask > 0`` (0 on the mask; 1e20 everywhere when it is empty)."""
    lib = library()
    m = _as_u8(mask)
    h, w = m.shape
    out = np.empty((h, w), np.float32)
    lib.edt_sq(_ptr(m, _U8P), h, w, _ptr(out, _F32P))
    return out


def hausdorff(a, b) -> float:
    """Symmetric Hausdorff distance between ``a > 0`` and ``b > 0``: 0 when
    both are empty, ``inf`` when one is."""
    lib = library()
    ma, mb = _as_u8(a), _as_u8(b)
    if ma.shape != mb.shape:
        raise ValueError("mask shapes differ")
    h, w = ma.shape
    return float(lib.hausdorff_dist(_ptr(ma, _U8P), _ptr(mb, _U8P), h, w))


def flip_small_regions(mask, threshold: int) -> np.ndarray:
    """``mask > 0`` as uint8 0/1 with foreground regions, then holes, of
    fewer than ``threshold`` pixels flipped."""
    lib = library()
    m = _as_u8(mask)
    h, w = m.shape
    lib.flip_small_regions(_ptr(m, _U8P), h, w, int(threshold))
    return m


# ---------------------------------------------------------------------------
# plain versions (scipy)
# ---------------------------------------------------------------------------

def label8_plain(mask) -> np.ndarray:
    """:func:`label8` by ``scipy.ndimage.label``, 8-connected."""
    from scipy import ndimage

    lab, _ = ndimage.label(_as_u8(mask), structure=np.ones((3, 3)))
    return lab.astype(np.int32)


def edt_sq_plain(mask) -> np.ndarray:
    """:func:`edt_sq` by ``scipy.ndimage.distance_transform_edt`` (f64,
    squared, then rounded to f32)."""
    from scipy import ndimage

    d = ndimage.distance_transform_edt(~_as_u8(mask).astype(bool))
    return (d * d).astype(np.float32)


def hausdorff_plain(a, b) -> float:
    """:func:`hausdorff` by ``scipy.spatial.distance.directed_hausdorff``
    on the two point sets (f64)."""
    from scipy.spatial.distance import directed_hausdorff

    ma, mb = _as_u8(a), _as_u8(b)
    if ma.shape != mb.shape:
        raise ValueError("mask shapes differ")
    if not ma.any() and not mb.any():
        return 0.0
    if not ma.any() or not mb.any():
        return float(np.inf)
    pa = np.column_stack(np.nonzero(ma))
    pb = np.column_stack(np.nonzero(mb))
    return float(max(directed_hausdorff(pa, pb)[0],
                     directed_hausdorff(pb, pa)[0]))
