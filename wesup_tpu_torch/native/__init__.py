"""ctypes bindings for the port's host libraries: the evaluation kernels of
``wesup_tpu_torch/csrc/wesup_native.cpp`` and the JPEG codec of
``wesup_tpu_torch/csrc/jpeg.cpp``.

The first is a copy of ``wesup_tpu.native``.  Each library is built by
the port itself: on first use, with the host's C++ compiler (``$CXX``,
else ``g++``) and the flags of ``csrc/Makefile`` (``$CXXFLAGS``, else
``-O3 -march=native -fPIC -std=c++17 -Wall``), into
``wesup_tpu_torch/_build/`` under a name keyed by a hash of the
compiler, the flags and the source; the finished file is moved into
place atomically, so processes that build at once never load half a
file.  A failed build raises ``RuntimeError`` with the compiler's log:
there is no quiet fallback.

Provided:
    label8(mask)             -- 8-connectivity CCL (skimage.label semantics),
                                labels numbered in raster order
    edt_sq(mask)             -- exact squared EDT to the nonzero set (f32)
    hausdorff(a, b)          -- symmetric Hausdorff, O(N) via two EDTs
    flip_small_regions(m, t) -- evaluation postprocess region flipping

and their plain scipy versions ``label8_plain``, ``edt_sq_plain`` and
``hausdorff_plain`` (the plain ``flip_small_regions`` is
``ops.morphology.flip_small_regions``), against which the tests and
``chip_smoke.py`` hold the library.  From the JPEG library:

    jpeg_decode(data, gray, file)
                             -- (H, W, 3) RGB or (H, W) uint8, as
                                cv2.imdecode (or, with ``file``,
                                cv2.imread) reads them, EXIF orientation
                                applied
    jpeg_size(data, gray)    -- (H, W) of jpeg_decode from the headers
    jpeg_encode(image)       -- the bytes of cv2.imencode(".jpg") at its
                                defaults

whose plain versions are ``data/jpeg.py``'s ``decode_plain`` and
``encode_plain``.  They raise ``ValueError`` with the library's reason.
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
JPEG_SOURCE = _PKG / "csrc" / "jpeg.cpp"
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
_U8PP = ctypes.POINTER(_U8P)
_JPEG_SIGNATURES = {
    "jpeg_size": (_I32, [ctypes.c_char_p, ctypes.c_size_t, _I32, _I32P,
                         _I32P, _I32P, ctypes.c_char_p, _I32]),
    "jpeg_decode": (_I32, [ctypes.c_char_p, ctypes.c_size_t, _I32, _U8PP,
                           _I32P, _I32P, ctypes.c_char_p, _I32]),
    "jpeg_encode": (ctypes.c_size_t, [_U8P, _I32, _I32, _I32, _U8PP]),
    "jpeg_free": (None, [_U8P]),
}

_lock = threading.Lock()
_libs = {}


def _command(out: Path, source: Path = SOURCE) -> list:
    cxx = shlex.split(os.environ.get("CXX") or "g++")
    flags = shlex.split(os.environ.get("CXXFLAGS") or DEFAULT_CXXFLAGS)
    return [*cxx, *flags, "-shared", "-o", str(out), str(source)]


def build(source: Path = SOURCE) -> Path:
    """Compile the library of ``source`` if this source, compiler and
    flags were not built yet; return its path."""
    probe = _command(Path("OUT"), source)
    digest = hashlib.sha256(" ".join(probe).encode())
    digest.update(source.read_bytes())
    stem = "wesup_native" if source == SOURCE else source.stem
    out = BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp.so"
    try:
        proc = subprocess.run(_command(tmp, source), capture_output=True,
                              text=True)
    except OSError as ex:  # the compiler itself is missing
        raise RuntimeError(f"cannot build {source.name}: {ex}") from ex
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {source.name} failed (exit {proc.returncode}): "
            f"{' '.join(_command(tmp, source))}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load(source: Path, signatures: dict) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is None:
        with _lock:
            lib = _libs.get(source)
            if lib is None:
                lib = ctypes.CDLL(str(build(source)))
                for name, (restype, argtypes) in signatures.items():
                    fn = getattr(lib, name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                _libs[source] = lib
    return lib


def library() -> ctypes.CDLL:
    """The loaded evaluation library, built on first call."""
    return _load(SOURCE, _SIGNATURES)


def jpeg_library() -> ctypes.CDLL:
    """The loaded JPEG library, built on first call."""
    return _load(JPEG_SOURCE, _JPEG_SIGNATURES)


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
# JPEG
# ---------------------------------------------------------------------------

def jpeg_size(data: bytes, gray: bool = False):
    """(H, W) that :func:`jpeg_decode` gives, from the markers before the
    first scan (the orientation tag swaps them); ``ValueError`` where they
    show a file that the read (``gray`` or colour) refuses."""
    lib = jpeg_library()
    h, w, o = _I32(), _I32(), _I32()
    err = ctypes.create_string_buffer(256)
    if lib.jpeg_size(data, len(data), int(bool(gray)), ctypes.byref(h),
                     ctypes.byref(w), ctypes.byref(o), err, 256):
        raise ValueError(err.value.decode())
    return (w.value, h.value) if o.value >= 5 else (h.value, w.value)


def jpeg_decode(data: bytes, gray: bool = False,
                file: bool = False) -> np.ndarray:
    """(H, W, 3) RGB or, with ``gray``, (H, W) uint8 samples of a JPEG,
    as ``cv2.imdecode`` gives them (``IMREAD_COLOR`` then BGR -> RGB, or
    ``IMREAD_GRAYSCALE``), the EXIF orientation applied.  With ``file``,
    as ``cv2.imread`` reads the same bytes from a file: libjpeg's stdio
    source supplies an EOI marker at the end of the data."""
    lib = jpeg_library()
    out, h, w = _U8P(), _I32(), _I32()
    err = ctypes.create_string_buffer(256)
    flags = int(bool(gray)) | 2 * int(bool(file))
    if lib.jpeg_decode(data, len(data), flags, ctypes.byref(out),
                       ctypes.byref(h), ctypes.byref(w), err, 256):
        raise ValueError(err.value.decode())
    try:
        shape = (h.value, w.value) if gray else (h.value, w.value, 3)
        return np.ctypeslib.as_array(out, shape=shape).copy()
    finally:
        lib.jpeg_free(out)


def jpeg_encode(image) -> bytes:
    """The JPEG of an (H, W) gray or (H, W, 3) RGB uint8 image, byte-equal
    to ``cv2.imencode(".jpg", image[..., ::-1])`` at its defaults."""
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (1, 3))):
        raise ValueError("jpeg_encode takes (H, W) or (H, W, 3) uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"JPEG sides are 1-65535 pixels, got {h}x{w}")
    lib = jpeg_library()
    out = _U8P()
    size = lib.jpeg_encode(_ptr(img, _U8P), h, w, ch, ctypes.byref(out))
    if not size:
        raise ValueError("JPEG encode failed")
    try:
        return ctypes.string_at(out, size)
    finally:
        lib.jpeg_free(out)


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
