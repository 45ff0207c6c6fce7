"""The port's native code: how it is built and loaded, and the bindings
of its host libraries, the evaluation kernels of
``wesup_tpu_torch/csrc/wesup_native.cpp`` and the JPEG codec of
``wesup_tpu_torch/csrc/jpeg.cpp``.

:func:`load` builds and loads every native library of the port: the CUDA
kernels' (``csrc/*.cu``, with nvcc: ``ops/kernels.py``) and these two host
libraries (with the host's C++ compiler, ``$CXX``, else ``g++``, and the
flags of ``csrc/Makefile``, ``$CXXFLAGS``, else ``-O3 -march=native -fPIC
-std=c++17 -Wall``).  On first use it compiles each source by its own
compiler process, all started together, and links the objects into
``wesup_tpu_torch/_build/`` under a name keyed by a hash of the compiler
command, the flags and every source and header; the finished file is
moved into place atomically, so processes that build at once never load
half a file.  A failed build raises ``RuntimeError`` with the failing
sources' names and the compiler's log, and leaves no file: there is no
quiet fallback.

The first host library is a copy of ``wesup_tpu.native``.  Provided:
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
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCE = CSRC / "wesup_native.cpp"
JPEG_SOURCE = CSRC / "jpeg.cpp"
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


class Built(NamedTuple):
    """One library's build: its path, the compiler's seconds and log (0
    and empty where a finished library was reused)."""

    path: Path
    seconds: float = 0.0
    log: str = ""


_lock = threading.Lock()
_libs: dict = {}
builds: dict = {}    # each library this process loaded, by name: its Built


def _run(steps: list, log: list) -> list:
    """Run the (name, command) ``steps`` all together, appending each
    command and its output to ``log``; the names of those that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _, cmd in steps]
    failed = []
    for (name, cmd), proc in zip(steps, procs):
        log.append(f"== {name}: {shlex.join(cmd)}\n{proc.communicate()[0]}")
        if proc.returncode != 0:
            failed.append(name)
    return failed


def build(name: str, compiler: list, flags: list, sources: list,
          headers: list = ()) -> Built:
    """Compile each of ``sources`` by its own ``compiler`` process with
    ``flags``, all started together, and link the objects into
    ``lib<name>_<key>.so`` under :data:`BUILD_DIR`, unless that library is
    there already; ``<key>`` hashes the compiler command, the flags and
    every source's and header's name and bytes."""
    digest = hashlib.sha256(shlex.join([*compiler, *flags]).encode())
    for path in sorted([*sources, *headers]):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return Built(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    lines: list = []
    t0 = time.perf_counter()
    try:
        failed = _run([(src.name,
                        [*compiler, *flags, "-c", "-o", str(obj), str(src)])
                       for src, obj in zip(sources, objs)], lines)
        if not failed:
            failed = _run([(out.name,
                            [*compiler, "-shared", "-o", str(tmp),
                             *map(str, objs)])], lines)
    except OSError as ex:    # the compiler cannot be started
        failed = [src.name for src in sources]
        lines.append(str(ex))
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    log = "".join(lines)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {', '.join(failed)} failed:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return Built(out, time.perf_counter() - t0, log)


def load(name: str, signatures: dict, recipe) -> ctypes.CDLL:
    """The library ``name``, built on first call from ``recipe()`` (the
    compiler command, flags, sources and headers of :func:`build`) and
    loaded once, its functions given ``signatures`` (symbol: (restype,
    argtypes))."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                built = build(name, *recipe())
                lib = ctypes.CDLL(str(built.path))
                for symbol, (restype, argtypes) in signatures.items():
                    fn = getattr(lib, symbol)
                    fn.restype = restype
                    fn.argtypes = argtypes
                builds[name] = built
                _libs[name] = lib
    return lib


def _cxx(source: Path):
    """The host compiler command, its flags and ``source``, for
    :func:`build`."""
    return (shlex.split(os.environ.get("CXX") or "g++"),
            shlex.split(os.environ.get("CXXFLAGS") or DEFAULT_CXXFLAGS),
            [source])


def library() -> ctypes.CDLL:
    """The loaded evaluation library, built on first call."""
    return load("wesup_native", _SIGNATURES, lambda: _cxx(SOURCE))


def jpeg_library() -> ctypes.CDLL:
    """The loaded JPEG library, built on first call."""
    return load("jpeg", _JPEG_SIGNATURES, lambda: _cxx(JPEG_SOURCE))


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
