"""Image decode and PNG encode in numpy and the standard library.

The JAX data layer reads images with ``cv2.imread`` (``IMREAD_COLOR``
then BGR -> RGB, and ``IMREAD_GRAYSCALE`` for masks).  The port must run
where neither OpenCV nor PIL is installed, so it decodes the formats its
datasets ship by itself, byte-equal to what ``cv2.imread`` returns for
them:

- PNG, 8 bits per sample, not interlaced: grayscale, RGB, palette, gray +
  alpha and RGBA, every row filter.  Colour reads drop the alpha channel
  and replicate gray; grayscale reads of colour images use libpng's
  ``png_set_rgb_to_gray(0.299, 0.587)`` fixed-point weights, as OpenCV
  asks libpng for;
- BMP, uncompressed (``BI_RGB``), 8-bit palette, 24 and 32 bits (GlaS
  ships BMP); grayscale reads use OpenCV's own BGR -> gray weights
  (14-bit fixed point, rounded).

Anything else (JPEG, 16-bit or interlaced PNG, compressed or bit-field
BMP) raises ``ValueError`` naming the file: JPEG decode waits for ROADMAP
Queue 1 item 12.  There is one route on every machine, whether OpenCV is
installed or not.

:func:`write_png` writes 8-bit gray, RGB and RGBA PNGs with a chosen row
filter (by default the five filters in turn), for synthetic datasets.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # by colour type
_LATER = "JPEG and other formats are not decoded yet (ROADMAP Queue 1 item 12)"


def _png_header(data: bytes, name: str):
    if data[12:16] != b"IHDR":
        raise ValueError(f"{name}: PNG without an IHDR chunk first")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                        data[16:29])
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(
            f"{name}: PNG with bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}; only 8-bit non-interlaced PNGs are "
            "decoded")
    return h, w, ctype


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of ``raw`` ((h, 1 + w * bpp) bytes).

    A byte depends on its left, upper and upper-left neighbours, so the
    pixels are reconstructed by anti-diagonals d = r + x, one vectorised
    step each, whatever the mix of filters.  The work runs in skewed
    coordinates, S[d + 2, r + 1] = pixel (r, x = d - r), where a
    diagonal's left and upper neighbours are the previous diagonal's
    slices and its upper-left ones the diagonal before that; index 0 on
    either axis is the zero padding the filters see beyond the image."""
    ftype = raw[:, 0].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {ftype.max()}")
    D = h + w - 1
    r = np.arange(h)[:, None]
    x = np.arange(w)[None, :]
    F = np.zeros((D, h, bpp), np.int32)
    F[r + x, r] = raw[:, 1:].reshape(h, w, bpp)
    S = np.zeros((D + 2, h + 1, bpp), np.int32)
    m = [(ftype == k).astype(np.int32)[:, None] for k in range(5)]
    for d in range(D):
        r0, r1 = max(0, d - w + 1), min(h, d + 1)
        a = S[d + 1, r0 + 1:r1 + 1]          # left
        b = S[d + 1, r0:r1]                  # up
        c = S[d, r0:r1]                      # upper left
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = (m[1][r0:r1] * a + m[2][r0:r1] * b
                + m[3][r0:r1] * ((a + b) >> 1) + m[4][r0:r1] * paeth)
        S[d + 2, r0 + 1:r1 + 1] = (F[d, r0:r1] + pred) & 255
    return S[r + x + 2, r + 1].astype(np.uint8)


def _decode_png(data: bytes, name: str):
    """(H, W, C) uint8 samples and the colour type (palette expanded)."""
    h, w, ctype = _png_header(data, name)
    pos, idat, palette = 8, [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(crc) != 4 or zlib.crc32(kind + body) != struct.unpack(
                ">I", crc)[0]:
            raise ValueError(f"{name}: PNG chunk {kind!r} is corrupt")
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IEND":
            break
        pos += 12 + length
    bpp = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (1 + w * bpp):
        raise ValueError(f"{name}: PNG image data is truncated")
    pix = _unfilter(raw[:h * (1 + w * bpp)].reshape(h, 1 + w * bpp), h, w,
                    bpp)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without a PLTE chunk")
        pix = palette[pix[..., 0]]
    return pix, ctype


def _png_gray(rgb: np.ndarray) -> np.ndarray:
    """libpng's ``rgb_to_gray`` at OpenCV's weights (0.299, 0.587): 15-bit
    coefficients from the fixed-point 29900 and 58700, truncated."""
    rc = 29900 * 32768 // 100000
    gc = 58700 * 32768 // 100000
    bc = 32768 - rc - gc
    x = rgb.astype(np.int64)
    y = (rc * x[..., 0] + gc * x[..., 1] + bc * x[..., 2]) >> 15
    grey = (x[..., 0] == x[..., 1]) & (x[..., 0] == x[..., 2])
    return np.where(grey, x[..., 0], y).astype(np.uint8)


def _bgr_gray(rgb: np.ndarray) -> np.ndarray:
    """OpenCV's BGR -> gray for decoders that convert themselves (BMP)."""
    cr = int(0.299 * (1 << 14) + 0.5)
    cg = int(0.587 * (1 << 14) + 0.5)
    cb = (1 << 14) - cr - cg
    x = rgb.astype(np.int64)
    return ((cr * x[..., 0] + cg * x[..., 1] + cb * x[..., 2] + (1 << 13))
            >> 14).astype(np.uint8)


def _decode_bmp(data: bytes, name: str, gray: bool) -> np.ndarray:
    offset, dib = struct.unpack("<II", data[10:18])
    w, h, _, bits, compression = struct.unpack("<iiHHI", data[18:34])
    if compression != 0 or bits not in (8, 24, 32) or dib < 40 or w <= 0:
        raise ValueError(f"{name}: BMP with {bits} bits, compression "
                         f"{compression}; only uncompressed 8/24/32-bit BMPs "
                         "are decoded")
    top_down, h = h < 0, abs(h)
    stride = (w * bits + 31) // 32 * 4
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h,
                                                                     stride)
    if not top_down:
        rows = rows[::-1]
    if bits == 8:
        n = struct.unpack("<I", data[46:50])[0] or 256
        pal = np.frombuffer(data, np.uint8, 4 * n, 14 + dib).reshape(n, 4)
        pal = pal[:, 2::-1]                                   # BGRX -> RGB
        if gray:
            pal = _bgr_gray(pal)
        return pal[rows[:, :w]]
    rgb = rows[:, :w * bits // 8].reshape(h, w, bits // 8)[..., 2::-1]
    return _bgr_gray(rgb) if gray else np.ascontiguousarray(rgb)


def decode(data: bytes, gray: bool = False, name: str = "<bytes>"):
    """(H, W, 3) RGB uint8, or (H, W) uint8 with ``gray``; ``cv2.imdecode``
    with ``IMREAD_COLOR`` (then BGR -> RGB) or ``IMREAD_GRAYSCALE``."""
    if data[:8] == _PNG_SIG:
        pix, ctype = _decode_png(data, name)
        if ctype in (0, 4):                       # gray, gray + alpha
            return pix[..., 0] if gray else np.repeat(pix[..., :1], 3, -1)
        rgb = pix[..., :3]
        return _png_gray(rgb) if gray else np.ascontiguousarray(rgb)
    if data[:2] == b"BM":
        return _decode_bmp(data, name, gray)
    raise ValueError(f"{name}: {_LATER}")


def _read(path) -> bytes:
    try:
        return Path(path).read_bytes()
    except (FileNotFoundError, IsADirectoryError) as ex:
        raise FileNotFoundError(f"cannot read image: {path}") from ex


def imread_rgb(path) -> np.ndarray:
    """(H, W, 3) RGB uint8, as ``cv2.imread(IMREAD_COLOR)`` + BGR -> RGB."""
    return decode(_read(path), gray=False, name=str(path))


def imread_mask(path) -> np.ndarray:
    """(H, W) uint8, as ``cv2.imread(IMREAD_GRAYSCALE)``."""
    return decode(_read(path), gray=True, name=str(path))


def image_size(path):
    """(H, W) from the file's header, or None where the file is missing or
    not a PNG or BMP (``cv2.imread`` returns None there)."""
    try:
        with open(path, "rb") as fp:
            head = fp.read(30)
    except OSError:
        return None
    if head[:8] == _PNG_SIG and head[12:16] == b"IHDR":
        w, h = struct.unpack(">II", head[16:24])
        return int(h), int(w)
    if head[:2] == b"BM" and len(head) >= 26:
        w, h = struct.unpack("<ii", head[18:26])
        return abs(h), w
    return None


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path, image: np.ndarray, row_filter: int | None = None) -> None:
    """Write an 8-bit (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA PNG.

    ``row_filter`` (0-4: none, sub, up, average, Paeth) filters every row
    alike; ``None`` gives row ``i`` filter ``i % 5``, so one file holds
    all five."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, bpp = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[bpp]
    x = img.astype(np.int32)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c)]
    ftype = (np.arange(h) % 5 if row_filter is None
             else np.full(h, int(row_filter)))
    pred = np.choose(ftype[:, None, None], preds)
    rows = ((x - pred) & 255).astype(np.uint8).reshape(h, w * bpp)
    raw = np.concatenate([ftype[:, None].astype(np.uint8), rows], axis=1)
    Path(path).write_bytes(
        _PNG_SIG
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b""))
