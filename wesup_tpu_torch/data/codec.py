"""Image decode and encode without OpenCV.

The JAX data layer reads images with ``cv2.imread`` (``IMREAD_COLOR``
then BGR -> RGB, and ``IMREAD_GRAYSCALE`` for masks).  The port must run
where neither OpenCV nor PIL is installed, so it decodes the formats its
datasets ship by itself, equal to what ``cv2.imread`` returns for them:

- PNG, every bit depth and colour type, interlaced (Adam7) or not, every
  row filter.  Samples below 8 bits are unpacked (gray scaled to 0-255,
  palette indices looked up) and 16-bit samples keep their high byte, as
  OpenCV asks libpng for (``png_set_packing``, ``png_set_expand``,
  ``png_set_strip_16``).  Colour reads drop the alpha channel and
  replicate gray; grayscale reads of colour images use libpng's
  ``png_set_rgb_to_gray(0.299, 0.587)`` fixed-point weights (at 16 bits
  rounded, before the high byte is kept);
- BMP, uncompressed (``BI_RGB``), 8-bit palette, 24 and 32 bits (GlaS
  ships BMP); grayscale reads use OpenCV's own BGR -> gray weights
  (14-bit fixed point, rounded);
- JPEG, baseline, extended-sequential or progressive, Huffman- or
  arithmetic-coded, 8-bit, gray, YCbCr (or RGB), CMYK or YCCK, at any
  common sampling, with restart intervals, with or without its DHT
  segments (Motion-JPEG frames) and with the EXIF orientation applied, by
  the port's own library (``wesup_tpu_torch/csrc/jpeg.cpp`` through
  ``native.jpeg_decode``), which follows libjpeg-turbo's default
  decompressor step by step and OpenCV's own CMYK conversions.

Anything else (lossless, hierarchical, 12-bit or 2-component JPEG, a
progressive JPEG whose scans end short of full precision, which libjpeg
smooths; compressed or bit-field BMP; other formats) raises
``ValueError`` naming the file and the reason.  So do corrupt or
truncated data: where libjpeg fills the rest of a truncated JPEG with
gray and only warns, the port raises, as it does for a cut PNG.  There is
one route on every machine, whether OpenCV is installed or not.

Encoding, for synthetic datasets and for the masks that the inference
entry points and the server write, byte for byte as ``cv2.imencode``
writes each format at its defaults: :func:`encode_png` (8-bit gray, RGB
and RGBA), :func:`encode_bmp` (uncompressed 8-bit gray with a 256-entry
gray palette, or 24-bit colour) and :func:`encode_jpeg` (quality 95,
4:2:0).  :func:`imwrite` picks the format from the file's suffix, as
``cv2.imwrite`` does.  Colour images are RGB throughout, as
:func:`imread_rgb` returns them.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from .. import native

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # by colour type
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
# where the JPEG kinds that the library refuses are planned
_LATER = ("lossless, hierarchical, 12-bit, 2-component and smoothed "
          "progressive JPEG: ROADMAP Queue 1 item 9")


def _png_header(data: bytes, name: str):
    if data[12:16] != b"IHDR":
        raise ValueError(f"{name}: PNG without an IHDR chunk first")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                        data[16:29])
    if (ctype not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[ctype]
            or interlace > 1 or w == 0 or h == 0):
        raise ValueError(
            f"{name}: PNG with bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace} is not a valid PNG")
    return h, w, depth, ctype, interlace


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


# Adam7: (x0, y0, dx, dy) of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unpack(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """(h, w, ch) samples of unfiltered rows: uint8 for depths 1-8 (packed
    samples unpacked as ``png_set_packing`` does), uint16 for 16."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :w * ch].reshape(h, w, ch)
    if depth == 16:
        return (rows[:, :2 * w * ch].astype(np.uint16).reshape(h, w * ch, 2)
                @ np.array([256, 1], np.uint16)).reshape(h, w, ch)
    bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]


def _decode_png(data: bytes, name: str):
    """(H, W, C) samples (uint8, or uint16 at bit depth 16; palette indices
    expanded; gray below 8 bits scaled to 0-255 as
    ``png_set_expand_gray_1_2_4_to_8``), the colour type and the depth."""
    h, w, depth, ctype, interlace = _png_header(data, name)
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
    ch = _PNG_CHANNELS[ctype]
    bits = ch * depth
    fbpp = max(1, bits // 8)             # the filters' byte distance
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    pix = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        rowbytes = (pw * bits + 7) // 8
        size = ph * (1 + rowbytes)
        if raw.size < at + size:
            raise ValueError(f"{name}: PNG image data is truncated")
        rows = _unfilter(raw[at:at + size].reshape(ph, 1 + rowbytes), ph,
                         rowbytes // fbpp, fbpp).reshape(ph, rowbytes)
        pix[y0::dy, x0::dx] = _unpack(rows, pw, ch, depth)
        at += size
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without a PLTE chunk")
        pix = palette[pix[..., 0]]
    elif depth < 8:
        pix = pix * np.uint8(255 // ((1 << depth) - 1))
    return pix, ctype, depth


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


def _png_gray16(rgb: np.ndarray) -> np.ndarray:
    """libpng's 16-bit ``rgb_to_gray`` (rounded, the equal-sample shortcut
    not taken), then ``png_set_strip_16``'s high byte."""
    rc = 29900 * 32768 // 100000
    gc = 58700 * 32768 // 100000
    bc = 32768 - rc - gc
    x = rgb.astype(np.int64)
    y = (rc * x[..., 0] + gc * x[..., 1] + bc * x[..., 2] + 16384) >> 15
    return (y >> 8).astype(np.uint8)


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
    with ``IMREAD_COLOR`` (then BGR -> RGB) or ``IMREAD_GRAYSCALE``.

    Raises ``ValueError`` naming ``name`` for anything it cannot decode,
    a PNG, BMP or JPEG whose fields or data run past its bytes included
    (libjpeg would decode a truncated JPEG to a partly gray image)."""
    try:
        return _decode(bytes(data), gray, name)
    except (struct.error, zlib.error, IndexError) as ex:
        raise ValueError(f"{name}: corrupt or truncated image data "
                         f"({ex})") from ex


def _decode(data: bytes, gray: bool, name: str):
    if data[:8] == _PNG_SIG:
        pix, ctype, depth = _decode_png(data, name)
        if ctype in (0, 4):                       # gray, gray + alpha
            y = pix[..., 0]
            if depth == 16:
                y = (y >> 8).astype(np.uint8)
            return y if gray else np.repeat(y[..., None], 3, -1)
        rgb = pix[..., :3]
        if depth == 16:
            if gray:
                return _png_gray16(rgb)
            return (rgb >> 8).astype(np.uint8)
        return _png_gray(rgb) if gray else np.ascontiguousarray(rgb)
    if data[:2] == b"BM":
        return _decode_bmp(data, name, gray)
    if data[:2] == b"\xff\xd8":
        try:
            return native.jpeg_decode(data, gray)
        except ValueError as ex:
            later = f" ({_LATER})" if "is not decoded" in str(ex) else ""
            raise ValueError(f"{name}: {ex}{later}") from None
    raise ValueError(f"{name}: not a PNG, BMP or JPEG file")


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
    """(H, W) of the image that :func:`imread_rgb` would return, from the
    file's headers (a JPEG's EXIF orientation swaps them), or None where
    the file is missing or not an image it decodes (``cv2.imread`` returns
    None there)."""
    try:
        with open(path, "rb") as fp:
            head = fp.read(30)
            if head[:2] == b"\xff\xd8":
                head += fp.read()
    except OSError:
        return None
    if head[:8] == _PNG_SIG and head[12:16] == b"IHDR":
        w, h = struct.unpack(">II", head[16:24])
        return int(h), int(w)
    if head[:2] == b"BM" and len(head) >= 26:
        w, h = struct.unpack("<ii", head[18:26])
        return abs(h), w
    if head[:2] == b"\xff\xd8":
        try:
            return native.jpeg_size(head)
        except ValueError:
            return None
    return None


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _sub_rows(image, who: str):
    """(raw rows with their filter bytes, h, w, colour type) of an 8-bit
    (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA image, every row filtered
    with Sub, or with None where the image is one pixel wide, as
    ``png_write_start_row`` drops Sub there."""
    img = _uint8(image, who)
    if img.ndim == 2:
        img = img[..., None]
    h, w, bpp = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[bpp]
    rows = img.astype(np.int32)
    ftype = 0 if w == 1 else 1
    if ftype:
        rows[:, 1:] -= img[:, :-1]
    rows = (rows & 255).astype(np.uint8).reshape(h, w * bpp)
    raw = np.concatenate([np.full((h, 1), ftype, np.uint8), rows], axis=1)
    return raw.tobytes(), h, w, ctype


def _ihdr(h: int, w: int, ctype: int) -> bytes:
    return _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))


def encode_png(image: np.ndarray) -> bytes:
    """An 8-bit (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA PNG,
    byte-equal to ``cv2.imencode(".png")`` at OpenCV's defaults: Sub rows,
    zlib level 1 with the ``Z_RLE`` strategy, the window shrunk as libpng
    shrinks it for small images (``png_deflate_claim``: halved while the
    raw size plus 262 bytes fits in half of it; then ``optimize_cmf``
    lowers the zlib header's window field while the raw size fits in half
    of it), and IDAT chunks of libpng's 8192-byte buffer."""
    raw, h, w, ctype = _sub_rows(image, "encode_png")
    wbits = 15
    if len(raw) <= 16384:
        while len(raw) + 262 <= 1 << (wbits - 1):
            wbits -= 1
    z = zlib.compressobj(1, zlib.DEFLATED, wbits, 8, zlib.Z_RLE)
    data = bytearray(z.compress(raw) + z.flush())
    if len(raw) <= 16384:         # libpng's optimize_cmf: a smaller CINFO
        cinfo = data[0] >> 4
        half = 1 << (cinfo + 7)
        if len(raw) <= half:
            while True:
                half >>= 1
                cinfo -= 1
                if not (cinfo > 0 and len(raw) <= half):
                    break
            data[0] = (data[0] & 0x0F) | (cinfo << 4)
            flg = data[1] & 0xE0
            data[1] = flg + 0x1F - ((data[0] << 8) + flg) % 0x1F
    data = bytes(data)
    idat = b"".join(_chunk(b"IDAT", data[i:i + 8192])
                    for i in range(0, len(data), 8192))
    return _PNG_SIG + _ihdr(h, w, ctype) + idat + _chunk(b"IEND", b"")


def write_png(path, image: np.ndarray) -> None:
    """Write :func:`encode_png` of ``image`` to ``path``."""
    Path(path).write_bytes(encode_png(image))


_GRAY_PALETTE = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
_GRAY_PALETTE[:, 3] = 0


def encode_bmp(image: np.ndarray) -> bytes:
    """An uncompressed BMP of an (H, W) gray or (H, W, 3) RGB uint8 image,
    as ``cv2.imwrite`` writes one: an 8-bit image with a 256-entry gray
    palette, or a 24-bit BGR one; rows bottom-up, each padded with zeros
    to 4 bytes; resolution, image size and colour counts 0."""
    img = _uint8(image, "encode_bmp")
    if img.ndim == 3 and img.shape[-1] == 3:
        bits, pixels = 24, img[..., ::-1]                     # RGB -> BGR
        palette = b""
    elif img.ndim == 2:
        bits, pixels = 8, img
        palette = _GRAY_PALETTE.tobytes()
    else:
        raise ValueError(f"encode_bmp takes (H, W) or (H, W, 3), got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    stride = (w * bits // 8 + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * bits // 8] = pixels.reshape(h, -1)
    offset = 14 + 40 + len(palette)
    size = offset + rows.size
    return (struct.pack("<2sIHHI", b"BM", size, 0, 0, offset)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, 0, 0, 0, 0, 0,
                          0)
            + palette + rows[::-1].tobytes())


def write_bmp(path, image: np.ndarray) -> None:
    """Write :func:`encode_bmp` of ``image`` to ``path``."""
    Path(path).write_bytes(encode_bmp(image))


def encode_jpeg(image: np.ndarray) -> bytes:
    """The JPEG of an (H, W) gray or (H, W, 3) RGB uint8 image, byte-equal
    to ``cv2.imencode(".jpg")`` of it (as BGR) at OpenCV's defaults:
    quality 95, 4:2:0, standard Huffman tables (``native.jpeg_encode``)."""
    return native.jpeg_encode(_uint8(image, "encode_jpeg"))


def write_jpeg(path, image: np.ndarray) -> None:
    """Write :func:`encode_jpeg` of ``image`` to ``path``."""
    Path(path).write_bytes(encode_jpeg(image))


_WRITERS = {".png": write_png, ".bmp": write_bmp,
            ".jpg": write_jpeg, ".jpeg": write_jpeg}


def imwrite(path, image: np.ndarray) -> None:
    """Write ``image`` in the format its suffix names (``.png``, ``.bmp``,
    ``.jpg`` or ``.jpeg``, in any case), as ``cv2.imwrite`` picks it and
    byte for byte as it writes it; other suffixes raise ``ValueError``."""
    suffix = Path(path).suffix.lower()
    if suffix not in _WRITERS:
        raise ValueError(f"{path}: cannot write {suffix or 'a file without a '
                         'suffix'}; only .png, .bmp, .jpg and .jpeg are "
                         "written")
    _WRITERS[suffix](path, image)


def _uint8(image, who: str) -> np.ndarray:
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"{who} takes uint8, got {img.dtype}")
    return img
