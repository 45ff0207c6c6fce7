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
- BMP, every kind that OpenCV's own BMP decoder reads (GlaS ships BMP):
  1-, 4- and 8-bit palettes (short palettes padded with black), RLE4 and
  RLE8 (end-of-line, delta and absolute runs; skipped pixels take palette
  entry 0), 16-bit 5-5-5 and ``BI_BITFIELDS`` 5-6-5 (channels shifted,
  not bit-replicated), 24 and 32 bits (``BI_RGB`` or ``BI_BITFIELDS``,
  read as BGRA whatever the masks), the OS/2 12-byte header, top-down or
  bottom-up rows; grayscale reads use OpenCV's own BGR -> gray weights
  (14-bit fixed point, rounded) on the pixel or its palette entry;
- JPEG, baseline, extended-sequential or progressive, Huffman- or
  arithmetic-coded, 8-bit, gray, YCbCr (or RGB), CMYK or YCCK, at any
  common sampling, with restart intervals, with or without its DHT
  segments (Motion-JPEG frames), progressive files that end short of full
  precision (libjpeg's block smoothing), lossless files (SOF3, 2-8 bits,
  every predictor and point transform, in the read modes cv2 reads them)
  and with the EXIF orientation applied, by the port's own library
  (``wesup_tpu_torch/csrc/jpeg.cpp`` through ``native.jpeg_decode``),
  which follows libjpeg-turbo's default decompressor step by step and
  OpenCV's own CMYK conversions.

What cv2 does not read raises :class:`ImageReadError`, which is both a
``FileNotFoundError`` (as the JAX package's readers raise where
``cv2.imread`` returns None) and a ``ValueError``: hierarchical, 12-bit,
2-component or lossless arithmetic-coded JPEG, a lossless file in a read
mode libjpeg-turbo does not convert, other formats.  Its message starts as
the JAX package's (``cannot read image: <path>`` or ``cannot read mask:
<path>``) and gives the reason.  A path is read as ``cv2.imread`` reads a
file (libjpeg's stdio source supplies the EOI marker a JPEG lacks at its
end), bytes as ``cv2.imdecode`` reads them (a JPEG of several scans
without its EOI is refused).  A damaged JPEG or PNG reads as cv2 reads it:
the JPEG library recovers where libjpeg-turbo recovers with a warning
(bad Huffman codes, runs past coefficient 63, entropy data that runs short
and is filled with gray, restart markers lost or out of order, arithmetic
decoding errors) and the PNG reader where libpng does (a CRC error in an
ancillary chunk drops it); each refuses where cv2 returns None.  There is
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
from .jpeg import CV2_TOO

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # by colour type
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}


class ImageReadError(FileNotFoundError, ValueError):
    """An image that ``cv2.imread`` returns None for.  A
    ``FileNotFoundError``, as the JAX package's readers raise there, and a
    ``ValueError``, as the port's decoder always raised."""


def _png_header(data: bytes):
    if data[12:16] != b"IHDR":
        raise ValueError("PNG without an IHDR chunk first")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                        data[16:29])
    if (ctype not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[ctype]
            or interlace > 1 or w == 0 or h == 0):
        raise ValueError(
            f"PNG with bit depth {depth}, colour type {ctype}, "
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


def _decode_png(data: bytes):
    """(H, W, C) samples (uint8, or uint16 at bit depth 16; palette indices
    expanded; gray below 8 bits scaled to 0-255 as
    ``png_set_expand_gray_1_2_4_to_8``), the colour type and the depth."""
    h, w, depth, ctype, interlace = _png_header(data)
    idat, palette = _png_chunks(data, ctype)
    ch = _PNG_CHANNELS[ctype]
    bits = ch * depth
    fbpp = max(1, bits // 8)             # the filters' byte distance
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    pix = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        rowbytes = (pw * bits + 7) // 8
        size = ph * (1 + rowbytes)
        if raw.size < at + size:
            raise ValueError("PNG image data is truncated")
        rows = _unfilter(raw[at:at + size].reshape(ph, 1 + rowbytes), ph,
                         rowbytes // fbpp, fbpp).reshape(ph, rowbytes)
        pix[y0::dy, x0::dx] = _unpack(rows, pw, ch, depth)
        at += size
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        pix = palette[pix[..., 0]]
    elif depth < 8:
        pix = pix * np.uint8(255 // ((1 << depth) - 1))
    return pix, ctype, depth


def _png_chunks(data: bytes, ctype: int):
    """The image data and the palette of a PNG, its chunks walked as
    libpng 1.6 reads them for OpenCV: a CRC error drops an ancillary
    chunk (a warning), is ignored in IEND and in a PLTE that a palette
    does not need, and refuses any other critical chunk; an unknown
    critical chunk, a second IHDR, a chunk type that is not four letters
    and a file that ends before its IEND are refused; IDAT chunks after
    another chunk are ignored where the data before it holds the whole
    zlib stream (a benign error), and refused otherwise."""
    pos, idat, palette, runs = 8, [], None, 0
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"PNG without its IEND chunk{CV2_TOO}")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        pos += 12 + length
        if not kind.isalpha() or not kind.isascii():
            raise ValueError(f"PNG chunk type {kind!r} is invalid{CV2_TOO}")
        if len(crc) != 4 or length >= 1 << 31:
            raise ValueError(f"PNG chunk {kind!r} is corrupt")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            if kind[0] & 0x20:                        # ancillary
                continue
            if kind not in (b"IEND", b"PLTE") or (kind == b"PLTE"
                                                  and ctype == 3):
                raise ValueError(f"PNG chunk {kind!r} is corrupt")
        if kind == b"IDAT":
            if runs == 2:
                # image data split by another chunk: libpng ran out of it
                # at that chunk unless the stream ended before it
                z = zlib.decompressobj()
                z.decompress(b"".join(idat))
                if not z.eof:
                    raise ValueError(f"PNG image data is truncated{CV2_TOO}")
                continue
            runs = 1
            idat.append(body)
            continue
        if runs == 1:
            runs = 2
        if kind == b"IEND":
            return b"".join(idat), palette
        if kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IHDR" and pos > 33:
            raise ValueError(f"PNG with a second IHDR chunk{CV2_TOO}")
        elif not kind[0] & 0x20 and kind != b"IHDR":
            raise ValueError(f"PNG chunk {kind!r} is an unknown critical "
                             f"chunk{CV2_TOO}")


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


def _bmp_header(data: bytes):
    """(width, height, bits, compression, palette (256, 3) RGB or None,
    masks or None) of a BMP as OpenCV's ``BmpDecoder::readHeader`` reads
    it: a DIB header
    of 36 bytes or more (16-bit files 5-5-5, or ``BI_BITFIELDS`` with the
    R, G, B masks of 5-6-5 or 5-5-5 read right after the header, whatever
    its size; 32-bit ``BI_BITFIELDS`` read as BGRA unless a header of 56
    bytes or more holds three nonzero masks), or the OS/2 12-byte one; a
    palette of ``biClrUsed`` entries (0: all), the rest black.  Bits 15
    stand for 5-5-5; ``masks`` are a masked 32-bit file's R, G, B ones."""
    size = struct.unpack("<i", data[14:18])[0]
    if size >= 36:
        w, h, bits, comp = struct.unpack("<iiiI", data[18:34])
        bits >>= 16                                 # planes, then bits
        used = struct.unpack("<i", data[46:50])[0]
        ok = w > 0 and h != 0 and (
            (bits in (1, 4, 8, 24, 32) and comp == 0)
            or (bits in (16, 32) and comp in (0, 3))
            or (bits, comp) in ((4, 2), (8, 1)))
        if not ok or comp > 3:
            raise ValueError(f"BMP with {bits} bits and compression {comp} "
                             "is not decoded")
        pal = masks = None
        at = 14 + size
        if bits <= 8:
            if not 0 <= used <= 256:
                raise ValueError("corrupt BMP palette size")
            n = used or 1 << bits
            entries = np.frombuffer(data[at:at + 4 * n], np.uint8)
            if entries.size != 4 * n:
                raise ValueError("truncated BMP palette")
            pal = np.zeros((256, 3), np.uint8)
            pal[:n] = entries.reshape(n, 4)[:, 2::-1]      # BGRX -> RGB
        elif bits == 16 and comp == 3:
            masks = struct.unpack("<III", data[at:at + 12])
            if masks not in ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)):
                raise ValueError(f"BMP with bit-field masks {masks} is not "
                                 "decoded")
            bits = 15 if masks[0] == 0x7C00 else 16
        elif bits == 16:
            bits = 15
        elif bits == 32 and comp == 3 and size >= 56:
            masks = struct.unpack("<III", data[54:66])
            if not all(masks):
                masks = None
            for m in masks or ():
                if (m + (m & -m)) & m:
                    raise ValueError(f"BMP with the bit-field mask {m:#x} "
                                     "is not decoded")
        return w, h, bits, comp, pal, masks
    if size != 12:
        raise ValueError(f"BMP with a {size}-byte header is not decoded")
    w, h, planes, bits = struct.unpack("<HHHH", data[18:26])
    if not (w > 0 and h > 0 and planes == 1 and bits in (1, 4, 8, 24, 32)):
        raise ValueError(f"OS/2 BMP with {bits} bits is not decoded")
    pal = None
    if bits <= 8:
        n = 1 << bits
        entries = np.frombuffer(data[26:26 + 3 * n], np.uint8)
        if entries.size != 3 * n:
            raise ValueError("truncated BMP palette")
        pal = np.zeros((256, 3), np.uint8)
        pal[:n] = entries.reshape(n, 3)[:, ::-1]
    return w, h, bits, 0, pal, None


def _bmp_rle(data: bytes, at: int, w: int, h: int, bits: int):
    """(h, w) palette indices, first stored row first, of RLE8 (``bits``
    8) or RLE4 data from ``at``, decoded as OpenCV's ``BmpDecoder``
    decodes it: a cursor over the rows that escape codes move by filling
    with entry 0.  RLE8: end of line fills the rest of the row, end of
    bitmap the rest of the image, delta (dx, dy) dx + dy * w pixels; an
    encoded run that fills a row steps to the next, and an end-of-line
    code right after it is a no-op.  RLE4: end of line and end of bitmap
    both fill the rest of the row, delta dx pixels (dy is read and
    ignored).  A run past its row is corrupt, as is data that ends before
    the last row."""
    out = np.zeros((h, w), np.uint8)
    y = x = 0
    stepped = False                       # RLE8: the last run ended a row

    def fill(count, value):
        nonlocal y, x
        while True:
            end = min(x + count, w)
            count -= end - x
            out[y, x:end] = value
            x = end
            if x >= w:
                y, x = y + 1, 0
                if y >= h:
                    return
            if count <= 0:
                return

    while y < h:
        if at + 2 > len(data):
            raise ValueError("truncated BMP RLE data")
        n, code = data[at], data[at + 1]
        at += 2
        if n:                                           # encoded mode
            if x + n > w:
                raise ValueError("corrupt BMP RLE data (a run past its row)")
            if bits == 8:
                row = y
                fill(n, code)
                stepped = y != row
            else:
                out[y, x:x + n] = np.array([code >> 4, code & 15])[
                    np.arange(n) % 2]
                x += n
        elif code > 2:                                  # absolute mode
            if x + code > w:
                raise ValueError("corrupt BMP RLE data (a run past its row)")
            size = ((code + 1) & ~1 if bits == 8
                    else (((code + 1) >> 1) + 1) & ~1)
            raw = np.frombuffer(data[at:at + size], np.uint8)
            if raw.size != size:
                raise ValueError("truncated BMP RLE data")
            at += size
            if bits == 4:
                raw = np.stack([raw >> 4, raw & 15], 1).reshape(-1)
            out[y, x:x + code] = raw[:code]
            x += code
            stepped = False
        else:
            skip = w - x
            if bits == 4 or code or not stepped or skip < w:
                rows = h - y
                if code == 2:
                    if at + 2 > len(data):
                        raise ValueError("truncated BMP RLE data")
                    skip, rows = data[at], data[at + 1]
                    at += 2
                # RLE4 moves by the row's rest or dx alone
                fill(skip + (rows * w if code and bits == 8 else 0), 0)
            stepped = False
    return out


def _decode_bmp(data: bytes, gray: bool) -> np.ndarray:
    """OpenCV's own BMP decoder (``grfmt_bmp.cpp``): see
    :func:`_bmp_header` and :func:`_bmp_rle`; colour (RGB) or gray
    (OpenCV's BGR -> gray weights on each pixel or palette entry)."""
    w, h, bits, comp, pal, masks = _bmp_header(data)
    top_down, h = h < 0, abs(h)
    if w * h > 1 << 30:
        raise ValueError(f"BMP of {w}x{h} pixels is too large (limit 2^30)")
    offset = struct.unpack("<I", data[10:14])[0]
    if comp in (1, 2):
        px = _bmp_rle(data, offset, w, h, bits)
    else:
        stride = (w * (16 if bits == 15 else bits) + 31) // 32 * 4
        rows = np.frombuffer(data[offset:offset + stride * h], np.uint8)
        if rows.size != stride * h:
            raise ValueError("truncated BMP pixel data")
        rows = rows.reshape(h, stride)
        if bits < 8:
            px = np.unpackbits(rows, axis=1).reshape(h, -1, bits)
            px = (px << np.arange(bits - 1, -1, -1)).sum(-1)[:, :w]
        elif bits == 8:
            px = rows[:, :w]
        elif bits in (15, 16):         # channels shifted, not replicated
            t = rows[:, :2 * w].view("<u2").astype(np.int64)
            g = (t >> 2) & 0xF8 if bits == 15 else (t >> 3) & 0xFC
            r = (t >> 7) & 0xF8 if bits == 15 else (t >> 8) & 0xF8
            px = np.stack([r, g, (t << 3) & 0xF8], -1).astype(np.uint8)
        elif masks:
            # each channel scaled to 8 bits, truncated; gray in float32,
            # truncated
            u = rows[:, :4 * w].view("<u4").astype(np.int64)
            ch = [(u & m) // (m & -m) * 255 // (m // (m & -m))
                  for m in masks]
            if gray:
                r, g, b = (c.astype(np.float32) for c in ch)
                y = (np.float32(0.299) * r + np.float32(0.587) * g
                     + np.float32(0.114) * b)
                return _bmp_rows(y.astype(np.uint8), top_down)
            px = np.stack(ch, -1).astype(np.uint8)
        else:                          # BGR or BGRA, the masks unread
            px = rows[:, :w * bits // 8].reshape(h, w, bits // 8)[..., 2::-1]
    if bits <= 8:                      # palette indices
        px = (_bgr_gray(pal) if gray else pal)[px]
    elif gray:
        px = _bgr_gray(px)
    return _bmp_rows(px, top_down)


def _bmp_rows(px: np.ndarray, top_down: bool) -> np.ndarray:
    """The stored rows in image order: a BMP's are bottom-up unless its
    height is negative."""
    return np.ascontiguousarray(px if top_down else px[::-1])


def decode(data: bytes, gray: bool = False, name: str = "<bytes>", *,
           file: bool = False, kind: str = "image"):
    """(H, W, 3) RGB uint8, or (H, W) uint8 with ``gray``; ``cv2.imdecode``
    with ``IMREAD_COLOR`` (then BGR -> RGB) or ``IMREAD_GRAYSCALE``, or
    with ``file`` ``cv2.imread`` of a file that holds ``data``.

    Raises :class:`ImageReadError` ("cannot read <kind>: <name>: <reason>")
    for anything it cannot decode, a PNG, BMP or JPEG whose fields or data
    run past its bytes included (``cv2.imdecode`` returns None for a
    truncated JPEG; ``cv2.imread``, and ``file``, decode it with the rest
    gray)."""
    try:
        return _decode(bytes(data), gray, file)
    except (struct.error, zlib.error, IndexError, ValueError) as ex:
        reason = str(ex)
        if not isinstance(ex, ValueError):
            reason = f"corrupt or truncated image data ({ex})"
        raise ImageReadError(f"cannot read {kind}: {name}: {reason}") from ex


def _decode(data: bytes, gray: bool, file: bool):
    if data[:8] == _PNG_SIG:
        pix, ctype, depth = _decode_png(data)
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
        try:
            return _decode_bmp(data, gray)
        except struct.error as ex:
            raise ValueError(f"corrupt or truncated image data ({ex})"
                             f"{CV2_TOO}") from ex
        except ValueError as ex:
            # the decoder is OpenCV's, which refuses the same files
            raise ValueError(f"{ex}{CV2_TOO}") from ex
    if data[:2] == b"\xff\xd8":
        return native.jpeg_decode(data, gray, file)
    raise ValueError("not a PNG, BMP or JPEG file")


def _read(path, kind: str) -> bytes:
    try:
        return Path(path).read_bytes()
    except (FileNotFoundError, IsADirectoryError) as ex:
        raise ImageReadError(f"cannot read {kind}: {path}: no such "
                             "file") from ex


def imread_rgb(path) -> np.ndarray:
    """(H, W, 3) RGB uint8, as ``cv2.imread(IMREAD_COLOR)`` + BGR -> RGB."""
    return decode(_read(path, "image"), gray=False, name=str(path),
                  file=True)


def imread_mask(path) -> np.ndarray:
    """(H, W) uint8, as ``cv2.imread(IMREAD_GRAYSCALE)``."""
    return decode(_read(path, "mask"), gray=True, name=str(path), file=True,
                  kind="mask")


def image_size(path, gray: bool = False):
    """(H, W) of the image that :func:`imread_rgb` (with ``gray``,
    :func:`imread_mask`) would return, from the file's headers (a JPEG's
    EXIF orientation swaps them), or None where the file is missing or
    its headers show an image that read refuses (``cv2.imread`` returns
    None there: a lossless JPEG that cv2 reads only in the other mode)."""
    try:
        with open(path, "rb") as fp:
            head = fp.read(30)
            if head[:2] == b"\xff\xd8":
                head += fp.read()
            elif head[:2] == b"BM":          # the DIB header and palette
                head += fp.read(2048)
    except OSError:
        return None
    if head[:8] == _PNG_SIG and head[12:16] == b"IHDR":
        w, h = struct.unpack(">II", head[16:24])
        return int(h), int(w)
    if head[:2] == b"BM":
        try:
            w, h = _bmp_header(head)[:2]
        except (ValueError, struct.error):
            return None
        return abs(h), w
    if head[:2] == b"\xff\xd8":
        try:
            return native.jpeg_size(head, gray)
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
