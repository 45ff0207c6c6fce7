"""A BMP writer for the port's decode tests and ``chip_smoke.py``: numpy
only, so that the card's machine can run it.

The port's own encoder writes only what ``cv2.imwrite(".bmp")`` writes
(8-bit gray with a full palette, or 24 bits), so the other kinds that
OpenCV's BMP decoder reads are made here: 1-, 4- and 8-bit palettes of
any length, RLE4 and RLE8 (encoded, absolute, end-of-line, delta and
end-of-bitmap codes), 16-bit 5-5-5 (``BI_RGB``) and 5-6-5 or 5-5-5
(``BI_BITFIELDS``), 32 bits with or without ``BI_BITFIELDS``, the OS/2
12-byte header and the 108- and 124-byte ones, bottom-up or top-down.
"""

from __future__ import annotations

import struct

import numpy as np

BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3
MASKS_565 = (0xF800, 0x07E0, 0x001F)
MASKS_555 = (0x7C00, 0x03E0, 0x001F)


def _rows(rows, top_down):
    """Stored row order: bottom-up unless ``top_down``."""
    return rows if top_down else rows[::-1]


def pack_rows(samples: np.ndarray, bits: int, top_down: bool = False):
    """The pixel array of (H, W) palette indices or 16-bit values, or
    (H, W, 3 or 4) stored bytes (BGR or BGRA), rows padded to 4 bytes."""
    x = np.asarray(samples)
    h = x.shape[0]
    if bits == 16:
        raw = x.astype("<u2").view(np.uint8).reshape(h, -1)
    elif bits in (24, 32):
        raw = x.astype(np.uint8).reshape(h, -1)
    elif bits == 8:
        raw = x.astype(np.uint8)
    else:
        per = 8 // bits
        w = x.shape[1]
        pad = np.zeros((h, -w % per), np.int64)
        v = np.concatenate([x.astype(np.int64), pad], 1).reshape(h, -1, per)
        shifts = bits * np.arange(per - 1, -1, -1)
        raw = (v << shifts).sum(-1).astype(np.uint8)
    stride = -(-raw.shape[1] // 4) * 4
    out = np.zeros((h, stride), np.uint8)
    out[:, :raw.shape[1]] = raw
    return b"".join(r.tobytes() for r in _rows(list(out), top_down))


def rle(indices: np.ndarray, bits: int, skip=None, top_down: bool = False,
        eob: bool = True) -> bytes:
    """RLE8 (``bits`` 8) or RLE4 (4) data of (H, W) palette indices: runs
    of one value (RLE4: of an alternating pair) in encoded mode, stretches
    of 3 or more values that do not repeat in absolute mode (padded to a
    16-bit boundary), an end-of-line code after each row and an
    end-of-bitmap code.  Pixels where ``skip`` is true are jumped over by
    delta codes (within the row, or across rows from a row's end), so
    that the decoder fills them."""
    x = np.asarray(indices, np.int64)
    h, w = x.shape
    skip = np.zeros((h, w), bool) if skip is None else np.asarray(skip)
    out = bytearray()
    order = list(range(h)) if top_down else list(range(h - 1, -1, -1))
    pending = 0                  # skipped pixels carried over from rows

    def delta(n, col):
        # a delta of (dx, dy) moves n pixels on in raster order
        while n:
            dy, dx = divmod(n, w)
            dy, dx = (dy, dx) if dx + col < w else (dy + 1, dx - w)
            if dx < 0 or dy > 255:
                dy, dx = min(dy, 255), 0
            out.extend([0, 2, dx, dy])
            n -= dx + dy * w
            col = (col + dx) % w

    for y in order:
        row, sk = x[y], skip[y]
        c = 0
        if pending:
            delta(pending, 0)
            pending = 0
        while c < w:
            if sk[c]:
                e = c
                while e < w and sk[e]:
                    e += 1
                if e == w:               # the rest of the row: next row
                    pending = w - c
                    break
                out.extend([0, 2, e - c, 0])
                c = e
                continue
            # a run: one value (RLE4: an alternating pair)
            period = 1 if bits == 8 else 2
            e = c + 1
            while (e < w and not sk[e] and e - c < 255
                   and row[e] == row[c + (e - c) % period]):
                e += 1
            if e - c >= 3 or e == w or sk[e] or e - c == 255:
                n = e - c
                if bits == 8:
                    out.extend([n, row[c]])
                else:
                    hi = row[c]
                    lo = row[c + 1] if n > 1 else 0
                    out.extend([n, (hi << 4) | lo])
                c = e
                continue
            # absolute mode: up to the next run of 3 or a skipped pixel
            e = c
            while (e < w and not sk[e] and e - c < 255
                   and not (e + 2 < w and row[e] == row[e + 1] == row[e + 2]
                            and not sk[e + 1] and not sk[e + 2])):
                e += 1
            n = e - c
            if n < 3:
                for k in range(c, e):
                    out.extend([1, row[k] << 4 if bits == 4 else row[k]])
                c = e
                continue
            vals = row[c:e]
            if bits == 8:
                body = bytes(vals.astype(np.uint8))
            else:
                v = np.concatenate([vals, np.zeros(n % 2, np.int64)]).reshape(
                    -1, 2)
                body = bytes(((v[:, 0] << 4) | v[:, 1]).astype(np.uint8))
            body += b"\0" * (len(body) % 2)
            out.extend([0, n])
            out += body
            c = e
        else:
            out.extend([0, 0])           # end of line
    if eob:
        out.extend([0, 1])
    return bytes(out)


def bmp(pixels: bytes, w: int, h: int, bits: int,
        compression: int = BI_RGB, palette=None, header: int = 40,
        top_down: bool = False, masks=None, clr_used=None) -> bytes:
    """A BMP file around the pixel array ``pixels`` (from :func:`pack_rows`
    or :func:`rle`): a ``header``-byte DIB header (12: OS/2 core, with
    3-byte palette entries; 40, 108 or 124), ``palette`` ((n, 3) RGB),
    ``masks`` (R, G, B dwords after a 40-byte header, inside a larger one),
    ``clr_used`` (default: the palette's length, 0 for a full one)."""
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]             # RGB -> BGR
        if header != 12:
            p = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], 1)
        pal = p.tobytes()
    n = 0 if palette is None else len(palette)
    if clr_used is None:
        clr_used = 0 if n == 1 << min(bits, 24) else n
    if header == 12:
        dib = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        dib = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                          1, bits, compression, len(pixels), 2835, 2835,
                          clr_used, 0)
        extra = b""
        if masks is not None:
            extra = struct.pack("<III", *masks)
        if header > 40:
            body = (extra or b"\0" * 12) + b"\0" * (header - 52)
            dib += body
            extra = b""
        dib += extra
    offset = 14 + len(dib) + len(pal)
    head = struct.pack("<2sIHHI", b"BM", offset + len(pixels), 0, 0, offset)
    return head + dib + pal + pixels
