"""A small PNG writer for the port's decode tests: every bit depth and
colour type, plain or Adam7-interlaced, every row filter.

The port's own encoder writes only what ``cv2.imencode(".png")`` writes
(8 bits, Sub rows), so the files that exercise the rest of its decoder
are made here.
"""

import struct
import zlib

import numpy as np

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}     # by colour type


def chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def pack(samples, depth):
    """Rows of packed bytes of (h, w, ch) samples at ``depth``."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.uint32)
    if depth == 16:
        return np.stack([flat >> 8, flat & 255], -1).reshape(h, -1).astype(
            np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(
        h, -1).astype(np.uint8)
    return np.packbits(bits, axis=1)


def filter_rows(rows, fbpp, row_filter=None):
    """Rows with filter ``row_filter`` (0-4: none, sub, up, average,
    Paeth), or filter i % 5 on row i for ``None``."""
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for i, row in enumerate(rows.astype(np.int32)):
        f = i % 5 if row_filter is None else row_filter
        a = np.concatenate([np.zeros(fbpp, np.int32), row[:-fbpp]])
        c = np.concatenate([np.zeros(fbpp, np.int32), prev[:-fbpp]])
        b = prev
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = [0, a, b, (a + b) >> 1, paeth][f]
        out.append(bytes([f]) + bytes(((row - pred) & 255).astype(np.uint8)))
        prev = row
    return b"".join(out)


def png(samples, depth=8, ctype=None, interlace=0, palette=None,
        row_filter=None) -> bytes:
    """The PNG of (h, w, ch) or (h, w) integer ``samples`` at ``depth``;
    ``ctype`` defaults to gray, RGB or RGBA by the channel count."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, ch = samples.shape
    if ctype is None:
        ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    fbpp = max(1, CHANNELS[ctype] * depth // 8)
    raw = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += filter_rows(pack(sub, depth), fbpp, row_filter)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")
