"""Plain versions of the JPEG library (``csrc/jpeg.cpp``), in Python and
numpy.

:func:`decode_plain` and :func:`encode_plain` compute what
``native.jpeg_decode`` and ``native.jpeg_encode`` compute, written apart
from them: the Huffman codes in a Python loop over a table of every
16-bit window of the bit buffer, the QM decoder of T.81 Annex D a byte at
a time, the DCTs, sampling and colour steps vectorised over all blocks of
a component, quantisation as a rounding division.
The tests and ``chip_smoke.py`` hold the library against them; the
codec's route (``data/codec.py``) uses the library on every machine.

What both compute is libjpeg-turbo's default path, as OpenCV runs it:
sequential and progressive Huffman or arithmetic entropy decoding
(``jdhuff.c``, ``jdphuff.c``, ``jdarith.c``; the Annex K tables where a
scan's Huffman table was never defined), lossless files (``jdlhuff.c``,
``jdlossls.c``), the ISLOW DCTs (``jfdctint.c``, and the inverse as the
x86-64 SIMD code computes it), block
smoothing (``jdcoefct.c``), fancy upsampling (``jdsample.c``), the fixed-point
colour tables (``jdcolor.c``, ``jccolor.c``; YCCK to CMYK), OpenCV's
CMYK to BGR and gray, ``h2v2_downsample`` (``jcsample.c``), and the EXIF
orientation as OpenCV applies it; the encoder writes what
``cv2.imencode(".jpg")`` writes at its defaults (quality 95, 4:2:0,
standard Huffman tables).  Damaged files decode as libjpeg-turbo recovers
them (its data sources, bit reader and marker reader, ``jdmarker.c``'s
resynchronisation at restarts), or raise where cv2 returns None.
"""

from __future__ import annotations

import struct

import numpy as np

NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA_Q = np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66]
                        + [99] * 4 + [24, 26, 56] + [99] * 5
                        + [47, 66] + [99] * 6 + [99] * 32)

# Annex K tables: counts of codes of length 1..16, then the symbols
DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
             tuple(range(12)))
AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))

QUALITY = 95


def quant_tables(quality: int = QUALITY):
    """jcparam.c's luma and chroma tables at ``quality`` (natural order),
    limited to baseline's 1..255."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return [np.clip((t * scale + 50) // 100, 1, 255)
            for t in (STD_LUMA_Q, STD_CHROMA_Q)]


def _codes(bits, vals):
    """{symbol: (code, length)} of a canonical Huffman table."""
    out, code, k = {}, 0, 0
    for length, n in enumerate(bits, start=1):
        for _ in range(n):
            out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


# ---------------------------------------------------------------------------
# the DCTs (ISLOW), over (N, 8, 8) int64 blocks
# ---------------------------------------------------------------------------

_C = dict(F0_298=2446, F0_390=3196, F0_541=4433, F0_765=6270, F0_899=7373,
          F1_175=9633, F1_501=12299, F1_847=15137, F1_961=16069,
          F2_053=16819, F2_562=20995, F3_072=25172)
CONST_BITS, PASS1_BITS = 13, 2


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _w16(x):
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _w32(x):
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def _idct_pass(v, n):
    """One pass of libjpeg-turbo's x86-64 SIMD ISLOW inverse DCT along the
    last axis of ``v`` (..., 8), 16-bit values: the even part's v0 + v4
    and the odd part's v7 + v3 and v5 + v1 wrap to 16 bits, products sum
    in 32 bits, and the outputs, descaled by ``n`` bits, saturate to 16
    bits."""
    c = _C
    z2, z3 = v[..., 2], v[..., 6]
    t3 = _w32(z2 * (c["F0_541"] + c["F0_765"]) + z3 * c["F0_541"])
    t2 = _w32(z2 * c["F0_541"] + z3 * (c["F0_541"] - c["F1_847"]))
    t0 = _w16(v[..., 0] + v[..., 4]) << CONST_BITS
    t1 = _w16(v[..., 0] - v[..., 4]) << CONST_BITS
    t10, t13 = _w32(t0 + t3), _w32(t0 - t3)
    t11, t12 = _w32(t1 + t2), _w32(t1 - t2)
    i0, i1, i2, i3 = v[..., 7], v[..., 5], v[..., 3], v[..., 1]
    z3, z4 = _w16(i0 + i2), _w16(i1 + i3)
    zz3 = _w32(z3 * (c["F1_175"] - c["F1_961"]) + z4 * c["F1_175"])
    zz4 = _w32(z3 * c["F1_175"] + z4 * (c["F1_175"] - c["F0_390"]))
    a0 = _w32(_w32(i0 * (c["F0_298"] - c["F0_899"]) - i3 * c["F0_899"]) + zz3)
    a3 = _w32(_w32(i3 * (c["F1_501"] - c["F0_899"]) - i0 * c["F0_899"]) + zz4)
    a1 = _w32(_w32(i1 * (c["F2_053"] - c["F2_562"]) - i2 * c["F2_562"]) + zz4)
    a2 = _w32(_w32(i2 * (c["F3_072"] - c["F2_562"]) - i1 * c["F2_562"]) + zz3)
    out = [t10 + a3, t11 + a2, t12 + a1, t13 + a0,
           t13 - a0, t12 - a1, t11 - a2, t10 - a3]
    out = [_w32(_w32(o) + (1 << (n - 1))) >> n for o in out]
    return np.clip(np.stack(out, -1), -32768, 32767)


def idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(N, 8, 8) uint8 samples of (N, 8, 8) coefficients (natural order)
    dequantised by ``q`` (8, 8), as OpenCV's libjpeg-turbo computes them
    with its SIMD code: the dequantised values wrap to 16 bits; a block
    whose rows 1-7 are zero takes pass 1's DC shortcut, a 16-bit shift;
    the samples saturate to 0-255."""
    dq = _w16(coef.astype(np.int64) * q.astype(np.int64))
    ws = _idct_pass(dq.swapaxes(1, 2), CONST_BITS - PASS1_BITS).swapaxes(1, 2)
    dc_only = ~coef[:, 1:, :].any((1, 2))
    ws[dc_only] = _w16(dq[dc_only, :1, :] << PASS1_BITS)
    out = _idct_pass(ws, CONST_BITS + PASS1_BITS + 3)
    return (np.clip(out, -128, 127) + 128).astype(np.uint8)


def _fdct_1d(v, even_bits, odd_bits, even_shift):
    c = _C
    t0, t7 = v[..., 0] + v[..., 7], v[..., 0] - v[..., 7]
    t1, t6 = v[..., 1] + v[..., 6], v[..., 1] - v[..., 6]
    t2, t5 = v[..., 2] + v[..., 5], v[..., 2] - v[..., 5]
    t3, t4 = v[..., 3] + v[..., 4], v[..., 3] - v[..., 4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    if even_shift:
        d0, d4 = (t10 + t11) << PASS1_BITS, (t10 - t11) << PASS1_BITS
    else:
        d0 = _descale(t10 + t11, even_bits)
        d4 = _descale(t10 - t11, even_bits)
    z1 = (t12 + t13) * c["F0_541"]
    d2 = _descale(z1 + t13 * c["F0_765"], odd_bits)
    d6 = _descale(z1 - t12 * c["F1_847"], odd_bits)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * c["F1_175"]
    t4, t5 = t4 * c["F0_298"], t5 * c["F2_053"]
    t6, t7 = t6 * c["F3_072"], t7 * c["F1_501"]
    z1, z2 = z1 * -c["F0_899"], z2 * -c["F2_562"]
    z3, z4 = z3 * -c["F1_961"] + z5, z4 * -c["F0_390"] + z5
    d7 = _descale(t4 + z1 + z3, odd_bits)
    d5 = _descale(t5 + z2 + z4, odd_bits)
    d3 = _descale(t6 + z2 + z3, odd_bits)
    d1 = _descale(t7 + z1 + z4, odd_bits)
    return np.stack([d0, d1, d2, d3, d4, d5, d6, d7], -1)


def fdct_islow(samples: np.ndarray) -> np.ndarray:
    """(N, 8, 8) int64 coefficients (scaled by 8) of (N, 8, 8) samples."""
    x = samples.astype(np.int64) - 128
    rows = _fdct_1d(x, None, CONST_BITS - PASS1_BITS, True)
    cols = _fdct_1d(rows.swapaxes(1, 2), PASS1_BITS,
                    CONST_BITS + PASS1_BITS, False)
    return cols.swapaxes(1, 2)


def quantize(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Coefficients divided by ``8 q``, rounded half away from zero."""
    d = (q.astype(np.int64) * 8)
    a = (np.abs(coef) + d // 2) // d
    return np.where(coef < 0, -a, a)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class _Huff:
    """A Huffman table as jdhuff.c derives it: the (length, symbol) of
    every 16-bit window (length 0 where no code of 16 bits or fewer starts
    it), and for a code read bit by bit the largest code of each length
    and the symbol offsets."""

    def __init__(self, bits, vals):
        self.vals = list(vals)
        self.max_symbol = max(self.vals, default=0)
        length = np.zeros(65536, np.int64)
        symbol = np.zeros(65536, np.int64)
        self.maxcode = [-1] * 17 + [0xFFFFF]
        self.offset = [0] * 17
        code = k = 0
        for n, count in enumerate(bits, start=1):
            self.offset[n] = k - code
            for _ in range(count):
                lo = code << (16 - n)
                length[lo:lo + (1 << (16 - n))] = n
                symbol[lo:lo + (1 << (16 - n))] = vals[k]
                code += 1
                k += 1
            if count:
                self.maxcode[n] = code - 1
            code <<= 1
        self.length, self.symbol = length.tolist(), symbol.tolist()


def _lut(bits, vals):
    """The :class:`_Huff` of a DHT table, or None for counts that are no
    prefix code or give an all-ones code, which jdhuff.c refuses when a
    scan uses the table."""
    code = 0
    for n, count in enumerate(bits, start=1):
        code += count
        if code >= 1 << n:
            return None
        code <<= 1
    return _Huff(bits, vals)


def _extend(v, s):
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _i16(v):
    return ((v + 0x8000) & 0xFFFF) - 0x8000


class _Suspended(Exception):
    """``cv2.imdecode``'s memory source has no byte past the end of the
    bytes: libjpeg suspends, and OpenCV takes that for a failure."""


class _Input:
    """The bytes as libjpeg's data source hands them over: the file's, then
    at each read past the end a fake EOI marker (``cv2.imread``'s stdio
    source) or a suspension (``cv2.imdecode``'s memory source); the read
    position, the marker that the entropy decoder stopped at, and the
    restart marker expected next."""

    def __init__(self, data: bytes, file: bool):
        self.data, self.n, self.file = data, len(data), file
        self.pos, self.marker, self.next_rst = 2, 0, 0

    def at(self, i: int) -> int:
        if i < self.n:
            return self.data[i]
        if not self.file:
            raise _Suspended
        return 0xD9 if (i - self.n) % 2 else 0xFF

    def next_marker(self) -> int:
        """jdmarker.c next_marker: skip data (a stuffed FF 00 too) up to the
        next marker, and return its code."""
        while True:
            c = self.at(self.pos)
            self.pos += 1
            while c != 0xFF:
                c = self.at(self.pos)
                self.pos += 1
            while c == 0xFF:
                c = self.at(self.pos)
                self.pos += 1
            if c:
                return c

    def restart(self):
        """jdmarker.c read_restart_marker: take the expected RSTn, or let
        jpeg_resync_to_restart judge the marker found: one below SOF0, or
        one of the two RSTs before, is skipped to the next marker; another
        marker, or one of the two RSTs after, stays unread (the segment is
        empty); any other RST is taken for the one expected."""
        if not self.marker:
            self.marker = self.next_marker()
        want = self.next_rst
        self.next_rst = (want + 1) & 7
        while self.marker != 0xD0 + want:
            m = self.marker
            rst = m - 0xD0 if 0xD0 <= m <= 0xD7 else None
            if m >= 0xC0 and (rst is None or rst in ((want + 1) & 7,
                                                      (want + 2) & 7)):
                return
            if m >= 0xC0 and rst not in ((want - 1) & 7, (want - 2) & 7):
                break
            self.marker = self.next_marker()
        self.marker = 0


class _Bits:
    """jdhuff.c's bit reader (decode_mcu's slow path; its fast path gives
    the same values): whole bytes, FF 00 read as FF, are loaded until 57
    bits are held or a marker is met; a request for more bits than the
    data holds then gets zero bits and sets ``insufficient``."""

    def __init__(self, inp: _Input):
        self.inp, self.buf, self.left, self.insufficient = inp, 0, 0, False

    def fill(self, nbits: int):
        inp = self.inp
        if not inp.marker:
            data, n, pos = inp.data, inp.n, inp.pos
            buf, left = self.buf & ((1 << self.left) - 1), self.left
            while left < 57:
                c = data[pos] if pos < n else inp.at(pos)
                pos += 1
                if c == 0xFF:
                    while c == 0xFF:
                        c = data[pos] if pos < n else inp.at(pos)
                        pos += 1
                    if c:
                        inp.marker = c
                        break
                    c = 0xFF
                buf = (buf << 8) | c
                left += 8
            inp.pos, self.buf, self.left = pos, buf, left
            if not inp.marker:
                return
        if nbits > self.left:
            self.insufficient = True
            self.buf = (self.buf & ((1 << self.left) - 1)) << (57 - self.left)
            self.left = 57

    def get(self, k: int) -> int:
        if k == 0:
            return 0
        if self.left < k:
            self.fill(k)
        self.left -= k
        return (self.buf >> self.left) & ((1 << k) - 1)

    def huff(self, t: _Huff) -> int:
        """One symbol; a code that matches nothing within 16 bits takes 17
        bits and reads as 0 (JWRN_HUFF_BAD_CODE)."""
        if self.left >= 16:
            v = (self.buf >> (self.left - 16)) & 0xFFFF
            n = t.length[v]
            if n:
                self.left -= n
                return t.symbol[v]
        # HUFF_DECODE's 8-bit lookahead, then jpeg_huff_decode bit by bit
        n = 1
        if self.left < 8:
            self.fill(0)
        if self.left >= 8:
            v = ((self.buf >> (self.left - 8)) & 0xFF) << 8
            if 0 < t.length[v] <= 8:
                self.left -= t.length[v]
                return t.symbol[v]
            n = 9
        code = self.get(n)
        while code > t.maxcode[n]:
            code = (code << 1) | self.get(1)
            n += 1
        return 0 if n > 16 else t.vals[code + t.offset[n]]


# jpeg_natural_order and its 16 extra entries of 63 (jutils.c): in damaged
# data a run past coefficient 63 puts its value there
_NATURAL = NATURAL.tolist() + [63] * 16


def _huffman_block(bits, blk, tables, pred, ci, scan, eobrun):
    """One block of a Huffman scan, as decode_mcu (jdhuff.c) or the
    progressive decoders (jdphuff.c) read it; returns the EOB run left."""
    ss, se, ah, al = scan["band"]
    dc, ac = tables
    if scan["seq"]:
        s = bits.huff(dc)
        pred[ci] = _w32(pred[ci] + (_extend(bits.get(s), s) if s else 0))
        blk[0] = _i16(pred[ci])
        k = 1
        while k < 64:
            rs = bits.huff(ac)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                blk[_NATURAL[k]] = _i16(_extend(bits.get(s), s))
            elif r != 15:
                break
            else:
                k += 15
            k += 1
        return eobrun
    if ss == 0:
        if ah:
            if bits.get(1):
                blk[0] |= 1 << al
            return eobrun
        s = bits.huff(dc)
        s = _extend(bits.get(s), s) if s else 0
        if not -2**31 <= pred[ci] + s < 2**31:
            raise ValueError("corrupt JPEG entropy data (a DC coefficient "
                             f"out of range){CV2_TOO}")
        pred[ci] += s
        blk[0] = _i16(pred[ci] << al)
        return eobrun
    if ah == 0:
        if eobrun:
            return eobrun - 1
        k = ss
        while k <= se:
            rs = bits.huff(ac)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                blk[_NATURAL[k]] = _i16(_extend(bits.get(s), s) << al)
            elif r == 15:
                k += 15
            else:
                return (1 << r) + bits.get(r) - 1
            k += 1
        return 0
    p1 = 1 << al
    k = ss
    if eobrun == 0:
        while k <= se:
            rs = bits.huff(ac)
            r, s = rs >> 4, rs & 15
            new = 0
            if s:                       # a size other than 1 is read as 1
                new = p1 if bits.get(1) else -p1
            elif r != 15:
                eobrun = (1 << r) + bits.get(r)
                break
            while k <= se:
                z = NATURAL[k]
                if blk[z]:
                    if bits.get(1) and not blk[z] & p1:
                        blk[z] = _i16(blk[z] + (p1 if blk[z] >= 0 else -p1))
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if new:
                blk[_NATURAL[k]] = new
            k += 1
    if eobrun:
        for z in NATURAL[k:se + 1]:
            if blk[z] and bits.get(1) and not blk[z] & p1:
                blk[z] = _i16(blk[z] + (p1 if blk[z] >= 0 else -p1))
        eobrun -= 1
    return eobrun


# T.81 Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS) by
# index; 113 is a fixed bin of probability one half
_QE = [
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080B, 18, 4, 0), (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0),
    (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 36, 16, 0), (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0),
    (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0CEF, 43, 21, 0),
    (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01B1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0),
    (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0),
    (0x2EF1, 67, 40, 0), (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0),
    (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0),
    (0x04DE, 50, 52, 0), (0x040F, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0), (0x01F8, 54, 57, 0),
    (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0),
    (0x008F, 61, 32, 0), (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0),
    (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0), (0x2FE8, 83, 69, 0),
    (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119C, 74, 76, 0), (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0),
    (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0),
    (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0),
    (0x3C3D, 104, 100, 0), (0x375E, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0), (0x415E, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0)]


class _Arith:
    """The QM decoder of T.81 D.2 (jdarith.c arith_decode), reading a byte
    at a time from the input; from a marker on (left unread) it is fed
    zero bytes.  ``ct`` -1 marks an error in the data
    (JWRN_ARITH_BAD_CODE): the rest of the restart interval decodes
    nothing.  A statistics bin is an int: its index in Table D.2 and its
    MPS in bit 7."""

    def __init__(self, inp: _Input):
        self.inp = inp
        self.c, self.a, self.ct = 0, 0, -16

    def _byte(self) -> int:
        inp = self.inp
        if inp.marker:
            return 0
        b = inp.at(inp.pos)
        inp.pos += 1
        if b != 0xFF:
            return b
        while b == 0xFF:
            b = inp.at(inp.pos)
            inp.pos += 1
        if b == 0:
            return 0xFF
        inp.marker = b
        return 0

    def decode(self, bins, i):
        while self.a < 0x8000:
            self.ct -= 1
            if self.ct < 0:
                self.c = (self.c << 8) | self._byte()
                self.ct += 8
                if self.ct < 0:
                    self.ct += 1
                    if self.ct == 0:
                        self.a = 0x8000
            self.a <<= 1
        state = bins[i]
        mps = state >> 7
        qe, nlps, nmps, switch = _QE[state & 0x7F]
        self.a -= qe
        chigh = self.a << self.ct
        if self.c >= chigh:           # the upper sub-interval
            self.c -= chigh
            lps = self.a >= qe        # else the exchange gives it the MPS
            self.a = qe
        elif self.a < 0x8000:
            lps = self.a < qe
        else:
            return mps
        if lps:
            bins[i] = nlps | ((mps ^ switch) << 7)
            return mps ^ 1
        bins[i] = nmps | (mps << 7)
        return mps


class _BadCode(Exception):
    """JWRN_ARITH_BAD_CODE: a magnitude or a run past the band."""


def _arith_value(ar, bins, s, kbins=None, x1=20):
    """The magnitude category and bits of a nonzero value (T.81 F.1.4.4,
    Figures F.21-F.24) after its sign, read from bin ``s`` on; an AC value
    (``kbins``: its X1 bin) reads its first category decision twice.
    Returns (value - 1 with the leading bit, category m)."""
    m = ar.decode(bins, s)
    if m:
        if kbins is not None:
            if not ar.decode(bins, s):
                return 1, 1
            m, s = 2, kbins
        else:
            s = x1
        while ar.decode(bins, s):
            m <<= 1
            if m == 0x8000:
                raise _BadCode
            s += 1
    v = m
    s += 14
    b = m >> 1
    while b:
        if ar.decode(bins, s):
            v |= b
        b >>= 1
    return v, m


class _ArithScan:
    """An arithmetic-coded scan's decoding state (T.81 F.2.4 and G.1.3):
    the statistics, DC predictions and contexts of its components."""

    def __init__(self, inp, scan, tnums, progressive):
        self.ar = _Arith(inp)
        self.scan, self.tnums, self.progressive = scan, tnums, progressive
        self.fixed = [113]
        self.reset()

    def reset(self):
        """The scan's start, and each restart: every statistic, prediction
        and context zero (those the scan does not use included)."""
        self.dc_bins = {td: [0] * 64 for td, _ in self.tnums.values()}
        self.ac_bins = {ta: [0] * 256 for _, ta in self.tnums.values()}
        self.pred = dict.fromkeys(self.tnums, 0)
        self.ctx = dict.fromkeys(self.tnums, 0)
        ar = self.ar
        ar.c, ar.a, ar.ct = 0, 0, -16

    def dc_diff(self, ci):
        ar, dac = self.ar, self.scan["dac"]
        td = self.tnums[ci][0]
        bins = self.dc_bins[td]
        s = self.ctx[ci]
        if not ar.decode(bins, s):
            self.ctx[ci] = 0
            return 0
        sign = ar.decode(bins, s + 1)
        v, m = _arith_value(ar, bins, s + 2 + sign)
        if m < (1 << dac["L"][td]) >> 1:
            self.ctx[ci] = 0
        elif m > (1 << dac["U"][td]) >> 1:
            self.ctx[ci] = 12 + 4 * sign
        else:
            self.ctx[ci] = 4 + 4 * sign
        return -(v + 1) if sign else v + 1

    def ac_band(self, ci, blk, lo, hi, shift):
        ar, dac = self.ar, self.scan["dac"]
        ta = self.tnums[ci][1]
        bins = self.ac_bins[ta]
        k = lo
        while k <= hi:
            s = 3 * (k - 1)
            if ar.decode(bins, s):                    # EOB
                return
            while not ar.decode(bins, s + 1):
                s += 3
                k += 1
                if k > hi:
                    raise _BadCode
            sign = ar.decode(self.fixed, 0)
            v, _ = _arith_value(ar, bins, s + 2,
                                kbins=189 if k <= dac["K"][ta] else 217)
            blk[NATURAL[k]] = _i16((-(v + 1) if sign else v + 1) << shift)
            k += 1

    def ac_refine(self, ci, blk):
        ar = self.ar
        ss, se, _, al = self.scan["band"]
        p1 = 1 << al
        bins = self.ac_bins[self.tnums[ci][1]]
        kex = se
        while kex > 0 and not blk[NATURAL[kex]]:
            kex -= 1
        k = ss
        while k <= se:
            s = 3 * (k - 1)
            if k > kex and ar.decode(bins, s):        # EOB
                return
            while True:
                z = NATURAL[k]
                if blk[z]:
                    if ar.decode(bins, s + 2):
                        blk[z] = _i16(blk[z] + (p1 if blk[z] > 0 else -p1))
                    break
                if ar.decode(bins, s + 1):
                    blk[z] = -p1 if ar.decode(self.fixed, 0) else p1
                    break
                s += 3
                k += 1
                if k > se:
                    raise _BadCode
            k += 1

    def block(self, ci, blk):
        ss, se, ah, al = self.scan["band"]
        if not self.progressive:
            self.pred[ci] = (self.pred[ci] + self.dc_diff(ci)) & 0xFFFF
            blk[0] = _i16(self.pred[ci])
            self.ac_band(ci, blk, 1, 63, 0)
        elif ss == 0 and ah == 0:
            self.pred[ci] = (self.pred[ci] + self.dc_diff(ci)) & 0xFFFF
            blk[0] = _i16(self.pred[ci] << al)
        elif ss == 0:
            if self.ar.decode(self.fixed, 0):
                blk[0] |= 1 << al
        elif ah == 0:
            self.ac_band(ci, blk, ss, se, al)
        else:
            self.ac_refine(ci, blk)


def _scan_units(scan, frame_comps, geo):
    """The scan's components (frame index, DC table, AC table) and its
    MCUs: lists of (component, block index) in coding order, one block of
    a lone component (its real blocks only) or each component's h x v;
    and the number of MCUs a row."""
    mcux, mcuy = geo
    idx = {c["id"]: i for i, c in enumerate(frame_comps)}
    parts = [(idx[cid], scan["dc"].get(td), scan["ac"].get(ta))
             for cid, td, ta in scan["sc"]]
    # jdinput.c per_scan_setup: at most 10 blocks (or samples) an MCU
    if len(parts) > 1 and sum(frame_comps[ci]["h"] * frame_comps[ci]["v"]
                              for ci, _, _ in parts) > 10:
        raise ValueError("corrupt SOS segment (more than 10 blocks in an "
                         f"MCU){CV2_TOO}")
    if len(parts) == 1:
        ci = parts[0][0]
        c = frame_comps[ci]
        units = [[(ci, by * c["bw"] + bx)] for by in range(c["hb"])
                 for bx in range(c["wb"])]
        return parts, units, c["wb"]
    units = []
    for my in range(mcuy):
        for mx in range(mcux):
            u = []
            for ci, _, _ in parts:
                c = frame_comps[ci]
                u += [(ci, (my * c["v"] + yy) * c["bw"] + mx * c["h"] + xx)
                      for yy in range(c["v"]) for xx in range(c["h"])]
            units.append(u)
    return parts, units, mcux


def _decode_scan(inp, st, scan, coefs):
    """One DCT scan from the input's position, MCU by MCU as decode_mcu
    does, restarts and recovery included: after the data runs out the
    MCUs up to the next restart keep their coefficients (a DC refinement
    reads on, from zero bits), and after an arithmetic decoding error
    nothing more is decoded up to it.  Sets ``st["last_good"]``, the iMCU
    row of the last MCU decoded with data left."""
    progressive, arith = st["mode"]
    comps = st["frame"][2]
    ss, se, ah, al = scan["band"]
    parts, units, cols = _scan_units(scan, comps, st["geo"])
    if not arith:
        use_dc = not progressive or (ss == 0 and ah == 0)
        use_ac = not progressive or ss > 0
        for _, dc, ac in parts:     # DC symbols are sizes, 0..15
            if (use_dc and (dc is None or dc.max_symbol > 15)) or (
                    use_ac and ac is None):
                raise ValueError("corrupt JPEG Huffman table")
    per_row = cols * (comps[parts[0][0]]["v"] if len(parts) == 1 else 1)
    ri = scan["ri"]
    togo = ri
    tables = {ci: (dc, ac) for ci, dc, ac in parts}
    if arith:
        tnums = {frame_ci: (td, ta) for (frame_ci, _, _), (_, td, ta)
                 in zip(parts, scan["sc"])}
        dec = _ArithScan(inp, scan, tnums, progressive)
    bits = _Bits(inp)
    pred = dict.fromkeys(tables, 0)
    eobrun = 0
    refine_dc = progressive and ss == 0 and ah > 0
    for u, unit in enumerate(units):
        if ri:
            if togo == 0:
                if arith:
                    inp.restart()
                    dec.reset()
                else:
                    bits.left = 0         # the bits left are dropped
                    inp.restart()
                    pred = dict.fromkeys(tables, 0)
                    eobrun = 0
                    if not inp.marker:
                        bits.insufficient = False
                togo = ri
            togo -= 1
        if arith:
            st["last_good"] = u // per_row
            if dec.ar.ct == -1:
                continue
            try:
                for ci, b in unit:
                    dec.block(ci, coefs[ci][b])
            except _BadCode:
                dec.ar.ct = -1
            continue
        if not bits.insufficient:
            st["last_good"] = u // per_row
        elif not refine_dc:
            continue
        for ci, b in unit:
            eobrun = _huffman_block(bits, coefs[ci][b], tables[ci], pred, ci,
                                    scan, eobrun)


def _decode_lossless_scan(inp, st, scan, diffs):
    """One lossless scan (T.81 Annex H; jdlhuff.c, jddiffct.c): each
    sample's difference, a DC-style size (16: 32768, no extra bits) and
    its bits, MCU row by MCU row, restart intervals of whole MCU rows.  A
    row that starts after the data ran out keeps zero differences.
    Returns the MCU rows at which the predictor starts afresh (the first,
    each restart's, and each of those)."""
    comps = st["frame"][2]
    parts, units, cols = _scan_units(scan, comps, st["geo"])
    for _, dc, _ in parts:
        if dc is None or dc.max_symbol > 16:
            raise ValueError("corrupt JPEG Huffman table")
    if scan["ri"] % cols:
        raise ValueError("lossless JPEG whose restart interval is not a "
                         f"whole number of MCU rows is not decoded{CV2_TOO}")
    interval = scan["ri"] // cols
    tables = {ci: dc for ci, dc, _ in parts}
    bits = _Bits(inp)
    fresh = [0]
    for r in range(len(units) // cols):
        if interval and r and r % interval == 0:
            bits.left = 0
            inp.restart()
            if not inp.marker:
                bits.insufficient = False
            fresh.append(r)
        if bits.insufficient:
            fresh.append(r)
            for unit in units[r * cols:(r + 1) * cols]:
                for ci, i in unit:
                    diffs[ci][i] = 0
            continue
        for unit in units[r * cols:(r + 1) * cols]:
            for ci, i in unit:
                size = bits.huff(tables[ci])
                diffs[ci][i] = (32768 if size == 16 else
                                _extend(bits.get(size), size) if size else 0)
    return sorted(set(fresh))


# the frame markers decoded, and how: (progressive, arithmetic); SOF3 is
# lossless
_FRAMES = {0xC0: (False, False), 0xC1: (False, False), 0xC2: (True, False),
           0xC3: (False, False), 0xC9: (False, True), 0xCA: (True, True)}
# what a refusal of a kind of file adds: OpenCV's build of libjpeg-turbo
# refuses it as well
CV2_TOO = " (cv2 returns None for it too)"
_REFUSED = {0xCB: "lossless arithmetic-coded JPEG (SOF11)",
            **{m: "hierarchical JPEG"
               for m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF, 0xDE)}}


def _check_readable(st, gray: bool):
    """The lossless files that cv2 does not read in the mode asked for:
    libjpeg-turbo converts no colour space in lossless mode (gray reads
    only as gray, RGB only as colour, CMYK as CMYK), and a 3-component
    file is RGB unless a JFIF marker or an Adobe transform other than 0
    makes it YCbCr."""
    if not st["lossless"]:
        return
    nc = len(st["frame"][2])
    ycc = st["jfif"] or st["adobe"] not in (None, 0)
    why = {1: None if gray else "a lossless gray JPEG read in colour",
           3: ("a lossless YCbCr JPEG" if ycc else
               "a lossless RGB JPEG read in gray" if gray else None),
           4: "a lossless YCCK JPEG" if st["adobe"] not in (None, 0)
           else None}[nc]
    if why:
        raise ValueError(f"{why} is not decoded{CV2_TOO}")


def _setup(st):
    """The frame's geometry and its zero coefficients (or differences),
    at the first scan."""
    h, w, comps = st["frame"]
    if h == 0:
        raise ValueError("JPEG with its height in a DNL marker is not decoded")
    if h * w > 1 << 30:
        raise ValueError(f"JPEG of {w}x{h} pixels is too large (limit 2^30)"
                         f"{CV2_TOO}")
    du = 1 if st["lossless"] else 8       # a lossless data unit: a sample
    max_h = max(c["h"] for c in comps)
    max_v = max(c["v"] for c in comps)
    mcux, mcuy = -(-w // (du * max_h)), -(-h // (du * max_v))
    st["geo"], st["max"] = (mcux, mcuy), (max_h, max_v)
    for c in comps:
        c["wb"] = -(-w * c["h"] // (du * max_h))
        c["hb"] = -(-h * c["v"] // (du * max_v))
        c["bw"] = c["wb"] if len(comps) == 1 else mcux * c["h"]
        c["bh"] = c["hb"] if len(comps) == 1 else mcuy * c["v"]
        c["bits"] = [-1] * 64            # jdphuff.c coef_bits
        c["prev"] = [-1] * 10            # coef_bits 1-9 before its last scan
    if st["lossless"]:
        st["coefs"] = [[0] * (c["bw"] * c["bh"]) for c in comps]
    else:
        st["coefs"] = [[[0] * 64 for _ in range(c["bw"] * c["bh"])]
                       for c in comps]


def _read(data: bytes, gray: bool, file: bool):
    """jdmarker.c read_markers over the file, the scans decoded as they
    come: from SOI to EOI for a file of several scans (libjpeg reads it
    whole before any output), to the end of the first scan for a lone one
    (what follows it only jpeg_finish_decompress reads, and OpenCV ignores
    its errors)."""
    if len(data) < 4 or data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    st = dict(qt={}, dc={}, ac={}, ri=0, frame=None, jfif=False,
              adobe=None, orientation=1, exif_seen=False, scans=0,
              mode=(False, False), lossless=False, precision=8,
              dac=dict(L=[0] * 16, U=[1] * 16, K=[5] * 16), qlatch={},
              last_good=0, fresh={})
    inp = _Input(data, file)
    n = len(data)
    while True:
        m, inp.marker = inp.marker, 0
        if not m:
            try:
                m = inp.next_marker()
            except _Suspended:
                if not st["scans"]:
                    raise ValueError("truncated JPEG file (no image data)") \
                        from None
                raise ValueError("JPEG of several scans without an EOI "
                                 f"marker after them is not decoded{CV2_TOO}"
                                 ) from None
        if m == 0xD9:
            if st["scans"]:
                return st
            break
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            continue
        if m == 0xD8:
            raise ValueError("corrupt JPEG file (second SOI)")
        if m < 0xC0 or m in (0xC8, 0xDF) or 0xF0 <= m <= 0xFD:
            # jdmarker.c: a reserved code (JPGn, DHP, EXP, RESn)
            raise ValueError(f"corrupt JPEG file (unknown marker 0x{m:02X})"
                             f"{CV2_TOO}")
        pos = inp.pos
        if (m in (0xFE, 0xDC) or 0xE0 <= m <= 0xEF) and file:
            # skip_variable: cv2.imread's source lets it run past the end
            length = (inp.at(pos) << 8) | inp.at(pos + 1)
            if length >= 2 and pos + length > n:
                inp.pos = pos + length
                continue
        if pos + 2 > n:
            raise ValueError("truncated JPEG header")
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        if length < 2 or pos + length > n:
            raise ValueError("truncated JPEG header")
        body = data[pos + 2:pos + length]
        inp.pos = pos + length
        if m in _REFUSED:
            raise ValueError(f"{_REFUSED[m]} is not decoded{CV2_TOO}")
        if m in _FRAMES:
            if st["frame"] is not None:
                raise ValueError("JPEG with more than one frame")
            prec, h, w, nc = struct.unpack(">BHHB", body[:6])
            lossless = m == 0xC3
            if lossless and not 2 <= prec <= 16:
                raise ValueError("corrupt SOF segment (bad precision)")
            # libjpeg-turbo reads 8-bit DCT files and 2-16-bit lossless
            # ones through the API for their precision; OpenCV calls only
            # the 8-bit one
            if prec > 8 or (not lossless and prec != 8):
                raise ValueError(f"{prec}-bit {'lossless ' * lossless}JPEG "
                                 f"is not decoded{CV2_TOO}")
            if nc not in (1, 3, 4):
                raise ValueError(f"{nc}-component JPEG is not decoded"
                                 f"{CV2_TOO}")
            st["lossless"], st["precision"] = lossless, prec
            comps = [dict(id=body[6 + 3 * i], h=body[7 + 3 * i] >> 4,
                          v=body[7 + 3 * i] & 15, tq=body[8 + 3 * i])
                     for i in range(nc)]
            st["frame"] = (h, w, comps)
            st["mode"] = _FRAMES[m]
        elif m == 0xC4:
            p = 0
            while p < len(body):
                tc, th = body[p] >> 4, body[p] & 15
                bits = tuple(body[p + 1:p + 17])
                vals = tuple(body[p + 17:p + 17 + sum(bits)])
                st["ac" if tc else "dc"][th] = _lut(bits, vals)
                p += 17 + sum(bits)
        elif m == 0xCC:
            dac = st["dac"]
            for p in range(0, len(body) - 1, 2):
                t, v = body[p], body[p + 1]
                if t >= 32 or (t < 16 and (v & 15) > (v >> 4)):
                    raise ValueError("corrupt DAC segment")
                if t >= 16:
                    dac["K"][t - 16] = v
                else:
                    dac["L"][t], dac["U"][t] = v & 15, v >> 4
        elif m == 0xDB:
            p = 0
            while p < len(body):
                pq, tq = body[p] >> 4, body[p] & 15
                if pq:
                    v = np.frombuffer(body[p + 1:p + 129], ">u2")
                else:
                    v = np.frombuffer(body[p + 1:p + 65], np.uint8)
                t = np.zeros(64, np.int64)
                t[NATURAL] = v
                st["qt"][tq] = t.reshape(8, 8)
                p += 1 + 64 * (pq + 1)
        elif m == 0xDD:
            st["ri"] = struct.unpack(">H", body[:2])[0]
        elif m == 0xE0 and body[:5] == b"JFIF\0":
            st["jfif"] = True
        elif m == 0xE1 and not st["exif_seen"]:
            st["exif_seen"] = True
            st["orientation"] = _exif_orientation(body[6:])
        elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            st["adobe"] = body[11]
        elif m == 0xDA:
            if st["frame"] is None:
                raise ValueError("JPEG scan before its frame header")
            _check_readable(st, gray)
            if _scan(inp, st, body):
                return st
    if st["frame"] is None:
        raise ValueError("JPEG without a frame header")
    raise ValueError("truncated JPEG file (no image data)")


def _scan(inp, st, body) -> bool:
    """Check and decode the scan of SOS ``body``; True where it was the
    file's lone scan."""
    comps = st["frame"][2]
    progressive, arith = st["mode"]
    ns = body[0] if body else 0
    if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
        raise ValueError("corrupt SOS segment")
    ids = [c["id"] for c in comps]
    sc = [(body[1 + 2 * i], body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15)
          for i in range(ns)]
    ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
    ah, al = a >> 4, a & 15
    if any(cid not in ids for cid, _, _ in sc):
        raise ValueError("corrupt SOS segment (unknown component)")
    cis = [ids.index(cid) for cid, _, _ in sc]
    # jdmarker.c: a component once a scan
    if len(set(cis)) != len(cis):
        raise ValueError("corrupt SOS segment (component listed twice)")
    if any(td > 3 or ta > 3 for _, td, ta in sc):
        raise ValueError("corrupt SOS segment")
    if st["lossless"]:
        if not 1 <= ss <= 7 or se or ah or al >= st["precision"]:
            raise ValueError("corrupt SOS segment (bad lossless parameters)")
    elif not progressive:
        if (ss, se, ah, al) != (0, 63, 0, 0):
            raise ValueError("corrupt SOS segment")
    elif ((se != 0) if ss == 0 else (se < ss or se > 63 or len(cis) != 1)
          ) or (ah and al != ah - 1) or al > 13:
        raise ValueError("corrupt SOS segment (bad progression parameters)")
    first = not st["scans"]
    if first:
        _setup(st)
        # jdinput.c initial_setup: has_multiple_scans
        st["multi"] = progressive or len(cis) < len(comps)
        if not arith:
            # Motion-JPEG frames leave out DHT: the Huffman decoder starts
            # with the Annex K tables wherever slots 0 and 1 are empty
            # (jstdhuff.c)
            for slot, (dc, ac) in enumerate(((DC_LUMA, AC_LUMA),
                                             (DC_CHROMA, AC_CHROMA))):
                st["dc"].setdefault(slot, _lut(*dc))
                st["ac"].setdefault(slot, _lut(*ac))
    for ci in cis:
        c = comps[ci]
        if progressive:
            c["prev"][1:] = c["bits"][1:10] if st["scans"] else [0] * 9
            c["bits"][ss:se + 1] = [al] * (se + 1 - ss)
        if ci not in st["qlatch"] and not st["lossless"]:
            if c["tq"] not in st["qt"]:
                raise ValueError("JPEG uses an undefined quant table")
            st["qlatch"][ci] = st["qt"][c["tq"]]
    st["scans"] += 1
    inp.next_rst = 0
    scan = dict(sc=sc, dc=st["dc"], ac=st["ac"], ri=st["ri"],
                band=(ss, se, ah, al), dac=st["dac"], seq=not progressive)
    try:
        if st["lossless"]:
            fresh = _decode_lossless_scan(inp, st, scan, st["coefs"])
            for ci in cis:
                st["fresh"][ci] = (fresh, len(cis) == 1, st["ri"], ss, al)
        else:
            _decode_scan(inp, st, scan, st["coefs"])
    except _Suspended:
        raise ValueError("truncated JPEG data (its scan runs past the end of "
                         f"the bytes){CV2_TOO}") from None
    return not st["multi"]


def _exif_orientation(tiff: bytes) -> int:
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    ifd = struct.unpack(e + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return 1
    for i in range(struct.unpack(e + "H", tiff[ifd:ifd + 2])[0]):
        p = ifd + 2 + 12 * i
        if p + 12 > len(tiff):
            return 1
        if struct.unpack(e + "H", tiff[p:p + 2])[0] == 0x0112:
            v = struct.unpack(e + "H", tiff[p + 8:p + 10])[0]
            return v if 1 <= v <= 8 else 1
    return 1


def _upsample(p: np.ndarray, rh: int, rv: int) -> np.ndarray:
    """jdsample.c's upsampling of one component plane (int64)."""
    h, w = p.shape
    e = np.pad(p, 1, mode="edge")
    mid = e[1:-1, 1:-1]
    if (rh, rv) == (2, 1) and w > 2:
        out = np.empty((h, 2 * w), np.int64)
        out[:, 0::2] = (3 * mid + e[1:-1, :-2] + 1) >> 2
        out[:, 1::2] = (3 * mid + e[1:-1, 2:] + 2) >> 2
        return out
    if (rh, rv) == (1, 2):
        out = np.empty((2 * h, w), np.int64)
        out[0::2] = (3 * mid + e[:-2, 1:-1] + 1) >> 2
        out[1::2] = (3 * mid + e[2:, 1:-1] + 2) >> 2
        return out
    if (rh, rv) == (2, 2) and w > 2:
        cs = np.empty((2 * h, w), np.int64)
        cs[0::2] = 3 * mid + e[:-2, 1:-1]
        cs[1::2] = 3 * mid + e[2:, 1:-1]
        ce = np.pad(cs, ((0, 0), (1, 1)), mode="edge")
        out = np.empty((2 * h, 2 * w), np.int64)
        out[:, 0::2] = (3 * cs + ce[:, :-2] + 8) >> 4
        out[:, 1::2] = (3 * cs + ce[:, 2:] + 7) >> 4
        return out
    return np.repeat(np.repeat(p, rv, 0), rh, 1)


def orient(img: np.ndarray, o: int) -> np.ndarray:
    """OpenCV's ``ApplyExifOrientation`` for tag value ``o``."""
    if o >= 5:
        img = img.swapaxes(0, 1)
    if o in (2, 3, 6, 7):
        img = img[:, ::-1]
    if o in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def decode_plain(data: bytes, gray: bool = False,
                 file: bool = False) -> np.ndarray:
    """(H, W, 3) RGB or (H, W) uint8, as ``native.jpeg_decode``."""
    st = _read(bytes(data), gray, file)
    h, w, comps = st["frame"]
    progressive = st["mode"][0]
    if st["lossless"]:
        return _decode_lossless(st, gray)
    max_h, max_v = st["max"]
    mcuy = st["geo"][1]
    # a component that no scan reached dequantises by zero (jddctmgr.c)
    qlatch = [st["qlatch"].get(ci, np.zeros((8, 8), np.int64))
              for ci in range(len(comps))]
    smooth = progressive and _smoothed([c["bits"] for c in comps], qlatch)
    planes = []
    for ci, c in enumerate(comps):
        bh, bw = c["bh"], c["bw"]
        blocks = np.array(st["coefs"][ci], np.int64).reshape(bh, bw, 64)
        if smooth:
            # each iMCU row smoothed with the bits of the scans that made
            # it: before the component's latest scan past the last row
            # decoded with data left (libjpeg-turbo's last_good_iMCU_row)
            args = (c["hb"], c["wb"], c["v"], mcuy)
            now = _smooth_blocks(blocks, *args, c["bits"], qlatch[ci])
            before = c["prev"] if st["scans"] > 1 else [-1] * 10
            late = np.arange(bh) // c["v"] > st["last_good"]
            if late.any():
                old = _smooth_blocks(blocks, *args, before, qlatch[ci])
                now[late] = old[late]
            blocks = now
        blocks = blocks.reshape(-1, 8, 8)
        px = idct_islow(blocks, qlatch[ci]).reshape(bh, bw, 8, 8)
        px = px.swapaxes(1, 2).reshape(bh * 8, bw * 8)
        ds_w, ds_h = -(-w * c["h"] // max_h), -(-h * c["v"] // max_v)
        up = _upsample(px[:ds_h, :ds_w].astype(np.int64), max_h // c["h"],
                       max_v // c["v"])
        planes.append(up[:h, :w])
    if len(comps) == 1:
        y = planes[0].astype(np.uint8)
        out = y if gray else np.repeat(y[..., None], 3, -1)
        return orient(out, st["orientation"])
    fix = lambda x: int(x * 65536 + 0.5)  # noqa: E731

    def ycc_rgb(a, b, c):
        cb, cr = b - 128, c - 128
        return (a + ((fix(1.402) * cr + 32768) >> 16),
                a + ((-fix(0.34414) * cb + 32768 - fix(0.71414) * cr) >> 16),
                a + ((fix(1.772) * cb + 32768) >> 16))

    if len(comps) == 4:
        # libjpeg reads CMYK (Adobe transform 0, or no Adobe marker) or
        # converts YCCK to it; OpenCV then applies its own CMYK -> BGR or
        # -> gray
        cmy, k = planes[:3], planes[3]
        if st["adobe"] not in (None, 0):
            cmy = [np.clip(255 - v, 0, 255) for v in ycc_rgb(*cmy)]
        r, g, b = (k - (((255 - v) * k) >> 8) for v in cmy)
        if gray:
            out = (b * 1868 + g * 9617 + r * 4899 + 8192) >> 14
        else:
            out = np.stack([r, g, b], -1)
        return orient(out.astype(np.uint8), st["orientation"])
    if st["jfif"]:
        rgb_space = False
    elif st["adobe"] is not None:
        rgb_space = st["adobe"] == 0
    else:
        rgb_space = [c["id"] for c in comps] == [82, 71, 66]
    a, b, c = planes
    if rgb_space:
        if gray:
            fw = [fix(x) for x in (0.299, 0.587, 0.114)]
            out = (fw[0] * a + fw[1] * b + fw[2] * c + 32768) >> 16
        else:
            out = np.stack([a, b, c], -1)
    elif gray:
        out = a
    else:
        out = np.clip(np.stack(ycc_rgb(a, b, c), -1), 0, 255)
    return orient(out.astype(np.uint8), st["orientation"])


def _decode_lossless(st, gray: bool) -> np.ndarray:
    """The samples of a lossless file (jdlossls.c): each scan's
    differences undifferenced by its predictor and shifted by its point
    transform into 8 bits, components upsampled by replication."""
    h, w, comps = st["frame"]
    max_h, max_v = st["max"]
    if len(st["fresh"]) != len(comps):
        # libjpeg would show uninitialised memory
        raise ValueError("truncated JPEG file (a component has no scan)")
    planes = []
    for ci, c in enumerate(comps):
        fresh, single, ri, ss, al = st["fresh"][ci]
        d = np.array(st["coefs"][ci], np.int64).reshape(c["bh"], c["bw"])
        first = np.zeros(c["bh"], bool)
        first[np.array(fresh) * (1 if single else c["v"])] = True
        x = _undifference(d, ss, st["precision"] - al, first)
        p = ((x << al) & 0xFF)[:-(-h * c["v"] // max_v), :-(-w * c["h"] // max_h)]
        p = np.repeat(np.repeat(p, max_v // c["v"], 0), max_h // c["h"], 1)
        planes.append(p[:h, :w].astype(np.int64))
    if len(comps) == 1:
        out = planes[0]
    elif len(comps) == 3:
        out = np.stack(planes, -1)
    else:                        # CMYK, as OpenCV converts it
        r, g, b = (planes[3] - (((255 - v) * planes[3]) >> 8)
                   for v in planes[:3])
        out = ((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14 if gray
               else np.stack([r, g, b], -1))
    return orient(out.astype(np.uint8), st["orientation"])


def _undifference(d, predictor: int, bits: int, first):
    """jdlossls.c's samples of the (rows, cols) differences ``d``, modulo
    2**16: a row where the predictor starts afresh (``first``) predicted
    from the left with ``2**(bits - 1)`` first, the first column from
    above, the rest by ``predictor`` (1-7)."""
    rows, cols = d.shape
    x = np.zeros((rows, cols), np.int64)
    for r in range(rows):
        t = d[r].copy()
        if first[r]:
            t[0] += 1 << (bits - 1)
            x[r] = np.cumsum(t) & 0xFFFF
            continue
        up = x[r - 1]
        t[0] += up[0]
        if predictor in (1, 4, 5):           # linear in the left sample
            if predictor == 4:
                t[1:] += up[1:] - up[:-1]
            elif predictor == 5:
                t[1:] += (up[1:] - up[:-1]) >> 1
            x[r] = np.cumsum(t) & 0xFFFF
        elif predictor in (2, 3):
            t[1:] += up[1:] if predictor == 2 else up[:-1]
            x[r] = t & 0xFFFF
        else:
            row, ups, ds = [int(t[0]) & 0xFFFF], up.tolist(), d[r].tolist()
            for c in range(1, cols):
                ra, rb, rc = row[-1], ups[c], ups[c - 1]
                pred = (rb + ((ra - rc) >> 1) if predictor == 6
                        else (ra + rb) >> 1)
                row.append((ds[c] + pred) & 0xFFFF)
            x[r] = row
    return x


def _smoothed(coef_bits, qtables) -> bool:
    """Whether libjpeg smooths the blocks of a progressive file
    (jdcoefct.c smoothing_ok): every component's DC known and its first
    ten quantisers (zigzag 0-9) nonzero, and some component's
    coefficients 1-9 short of full precision."""
    useful = False
    for bits, q in zip(coef_bits, qtables):
        if (q.reshape(64)[NATURAL[:10]] == 0).any() or bits[0] < 0:
            return False
        useful |= any(b != 0 for b in bits[1:10])
    return useful


def _kernel(rows):
    return np.array(rows, np.int64)


# jdcoefct.c decompress_smooth_data's estimates of zigzag coefficients
# 1-9 (and the DC) from the 5 x 5 DC values around a block (rows and
# columns -2..2): (natural index, weights with DC interpolation, weights
# without it, or None where only DC interpolation estimates it)
_AC01 = _kernel([[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3],
                 [-3, 13, 0, -13, 3], [-1, -1, 0, 1, 1]])
_AC01_K8 = _kernel([[0] * 5, [0] * 5, [-7, 50, 0, -50, 7], [0] * 5, [0] * 5])
_AC20 = _kernel([[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0],
                 [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]])
_AC20_K8 = _kernel([[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0],
                    [0, 0, 13, 0, 0], [0, 0, -1, 0, 0]])
_AC11 = _kernel([[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0] * 5,
                 [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]])
_AC11_K8 = _kernel([[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0] * 5,
                    [1, -10, 0, 10, -1], [0, 1, 0, -1, 0]])
_AC03 = _kernel([[0] * 5, [0, 1, 0, -1, 0], [0, 2, 0, -2, 0],
                 [0, 1, 0, -1, 0], [0] * 5])
_AC12 = _kernel([[0] * 5, [0, 1, -3, 1, 0], [0] * 5, [0, -1, 3, -1, 0],
                 [0] * 5])
_SMOOTH = [(1, _AC01, _AC01_K8), (8, _AC01.T, _AC01_K8.T),
           (16, _AC20, _AC20_K8), (9, _AC11, _AC11_K8),
           (2, _AC20.T, _AC20_K8.T), (3, _AC03, None), (10, _AC12, None),
           (17, _AC12.T, None), (24, _AC03.T, None)]
_DC_SMOOTH = _kernel([[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6],
                      [-8, 42, 152, 42, -8], [-6, 6, 42, 6, -6],
                      [-2, -6, -8, -6, -2]])


def _smooth_rows(hb, v, total):
    """(hb, 5) rows of the DC values around each block row, -2..2, as
    decompress_smooth_data picks them: an iMCU row's block rows count
    ``block_rows`` (the last one's only its real rows), and a neighbour
    row that its index math puts outside the image repeats the nearer
    one."""
    out = np.zeros((hb, 5), np.int64)
    for r in range(hb):
        i, b = divmod(r, v)
        rows = v if i < total - 1 else (hb % v or v)
        at, n = i * rows + b, rows * total
        prev = r - 1 if at > 0 else r
        prev2 = r - 2 if at > 1 else prev
        nxt = r + 1 if at < n - 1 else r
        nxt2 = r + 2 if at < n - 2 else nxt
        out[r] = (prev2, prev, r, nxt, nxt2)
    return out


def _smooth_blocks(blocks, hb, wb, v, total, bits, q):
    """libjpeg's block smoothing (jdcoefct.c decompress_smooth_data) of a
    component's real ``hb`` x ``wb`` blocks in ``blocks`` ((rows, cols,
    64) natural order, rows past ``hb`` the iMCU rows' dummy ones): zigzag
    coefficients 1-9 still zero and short of full precision
    (``bits[k]`` != 0, the Al of the last scan that coded them, -1 for
    none) are estimated from the 5 x 5 DC values around the block, bounded
    below ``2**Al``; where no AC scan coded any of them, the DC is also
    replaced by its interpolation.  Returns the blocks to transform."""
    q = q.reshape(64).astype(np.int64)
    short = total * v - blocks.shape[0]       # a lone component's dummies
    dc = np.pad(blocks[..., 0], ((0, max(short, 0)), (0, 0)))
    rows = _smooth_rows(hb, v, total)
    cols = np.clip(np.arange(wb)[:, None] + np.arange(-2, 3), 0, wb - 1)
    # (hb, wb, 5, 5) DC values around each real block
    near = dc[rows[:, None, :, None], cols[None, :, None, :]]
    change_dc = all(b == -1 for b in bits[1:10])
    out = blocks.copy()
    real = out[:hb, :wb]
    for k, (pos, with_dc, without) in enumerate(_SMOOTH, start=1):
        kernel = with_dc if change_dc else without
        if kernel is None or bits[k] == 0:
            continue
        num = q[0] * (near * kernel).sum((-2, -1))
        qk = q[pos]
        pred = ((qk << 7) + np.abs(num)) // (qk << 8)
        if bits[k] > 0:
            pred = np.minimum(pred, (1 << bits[k]) - 1)
        pred = np.where(num < 0, -pred, pred)
        real[..., pos] = np.where(real[..., pos] == 0, pred, real[..., pos])
    if change_dc:
        num = q[0] * (near * _DC_SMOOTH).sum((-2, -1))
        pred = ((q[0] << 7) + np.abs(num)) // (q[0] << 8)
        real[..., 0] = np.where(num < 0, -pred, pred)
    return out


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _plane_blocks(p: np.ndarray) -> np.ndarray:
    """(bh, bw, 8, 8) blocks of a plane whose sides are multiples of 8."""
    bh, bw = p.shape[0] // 8, p.shape[1] // 8
    return p.reshape(bh, 8, bw, 8).swapaxes(1, 2)


def _downsample(e: np.ndarray, rh: int, rv: int) -> np.ndarray:
    """jcsample.c's chroma downsampling of an edge-padded plane ``e``
    (sides multiples of ``rv`` and ``rh``): h2v2 with bias 1, 2, 1, ...,
    h2v1 with bias 0, 1, 0, ..., and the integer average (rounded half
    up) otherwise."""
    sums = sum(e[i::rv, j::rh] for i in range(rv) for j in range(rh))
    cols = sums.shape[1]
    if (rh, rv) == (2, 2):
        return (sums + np.tile([1, 2], cols // 2 + 1)[:cols]) >> 2
    if (rh, rv) == (2, 1):
        return (sums + np.tile([0, 1], cols // 2 + 1)[:cols]) >> 1
    return (sums + rh * rv // 2) // (rh * rv)


def encode_plain(image: np.ndarray, sampling=(2, 2)) -> bytes:
    """The bytes of ``cv2.imencode(".jpg")`` at its defaults, as
    ``native.jpeg_encode``.  ``sampling`` is the luma's (h, v) factors
    over chroma's (1, 1): (2, 2) is the default 4:2:0, (1, 1) 4:4:4,
    (2, 1) 4:2:2 and (1, 2) 4:4:0, as ``IMWRITE_JPEG_SAMPLING_FACTOR``
    gives them (the library writes 4:2:0 only)."""
    img = np.asarray(image)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    color = img.ndim == 3
    h, w = img.shape[:2]
    x = img.astype(np.int64)
    fix = lambda v: int(v * 65536 + 0.5)  # noqa: E731
    half, off = 1 << 15, 128 << 16
    if color:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        full = [(fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half)
                >> 16,
                (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off
                 + half - 1) >> 16,
                (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off
                 + half - 1) >> 16]
        hy, vy = sampling
    else:
        full, (hy, vy) = [x], (1, 1)
    qt = quant_tables()
    mcux, mcuy = -(-w // (8 * hy)), -(-h // (8 * vy))
    comps = []
    for ci, p in enumerate(full):
        if ci == 0:
            wb, hb = -(-w // 8), -(-h // 8)
            pad = np.pad(p, ((0, mcuy * vy * 8 - h), (0, wb * 8 - w)),
                         mode="edge")
        else:
            wb, hb = mcux, mcuy
            e = np.pad(p, ((0, -h % vy), (0, wb * 8 * hy - w)), mode="edge")
            ds = _downsample(e, hy, vy)
            pad = np.pad(ds, ((0, hb * 8 - ds.shape[0]), (0, 0)), mode="edge")
        blocks = _plane_blocks(pad)[:hb, :wb].reshape(-1, 8, 8)
        q = qt[0 if ci == 0 else 1].reshape(8, 8)
        coef = quantize(fdct_islow(blocks), q).reshape(hb, wb, 8, 8)
        comps.append(coef.reshape(hb, wb, 64))
    out = bytearray(b"\xff\xd8\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01"
                    b"\x00\x01\x00\x00")
    for t in range(2 if color else 1):
        out += b"\xff\xdb\x00\x43" + bytes([t]) + bytes(
            qt[t][NATURAL].astype(np.uint8))
    nc = 3 if color else 1
    out += b"\xff\xc0" + struct.pack(">HBHHB", 8 + 3 * nc, 8, h, w, nc)
    for ci in range(nc):
        out += bytes([ci + 1, (hy << 4 | vy) if ci == 0 else 0x11,
                      0 if ci == 0 else 1])
    tables = [(0, 0, DC_LUMA), (1, 0, AC_LUMA)]
    if color:
        tables += [(0, 1, DC_CHROMA), (1, 1, AC_CHROMA)]
    for cls, tid, (bits, vals) in tables:
        out += b"\xff\xc4" + struct.pack(">HB", 3 + 16 + len(vals),
                                         cls << 4 | tid)
        out += bytes(bits) + bytes(vals)
    out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * nc, nc)
    for ci in range(nc):
        out += bytes([ci + 1, 0 if ci == 0 else 0x11])
    out += b"\x00\x3f\x00"
    out += _entropy(comps, (hy, vy) if color else None, mcux, mcuy)
    return bytes(out + b"\xff\xd9")


def _entropy(comps, luma, mcux, mcuy) -> bytes:
    """The Huffman-coded scan: one component's blocks in order, or the
    MCUs of three (``luma`` = Y's (h, v) blocks per MCU), with
    jccoefct.c's dummy blocks (AC 0, DC of the block before) where an
    MCU overhangs the image."""
    dc = [_codes(*DC_LUMA), _codes(*DC_CHROMA)]
    ac = [_codes(*AC_LUMA), _codes(*AC_CHROMA)]
    natural = NATURAL.tolist()
    bits = []

    def put(code, n):
        if n:
            bits.append(format(code, f"0{n}b"))

    def block(blk, ci, last):
        t = 0 if ci == 0 else 1
        diff = blk[0] - last
        size = abs(diff).bit_length()
        put(*dc[t][size])
        if size:
            put(diff if diff > 0 else diff - 1 + (1 << size), size)
        run = 0
        for k in range(1, 64):
            v = blk[natural[k]]
            if v == 0:
                run += 1
                continue
            while run > 15:
                put(*ac[t][0xF0])
                run -= 16
            size = abs(v).bit_length()
            put(*ac[t][(run << 4) | size])
            put(v if v > 0 else v - 1 + (1 << size), size)
            run = 0
        if run:
            put(*ac[t][0])
        return blk[0]

    last = [0, 0, 0]
    if luma is None:
        for blk in comps[0].reshape(-1, 64).tolist():
            last[0] = block(blk, 0, last[0])
    else:
        lists = [c.tolist() for c in comps]
        for my in range(mcuy):
            for mx in range(mcux):
                for ci in range(3):
                    nh, nv = luma if ci == 0 else (1, 1)
                    hb, wb = comps[ci].shape[:2]
                    prev = 0
                    for yy in range(nv):
                        by, row_dc = my * nv + yy, prev
                        for xx in range(nh):
                            bx = mx * nh + xx
                            if by < hb and bx < wb:
                                blk = lists[ci][by][bx]
                            else:       # jccoefct.c's dummy blocks
                                blk = [0] * 64
                                blk[0] = prev if by < hb else row_dc
                            prev = blk[0]
                            last[ci] = block(blk, ci, last[ci])
    s = "".join(bits)
    s += "1" * (-len(s) % 8)
    raw = int(s, 2).to_bytes(len(s) // 8, "big") if s else b""
    return raw.replace(b"\xff", b"\xff\x00")
