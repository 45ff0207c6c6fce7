"""Plain versions of the JPEG library (``csrc/jpeg.cpp``), in Python and
numpy.

:func:`decode_plain` and :func:`encode_plain` compute what
``native.jpeg_decode`` and ``native.jpeg_encode`` compute, written apart
from them: the Huffman codes in a Python loop over a table of every
16-bit window of the entropy bits, the QM decoder of T.81 Annex D over a
restart interval's bytes, the DCTs, sampling and colour steps vectorised
over all blocks of a component, quantisation as a rounding division.
The tests and ``chip_smoke.py`` hold the library against them; the
codec's route (``data/codec.py``) uses the library on every machine.

What both compute is libjpeg-turbo's default path, as OpenCV runs it:
sequential and progressive Huffman or arithmetic entropy decoding
(``jdhuff.c``, ``jdphuff.c``, ``jdarith.c``; the Annex K tables where a
scan's Huffman table was never defined), lossless files (``jdlhuff.c``,
``jdlossls.c``), the ISLOW DCTs (``jidctint.c``, ``jfdctint.c``), block
smoothing (``jdcoefct.c``), fancy upsampling (``jdsample.c``), the fixed-point
colour tables (``jdcolor.c``, ``jccolor.c``; YCCK to CMYK), OpenCV's
CMYK to BGR and gray, ``h2v2_downsample`` (``jcsample.c``), and the EXIF
orientation as OpenCV applies it; the encoder writes what
``cv2.imencode(".jpg")`` writes at its defaults (quality 95, 4:2:0,
standard Huffman tables).
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


def _idct_1d(v, n):
    """One ISLOW pass along the last axis of ``v`` (..., 8), descaled by
    ``n`` bits."""
    c = _C
    z1 = (v[..., 2] + v[..., 6]) * c["F0_541"]
    t2 = z1 - v[..., 6] * c["F1_847"]
    t3 = z1 + v[..., 2] * c["F0_765"]
    t0 = (v[..., 0] + v[..., 4]) << CONST_BITS
    t1 = (v[..., 0] - v[..., 4]) << CONST_BITS
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    o0, o1, o2, o3 = v[..., 7], v[..., 5], v[..., 3], v[..., 1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * c["F1_175"]
    o0 = o0 * c["F0_298"]
    o1 = o1 * c["F2_053"]
    o2 = o2 * c["F3_072"]
    o3 = o3 * c["F1_501"]
    z1 = z1 * -c["F0_899"]
    z2 = z2 * -c["F2_562"]
    z3 = z3 * -c["F1_961"] + z5
    z4 = z4 * -c["F0_390"] + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    out = [t10 + o3, t11 + o2, t12 + o1, t13 + o0,
           t13 - o0, t12 - o1, t11 - o2, t10 - o3]
    return _descale(np.stack(out, -1), n)


_RANGE = np.concatenate([np.arange(128, 256), np.full(384, 255),
                         np.zeros(384, int), np.arange(0, 128)]).astype(
                             np.uint8)


def idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(N, 8, 8) uint8 samples of (N, 8, 8) coefficients (natural order)
    dequantised by ``q`` (8, 8)."""
    x = coef.astype(np.int64) * q.astype(np.int64)
    ws = _idct_1d(x.swapaxes(1, 2), CONST_BITS - PASS1_BITS)  # columns
    out = _idct_1d(ws.swapaxes(1, 2), CONST_BITS + PASS1_BITS + 3)  # rows
    return _RANGE[out & 1023]


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

def _lut(bits, vals):
    """(length, symbol) of every 16-bit window: 65536-entry lists; None for
    counts that are no prefix code or give an all-ones code, which jdhuff.c
    refuses when a scan uses the table."""
    code = 0
    for n, count in enumerate(bits, start=1):
        code += count
        if code >= 1 << n:
            return None
        code <<= 1
    length = np.zeros(65536, np.int64)
    symbol = np.zeros(65536, np.int64)
    code = k = 0
    for n, count in enumerate(bits, start=1):
        for _ in range(count):
            lo = code << (16 - n)
            length[lo:lo + (1 << (16 - n))] = n
            symbol[lo:lo + (1 << (16 - n))] = vals[k]
            code += 1
            k += 1
        code <<= 1
    return length.tolist(), symbol.tolist()


def _segments(data: bytes, pos: int):
    """The entropy-coded segments from ``pos``: byte strings between
    restart markers with the stuffing removed, and the position of the
    marker that ends the scan."""
    segs, cur = [], bytearray()
    n = len(data)
    while pos < n:
        b = data[pos]
        if b != 0xFF:
            cur.append(b)
            pos += 1
            continue
        q = pos + 1
        while q < n and data[q] == 0xFF:
            q += 1
        if q >= n:
            pos = n
            break
        if data[q] == 0x00 and q == pos + 1:
            cur.append(0xFF)
            pos += 2
        elif 0xD0 <= data[q] <= 0xD7:
            segs.append((bytes(cur), data[q] - 0xD0))
            cur = bytearray()
            pos = q + 1
        else:
            break
    segs.append((bytes(cur), None))
    return segs, pos


def _windows(seg: bytes):
    """Every 16-bit window of the segment's bits (list), and its bit
    count; the bits past the end read as zeros."""
    bits = np.unpackbits(np.frombuffer(seg + b"\0\0\0\0", np.uint8)).astype(
        np.int64)
    n = len(seg) * 8
    w = np.zeros(n + 16, np.int64)
    for k in range(16):
        w += bits[k:k + n + 16] << (15 - k)
    return w.tolist(), n


def _extend(v, s):
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _i16(v):
    return ((v + 0x8000) & 0xFFFF) - 0x8000


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


def _parse(data: bytes, gray: bool = False, file: bool = False):
    if len(data) < 4 or data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    st = dict(qt={}, dc={}, ac={}, ri=0, frame=None, jfif=False,
              adobe=None, orientation=1, exif_seen=False, scans=[],
              mode=(False, False), eoi=False, lossless=False, precision=8,
              dac=dict(L=[0] * 16, U=[1] * 16, K=[5] * 16))
    pos, n = 2, len(data)
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            if not st["scans"]:
                raise ValueError("truncated JPEG file (no image data)")
            # cv2.imread reads a file through libjpeg's stdio source, which
            # supplies an EOI marker at the end of the file; taken where
            # the scans' data is known whole (not after arithmetic-coded
            # data, which decodes on from zero bits)
            st["eoi"] = file and not (st["mode"][1] and st["last_at_end"])
            st["file"] = file
            break
        m = data[pos]
        pos += 1
        if m == 0xD9:
            st["eoi"] = True
            break
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            continue
        if pos + 2 > n:
            raise ValueError("truncated JPEG header")
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        if length < 2 or pos + length > n:
            raise ValueError("truncated JPEG header")
        body = data[pos + 2:pos + length]
        if m in _REFUSED:
            raise ValueError(f"{_REFUSED[m]} is not decoded{CV2_TOO}")
        if m in _FRAMES:
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
            if not st["scans"] and not st["mode"][1]:
                # Motion-JPEG frames leave out DHT: the Huffman decoder
                # starts with the Annex K tables wherever slots 0 and 1
                # are empty (jstdhuff.c)
                for slot, (dc, ac) in enumerate(((DC_LUMA, AC_LUMA),
                                                 (DC_CHROMA, AC_CHROMA))):
                    st["dc"].setdefault(slot, _lut(*dc))
                    st["ac"].setdefault(slot, _lut(*ac))
            ns = body[0]
            sc = [(body[1 + 2 * i], body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15)
                  for i in range(ns)]
            ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
            segs, pos = _segments(data, pos + length)
            st["last_at_end"] = pos >= n
            st["scans"].append(dict(
                sc=sc, segs=segs, dc=dict(st["dc"]), ac=dict(st["ac"]),
                qt=dict(st["qt"]), ri=st["ri"], band=(ss, se, a >> 4, a & 15),
                dac={k: list(v) for k, v in st["dac"].items()}))
            continue
        pos += length
    if st["frame"] is None:
        raise ValueError("JPEG without a frame header")
    return st


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


def _scan_units(scan, frame_comps, geo):
    """The scan's components (frame index, DC table, AC table) and its
    MCUs: lists of (component, block index) in coding order, one block of
    a lone component (its real blocks only) or each component's h x v."""
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
    else:
        units = []
        for my in range(mcuy):
            for mx in range(mcux):
                u = []
                for ci, _, _ in parts:
                    c = frame_comps[ci]
                    u += [(ci, (my * c["v"] + yy) * c["bw"] + mx * c["h"] + xx)
                          for yy in range(c["v"]) for xx in range(c["h"])]
                units.append(u)
    return parts, units


def _decode_scan(scan, frame_comps, coefs, geo, mode):
    progressive, arith = mode
    ss, se, ah, al = scan["band"]
    parts, units = _scan_units(scan, frame_comps, geo)
    if not arith:
        use_dc = not progressive or (ss == 0 and ah == 0)
        use_ac = not progressive or ss > 0
        for _, dc, ac in parts:     # DC symbols are sizes, 0..15
            if (use_dc and (dc is None or max(dc[1]) > 15)) or (
                    use_ac and ac is None):
                raise ValueError("corrupt JPEG Huffman table")
    ri = scan["ri"]
    segs = scan["segs"]
    per_seg = ri if ri else len(units)
    tables = {ci: (dc, ac) for ci, dc, ac in parts}
    tnums = {frame_ci: (td, ta) for (frame_ci, _, _), (_, td, ta)
             in zip(parts, scan["sc"])}
    for s, start in enumerate(range(0, len(units), per_seg)):
        if s >= len(segs):
            raise ValueError("truncated JPEG entropy data")
        seg, rst = segs[s]
        if start + per_seg < len(units) and rst != s % 8:
            raise ValueError("corrupt JPEG entropy data (restart marker)")
        chunk = units[start:start + per_seg]
        if arith:
            _arith_units(chunk, tnums, coefs, seg, scan, progressive)
            continue
        win, nbits = _windows(seg)
        try:
            if progressive:
                _progressive_units(chunk, tables, coefs, _Bits(win, nbits),
                                   scan["band"])
            else:
                _decode_units(chunk, tables, coefs, win, nbits)
        except IndexError as ex:      # read past the padding
            raise ValueError("truncated JPEG entropy data") from ex


def _decode_units(units, tables, coefs, win, nbits):
    """Huffman-decode the blocks of ``units`` (lists of (component, block
    index)) of a sequential scan from one restart interval's bit
    windows."""
    natural = NATURAL.tolist()
    pos = 0
    pred = dict.fromkeys(tables, 0)
    for unit in units:
        for ci, b in unit:
            (dlen, dsym), (alen, asym) = tables[ci]
            blk = [0] * 64
            v = win[pos]
            if dlen[v] == 0:
                raise ValueError("corrupt JPEG entropy data")
            size = dsym[v]
            pos += dlen[v]
            if size:
                pred[ci] += _extend(win[pos] >> (16 - size), size)
                pos += size
            blk[0] = pred[ci]
            k = 1
            while k < 64:
                v = win[pos]
                if alen[v] == 0:
                    raise ValueError("corrupt JPEG entropy data")
                rs = asym[v]
                pos += alen[v]
                r, size = rs >> 4, rs & 15
                if size:
                    k += r
                    if k > 63:
                        raise ValueError("corrupt JPEG entropy data")
                    blk[natural[k]] = _extend(win[pos] >> (16 - size), size)
                    pos += size
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    break
            if pos > nbits:
                raise ValueError("truncated JPEG entropy data")
            coefs[ci][b] = [_i16(x) for x in blk]


class _Bits:
    """A reader over one restart interval's bit windows."""

    def __init__(self, win, nbits):
        self.win, self.nbits, self.pos = win, nbits, 0

    def huff(self, table):
        length, symbol = table
        v = self.win[self.pos]
        if length[v] == 0:
            raise ValueError("corrupt JPEG entropy data")
        self.pos += length[v]
        return symbol[v]

    def get(self, n):
        if n == 0:
            return 0
        v = self.win[self.pos] >> (16 - n)
        self.pos += n
        return v


def _progressive_units(units, tables, coefs, bits, band):
    """One restart interval of a progressive Huffman scan (T.81 G.1.2:
    DC first and refinement, AC first with EOB runs, AC refinement with
    its correction bits)."""
    ss, se, ah, al = band
    natural = NATURAL.tolist()
    p1 = 1 << al
    pred = dict.fromkeys(tables, 0)
    eobrun = 0
    for unit in units:
        for ci, b in unit:
            blk = coefs[ci][b]
            if ss == 0:
                if ah == 0:
                    size = bits.huff(tables[ci][0])
                    pred[ci] += _extend(bits.get(size), size) if size else 0
                    blk[0] = _i16(pred[ci] << al)
                elif bits.get(1):
                    blk[0] |= p1
                continue
            ac = tables[ci][1]
            if ah == 0:
                if eobrun:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    rs = bits.huff(ac)
                    r, size = rs >> 4, rs & 15
                    if size:
                        k += r
                        if k > 63:
                            raise ValueError("corrupt JPEG entropy data")
                        blk[natural[k]] = _i16(
                            _extend(bits.get(size), size) << al)
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = (1 << r) + bits.get(r) - 1
                        break
                    k += 1
                continue
            k = ss
            if eobrun == 0:
                while k <= se:
                    rs = bits.huff(ac)
                    r, size = rs >> 4, rs & 15
                    new = 0
                    if size:
                        new = p1 if bits.get(1) else -p1
                    elif r != 15:
                        eobrun = (1 << r) + bits.get(r)
                        break
                    while k <= se:
                        z = natural[k]
                        if blk[z]:
                            if bits.get(1) and not blk[z] & p1:
                                blk[z] += p1 if blk[z] > 0 else -p1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if new:
                        if k > 63:
                            raise ValueError("corrupt JPEG entropy data")
                        blk[natural[k]] = new
                    k += 1
            if eobrun:
                for z in natural[k:se + 1]:
                    if blk[z] and bits.get(1) and not blk[z] & p1:
                        blk[z] += p1 if blk[z] > 0 else -p1
                eobrun -= 1
        if bits.pos > bits.nbits:
            raise ValueError("truncated JPEG entropy data")


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
    """The QM decoder of T.81 D.2 over one restart interval's bytes (the
    stuffing removed); past their end it reads zeros, as the decoder is fed
    zeros at a marker.  A statistics bin is an int: its index in Table D.2
    and its MPS in bit 7."""

    def __init__(self, seg: bytes):
        self.seg, self.pos = seg, 0
        self.c, self.a, self.ct = 0, 0, -16

    def decode(self, bins, i):
        while self.a < 0x8000:
            self.ct -= 1
            if self.ct < 0:
                b = self.seg[self.pos] if self.pos < len(self.seg) else 0
                self.pos += 1
                self.c = (self.c << 8) | b
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
                raise ValueError("corrupt JPEG entropy data (bad arithmetic "
                                 "code)")
            s += 1
    v = m
    s += 14
    b = m >> 1
    while b:
        if ar.decode(bins, s):
            v |= b
        b >>= 1
    return v, m


def _arith_units(units, tnums, coefs, seg, scan, progressive):
    """One restart interval of an arithmetic-coded scan, sequential or
    progressive (T.81 F.2.4 and G.1.3; the statistics start at zero)."""
    ss, se, ah, al = scan["band"]
    dac = scan["dac"]
    natural = NATURAL.tolist()
    ar = _Arith(seg)
    dc_bins = {td: [0] * 64 for td, _ in tnums.values()}
    ac_bins = {ta: [0] * 256 for _, ta in tnums.values()}
    fixed = [113]
    pred = dict.fromkeys(tnums, 0)
    ctx = dict.fromkeys(tnums, 0)
    p1 = 1 << al

    def dc_diff(ci):
        td = tnums[ci][0]
        bins = dc_bins[td]
        s = ctx[ci]
        if not ar.decode(bins, s):
            ctx[ci] = 0
            return 0
        sign = ar.decode(bins, s + 1)
        v, m = _arith_value(ar, bins, s + 2 + sign)
        if m < (1 << dac["L"][td]) >> 1:
            ctx[ci] = 0
        elif m > (1 << dac["U"][td]) >> 1:
            ctx[ci] = 12 + 4 * sign
        else:
            ctx[ci] = 4 + 4 * sign
        return -(v + 1) if sign else v + 1

    def ac_band(ci, blk, lo, hi, shift):
        ta = tnums[ci][1]
        bins = ac_bins[ta]
        k = lo
        while k <= hi:
            s = 3 * (k - 1)
            if ar.decode(bins, s):                    # EOB
                return
            while not ar.decode(bins, s + 1):
                s += 3
                k += 1
                if k > hi:
                    raise ValueError("corrupt JPEG entropy data (bad "
                                     "arithmetic code)")
            sign = ar.decode(fixed, 0)
            v, _ = _arith_value(ar, bins, s + 2,
                                kbins=189 if k <= dac["K"][ta] else 217)
            blk[natural[k]] = _i16((-(v + 1) if sign else v + 1) << shift)
            k += 1

    def ac_refine(ci, blk):
        bins = ac_bins[tnums[ci][1]]
        kex = se
        while kex > 0 and not blk[natural[kex]]:
            kex -= 1
        k = ss
        while k <= se:
            s = 3 * (k - 1)
            if k > kex and ar.decode(bins, s):        # EOB
                return
            while True:
                z = natural[k]
                if blk[z]:
                    if ar.decode(bins, s + 2):
                        blk[z] += p1 if blk[z] > 0 else -p1
                    break
                if ar.decode(bins, s + 1):
                    blk[z] = -p1 if ar.decode(fixed, 0) else p1
                    break
                s += 3
                k += 1
                if k > se:
                    raise ValueError("corrupt JPEG entropy data (bad "
                                     "arithmetic code)")
            k += 1

    for unit in units:
        for ci, b in unit:
            blk = coefs[ci][b]
            if not progressive:
                pred[ci] = (pred[ci] + dc_diff(ci)) & 0xFFFF
                blk[0] = _i16(pred[ci])
                ac_band(ci, blk, 1, 63, 0)
            elif ss == 0 and ah == 0:
                pred[ci] += dc_diff(ci)
                blk[0] = _i16(pred[ci] << al)
            elif ss == 0:
                if ar.decode(fixed, 0):
                    blk[0] |= p1
            elif ah == 0:
                ac_band(ci, blk, ss, se, al)
            else:
                ac_refine(ci, blk)


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


def _check_eoi(st):
    """cv2.imdecode's memory source has no byte past the end of the
    buffer, and libjpeg's read of one suspends, which OpenCV takes as a
    failure: libjpeg reads a file of several scans (every progressive one)
    to its EOI before any output, and a lone scan as far as its bit reader
    looks ahead."""
    if st["eoi"]:
        return
    if st.get("file"):
        raise ValueError("arithmetic-coded JPEG whose scan data runs to the "
                         "end of the file is not decoded (cv2.imread decodes "
                         "it on from zero bits)")
    if st["mode"][0] or len(st["scans"]) > 1:
        raise ValueError("JPEG of several scans without an EOI marker after "
                         f"them is not decoded{CV2_TOO}")
    if st["last_at_end"]:
        raise ValueError("JPEG whose scan data runs to the end of the bytes "
                         "without an EOI marker is not decoded (cv2.imdecode "
                         "returns None for it unless libjpeg's bit reader "
                         "looks no byte past the end)")


def decode_plain(data: bytes, gray: bool = False,
                 file: bool = False) -> np.ndarray:
    """(H, W, 3) RGB or (H, W) uint8, as ``native.jpeg_decode``."""
    st = _parse(bytes(data), gray, file)
    h, w, comps = st["frame"]
    progressive, arith = st["mode"]
    if h == 0:
        raise ValueError("JPEG with its height in a DNL marker is not decoded")
    if h * w > 1 << 30:
        raise ValueError(f"JPEG of {w}x{h} pixels is too large (limit 2^30)"
                         f"{CV2_TOO}")
    if st["lossless"]:
        return _decode_lossless(st, gray)
    max_h = max(c["h"] for c in comps)
    max_v = max(c["v"] for c in comps)
    mcux, mcuy = -(-w // (8 * max_h)), -(-h // (8 * max_v))
    coefs = []
    for c in comps:
        c["wb"] = -(-w * c["h"] // (8 * max_h))
        c["hb"] = -(-h * c["v"] // (8 * max_v))
        c["bw"] = c["wb"] if len(comps) == 1 else mcux * c["h"]
        c["bh"] = c["hb"] if len(comps) == 1 else mcuy * c["v"]
        coefs.append([[0] * 64 for _ in range(c["bw"] * c["bh"])])
    ids = [c["id"] for c in comps]
    seen, qlatch = set(), {}
    coef_bits = [[-1] * 64 for _ in comps]
    for scan in st["scans"]:
        ss, se, ah, al = scan["band"]
        cis = [ids.index(cid) for cid, _, _ in scan["sc"]]
        if not progressive:
            if (ss, se, ah, al) != (0, 63, 0, 0):
                raise ValueError("corrupt SOS segment")
        elif ((se != 0) if ss == 0 else (se < ss or se > 63 or len(cis) != 1)
              ) or (ah and al != ah - 1) or al > 13:
            raise ValueError("corrupt SOS segment (bad progression "
                             "parameters)")
        for ci in cis:
            seen.add(ci)
            qlatch.setdefault(ci, scan["qt"][comps[ci]["tq"]])
            coef_bits[ci][ss:se + 1] = [al] * (se + 1 - ss)
        _decode_scan(scan, comps, coefs, (mcux, mcuy), st["mode"])
    if len(seen) != len(comps):
        raise ValueError("truncated JPEG file (a component has no scan)")
    _check_eoi(st)
    smooth = progressive and _smoothed(
        coef_bits, [qlatch[i] for i in range(len(comps))])
    planes = []
    for ci, c in enumerate(comps):
        bh, bw = c["bh"], c["bw"]
        blocks = np.array(coefs[ci], np.int64).reshape(bh, bw, 64)
        if smooth:
            blocks = _smooth_blocks(blocks, c["hb"], c["wb"], c["v"], mcuy,
                                   coef_bits[ci], qlatch[ci])
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
    """A lossless file (T.81 Annex H; jdlhuff.c, jddiffct.c, jdlossls.c):
    each scan's differences in MCU order (restart intervals of whole MCU
    rows), the samples undifferenced by the scan's predictor and shifted
    by its point transform into 8 bits, components upsampled by
    replication."""
    h, w, comps = st["frame"]
    max_h = max(c["h"] for c in comps)
    max_v = max(c["v"] for c in comps)
    mcux, mcuy = -(-w // max_h), -(-h // max_v)
    for c in comps:          # a data unit is a sample
        c["wb"] = -(-w * c["h"] // max_h)
        c["hb"] = -(-h * c["v"] // max_v)
        c["bw"] = c["wb"] if len(comps) == 1 else mcux * c["h"]
        c["bh"] = c["hb"] if len(comps) == 1 else mcuy * c["v"]
    ids = [c["id"] for c in comps]
    samples = {}
    for scan in st["scans"]:
        ss, se, ah, al = scan["band"]
        if not 1 <= ss <= 7 or se or ah or al >= st["precision"]:
            raise ValueError("corrupt SOS segment (bad lossless parameters)")
        parts, units = _scan_units(scan, comps, (mcux, mcuy))
        for _, dc, _ in parts:
            if dc is None or max(dc[1]) > 16:
                raise ValueError("corrupt JPEG Huffman table")
        single = len(parts) == 1
        cols = comps[parts[0][0]]["wb"] if single else mcux
        if scan["ri"] % cols:
            raise ValueError("lossless JPEG whose restart interval is not a "
                             f"whole number of MCU rows is not decoded"
                             f"{CV2_TOO}")
        diffs = {ci: [0] * (comps[ci]["bw"] * comps[ci]["bh"])
                 for ci, _, _ in parts}
        tables = {ci: dc for ci, dc, _ in parts}
        per_seg = scan["ri"] or len(units)
        for s, start in enumerate(range(0, len(units), per_seg)):
            if s >= len(scan["segs"]):
                raise ValueError("truncated JPEG entropy data")
            seg, rst = scan["segs"][s]
            if start + per_seg < len(units) and rst != s % 8:
                raise ValueError("corrupt JPEG entropy data (restart marker)")
            win, nbits = _windows(seg)
            bits = _Bits(win, nbits)
            try:
                for unit in units[start:start + per_seg]:
                    for ci, i in unit:
                        size = bits.huff(tables[ci])
                        diffs[ci][i] = (32768 if size == 16 else
                                        _extend(bits.get(size), size)
                                        if size else 0)
            except IndexError as ex:
                raise ValueError("truncated JPEG entropy data") from ex
            if bits.pos > bits.nbits:
                raise ValueError("truncated JPEG entropy data")
        for ci, _, _ in parts:
            c = comps[ci]
            d = np.array(diffs[ci], np.int64).reshape(c["bh"], c["bw"])
            rows = scan["ri"] // cols * (1 if single else c["v"])
            x = _undifference(d, ss, st["precision"] - al, rows)
            samples[ci] = ((x << al) & 0xFF).astype(np.uint8)
    if len(samples) != len(comps):
        raise ValueError("truncated JPEG file (a component has no scan)")
    _check_eoi(st)
    planes = []
    for ci, c in enumerate(comps):
        p = samples[ci][:-(-h * c["v"] // max_v), :-(-w * c["h"] // max_h)]
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


def _undifference(d, predictor: int, bits: int, interval: int):
    """jdlossls.c's samples of the (rows, cols) differences ``d``, modulo
    2**16: a restart interval's first row (every ``interval`` rows, or the
    first) predicted from the left with ``2**(bits - 1)`` first, the first
    column from above, the rest by ``predictor`` (1-7)."""
    rows, cols = d.shape
    x = np.zeros((rows, cols), np.int64)
    for r in range(rows):
        t = d[r].copy()
        if r % (interval or rows) == 0:
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
