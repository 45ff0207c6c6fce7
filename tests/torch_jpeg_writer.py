"""A JPEG writer for the port's tests and ``chip_smoke.py``: numpy only
(no cv2, no PIL), so that the card's machine can run it.

It parses a baseline or extended-sequential Huffman file (such as
``data/jpeg.encode_plain``'s) down to its quantised coefficients, and
writes those coefficients back, losslessly, in the codings that
libjpeg-turbo reads beyond baseline:

- :func:`progressive`: progressive Huffman (SOF2) with the scan script of
  ``jcparam.c``'s ``jpeg_simple_progression``, or another script (such as
  :func:`early_stop`'s, which leaves coefficients short of full precision),
  optionally with a restart interval; each scan gets an optimal Huffman
  table (``jchuff.c``'s ``jpeg_gen_optimal_table``, T.81 K.2);
- :func:`arithmetic`: sequential (SOF9) or progressive (SOF10) arithmetic
  coding, with or without a DAC segment and a restart interval.  The
  encoder is T.81 Annex D's (Initenc, Code_0/Code_1, Renorm_e, Byte_out,
  Flush) under the statistical models of Annex F and G;
- :func:`without_dht`: a baseline file with its DHT segments dropped,
  where they held the Annex K tables (Motion-JPEG frames);
- :func:`four_component`: a baseline CMYK (Adobe transform 0) or YCCK
  (Adobe transform 2) file from an (H, W, 4) array;
- :func:`sequential`: the coefficients as sequential Huffman, 8 or 12
  bits, any number of components (a 2-component file);
- :func:`lossless`: a lossless (SOF3) file of integer planes, T.81 Annex
  H: 2-16 bits, predictors 1-7, a point transform, restart intervals,
  any number of components at any sampling, interleaved or a scan per
  component (its entropy coding vectorised, so a slide's mask takes
  seconds).

Transcoding keeps every quantised coefficient, so a decoder gives the
same pixels for a baseline file and any of its transcodes (a progressive
script that ends short of full precision aside: libjpeg smooths those).
"""

from __future__ import annotations

import struct

import numpy as np

# the natural (row-major) index of zigzag position k
NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
           12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
           35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
           58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]

# Annex K tables: counts of codes of length 1..16, then the symbols
STD_TABLES = {
    (0, 0): (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]),
             bytes(range(12))),
    (0, 1): (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]),
             bytes(range(12))),
    (1, 0): (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d]),
             bytes.fromhex(
                 "01020300041105122131410613516107227114328191a1082342b1c1"
                 "1552d1f02433627282090a161718191a25262728292a343536373839"
                 "3a434445464748494a535455565758595a636465666768696a737475"
                 "767778797a838485868788898a92939495969798999aa2a3a4a5a6a7"
                 "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8"
                 "d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    (1, 1): (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]),
             bytes.fromhex(
                 "000102031104052131061241510761711322328108144291a1b1c109"
                 "233352f0156272d10a162434e125f11718191a262728292a35363738"
                 "393a434445464748494a535455565758595a636465666768696a7374"
                 "75767778797a82838485868788898a92939495969798999aa2a3a4a5"
                 "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6"
                 "d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}


class Frame:
    """A sequential file's coefficients: ``comps`` hold ``id``, ``h``,
    ``v``, ``tq`` and ``blocks``, an (rows, cols, 64) int64 array in
    zigzag order over every block the file codes (whole MCUs for
    interleaved files); ``wb``/``hb`` are a component's real blocks.
    ``head`` is the APPn segments, kept verbatim; ``dqt`` the DQT
    segments' bodies."""

    def __init__(self, h, w, comps, head, dqt, precision=8):
        self.h, self.w, self.comps = h, w, comps
        self.head, self.dqt, self.precision = head, dqt, precision
        self.max_h = max(c["h"] for c in comps)
        self.max_v = max(c["v"] for c in comps)
        self.mcux = -(-w // (8 * self.max_h))
        self.mcuy = -(-h // (8 * self.max_v))
        for c in comps:
            c["wb"] = -(-w * c["h"] // (8 * self.max_h))
            c["hb"] = -(-h * c["v"] // (8 * self.max_v))
            if "blocks" not in c:
                rows, cols = self.grid(c)
                c["blocks"] = np.zeros((rows, cols, 64), np.int64)

    def grid(self, c):
        if len(self.comps) == 1:
            return c["hb"], c["wb"]
        return self.mcuy * c["v"], self.mcux * c["h"]

    def units(self, cis):
        """The MCUs of a scan of components ``cis``: lists of (component,
        row, column) in coding order."""
        if len(cis) == 1:
            c = self.comps[cis[0]]
            return [[(cis[0], r, q)] for r in range(c["hb"])
                    for q in range(c["wb"])]
        out = []
        for my in range(self.mcuy):
            for mx in range(self.mcux):
                u = []
                for ci in cis:
                    c = self.comps[ci]
                    u += [(ci, my * c["v"] + y, mx * c["h"] + x)
                          for y in range(c["v"]) for x in range(c["h"])]
                out.append(u)
        return out


# ---------------------------------------------------------------------------
# parsing a sequential Huffman file
# ---------------------------------------------------------------------------

def _lut(bits, vals):
    """(length, symbol) lists over every 16-bit window."""
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


def _entropy(data: bytes, pos: int):
    """The restart intervals' bytes (stuffing removed) from ``pos`` and
    the position of the marker that ends the scan."""
    segs, cur = [], bytearray()
    while True:
        j = data.index(b"\xff", pos)
        cur += data[pos:j]
        nxt = data[j + 1]
        if nxt == 0:
            cur.append(0xFF)
            pos = j + 2
        elif 0xD0 <= nxt <= 0xD7:
            segs.append(bytes(cur))
            cur = bytearray()
            pos = j + 2
        elif nxt == 0xFF:
            pos = j + 1
        else:
            segs.append(bytes(cur))
            return segs, j


def parse(data: bytes) -> Frame:
    """The quantised coefficients of a sequential Huffman JPEG."""
    data = bytes(data)
    head, dqt, tables = [], [], {}
    frame, ri, pos = None, 0, 2
    while True:
        while data[pos] != 0xFF:
            pos += 1
        while data[pos] == 0xFF:
            pos += 1
        m = data[pos]
        pos += 1
        if m == 0xD9:
            return frame
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        body = data[pos + 2:pos + length]
        pos += length
        if 0xE0 <= m <= 0xEF:
            head.append(bytes([0xFF, m]) + struct.pack(">H", length) + body)
        elif m == 0xDB:
            dqt.append(body)
        elif m in (0xC0, 0xC1):
            prec, h, w, nc = struct.unpack(">BHHB", body[:6])
            comps = [dict(id=body[6 + 3 * i], h=body[7 + 3 * i] >> 4,
                          v=body[7 + 3 * i] & 15, tq=body[8 + 3 * i])
                     for i in range(nc)]
            frame = Frame(h, w, comps, head, dqt, prec)
        elif 0xC2 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            raise ValueError("parse reads sequential Huffman files only")
        elif m == 0xC4:
            p = 0
            while p < len(body):
                bits = body[p + 1:p + 17]
                vals = body[p + 17:p + 17 + sum(bits)]
                tables[body[p] >> 4, body[p] & 15] = _lut(bits, vals)
                p += 17 + sum(bits)
        elif m == 0xDD:
            ri = struct.unpack(">H", body[:2])[0]
        elif m == 0xDA:
            ns = body[0]
            ids = [c["id"] for c in frame.comps]
            sc = [(ids.index(body[1 + 2 * i]), body[2 + 2 * i] >> 4,
                   body[2 + 2 * i] & 15) for i in range(ns)]
            for key in STD_TABLES:
                if key not in tables:
                    tables[key] = _lut(*STD_TABLES[key])
            segs, pos = _entropy(data, pos)
            _read_scan(frame, sc, segs, ri, tables)


def _read_scan(frame, sc, segs, ri, tables):
    units = frame.units([ci for ci, _, _ in sc])
    per = ri or len(units)
    lists = {ci: frame.comps[ci]["blocks"] for ci, _, _ in sc}
    tabs = {ci: (tables[0, td], tables[1, ta]) for ci, td, ta in sc}
    for s, start in enumerate(range(0, len(units), per)):
        seg = segs[s]
        bits = np.unpackbits(np.frombuffer(seg + b"\0\0\0\0", np.uint8))
        n = len(seg) * 8
        win = np.zeros(n + 16, np.int64)
        for k in range(16):
            win += bits[k:k + n + 16].astype(np.int64) << (15 - k)
        win = win.tolist()
        pos = 0
        pred = dict.fromkeys(lists, 0)
        for unit in units[start:start + per]:
            for ci, r, q in unit:
                (dl, ds), (al, asym) = tabs[ci]
                blk = [0] * 64
                v = win[pos]
                size = ds[v]
                pos += dl[v]
                if size:
                    x = win[pos] >> (16 - size)
                    pred[ci] += x if x >> (size - 1) else x - (1 << size) + 1
                    pos += size
                blk[0] = pred[ci]
                k = 1
                while k < 64:
                    v = win[pos]
                    rs = asym[v]
                    pos += al[v]
                    size = rs & 15
                    if size:
                        k += rs >> 4
                        x = win[pos] >> (16 - size)
                        blk[k] = x if x >> (size - 1) else x - (1 << size) + 1
                        pos += size
                        k += 1
                    elif rs == 0xF0:
                        k += 16
                    else:
                        break
                lists[ci][r, q] = blk


# ---------------------------------------------------------------------------
# Huffman coding
# ---------------------------------------------------------------------------

def optimal_table(freq) -> tuple:
    """(bits, vals) of jchuff.c's jpeg_gen_optimal_table (T.81 K.2) for
    symbol counts ``freq`` (256): lengths of 16 or fewer, no all-ones
    code."""
    freq = list(freq) + [1]             # the reserved code point
    codesize = [0] * 257
    others = [-1] * 257
    while True:
        c1 = c2 = -1
        v = v2 = None
        for i in range(257):
            f = freq[i]
            if f and (v is None or f <= v):
                v2, c2 = v, c1
                v, c1 = f, i
            elif f and (v2 is None or f <= v2):
                v2, c2 = f, i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for i in range(257):
        if codesize[i]:
            bits[codesize[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1                        # the reserved code point
    vals = [j for n in range(1, 33) for j in range(256) if codesize[j] == n]
    return bytes(bits[1:17]), bytes(vals)


def _codes(bits, vals):
    out, code, k = {}, 0, 0
    for n, count in enumerate(bits, start=1):
        for _ in range(count):
            out[vals[k]] = (code, n)
            code += 1
            k += 1
        code <<= 1
    return out


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value, n):
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def pad(self):
        if self.n:
            self.put(0x7F, 8 - self.n)


# a token is a DC symbol (int), an AC symbol (AC + int), extra bits
# ((value, n)) or a restart marker (str, its number)
AC = 256


def _huffman_scan(tokens):
    """(DHT segment body, entropy bytes) of a token list, with optimal
    tables in slot 0 of the classes it uses."""
    freq = [0] * 512
    for t in tokens:
        if type(t) is int:
            freq[t] += 1
    body, codes = b"", {}
    for cls in (0, 1):
        f = freq[cls * AC:(cls + 1) * AC]
        if any(f):
            bits, vals = optimal_table(f)
            body += bytes([cls << 4]) + bits + vals
            codes.update({cls * AC + k: v
                          for k, v in _codes(bits, vals).items()})
    w = _BitWriter()
    for t in tokens:
        if type(t) is int:
            w.put(*codes[t])
        elif type(t) is tuple:
            if t[1]:
                w.put(*t)
        else:
            w.pad()
            w.out += bytes([0xFF, 0xD0 + int(t)])
    w.pad()
    return body, bytes(w.out)


def _value_bits(v):
    """(size, the size's low bits of v as T.81 F.1.2.1 codes them)."""
    n = abs(v).bit_length()
    return n, (v if v >= 0 else v - 1) & ((1 << n) - 1)


# scans as (components, Ss, Se, Ah, Al); jcparam.c jpeg_simple_progression
def simple_progression(ncomps: int) -> list:
    if ncomps == 3:
        return [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
    every = tuple(range(ncomps))

    def each(ss, se, ah, al):
        return [((c,), ss, se, ah, al) for c in every]

    return ([(every, 0, 0, 0, 1)] + each(1, 5, 0, 2) + each(6, 63, 0, 2)
            + each(1, 63, 2, 1) + [(every, 0, 0, 1, 0)] + each(1, 63, 1, 0))


def early_stop(ncomps: int) -> list:
    """The simple script cut after its first AC scans: coefficients 1-9
    stay one or two bits short, and libjpeg smooths the blocks."""
    return simple_progression(ncomps)[:5 if ncomps == 3 else 1 + 2 * ncomps]


def _progressive_tokens(frame, scan, restart):
    """The tokens of one progressive Huffman scan (T.81 G.1.2), as
    jcphuff.c orders them: EOB runs, and the correction bits of a
    refinement scan buffered behind them."""
    cis, ss, se, ah, al = scan
    units = frame.units(list(cis))
    lists = {ci: frame.comps[ci]["blocks"].tolist() for ci in cis}
    tokens = []
    last = dict.fromkeys(cis, 0)
    st = {"eobrun": 0, "be": []}

    def flush_eob():
        e = st["eobrun"]
        if e:
            n = e.bit_length() - 1
            tokens.append(AC + (n << 4))
            tokens.append((e, n))
            st["eobrun"] = 0
        tokens.extend((b, 1) for b in st["be"])
        st["be"] = []

    for i, unit in enumerate(units):
        if restart and i and i % restart == 0:
            flush_eob()
            tokens.append(str((i // restart - 1) % 8))
            last = dict.fromkeys(cis, 0)
        for ci, r, q in unit:
            blk = lists[ci][r][q]
            if ss == 0:
                if ah == 0:
                    v = blk[0] >> al
                    size, bits = _value_bits(v - last[ci])
                    last[ci] = v
                    tokens += [size, (bits, size)]
                else:
                    tokens.append(((blk[0] >> al) & 1, 1))
                continue
            mags = [abs(blk[k]) >> al for k in range(ss, se + 1)]
            if ah == 0:
                run = 0
                for j, m in enumerate(mags):
                    if not m:
                        run += 1
                        continue
                    flush_eob()
                    while run > 15:
                        tokens.append(AC + 0xF0)
                        run -= 16
                    size, bits = _value_bits(m if blk[ss + j] > 0 else -m)
                    tokens += [AC + ((run << 4) | size), (bits, size)]
                    run = 0
                if run:
                    st["eobrun"] += 1
                    if st["eobrun"] == 0x7FFF:
                        flush_eob()
                continue
            # refinement: a newly nonzero coefficient is a symbol and its
            # sign; one already nonzero gets a correction bit, carried
            # after the next symbol (or the EOB run that covers it)
            eob = max([j for j, m in enumerate(mags) if m == 1], default=-1)
            run, br = 0, []
            for j, m in enumerate(mags):
                if m == 0:
                    run += 1
                    continue
                while run > 15 and j <= eob:
                    flush_eob()
                    tokens.append(AC + 0xF0)
                    run -= 16
                    tokens.extend((b, 1) for b in br)
                    br = []
                if m > 1:
                    br.append(m & 1)
                    continue
                flush_eob()
                tokens += [AC + ((run << 4) | 1), (int(blk[ss + j] > 0), 1)]
                tokens.extend((b, 1) for b in br)
                br, run = [], 0
            if run or br:
                st["eobrun"] += 1
                st["be"] += br
                if st["eobrun"] == 0x7FFF or len(st["be"]) > 937:
                    flush_eob()
    flush_eob()
    return tokens


def _sequential_tokens(frame, cis, restart):
    units = frame.units(list(cis))
    lists = {ci: frame.comps[ci]["blocks"].tolist() for ci in cis}
    tokens = []
    last = dict.fromkeys(cis, 0)
    for i, unit in enumerate(units):
        if restart and i and i % restart == 0:
            tokens.append(str((i // restart - 1) % 8))
            last = dict.fromkeys(cis, 0)
        for ci, r, q in unit:
            blk = lists[ci][r][q]
            size, bits = _value_bits(blk[0] - last[ci])
            last[ci] = blk[0]
            tokens += [size, (bits, size)]
            run = 0
            for k in range(1, 64):
                v = blk[k]
                if not v:
                    run += 1
                    continue
                while run > 15:
                    tokens.append(AC + 0xF0)
                    run -= 16
                size, bits = _value_bits(v)
                tokens += [AC + ((run << 4) | size), (bits, size)]
                run = 0
            if run:
                tokens.append(AC)
    return tokens


def _sos(frame, cis, ss, se, ah, al) -> bytes:
    """An SOS: every component on DC and AC table 0."""
    body = bytes([len(cis)])
    for ci in cis:
        body += bytes([frame.comps[ci]["id"], 0x00])
    body += bytes([ss, se, (ah << 4) | al])
    return b"\xff\xda" + struct.pack(">H", len(body) + 2) + body


def _head(frame, sof, extra=b"", restart=0) -> bytes:
    out = bytearray(b"\xff\xd8")
    for seg in frame.head:
        out += seg
    for body in frame.dqt:
        out += b"\xff\xdb" + struct.pack(">H", len(body) + 2) + body
    body = struct.pack(">BHHB", frame.precision, frame.h, frame.w,
                       len(frame.comps))
    for c in frame.comps:
        body += bytes([c["id"], (c["h"] << 4) | c["v"], c["tq"]])
    out += bytes([0xFF, sof]) + struct.pack(">H", len(body) + 2) + body
    out += extra
    if restart:
        out += b"\xff\xdd\x00\x04" + struct.pack(">H", restart)
    return bytes(out)


def _dht(body) -> bytes:
    return b"\xff\xc4" + struct.pack(">H", len(body) + 2) + body


def progressive(frame: Frame, script=None, restart: int = 0) -> bytes:
    """SOF2 with ``script`` (default: jpeg_simple_progression's), a DHT
    before each scan that needs one."""
    script = script or simple_progression(len(frame.comps))
    out = bytearray(_head(frame, 0xC2, restart=restart))
    for scan in script:
        body, ent = _huffman_scan(_progressive_tokens(frame, scan, restart))
        if body:
            out += _dht(body)
        out += _sos(frame, *scan) + ent
    return bytes(out + b"\xff\xd9")


def sequential(frame: Frame, restart: int = 0) -> bytes:
    """One interleaved sequential Huffman scan with optimal tables (SOF0
    at 8 bits, SOF1 at 12)."""
    cis = tuple(range(len(frame.comps)))
    body, ent = _huffman_scan(_sequential_tokens(frame, cis, restart))
    sof = 0xC0 if frame.precision == 8 else 0xC1
    return (_head(frame, sof, restart=restart) + _dht(body)
            + _sos(frame, cis, 0, 63, 0, 0) + ent + b"\xff\xd9")


def without_dht(data: bytes) -> bytes:
    """``data`` with its DHT segments dropped; they must hold the Annex K
    tables in slots 0 and 1, which a decoder loads where none is
    given."""
    out, pos = bytearray(data[:2]), 2
    while True:
        m = data[pos + 1]
        if m == 0xDA:
            return bytes(out + data[pos:])
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos:pos + 2 + length]
        if m == 0xC4:
            p, body = 0, seg[4:]
            while p < len(body):
                bits = body[p + 1:p + 17]
                key = (body[p] >> 4, body[p] & 15)
                if STD_TABLES.get(key) != (bits, body[p + 17:p + 17
                                                      + sum(bits)]):
                    raise ValueError("not the Annex K tables")
                p += 17 + sum(bits)
        else:
            out += seg
        pos += 2 + length


# ---------------------------------------------------------------------------
# arithmetic coding (T.81 Annex D, F.1.4, G.1.3)
# ---------------------------------------------------------------------------

# Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS); index 113
# is a fixed bin of probability one half
QE_TABLE = [
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


class QMEncoder:
    """T.81 D.1's encoder.  A statistics bin is a list entry: its index
    in Table D.2, and its MPS in bit 7."""

    def __init__(self):
        self.out = bytearray(b"\0")     # B before BPST (Initenc)
        self.a, self.c, self.ct, self.st = 0x10000, 0, 11, 0

    def code(self, bins, i, bit):
        idx, mps = bins[i] & 0x7F, bins[i] >> 7
        qe, nlps, nmps, switch = QE_TABLE[idx]
        self.a -= qe
        if bit == mps:                          # Code_MPS (D.1.4)
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            bins[i] = nmps | (mps << 7)
        else:                                   # Code_LPS (D.1.4)
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            bins[i] = nlps | ((mps ^ switch) << 7)
        while True:                             # Renorm_e (D.1.5)
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte_out()
                self.ct = 8
            if self.a >= 0x8000:
                return

    def _byte_out(self):                        # D.1.6
        t = self.c >> 19
        if t > 0xFF:
            self.out[-1] += 1
            if self.out[-1] == 0xFF:            # Stuff_0
                self.out.append(0)
            self.out += bytes(self.st)          # Output_stacked_zeros
            self.st = 0
            self.out.append(t & 0xFF)
        elif t == 0xFF:
            self.st += 1
        else:
            self.out += b"\xff\x00" * self.st   # Output_stacked_0xFFs
            self.st = 0
            self.out.append(t)
        self.c &= 0x7FFFF

    def flush(self) -> bytes:                   # D.1.8
        t = (self.c + self.a - 1) & 0xFFFF0000  # Clear_final_bits
        self.c = t + 0x8000 if t < self.c else t
        self.c <<= self.ct
        self._byte_out()
        self.c <<= 8
        self._byte_out()
        out = self.out[1:]
        # Discard_final_zeros (a stuffed zero stays with its 0xFF)
        while out and out[-1] == 0 and not (len(out) > 1 and out[-2] == 0xFF):
            out.pop()
        return bytes(out)


def _code_magnitude(enc, bins, s, v, x2=None):
    """Figures F.8 and F.9: the magnitude category of v >= 1 and its
    bits, from bin ``s``; an AC value (``x2`` its X2 bin) codes its
    first two category decisions in bin ``s``, a DC value goes on at X1
    (bin 20)."""
    v -= 1
    if v == 0:
        enc.code(bins, s, 0)
        return
    enc.code(bins, s, 1)
    m = 1
    if x2 is None:
        s = 20
    elif v == 1:
        enc.code(bins, s, 0)
        return
    else:
        enc.code(bins, s, 1)
        m, s = 2, x2
    while v >= m << 1:
        enc.code(bins, s, 1)
        m <<= 1
        s += 1
    enc.code(bins, s, 0)
    s += 14
    m >>= 1
    while m:
        enc.code(bins, s, int(bool(v & m)))
        m >>= 1


def _code_dc(enc, bins, ctx, diff, lo, hi):
    """F.1.4.1 for one DC difference from context ``ctx``; returns the
    next context (F.1.4.4.1.2, bounds L = ``lo``, U = ``hi``)."""
    if diff == 0:
        enc.code(bins, ctx, 0)
        return 0
    enc.code(bins, ctx, 1)
    sign = int(diff < 0)
    enc.code(bins, ctx + 1, sign)
    _code_magnitude(enc, bins, ctx + 2 + sign, abs(diff))
    a = abs(diff)
    if a <= (1 << lo) >> 1:
        return 0
    return (12 if a > 1 << hi else 4) + 4 * sign


def _code_ac(enc, bins, fixed, vals, ss, se, kx):
    """Figure F.5 (G.1.3.2 for a first scan): ``vals`` the coefficients
    ss..se after the point transform."""
    eob = max([k for k in range(ss, se + 1) if vals[k]], default=ss - 1)
    k = ss
    while k <= eob:
        s = 3 * (k - 1)
        enc.code(bins, s, 0)
        while not vals[k]:
            enc.code(bins, s + 1, 0)
            s += 3
            k += 1
        enc.code(bins, s + 1, 1)
        enc.code(fixed, 0, int(vals[k] < 0))
        _code_magnitude(enc, bins, s + 2, abs(vals[k]),
                        189 if k <= kx else 217)
        k += 1
    if k <= se:
        enc.code(bins, 3 * (k - 1), 1)


def _code_ac_refine(enc, bins, fixed, blk, ss, se, al):
    """Figure G.10: the next bit of coefficients ss..se."""
    now = [abs(x) >> al for x in blk]
    before = [x >> 1 for x in now]
    eob = max([k for k in range(1, se + 1) if now[k]], default=0)
    eobx = max([k for k in range(1, eob + 1) if before[k]], default=0)
    k = ss
    while k <= eob:
        s = 3 * (k - 1)
        if k > eobx:
            enc.code(bins, s, 0)
        while True:
            if before[k]:
                enc.code(bins, s + 2, now[k] & 1)
                break
            if now[k]:
                enc.code(bins, s + 1, 1)
                enc.code(fixed, 0, int(blk[k] < 0))
                break
            enc.code(bins, s + 1, 0)
            s += 3
            k += 1
        k += 1
    if k <= se:
        enc.code(bins, 3 * (k - 1), 1)


def _arith_scan(frame, scan, restart, dac, progressive_mode):
    """The entropy bytes (restart markers included) of one arithmetic
    scan; every component on table 0."""
    cis, ss, se, ah, al = scan
    units = frame.units(list(cis))
    lists = {ci: frame.comps[ci]["blocks"].tolist() for ci in cis}
    lo, hi, kx = dac
    out = bytearray()
    enc = None
    for i, unit in enumerate(units):
        if i == 0 or (restart and i % restart == 0):
            if enc is not None:
                out += enc.flush()
                out += bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
            enc = QMEncoder()
            dc_bins, ac_bins, fixed = [0] * 64, [0] * 256, [113]
            last = dict.fromkeys(cis, 0)
            ctx = dict.fromkeys(cis, 0)
        for ci, r, q in unit:
            blk = lists[ci][r][q]
            if not progressive_mode or (ss == 0 and ah == 0):
                v = blk[0] >> al
                ctx[ci] = _code_dc(enc, dc_bins, ctx[ci], v - last[ci], lo,
                                   hi)
                last[ci] = v
                if not progressive_mode:
                    _code_ac(enc, ac_bins, fixed, blk, 1, 63, kx)
            elif ss == 0:
                enc.code(fixed, 0, (blk[0] >> al) & 1)
            elif ah == 0:
                vals = [0] * 64
                for k in range(ss, se + 1):
                    m = abs(blk[k]) >> al
                    vals[k] = m if blk[k] > 0 else -m
                _code_ac(enc, ac_bins, fixed, vals, ss, se, kx)
            else:
                _code_ac_refine(enc, ac_bins, fixed, blk, ss, se, al)
    return bytes(out + enc.flush())


def arithmetic(frame: Frame, progressive_mode: bool = False,
               restart: int = 0, dac=None, script=None) -> bytes:
    """SOF9 (sequential) or SOF10 (progressive, ``script`` or the simple
    one) with arithmetic coding; ``dac`` = (L, U, Kx) writes a DAC
    segment for table 0, else the defaults (0, 1, 5) hold."""
    extra = b""
    if dac is not None:
        lo, hi, kx = dac
        extra = b"\xff\xcc\x00\x06" + bytes([0x00, (hi << 4) | lo, 0x10, kx])
    cond = dac or (0, 1, 5)
    sof = 0xCA if progressive_mode else 0xC9
    out = bytearray(_head(frame, sof, extra, restart))
    cis = tuple(range(len(frame.comps)))
    scans = (script or simple_progression(len(cis))) if progressive_mode \
        else [(cis, 0, 63, 0, 0)]
    for scan in scans:
        out += _sos(frame, *scan)
        out += _arith_scan(frame, scan, restart, cond, progressive_mode)
    return bytes(out + b"\xff\xd9")


# ---------------------------------------------------------------------------
# files from pixels: four components, 12 bits, lossless
# ---------------------------------------------------------------------------

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])


def _fdct_pass(v, shift_even, shift_odd, pre):
    """One pass of jfdctint.c's ISLOW forward DCT along the last axis,
    integers only (13-bit constants)."""
    def d(x, n):
        return (x + (1 << (n - 1))) >> n

    t0, t7 = v[..., 0] + v[..., 7], v[..., 0] - v[..., 7]
    t1, t6 = v[..., 1] + v[..., 6], v[..., 1] - v[..., 6]
    t2, t5 = v[..., 2] + v[..., 5], v[..., 2] - v[..., 5]
    t3, t4 = v[..., 3] + v[..., 4], v[..., 3] - v[..., 4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    if pre:
        o0, o4 = (t10 + t11) << 2, (t10 - t11) << 2
    else:
        o0, o4 = d(t10 + t11, shift_even), d(t10 - t11, shift_even)
    z1 = (t12 + t13) * 4433
    o2 = d(z1 + t13 * 6270, shift_odd)
    o6 = d(z1 - t12 * 15137, shift_odd)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * 9633
    t4, t5, t6, t7 = t4 * 2446, t5 * 16819, t6 * 25172, t7 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    return np.stack([o0, d(t7 + z1 + z4, shift_odd), o2,
                     d(t6 + z2 + z3, shift_odd), o4,
                     d(t5 + z2 + z4, shift_odd), o6,
                     d(t4 + z1 + z3, shift_odd)], -1)


def _plane_coefficients(plane, rows, cols, q, shift):
    """(rows, cols, 64) zigzag coefficients of the integer ``plane``
    edge-padded to the block grid: the ISLOW forward DCT and a rounding
    division by 8 q (integers only, so the file is the same on every
    machine)."""
    h, w = plane.shape
    p = np.pad(plane.astype(np.int64) - shift,
               ((0, rows * 8 - h), (0, cols * 8 - w)), mode="edge")
    b = p.reshape(rows, 8, cols, 8).swapaxes(1, 2)
    r = _fdct_pass(b, None, 11, True)
    c = _fdct_pass(r.swapaxes(-1, -2), 2, 15, False).swapaxes(-1, -2)
    c = c.reshape(rows, cols, 64)[..., NATURAL]
    d = 8 * q[NATURAL]
    mag = (np.abs(c) + d // 2) // d
    return np.where(c < 0, -mag, mag)


def from_planes(planes, sampling, ids, qscale=1, precision=8,
                head=()) -> Frame:
    """A Frame coding full-resolution integer ``planes`` (each (H, W)),
    each downsampled (a box average, rounded) to its ``sampling`` (h, v)
    factors."""
    h, w = planes[0].shape
    q = np.clip(_LUMA_Q * qscale, 1, 255 if precision == 8 else 65535)
    comps = [dict(id=i, h=sh, v=sv, tq=0) for i, (sh, sv) in zip(ids,
                                                                 sampling)]
    dqt = bytes([0x00 if precision == 8 else 0x10])
    dqt += (bytes(q[NATURAL].astype(np.uint8)) if precision == 8
            else q[NATURAL].astype(">u2").tobytes())
    frame = Frame(h, w, comps, list(head), [dqt], precision)
    for c, plane in zip(comps, planes):
        rh, rv = frame.max_h // c["h"], frame.max_v // c["v"]
        p = np.pad(np.asarray(plane, np.int64),
                   ((0, -h % rv), (0, -w % rh)), mode="edge")
        ds = (p.reshape(p.shape[0] // rv, rv, p.shape[1] // rh, rh).sum(
            (1, 3)) + rh * rv // 2) // (rh * rv)
        rows, cols = frame.grid(c)
        c["blocks"] = _plane_coefficients(ds, rows, cols, q,
                                          1 << (precision - 1))
    return frame


ADOBE = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00"


def four_component(cmyk: np.ndarray, transform: int = 0,
                   sampling=((1, 1),) * 4) -> bytes:
    """A baseline 4-component file of the (H, W, 4) uint8 ``cmyk`` as
    stored samples: CMYK (Adobe transform 0) or YCCK (transform 2: Y, Cb,
    Cr of 255 minus C, M, Y, by jccolor.c's fixed-point weights, then
    K)."""
    x = np.asarray(cmyk, np.int64)
    planes = [x[..., i] for i in range(4)]
    if transform == 2:
        r, g, b = 255 - planes[0], 255 - planes[1], 255 - planes[2]
        half, off = 1 << 15, 128 << 16

        def fix(v):
            return int(v * 65536 + 0.5)

        planes[:3] = [
            (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16,
            (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off
             + half - 1) >> 16,
            (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off
             + half - 1) >> 16]
    head = [ADOBE[:15] + bytes([transform])]
    return sequential(from_planes(planes, sampling, (1, 2, 3, 4),
                                  head=head))


def lossless(planes, predictor: int = 1, pt: int = 0, restart_rows: int = 0,
             precision: int = 8, sampling=None, ids=None,
             interleave: bool = True) -> bytes:
    """A lossless (SOF3) file, T.81 Annex H: ``planes`` (one (H, W)
    array, or a list of full-size ones) of samples below ``2**precision``,
    each component's taken at its ``sampling`` (h, v) factors (every
    ``max/h``-th column and ``max/v``-th row); predictor 1-7, point
    transform ``pt`` (the samples' low bits dropped), a restart interval
    of ``restart_rows`` MCU rows, one interleaved scan (or one scan per
    component) and an optimal Huffman table per scan (T.81 H.1).  MCUs
    that overhang a component repeat its last column and row."""
    if isinstance(planes, np.ndarray) and planes.ndim == 2:
        planes = [planes]
    nc = len(planes)
    h, w = planes[0].shape
    sampling = list(sampling or [(1, 1)] * nc)
    ids = list(ids or range(1, nc + 1))
    max_h = max(sh for sh, _ in sampling)
    max_v = max(sv for _, sv in sampling)
    single = nc == 1 or not interleave
    comps = []
    for plane, (sh, sv) in zip(planes, sampling):
        cw, ch = -(-w * sh // max_h), -(-h * sv // max_v)
        x = np.asarray(plane, np.int64)[::max_v // sv, ::max_h // sh]
        x = x[:ch, :cw] >> pt
        if not single:
            mcux, mcuy = -(-w // max_h), -(-h // max_v)
            x = np.pad(x, ((0, mcuy * sv - ch), (0, mcux * sh - cw)),
                       mode="edge")
        comps.append(x)
    body = struct.pack(">BHHB", precision, h, w, nc)
    for cid, (sh, sv) in zip(ids, sampling):
        body += bytes([cid, (sh << 4) | sv, 0])
    out = bytearray(b"\xff\xd8\xff\xc3" + struct.pack(">H", len(body) + 2)
                    + body)
    if restart_rows:
        per_row = -(-w // max_h) if not single else None
        out += b"\xff\xdd\x00\x04"
        out += struct.pack(">H", restart_rows * (per_row or comps[0].shape[1]))
    scans = [list(range(nc))] if not single else [[i] for i in range(nc)]
    for cis in scans:
        # each scan's differences in coding order: an MCU's samples, the
        # component's h x v for each component in turn
        units = []
        for ci in cis:
            d = _lossless_diffs(comps[ci], predictor, precision - pt,
                                restart_rows * (1 if single else
                                                sampling[ci][1]))
            sh, sv = (1, 1) if single else sampling[ci]
            rows, cols = d.shape[0] // sv, d.shape[1] // sh
            units.append(d.reshape(rows, sv, cols, sh).transpose(
                0, 2, 1, 3).reshape(rows * cols, sv * sh))
        per = restart_rows * (cols if single else -(-w // max_h))
        dht, ent = _lossless_scan(np.concatenate(units, 1), per)
        sos = bytes([len(cis)]) + b"".join(bytes([ids[ci], 0x00])
                                           for ci in cis)
        sos += bytes([predictor, 0, pt])
        out += _dht(dht) + b"\xff\xda" + struct.pack(">H", len(sos) + 2)
        out += sos + ent
    return bytes(out + b"\xff\xd9")


def _lossless_scan(units: np.ndarray, per: int):
    """(DHT segment body, entropy bytes) of a lossless scan: ``units``
    (MCUs, samples an MCU) of differences coded as DC sizes (16 for 32768,
    with no extra bits) with one optimal table, restart markers every
    ``per`` MCUs.  Vectorised: the bits of each code and value are laid
    out with numpy, then packed, padded with 1 bits and stuffed."""
    d = units.astype(np.int64)
    size = np.where(d == 32768, 16, np.ceil(np.log2(np.abs(d) + 1)))
    size = size.astype(np.int64)
    extra = np.where(size == 16, 0, np.where(d >= 0, d, d - 1)
                     & ((1 << size) - 1))
    bits, vals = optimal_table(np.bincount(size.ravel(), minlength=256))
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    for sym, (c, n) in _codes(bits, vals).items():
        code[sym], length[sym] = c, n
    dht = bytes([0]) + bits + vals
    per = per or len(d)
    out = bytearray()
    for k, start in enumerate(range(0, len(d), per)):
        if k:
            out += bytes([0xFF, 0xD0 + (k - 1) % 8])
        s = size[start:start + per].ravel()
        e = extra[start:start + per].ravel()
        values = np.stack([code[s], e], 1).ravel()
        lens = np.stack([length[s], np.where(s == 16, 0, s)], 1).ravel()
        out += _pack_bits(values, lens)
    return dht, bytes(out)


def _pack_bits(values: np.ndarray, lens: np.ndarray) -> bytes:
    """The codes ``values`` of ``lens`` bits each, most significant bit
    first, padded with 1 bits to a byte and with 0xFF bytes stuffed."""
    total = int(lens.sum())
    pad = -total % 8
    out = np.ones(total + pad, np.uint8)
    start = np.cumsum(lens) - lens
    for k in range(int(lens.max(initial=0))):
        sel = lens > k
        out[start[sel] + k] = (values[sel] >> (lens[sel] - 1 - k)) & 1
    return np.packbits(out).tobytes().replace(b"\xff", b"\xff\x00")


def _lossless_diffs(x, predictor, bits, restart_rows):
    """T.81 H.1.2's differences of the (rows, cols) samples ``x`` (already
    point-transformed, ``bits`` of precision), modulo 2**16 as
    -32767..32768: the first row (and each restart interval's) predicted
    from the left with 2**(bits-1) first, the first column from above,
    the rest by ``predictor``."""
    rows, cols = x.shape
    ra = np.zeros_like(x)
    rb = np.zeros_like(x)
    rc = np.zeros_like(x)
    ra[:, 1:] = x[:, :-1]
    rb[1:] = x[:-1]
    rc[1:, 1:] = x[:-1, :-1]
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
            5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
            7: (ra + rb) >> 1}[predictor].copy()
    pred[:, 0] = rb[:, 0]
    first = np.zeros(rows, bool)
    first[::restart_rows or rows] = True
    pred[first, 1:] = x[first, :-1]
    pred[first, 0] = 1 << (bits - 1)
    d = (x - pred) % 65536
    return np.where(d > 32768, d - 65536, d)
