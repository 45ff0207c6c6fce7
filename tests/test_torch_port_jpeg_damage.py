"""Damaged JPEG and PNG files, read as OpenCV reads them, on the CPU.

- A seeded corpus of 704 damaged JPEG files (``tests/torch_jpeg_damage.py``):
  4 images, 11 kinds (baseline 4:2:0, 4:4:4 and gray from
  ``cv2.imencode``, a restart interval of 2 from cv2 and from the writer,
  progressive with and without restarts, sequential and progressive
  arithmetic coding, lossless gray and RGB), each damaged twice by each of
  8 edits (a byte replaced, 1-4 bits flipped, a cut mid-scan with and
  without an EOI appended, an RST removed, two RSTs swapped, extraneous
  bytes before an RST, a marker inserted into the scan data).  Each file's
  four reads (bytes as ``cv2.imdecode``, a file as ``cv2.imread``; colour,
  gray) through the library (``native.jpeg_decode``) and ``codec`` equal
  cv2's byte for byte, or raise ``codec.ImageReadError`` where it returns
  None; the plain version (``data/jpeg.decode_plain``) on a fixed subset
  of 44 files.
- Pinned: the baseline file whose byte 2009 is 0xCF (the damage sends its
  DC values far out of range, where libjpeg-turbo's SIMD inverse DCT
  wraps its 16-bit lanes and saturates, and jidctint.c's range-limit
  table would give other values), crafted blocks of extreme coefficients
  through that IDCT, and a progressive file that never codes one
  component.
- PNG as libpng 1.6 reads it for OpenCV: a CRC error in an ancillary
  chunk drops the chunk, in IEND it is ignored; an unknown critical
  chunk, a second IHDR, a chunk type that is not four letters, a file
  without its IEND and image data split by another chunk are refused.
"""

import struct
import sys
import zlib
from functools import lru_cache
from pathlib import Path

import cv2
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
import torch_jpeg_damage as damage  # noqa: E402
import torch_jpeg_writer as writer  # noqa: E402
from wesup_tpu_torch import native  # noqa: E402
from wesup_tpu_torch.data import codec  # noqa: E402
from wesup_tpu_torch.data import jpeg  # noqa: E402
from torch_threads import worker_threads  # noqa: E402,F401


def _encode(a, *flags):
    return cv2.imencode(".jpg", a[..., ::-1] if a.ndim == 3 else a,
                        list(flags))[1].tobytes()


# the kinds only cv2's encoder makes
CV2_KINDS = {
    "444": lambda img: _encode(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
    "restart2_cv2": lambda img: _encode(img, cv2.IMWRITE_JPEG_RST_INTERVAL, 2),
}
KINDS = ("baseline", "gray", "444", "restart2", "restart2_cv2",
         "progressive", "progressive_rst", "arith", "arith_progressive",
         "lossless_gray", "lossless_rgb")


@lru_cache(maxsize=1)
def _corpus():
    """{kind: [(name, bytes)]} of seed 17's damaged files."""
    out = {k: [] for k in KINDS}
    for name, data in damage.corpus(_encode, 17, more=CV2_KINDS):
        kind = next(k for k in sorted(KINDS, key=len, reverse=True)
                    if f"_{k}_" in name)
        out[kind].append((name, data))
    return out


def _cv2_reads(data, path):
    """{(gray, file): cv2's read or None}, colour reads as RGB."""
    path.write_bytes(data)
    out = {}
    for gray in (False, True):
        flag = cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR
        for file in (False, True):
            got = (cv2.imread(str(path), flag) if file else
                   cv2.imdecode(np.frombuffer(data, np.uint8), flag))
            if got is not None and not gray:
                got = got[..., ::-1]
            out[gray, file] = got
    return out


def _assert_reads(data, path, plain=False):
    """Every read of ``data`` through the library and the codec (and the
    plain version with ``plain``) equals cv2's, or raises where cv2
    returns None (the codec: ImageReadError, naming the file and saying
    that cv2 refuses it too).  Returns the number of reads cv2 decodes."""
    decoded = 0
    for (gray, file), want in _cv2_reads(data, path).items():
        reads = [lambda: native.jpeg_decode(data, gray, file),
                 lambda: (codec.imread_mask if gray else codec.imread_rgb)(
                     path) if file else codec.decode(data, gray,
                                                     name=str(path))]
        if plain:
            reads.append(lambda: jpeg.decode_plain(data, gray, file))
        for i, read in enumerate(reads):
            if want is None:
                with pytest.raises(ValueError) as ex:
                    read()
                if i == 1:
                    assert isinstance(ex.value, codec.ImageReadError)
                    assert path.name in str(ex.value), str(ex.value)
                    assert "cv2" in str(ex.value), str(ex.value)
                continue
            np.testing.assert_array_equal(
                read(), want, err_msg=f"{path.name} gray={gray} file={file}")
        decoded += want is not None
    return decoded


def test_corpus_is_seeded_and_large():
    """704 files, every kind damaged by every edit, the same bytes on
    every call (the names carry seed, image, kind, edit and index)."""
    files = [f for k in KINDS for f in _corpus()[k]]
    assert len(files) == 704 and len({n for n, _ in files}) == 704
    again = damage.corpus(_encode, 17, n_images=1, more=CV2_KINDS)
    assert dict(again).items() <= dict(files).items()
    for kind in KINDS:
        assert len(_corpus()[kind]) == 64, kind


@pytest.mark.parametrize("kind", KINDS)
def test_damaged_jpeg_reads_as_cv2_reads_it(tmp_path, kind):
    decoded = refused = 0
    for name, data in _corpus()[kind]:
        n = _assert_reads(data, tmp_path / f"{name}.jpg")
        decoded += n
        refused += 4 - n
    # cv2 recovers from most edits, and refuses some reads of every kind
    # (a cut without its EOI, read from bytes)
    assert decoded and refused, (decoded, refused)


@pytest.mark.parametrize("part", range(4))
def test_plain_version_on_a_fixed_subset(tmp_path, part):
    """The plain version on every 16th file (44 files, 11 a case): its four
    reads equal cv2's (and so the library's) or raise where cv2 refuses."""
    files = [f for k in KINDS for f in _corpus()[k]][part * 16::64]
    assert len(files) == 11
    for name, data in files:
        _assert_reads(data, tmp_path / f"{name}.jpg", plain=True)


def _byte_2009():
    """The baseline 64x96 file of ``test_torch_port_jpeg_kinds._image``
    (seed 5) whose byte 2009 is 0xCF instead of 0x58."""
    rng = np.random.default_rng(5)
    y, x = np.mgrid[0:64, 0:96]
    base = np.stack([x * 255 / 95, y * 255 / 63, (x + y) * 127 / 158], -1)
    img = np.clip(base + rng.normal(0, 30, (64, 96, 3)), 0, 255).astype(
        np.uint8)
    data = bytearray(_encode(img))
    assert len(data) == 5740 and data[2009] == 0x58
    data[2009] = 0xCF
    return bytes(data)


def test_byte_2009_decodes_to_cv2s_pixels(tmp_path):
    """DC values far out of range: every read equals cv2's (with
    jidctint.c's range-limit table the library and the plain version gave
    255 where cv2 gives 0, in 733 of 6144 pixels from (16, 16) on)."""
    data = _byte_2009()
    assert _assert_reads(data, tmp_path / "byte2009.jpg", plain=True) == 4
    got = native.jpeg_decode(data, True)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
    assert (want[16:24, 16:24] == 0).all()
    np.testing.assert_array_equal(got, want)


def _crafted(blocks, q):
    """A 64x64 gray file of the (8, 8, 64) zigzag ``blocks``, quantised by
    ``q`` (natural order), with optimal Huffman tables."""
    frame = writer.parse(_encode(np.full((64, 64), 128, np.uint8)))
    frame.dqt = [bytes([0]) + bytes(q.reshape(-1)[writer.NATURAL].astype(
        np.uint8).tolist())]
    frame.comps[0]["blocks"] = blocks
    return writer.sequential(frame)


@pytest.mark.parametrize("shape", ["dc_only", "row0", "full", "sparse"])
def test_extreme_coefficients_take_the_simd_idct(tmp_path, shape):
    """Blocks of coefficients far beyond what an encoder makes, through
    each branch of the SIMD inverse DCT (the DC shortcut of a block whose
    rows 1-7 are zero; the 16-bit wraps of the dequantised values and of
    the even and odd sums; the saturations), at quanta 1 and up to 255:
    every read equals cv2's."""
    rng = np.random.default_rng(["dc_only", "row0", "full",
                                 "sparse"].index(shape))
    for q in (np.ones((8, 8), np.int64), rng.integers(1, 256, (8, 8))):
        b = np.zeros((8, 8, 64), np.int64)
        if shape == "dc_only":
            b[..., 0] = rng.integers(-16383, 16384, (8, 8))
        elif shape == "row0":
            b[..., [0, 1, 5, 6, 14, 15, 27, 28]] = rng.integers(
                -16383, 16384, (8, 8, 8))
        elif shape == "full":
            b = rng.integers(-32767, 32768, (8, 8, 64))
            b[rng.random(b.shape) < 0.5] = 0
            b[..., 0] = np.clip(b[..., 0], -16383, 16383)
        else:
            k = rng.integers(1, 64, (8, 8))
            np.put_along_axis(b, k[..., None],
                              rng.integers(-32767, 32768, (8, 8, 1)), -1)
        assert _assert_reads(_crafted(b, q), tmp_path / f"{shape}.jpg",
                             plain=True) == 4


def test_component_no_scan_reached_is_flat(tmp_path):
    """A progressive file whose script never codes Cr: cv2 decodes it, the
    missing component dequantised by zero (a flat 128), and so does the
    port."""
    img = damage.image((37, 53), 5)
    script = [((0, 1), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((1,), 1, 63, 0, 1),
              ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), ((0, 1), 0, 0, 1, 0),
              ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
    data = writer.progressive(writer.parse(_encode(img)), script)
    assert _assert_reads(data, tmp_path / "no_cr.jpg", plain=True) == 4


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _chunk(kind, body, crc=None):
    crc = zlib.crc32(kind + body) if crc is None else crc
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def _png_parts():
    img = damage.image((20, 30), 3)
    data = cv2.imencode(".png", img)[1].tobytes()
    parts, p = [], 8
    while p < len(data):
        n, kind = struct.unpack(">I4s", data[p:p + 8])
        parts.append((kind, data[p + 8:p + 8 + n]))
        p += 12 + n
    ihdr, = (b for k, b in parts if k == b"IHDR")
    idat = zlib.decompress(b"".join(b for k, b in parts if k == b"IDAT"))
    return ihdr, zlib.compress(idat)


def _png(*chunks):
    ihdr, idat = _png_parts()
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
    for c in chunks:
        out += {"IDAT": lambda: _chunk(b"IDAT", idat),
                "IDAT1": lambda: _chunk(b"IDAT", idat[:len(idat) // 2]),
                "IDAT2": lambda: _chunk(b"IDAT", idat[len(idat) // 2:]),
                "IEND": lambda: _chunk(b"IEND", b"")}.get(c, lambda: c)()
    return out


TEXT = _chunk(b"tEXt", b"Comment\0damaged", crc=0)
PNG_CASES = {
    # (chunks after IHDR, whether cv2 decodes it)
    "text_bad_crc_before_idat": ((TEXT, "IDAT", "IEND"), True),
    "text_bad_crc_after_idat": (("IDAT", TEXT, "IEND"), True),
    "gama_bad_crc": ((_chunk(b"gAMA", struct.pack(">I", 45455), crc=1),
                      "IDAT", "IEND"), True),
    "unknown_ancillary_bad_crc": ((_chunk(b"abCD", b"xyz", crc=0), "IDAT",
                                   "IEND"), True),
    "iend_bad_crc": (("IDAT", _chunk(b"IEND", b"", crc=7)), True),
    "data_after_iend": (("IDAT", "IEND", b"junk"), True),
    "unknown_critical": ((_chunk(b"ABCD", b"xyz"), "IDAT", "IEND"), False),
    "unknown_critical_after_idat": (("IDAT", _chunk(b"ABCD", b"xyz"),
                                     "IEND"), False),
    "no_iend": (("IDAT",), False),
    "iend_without_crc": (("IDAT", b"\0\0\0\0IEND"), False),
    "second_ihdr": ((_chunk(b"IHDR", _png_parts()[0]), "IDAT", "IEND"),
                    False),
    "bad_chunk_type": ((_chunk(b"ab1D", b"xyz"), "IDAT", "IEND"), False),
    "idat_split_by_text": (("IDAT1", _chunk(b"tEXt", b"a\0b"), "IDAT2",
                            "IEND"), False),
    "idat_bad_crc": ((_chunk(b"IDAT", _png_parts()[1], crc=0), "IEND"),
                     False),
}


@pytest.mark.parametrize("case", list(PNG_CASES))
def test_damaged_png_reads_as_cv2_reads_it(tmp_path, case):
    chunks, decodes = PNG_CASES[case]
    data = _png(*chunks)
    path = tmp_path / f"{case}.png"
    path.write_bytes(data)
    for gray, flag in ((False, cv2.IMREAD_COLOR),
                       (True, cv2.IMREAD_GRAYSCALE)):
        want = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        assert (want is not None) == decodes, case
        read = codec.imread_mask if gray else codec.imread_rgb
        if want is None:
            with pytest.raises(codec.ImageReadError, match=f"{case}.png"):
                read(path)
            continue
        np.testing.assert_array_equal(
            read(path), want if gray else want[..., ::-1])
        np.testing.assert_array_equal(
            codec.decode(data, gray), want if gray else want[..., ::-1])
