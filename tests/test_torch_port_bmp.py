"""The port's BMP decode (``data/codec.py``) against OpenCV's own BMP
decoder, on the CPU.

Every kind that ``cv2.imread`` reads, written by ``tests/torch_bmp_writer.py``
(numpy only): 1-, 4- and 8-bit palettes, full, short (the rest black) and
gray; RLE8 and RLE4 with encoded, absolute, end-of-line, delta and
end-of-bitmap codes; 16-bit 5-5-5 (``BI_RGB`` and ``BI_BITFIELDS``) and
5-6-5; 24 and 32 bits; 32-bit ``BI_BITFIELDS`` after a 40-byte header
(read as BGRA) and inside a 124-byte one (the masks applied); the OS/2
12-byte header; top-down and bottom-up rows.  The colour and gray reads
of the path (``imread_rgb``, ``imread_mask``) and of the bytes
(``decode``) equal ``cv2.imread`` and ``cv2.imdecode`` byte for byte, and
``image_size`` gives the shape.  The kinds cv2 refuses (16-bit masks
inside a large header or other than 5-6-5 and 5-5-5, 2 bits, a
compression the depth does not take, RLE runs past their row, RLE data
that ends early) are refused by the port, naming the file and saying
that cv2 refuses them too.  A last case decodes random RLE op streams
(any mix of codes, the corrupt ones too) as cv2 does.
"""

import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
import torch_bmp_writer as bmp  # noqa: E402
from wesup_tpu_torch.data import codec  # noqa: E402

H, W = 23, 37                  # odd: rows padded, RLE4 pairs split


def _rng(name):
    return np.random.default_rng(sum(map(ord, name)))


def _indices(rng, bits):
    """Palette indices with runs (for the RLE codes) and noise."""
    idx = rng.integers(0, 1 << bits, (H, W))
    runs = np.repeat(rng.integers(0, 1 << bits, (H, W // 4 + 1)), 4, 1)
    return np.where(rng.random((H, W)) < 0.6, runs[:, :W], idx)


def _palette(rng, n, gray=False):
    pal = rng.integers(0, 256, (n, 3))
    return np.repeat(pal[:, :1], 3, 1) if gray else pal


def _palette_file(name, bits, n=None, gray=False, top_down=False):
    rng = _rng(name)
    idx = _indices(rng, bits)
    pal = _palette(rng, n or 1 << bits, gray)
    return bmp.bmp(bmp.pack_rows(idx, bits, top_down), W, H, bits,
                   palette=pal, top_down=top_down)


def _rle_file(name, bits, skip=0.0, top_down=False, eob=True):
    rng = _rng(name)
    idx = _indices(rng, bits)
    mask = rng.random((H, W)) < skip
    data = bmp.rle(idx, bits, skip=mask, top_down=top_down, eob=eob)
    return bmp.bmp(data, W, H, bits, bmp.BI_RLE8 if bits == 8
                   else bmp.BI_RLE4, palette=_palette(rng, 1 << bits),
                   top_down=top_down)


def _pixels_file(name, bits, compression=bmp.BI_RGB, masks=None,
                 header=40, top_down=False):
    rng = _rng(name)
    if bits == 16:
        px = rng.integers(0, 1 << 16, (H, W))
    else:
        px = rng.integers(0, 256, (H, W, bits // 8))
    return bmp.bmp(bmp.pack_rows(px, bits, top_down), W, H, bits,
                   compression, masks=masks, header=header,
                   top_down=top_down)


def _os2_file(name, bits):
    rng = _rng(name)
    if bits <= 8:
        idx = _indices(rng, bits)
        return bmp.bmp(bmp.pack_rows(idx, bits), W, H, bits,
                       palette=_palette(rng, 1 << bits), header=12)
    px = rng.integers(0, 256, (H, W, bits // 8))
    return bmp.bmp(bmp.pack_rows(px, bits), W, H, bits, header=12)


READ = {
    "pal1": lambda n: _palette_file(n, 1),
    "pal1_top_down": lambda n: _palette_file(n, 1, top_down=True),
    "pal4": lambda n: _palette_file(n, 4),
    "pal4_short": lambda n: _palette_file(n, 4, n=5),
    "pal8_short_gray": lambda n: _palette_file(n, 8, n=100, gray=True),
    "pal8_top_down": lambda n: _palette_file(n, 8, top_down=True),
    "rle8": lambda n: _rle_file(n, 8),
    "rle8_delta": lambda n: _rle_file(n, 8, skip=0.08),
    "rle8_no_eob": lambda n: _rle_file(n, 8, eob=False),
    "rle8_top_down": lambda n: _rle_file(n, 8, skip=0.05, top_down=True),
    "rle4": lambda n: _rle_file(n, 4),
    "rle4_delta": lambda n: _rle_file(n, 4, skip=0.08),
    "555": lambda n: _pixels_file(n, 16),
    "555_bitfields": lambda n: _pixels_file(n, 16, bmp.BI_BITFIELDS,
                                            bmp.MASKS_555),
    "565_bitfields": lambda n: _pixels_file(n, 16, bmp.BI_BITFIELDS,
                                            bmp.MASKS_565, top_down=True),
    "24_v5_header": lambda n: _pixels_file(n, 24, header=124),
    "32": lambda n: _pixels_file(n, 32),
    "32_bitfields": lambda n: _pixels_file(
        n, 32, bmp.BI_BITFIELDS, (0xFF0000, 0xFF00, 0xFF)),
    "32_bitfields_v5_masks": lambda n: _pixels_file(
        n, 32, bmp.BI_BITFIELDS, (0x3FF00000, 0xFFC00, 0x3FF), header=124),
    "32_bitfields_v4_bgra": lambda n: _pixels_file(
        n, 32, bmp.BI_BITFIELDS, (0xFF0000, 0xFF00, 0xFF), header=108,
        top_down=True),
    "os2_1": lambda n: _os2_file(n, 1),
    "os2_4": lambda n: _os2_file(n, 4),
    "os2_8": lambda n: _os2_file(n, 8),
    "os2_24": lambda n: _os2_file(n, 24),
}


def _cv2_reads(path):
    data = np.frombuffer(path.read_bytes(), np.uint8)
    return {(gray, file): (cv2.imread(str(path), flag) if file
                           else cv2.imdecode(data, flag))
            for gray, flag in ((False, cv2.IMREAD_COLOR),
                               (True, cv2.IMREAD_GRAYSCALE))
            for file in (False, True)}


def _port_read(path, gray, file):
    if file:
        return (codec.imread_mask if gray else codec.imread_rgb)(path)
    return codec.decode(path.read_bytes(), gray, name=str(path))


@pytest.mark.parametrize("kind", list(READ))
def test_bmp_kinds_read_like_cv2(tmp_path, kind):
    path = tmp_path / f"{kind}.bmp"
    path.write_bytes(READ[kind](kind))
    for (gray, file), want in _cv2_reads(path).items():
        assert want is not None, (kind, gray, file)
        if not gray:
            want = want[..., ::-1]
        np.testing.assert_array_equal(_port_read(path, gray, file), want,
                                      err_msg=f"{kind} gray={gray}")
    assert codec.image_size(path) == (H, W)


def _header_patch(data, at, raw):
    return data[:at] + raw + data[at + len(raw):]


REFUSED = {
    # masks read after the header, where a 108-byte one has none
    "565_bitfields_v4_header": lambda n: _pixels_file(
        n, 16, bmp.BI_BITFIELDS, bmp.MASKS_565, header=108),
    "16_other_masks": lambda n: _pixels_file(
        n, 16, bmp.BI_BITFIELDS, (0xF00, 0xF0, 0xF)),
    "2_bits": lambda n: _header_patch(_palette_file(n, 4), 28, b"\x02"),
    "rle8_in_a_4_bit_file": lambda n: _header_patch(_rle_file(n, 4), 30,
                                                    b"\x01"),
    "rle8_run_past_its_row": lambda n: bmp.bmp(
        bytes([W + 1, 3, 0, 1]), W, H, 8, bmp.BI_RLE8,
        palette=_palette(_rng(n), 256)),
    "rle4_ends_early": lambda n: _rle_file(n, 4)[:-40],
    "truncated_rows": lambda n: _pixels_file(n, 24)[:-5],
}


@pytest.mark.parametrize("kind", list(REFUSED))
def test_bmp_kinds_cv2_refuses_are_refused(tmp_path, kind):
    path = tmp_path / f"{kind}.bmp"
    path.write_bytes(REFUSED[kind](kind))
    for (gray, file), want in _cv2_reads(path).items():
        assert want is None, (kind, gray, file)
        with pytest.raises(codec.ImageReadError,
                           match=f"{kind}.bmp.*cv2 returns None"):
            _port_read(path, gray, file)


def _random_rle(rng, bits, w, h):
    """A stream of random RLE ops, corrupt ones included."""
    ops = []
    for _ in range(int(rng.integers(1, 25))):
        r = rng.random()
        if r < 0.4:                                     # encoded
            ops += [int(rng.integers(1, w + 2)), int(rng.integers(0, 256))]
        elif r < 0.6:                                   # absolute
            n = int(rng.integers(3, w + 3))
            size = (n + 1) & ~1 if bits == 8 else (((n + 1) >> 1) + 1) & ~1
            ops += [0, n] + rng.integers(0, 256, size).tolist()
        elif r < 0.8:
            ops += [0, 0]                               # end of line
        elif r < 0.9:                                   # delta
            ops += [0, 2, int(rng.integers(0, w + 2)),
                    int(rng.integers(0, 3))]
        else:
            ops += [0, 1]                               # end of bitmap
    return bytes(ops)


def test_random_rle_streams_decode_as_cv2_decodes():
    """300 random RLE8 and RLE4 streams on small images: the port's decode
    equals cv2's, or both refuse."""
    rng = np.random.default_rng(0)
    pal = rng.integers(0, 256, (256, 3))
    decoded = 0
    for _ in range(300):
        bits = int(rng.choice([4, 8]))
        w, h = int(rng.integers(1, 9)), int(rng.integers(1, 6))
        top_down = bool(rng.random() < 0.3)
        data = bmp.bmp(_random_rle(rng, bits, w, h), w, h, bits,
                       bmp.BI_RLE8 if bits == 8 else bmp.BI_RLE4,
                       palette=pal[:1 << bits], top_down=top_down)
        for gray, flag in ((False, cv2.IMREAD_COLOR),
                           (True, cv2.IMREAD_GRAYSCALE)):
            want = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
            if want is None:
                with pytest.raises(codec.ImageReadError):
                    codec.decode(data, gray)
                continue
            decoded += 1
            np.testing.assert_array_equal(
                codec.decode(data, gray), want if gray else want[..., ::-1])
    assert decoded > 50
