"""The port's JPEG library and its PNG decode against OpenCV, on the CPU.

- ``native.jpeg_decode`` (``csrc/jpeg.cpp``) and its plain version
  ``data/jpeg.decode_plain`` equal ``cv2.imdecode`` exactly, in colour
  (then BGR -> RGB) and in gray, on JPEGs that cv2 writes: sizes 1x1,
  7x9, 37x53 and 97x131; sampling 4:4:4, 4:2:2, 4:2:0, 4:4:0
  (``IMWRITE_JPEG_SAMPLING_FACTOR``) and grayscale; qualities 50, 95 and
  100; restart intervals (``IMWRITE_JPEG_RST_INTERVAL``) and optimised
  Huffman tables (``IMWRITE_JPEG_OPTIMIZE``); the eight EXIF
  orientations spliced into an APP1 in both byte orders, where
  ``codec.image_size`` also gives the oriented size;
- ``native.jpeg_encode`` and ``encode_plain`` are byte-equal to
  ``cv2.imencode(".jpg")`` at its defaults, at the same sizes in colour
  and gray, and ``codec.imwrite`` writes those bytes; ``encode_plain``'s
  other sampling modes are cv2's with ``IMWRITE_JPEG_SAMPLING_FACTOR``;
- the plain quantiser (a rounding division) equals libjpeg-turbo's
  reciprocal multiply for every quantum a baseline table can hold;
- beyond baseline, both routes equal ``cv2.imdecode`` on progressive
  files from cv2 (every sampling, gray, restart intervals) and PIL (4:4:4
  and 4:2:0), PIL's CMYK files, and the files of
  ``tests/torch_jpeg_writer.py``: sequential and progressive arithmetic
  coding (with and without DAC conditioning and restarts), scans with no
  DHT (the Annex K tables), CMYK and YCCK at 4:4:4 and 4:2:0, EXIF
  orientations on a progressive and an arithmetic file, at 1x1, 6x8 and
  37x53; cv2's decode of each transcode equals its decode of the source;
- a 12-bit, a hierarchical and a 2-component file, a header of more
  than 2**30 pixels (OpenCV's limit), Huffman tables that libjpeg refuses
  (over-subscribed counts, an all-ones code, a DC size past 15), a scan
  that lists a component twice, a baseline file patched to SOF3 and a
  truncated file raise ``ValueError`` naming the file and the reason, and
  cv2 returns None for each (a truncated file read from its path aside:
  ``cv2.imread`` decodes it with the rest gray, and so does the port); the
  kinds once refused here (progressive, CMYK, arithmetic; lossless, a
  progressive file cut after some scans and one whose scans stop short
  of full precision, which libjpeg smooths) now decode as cv2 decodes
  them, in the reads it decodes them in, under the same test ids;
- PNGs at bit depths 1, 2, 4 (gray and palette) and 16 (gray, RGB,
  gray + alpha, RGBA), plain and Adam7-interlaced, written by
  ``tests/torch_png_writer.py``, decode as ``cv2.imread`` reads them;
  ``codec.imwrite`` writes ``cv2.imwrite``'s PNG bytes.
"""

import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

import torch_jpeg_writer as writer
from torch_png_writer import CHANNELS, png
from wesup_tpu_torch import native
from wesup_tpu_torch.data import codec
from wesup_tpu_torch.data import jpeg
from torch_threads import worker_threads  # noqa: E402,F401

SIZES = [(1, 1), (7, 9), (37, 53), (97, 131)]
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111,
            "440": 0x121111, "gray": None}


def _image(hw, seed=0):
    """Gradients under noise: smooth enough for the chroma filters to
    matter, noisy enough for long Huffman codes."""
    h, w = hw
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                     (x + y) * 127 / max(h + w - 2, 1)], -1)
    return np.clip(base + rng.normal(0, 40, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _cv2_jpeg(rgb, sampling="420", **params):
    flags = [cv2.IMWRITE_JPEG_QUALITY, params.pop("quality", 95)]
    for key, value in params.items():
        flags += [getattr(cv2, f"IMWRITE_JPEG_{key.upper()}"), value]
    if SAMPLING[sampling] is None:
        src = rgb[..., 0].copy()
    else:
        src = rgb[..., ::-1].copy()
        flags += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", src, flags)
    assert ok
    return buf.tobytes()


def _assert_decodes_like_cv2(data: bytes):
    for gray in (False, True):
        want = cv2.imdecode(np.frombuffer(data, np.uint8),
                            cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
        if not gray:
            want = want[..., ::-1]
        np.testing.assert_array_equal(native.jpeg_decode(data, gray), want)
        np.testing.assert_array_equal(jpeg.decode_plain(data, gray), want)
        np.testing.assert_array_equal(codec.decode(data, gray), want)
        assert native.jpeg_size(data) == want.shape[:2]


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_decode_matches_cv2(hw, sampling):
    for i, quality in enumerate((50, 95, 100)):
        _assert_decodes_like_cv2(_cv2_jpeg(_image(hw, seed=i), sampling,
                                           quality=quality))


@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_decode_restarts_and_optimised_tables(sampling):
    img = _image((37, 53), seed=7)
    for rst in (1, 3):
        _assert_decodes_like_cv2(_cv2_jpeg(img, sampling, rst_interval=rst))
    _assert_decodes_like_cv2(_cv2_jpeg(img, sampling, optimize=1))


def _with_orientation(data: bytes, value: int, order: str) -> bytes:
    """``data`` with an Exif APP1 (IFD0: Orientation = ``value``) after its
    JFIF APP0."""
    e = "<" if order == "II" else ">"
    tiff = (order.encode() + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, value, 0)
            + struct.pack(e + "I", 0))
    body = b"Exif\0\0" + tiff
    app1 = b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body
    return data[:20] + app1 + data[20:]


@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("value", range(1, 9))
def test_exif_orientation(tmp_path, value, order):
    for sampling in ("420", "gray"):
        data = _with_orientation(_cv2_jpeg(_image((37, 53), seed=value),
                                           sampling), value, order)
        _assert_decodes_like_cv2(data)
        path = tmp_path / f"o{sampling}.jpg"
        path.write_bytes(data)
        want = cv2.imread(str(path))
        assert codec.image_size(path) == want.shape[:2]
        np.testing.assert_array_equal(codec.imread_rgb(path),
                                      want[..., ::-1])


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("hw", SIZES + [(100, 150)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_encode_matches_cv2(tmp_path, hw, channels):
    img = _image(hw, seed=11)
    arr = img if channels == 3 else img[..., 1].copy()
    want = cv2.imencode(".jpg", arr[..., ::-1] if channels == 3 else arr)[1]
    want = want.tobytes()
    assert native.jpeg_encode(arr) == want
    assert jpeg.encode_plain(arr) == want
    codec.imwrite(tmp_path / "x.jpg", arr)
    assert (tmp_path / "x.jpg").read_bytes() == want


@pytest.mark.parametrize("sampling", ["444", "422", "420", "440"])
def test_plain_encoder_sampling_matches_cv2(sampling):
    """The plain encoder's other sampling modes (the files phase 15 of
    chip_smoke.py decodes on the card) are cv2.imencode's bytes with that
    ``IMWRITE_JPEG_SAMPLING_FACTOR``."""
    factors = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2)}
    for hw in ((7, 9), (37, 53), (97, 131)):
        img = _image(hw, seed=12)
        want = _cv2_jpeg(img, sampling)
        assert jpeg.encode_plain(img, factors[sampling]) == want
        _assert_decodes_like_cv2(want)


def _reciprocal(divisor):
    """jcdctmgr.c's compute_reciprocal for a 16-bit DCTELEM."""
    b = divisor.bit_length() - 1
    r = 16 + b
    fq, fr = divmod(1 << r, divisor)
    c = divisor // 2
    if fr == 0:
        fq, r = fq >> 1, r - 1
    elif fr <= divisor // 2:
        c += 1
    else:
        fq += 1
    return fq & 0xFFFF, c & 0xFFFF, r


def test_quantiser_rounds_as_libjpeg_turbo():
    """Every quantum 1-255 (the encoder divides by 8 q) against every
    magnitude the 8-bit ISLOW DCT can give (below 2**14): the rounding
    division of ``encode_plain`` equals the reciprocal multiply of the
    library and of libjpeg-turbo."""
    coef = np.arange(-(1 << 14) + 1, 1 << 14, dtype=np.int64)
    a = np.abs(coef)
    for q in range(1, 256):
        fq, c, r = _reciprocal(8 * q)
        want = (((a + c) & 0xFFFF) * fq) >> r
        want = np.where(coef < 0, -want, want)
        np.testing.assert_array_equal(
            jpeg.quantize(coef, np.array(q)), want, err_msg=f"q={q}")
    assert set(jpeg.quant_tables()[0].tolist()) <= set(range(1, 256))


def _patched_sof(data: bytes, marker: int, precision: int = 8,
                 components: int | None = None) -> bytes:
    i = data.index(b"\xff\xc0")
    length = struct.unpack(">H", data[i + 2:i + 4])[0]
    body = bytearray(data[i + 4:i + 2 + length])
    body[0] = precision
    if components:
        h, w = struct.unpack(">HH", body[1:5])
        comps = b"".join(bytes([k + 1, 0x11, 0]) for k in range(components))
        body = bytearray(struct.pack(">BHHB", precision, h, w, components)
                         + comps)
    return (data[:i] + bytes([0xFF, marker])
            + struct.pack(">H", len(body) + 2) + bytes(body)
            + data[i + 2 + length:])


def _patched_dht(data: bytes, bits, vals=None) -> bytes:
    """``data`` with the counts (and symbols) of its first Huffman table
    replaced; symbols are kept, padded with 0 or cut, when not given."""
    i = data.index(b"\xff\xc4")
    length = struct.unpack(">H", data[i + 2:i + 4])[0]
    body = data[i + 4:i + 2 + length]
    old = sum(body[1:17])
    if vals is None:
        vals = body[17:17 + old] + bytes(max(0, sum(bits) - old))
    seg = bytes([body[0]]) + bytes(bits) + bytes(vals)[:sum(bits)] + body[
        17 + old:]
    return (data[:i] + b"\xff\xc4" + struct.pack(">H", len(seg) + 2) + seg
            + data[i + 2 + length:])


def _scan_listing_a_component_twice(data: bytes) -> bytes:
    i = data.index(b"\xff\xda")
    length = struct.unpack(">H", data[i + 2:i + 4])[0]
    body = data[i + 4:i + 2 + length]
    body = bytes([2]) + body[1:3] * 2 + body[-3:]
    return (data[:i] + b"\xff\xda" + struct.pack(">H", len(body) + 2) + body
            + data[i + 2 + length:])


def _dc_table(data: bytes):
    i = data.index(b"\xff\xc4")
    bits = list(data[i + 5:i + 21])
    return bits, list(data[i + 21:i + 21 + sum(bits)])


def _cmyk(img):
    k = (np.arange(img.size // 3) % 251).reshape(img.shape[:2] + (1,))
    return np.concatenate([img, k.astype(np.uint8)], -1)


REFUSED = {
    # once refused, now decoded (a patched header would be a corrupt
    # file, whose garbage cv2 shows with a warning: these are real ones)
    "progressive": (lambda d, img: _cv2_jpeg(img, progressive=1), None),
    "cmyk": (lambda d, img: writer.four_component(_cmyk(img)), None),
    "lossless": (lambda d, img: _patched_sof(d, 0xC3), "lossless"),
    "12bit": (lambda d, img: _patched_sof(d, 0xC1, precision=12), "12-bit"),
    "arithmetic": (lambda d, img: writer.arithmetic(writer.parse(d)), None),
    "truncated": (lambda d, img: d[:len(d) // 2], "truncated"),
    "huge": (lambda d, img: d.replace(struct.pack(">HH", 37, 53),
                                      struct.pack(">HH", 65535, 65535), 1),
             "too large"),
    # counts that are no prefix code (200 codes of 1 bit would overrun a
    # lookup table), an all-ones code, and a DC size past 15: libjpeg
    # refuses each as a bad Huffman table
    "oversubscribed": (lambda d, img: _patched_dht(d, [200] + [0] * 15),
                       "Huffman table"),
    "all_ones_code": (lambda d, img: _patched_dht(d, [2] + [0] * 14 + [10]),
                      "Huffman table"),
    "dc_size_16": (lambda d, img: _patched_dht(
        d, _dc_table(d)[0], _dc_table(d)[1][:-1] + [16]), "Huffman table"),
    "component_twice": (lambda d, img: _scan_listing_a_component_twice(d),
                        "listed twice"),
}
# corrupt files that cv2 refuses too (cv2.imread decodes a truncated one,
# with the rest gray: libjpeg's stdio source supplies the EOI it lacks)
CV2_REFUSES = ("lossless", "12bit", "huge", "oversubscribed", "all_ones_code",
               "dc_size_16", "component_twice")


@pytest.mark.parametrize("case", list(REFUSED))
def test_unsupported_jpeg_raises_naming_the_file(tmp_path, case):
    img = _image((37, 53), seed=5)
    make, reason = REFUSED[case]
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(make(_cv2_jpeg(img), img))
    if reason is None:
        _assert_decodes_like_cv2(path.read_bytes())
        want = cv2.imread(str(path))
        np.testing.assert_array_equal(codec.imread_rgb(path), want[..., ::-1])
        return
    for read, flag in ((codec.imread_rgb, cv2.IMREAD_COLOR),
                       (codec.imread_mask, cv2.IMREAD_GRAYSCALE)):
        want = cv2.imread(str(path), flag)
        if want is None:
            with pytest.raises(ValueError, match=f"{case}.jpg.*{reason}"):
                read(path)
        else:       # a cut file, whose rest cv2.imread fills with gray
            np.testing.assert_array_equal(
                read(path), want[..., ::-1] if want.ndim == 3 else want)
    with pytest.raises(ValueError, match=f"{case}.jpg.*{reason}"):
        codec.decode(path.read_bytes(), name=str(path))
    with pytest.raises(ValueError):
        jpeg.decode_plain(path.read_bytes())
    assert cv2.imdecode(np.frombuffer(path.read_bytes(), np.uint8),
                        cv2.IMREAD_COLOR) is None
    assert (cv2.imread(str(path)) is None) == (case in CV2_REFUSES)


# ---------------------------------------------------------------------------
# JPEG beyond baseline
# ---------------------------------------------------------------------------

BEYOND_SIZES = [(1, 1), (6, 8), (37, 53)]


@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_progressive_from_cv2_matches_cv2(sampling):
    for i, hw in enumerate(BEYOND_SIZES + [(97, 131)]):
        img = _image(hw, seed=20 + i)
        _assert_decodes_like_cv2(_cv2_jpeg(img, sampling, progressive=1))
    img = _image((37, 53), seed=30)
    for rst in (1, 3):
        _assert_decodes_like_cv2(_cv2_jpeg(img, sampling, progressive=1,
                                           rst_interval=rst))


@pytest.mark.parametrize("subsampling", [0, 2], ids=["444", "420"])
def test_progressive_and_cmyk_from_pil_match_cv2(subsampling):
    Image = pytest.importorskip("PIL.Image")
    import io

    for i, hw in enumerate(BEYOND_SIZES + [(61, 77)]):
        img = _image(hw, seed=40 + i)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", progressive=True,
                                  quality=90, subsampling=subsampling)
        _assert_decodes_like_cv2(buf.getvalue())
        buf = io.BytesIO()
        Image.fromarray(_cmyk(img), "CMYK").save(buf, "JPEG", quality=90,
                                                 subsampling=subsampling)
        _assert_decodes_like_cv2(buf.getvalue())


def _sources(hw, seed):
    """Baseline files to transcode: 4:2:0, 4:4:4, 4:2:2 and gray."""
    img = _image(hw, seed)
    return {"420": jpeg.encode_plain(img), "444": jpeg.encode_plain(
        img, (1, 1)), "422": jpeg.encode_plain(img, (2, 1)),
        "gray": jpeg.encode_plain(img[..., 0])}


TRANSCODES = {
    "sequential_huffman": lambda f: writer.sequential(f),
    "progressive_restarts": lambda f: writer.progressive(f, restart=2),
    "arithmetic": lambda f: writer.arithmetic(f),
    "arithmetic_dac_restarts": lambda f: writer.arithmetic(
        f, restart=3, dac=(1, 3, 2)),
    "progressive_arithmetic": lambda f: writer.arithmetic(f, True),
    "progressive_arithmetic_dac_restarts": lambda f: writer.arithmetic(
        f, True, restart=1, dac=(2, 5, 10)),
}


def _cv2_decodes(data):
    return [cv2.imdecode(np.frombuffer(data, np.uint8), flag)
            for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE)]


@pytest.mark.parametrize("kind", list(TRANSCODES))
def test_writer_transcodes_decode_like_cv2(kind):
    """The writer's own check: cv2 decodes each transcode as it decodes
    the baseline source (transcoding keeps every coefficient), and both
    routes decode it as cv2 does."""
    for i, hw in enumerate(BEYOND_SIZES):
        for name, src in _sources(hw, 50 + i).items():
            data = TRANSCODES[kind](writer.parse(src))
            for got, want in zip(_cv2_decodes(data), _cv2_decodes(src)):
                assert got is not None, (kind, name, hw)
                np.testing.assert_array_equal(got, want)
            _assert_decodes_like_cv2(data)


def test_scans_without_dht_take_the_annex_k_tables():
    for i, hw in enumerate(BEYOND_SIZES):
        for name, src in _sources(hw, 60 + i).items():
            data = writer.without_dht(src)
            assert b"\xff\xc4" not in data[:data.index(b"\xff\xda")]
            for got, want in zip(_cv2_decodes(data), _cv2_decodes(src)):
                np.testing.assert_array_equal(got, want)
            _assert_decodes_like_cv2(data)
    # cv2's own file (quality 95, the Annex K tables) without its DHT
    _assert_decodes_like_cv2(writer.without_dht(_cv2_jpeg(_image(
        (37, 53), 64), "420")))


@pytest.mark.parametrize("transform", [0, 2], ids=["cmyk", "ycck"])
def test_four_component_files_match_cv2(transform):
    for i, hw in enumerate(BEYOND_SIZES):
        cmyk = _cmyk(_image(hw, seed=70 + i))
        for sampling in (((1, 1),) * 4, ((2, 2), (1, 1), (1, 1), (2, 2))):
            _assert_decodes_like_cv2(writer.four_component(
                cmyk, transform, sampling))


@pytest.mark.parametrize("value", range(1, 9))
def test_exif_orientation_beyond_baseline(tmp_path, value):
    src = _cv2_jpeg(_image((37, 53), seed=80 + value), "420")
    frame = writer.parse(src)
    for name, data in (("progressive", writer.progressive(frame)),
                       ("arithmetic", writer.arithmetic(frame))):
        data = _with_orientation(data, value, "MM" if value % 2 else "II")
        _assert_decodes_like_cv2(data)
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(data)
        assert codec.image_size(path) == cv2.imread(str(path)).shape[:2]


def _two_component(img):
    return writer.sequential(writer.from_planes(
        [img[..., 0], img[..., 1]], [(1, 1), (1, 1)], [1, 2]))


def _twelve_bit(img):
    return writer.sequential(writer.from_planes(
        [img[..., 0].astype(np.int64) * 16 + 8], [(1, 1)], [1],
        precision=12))


def _cut_progressive(img):
    data = writer.progressive(writer.parse(_cv2_jpeg(img)))
    return data[:data.rfind(b"\xff\xda")]


def _hierarchical(img):
    data = bytearray(_cv2_jpeg(img))
    data[data.index(b"\xff\xc0") + 1] = 0xC5
    return bytes(data)


# the kinds once refused, each by its own file, and what cv2 (OpenCV
# 5.0.0, libjpeg-turbo 3.1.2) does with it: the port reads what cv2 reads
# and refuses the rest, saying that cv2 refuses it too
STILL_REFUSED = {
    # (maker, the reason the port gives where cv2 refuses, whether cv2's
    # colour and gray reads of the bytes (cv2.imdecode) decode it)
    "lossless": (lambda img: writer.lossless(img[..., 0]), "lossless",
                 (False, True)),
    "12bit": (_twelve_bit, "12-bit", (False, False)),
    "hierarchical": (_hierarchical, "hierarchical", (False, False)),
    "two_component": (_two_component, "2-component", (False, False)),
    "truncated_progressive": (_cut_progressive, "several scans without an "
                              "EOI", (False, False)),
    "smoothed_progressive": (lambda img: writer.progressive(
        writer.parse(_cv2_jpeg(img)), writer.early_stop(3)), None,
        (True, True)),
}


@pytest.mark.parametrize("case", list(STILL_REFUSED))
def test_kinds_still_refused_name_the_file_and_the_roadmap(tmp_path, case):
    """Each read, of the bytes (``decode``, ``decode_plain``, the library)
    as ``cv2.imdecode`` and of the path as ``cv2.imread`` (which reads a
    progressive file cut after some scans: libjpeg's stdio source
    supplies its EOI), equals cv2's or is refused where cv2 returns None,
    naming the file and saying that cv2 refuses it too."""
    img = _image((37, 53), seed=90)
    make, reason, cv2_does = STILL_REFUSED[case]
    data = make(img)
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(data)
    got = _cv2_decodes(data)
    assert tuple(g is not None for g in got) == cv2_does
    for gray, want in zip((False, True), got):
        decodes = [lambda: codec.decode(data, gray, name=str(path)),
                   lambda: jpeg.decode_plain(data, gray),
                   lambda: native.jpeg_decode(data, gray)]
        for i, decode in enumerate(decodes):
            if want is None:
                with pytest.raises(ValueError, match=reason) as ex:
                    decode()
                assert i or (f"{case}.jpg" in str(ex.value)
                             and "cv2" in str(ex.value))
            else:
                np.testing.assert_array_equal(
                    decode(), want if gray else want[..., ::-1])
        read = codec.imread_mask if gray else codec.imread_rgb
        want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE if gray
                          else cv2.IMREAD_COLOR)
        if want is None:
            with pytest.raises(codec.ImageReadError,
                               match=f"{case}.jpg.*{reason}.*cv2"):
                read(path)
        else:
            np.testing.assert_array_equal(
                read(path), want if gray else want[..., ::-1])
    if case == "lossless":
        np.testing.assert_array_equal(got[1], img[..., 0])


# ---------------------------------------------------------------------------
# PNG beyond 8 bits and interlace
# ---------------------------------------------------------------------------

PNG_CASES = [(0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 4), (0, 16),
             (2, 16), (4, 16), (6, 16), (2, 8), (3, 8)]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("ctype,depth", PNG_CASES,
                         ids=lambda v: str(v))
def test_png_depths_and_interlace_read_like_cv2(tmp_path, ctype, depth,
                                                interlace):
    rng = np.random.default_rng(depth * 10 + ctype)
    h, w = 19, 23                     # every Adam7 pass, odd row lengths
    top = (1 << depth) - 1
    samples = rng.integers(0, top + 1, (h, w, CHANNELS[ctype]))
    samples[:4, :4] = samples[:4, :4, :1]        # some gray RGB pixels
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (1 << depth, 3))
    path = tmp_path / "p.png"
    path.write_bytes(png(samples, depth, ctype, interlace, palette))
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert want is not None
    np.testing.assert_array_equal(codec.imread_rgb(path), want[..., ::-1])
    np.testing.assert_array_equal(
        codec.imread_mask(path), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    assert codec.image_size(path) == (h, w)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("hw", [(1, 1), (7, 1), (1, 7), (37, 53), (60, 60),
                                (200, 300)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_png_writer_matches_cv2(tmp_path, hw, channels):
    """``codec.imwrite(".png")`` writes ``cv2.imwrite``'s bytes (Sub rows,
    zlib level 1 with Z_RLE, libpng's window choice and 8192-byte IDATs)
    for masks, colour and colour + alpha."""
    rng = np.random.default_rng(hw[0] * 7 + channels)
    if channels == 1:
        img = (rng.random(hw) < 0.3).astype(np.uint8) * 255
        as_cv2 = img
    else:
        img = rng.integers(0, 256, hw + (channels,), np.uint8)
        as_cv2 = np.ascontiguousarray(
            img[..., [2, 1, 0, 3][:channels]])       # RGB(A) -> BGR(A)
    codec.imwrite(tmp_path / "m.png", img)
    cv2.imwrite(str(tmp_path / "c.png"), as_cv2)
    assert ((tmp_path / "m.png").read_bytes()
            == (tmp_path / "c.png").read_bytes())


def test_png_16_bit_keeps_the_high_byte(tmp_path):
    samples = np.full((2, 3, 1), 0x12FF)
    path = tmp_path / "hi.png"
    path.write_bytes(png(samples, 16, 0, 0))
    assert (codec.imread_mask(path) == 0x12).all()
    assert (cv2.imread(str(path), cv2.IMREAD_GRAYSCALE) == 0x12).all()


def test_codec_module_docs_name_no_missing_format():
    """The codec's docstring lists JPEG as decoded, lossless and smoothed
    files among it, and the refusals it keeps, none of them sent to a
    roadmap item: every kind it refuses is one cv2 refuses too, and
    damaged files read as cv2 reads them (no known difference is left)."""
    doc = codec.__doc__
    assert "JPEG, baseline" in doc and "Adam7" in doc
    assert "lossless files" in doc and "block smoothing" in doc
    assert "RLE4" in doc and "known difference" not in doc
    assert "damaged" in doc
    assert "item 9" not in doc and not hasattr(codec, "_LATER")
    assert Path(native.JPEG_SOURCE).exists()
