"""The JPEG kinds the port reads beyond those of ``test_torch_port_jpeg.py``,
and where it stops, against OpenCV on the CPU.

- Block smoothing: progressive files whose scans leave zigzag
  coefficients 1-9 short of full precision, which libjpeg-turbo smooths
  (``jdcoefct.c`` ``decompress_smooth_data``): DC only (the DC
  interpolated too), DC at Al 1, DC with the first AC band at Al 2, luma
  refined and chroma not, the simple script cut early, successive
  approximation stopped half way, with a restart interval, and
  progressive arithmetic coding (SOF10); 4:2:0, 4:4:4 and gray, at sizes
  that are not whole MCUs and at one and two blocks wide.
- Lossless files (SOF3, T.81 Annex H): predictors 1-7, point transforms,
  restart intervals, 2-8 bits, gray, RGB (interleaved or a scan per
  component, subsampled, upsampled by replication) and CMYK; and the map
  of what cv2 refuses (9-16 bits, 2 components, YCbCr and YCCK, a gray
  file read in colour and an RGB one in gray, SOF11, bad scan
  parameters, a restart interval of part of an MCU row, an MCU of more
  than 10 samples).
- Where a file ends: ``decode`` of bytes follows ``cv2.imdecode``
  (without its EOI marker a file of several scans is refused, and one
  whose scan data runs to its end), the readers of a path follow
  ``cv2.imread`` (libjpeg's stdio source supplies the EOI at the end of
  a file); the cuts of the file cv2 refuses, and the cases once known
  differences: data that runs short (``cv2.imread`` fills it with gray),
  an EOI-less file that ``cv2.imdecode`` decodes because libjpeg's bit
  reader never looked past its end, a restart interval without its
  markers.

The library (``native.jpeg_decode``), its plain version
(``data/jpeg.decode_plain``) and ``codec`` equal cv2 byte for byte, in
colour (then BGR -> RGB) and in gray, or raise where it returns None.
"""

import struct
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
import torch_jpeg_writer as writer  # noqa: E402
from wesup_tpu_torch import native  # noqa: E402
from wesup_tpu_torch.data import codec  # noqa: E402
from wesup_tpu_torch.data import jpeg  # noqa: E402
from torch_threads import worker_threads  # noqa: E402,F401


def _image(hw, seed=0):
    h, w = hw
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                     (x + y) * 127 / max(h + w - 2, 1)], -1)
    return np.clip(base + rng.normal(0, 30, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _reads(data, tmp_path, name):
    """cv2's reads of ``data``: {(gray, file): array or None}, colour ones
    as RGB; file reads through ``cv2.imread`` of ``tmp_path / name``."""
    path = tmp_path / name
    path.write_bytes(data)
    out = {}
    for gray, flag in ((False, cv2.IMREAD_COLOR),
                       (True, cv2.IMREAD_GRAYSCALE)):
        for file in (False, True):
            got = (cv2.imread(str(path), flag) if file else
                   cv2.imdecode(np.frombuffer(data, np.uint8), flag))
            if got is not None and not gray:
                got = got[..., ::-1]
            out[gray, file] = got
    return path, out


def _port_reads(data, path, gray, file):
    """The port's routes for one read: the library, its plain version and
    the codec (a path read for ``file``)."""
    routes = [lambda: native.jpeg_decode(data, gray, file),
              lambda: jpeg.decode_plain(data, gray, file)]
    if file:
        routes.append(lambda: (codec.imread_mask if gray
                               else codec.imread_rgb)(path))
    else:
        routes.append(lambda: codec.decode(data, gray, name=str(path)))
    return routes


def assert_reads_like_cv2(data, tmp_path, name="f.jpg"):
    """Every route of every read equals cv2's, or raises where cv2 returns
    None (naming the file where the codec reads it, and saying that cv2
    refuses it too).  Returns the number of reads cv2 decodes."""
    path, want = _reads(data, tmp_path, name)
    decoded = 0
    for (gray, file), expect in want.items():
        for i, read in enumerate(_port_reads(data, path, gray, file)):
            if expect is None:
                with pytest.raises(ValueError) as ex:
                    read()
                if i == 2:
                    assert name in str(ex.value) and "cv2" in str(ex.value)
                continue
            np.testing.assert_array_equal(read(), expect,
                                          err_msg=f"{name} {gray} {file}")
        decoded += expect is not None
    return decoded


# ---------------------------------------------------------------------------
# block smoothing
# ---------------------------------------------------------------------------

def _all(n):
    return tuple(range(n))


SCRIPTS = {
    "dc_only": lambda n: [(_all(n), 0, 0, 0, 0)],
    "dc_al1": lambda n: [(_all(n), 0, 0, 0, 1)],
    "dc_and_first_band_al2": lambda n: [(_all(n), 0, 0, 0, 0)] + [
        ((c,), 1, 5, 0, 2) for c in range(n)],
    "luma_refined_chroma_not": lambda n: [(_all(n), 0, 0, 0, 0),
                                          ((0,), 1, 63, 0, 0)],
    "simple_cut_early": writer.early_stop,
    "refinement_half_way": lambda n: [
        (_all(n), 0, 0, 0, 1), (_all(n), 0, 0, 1, 0)] + [
        s for c in range(n) for s in (((c,), 1, 2, 0, 2), ((c,), 1, 2, 2, 1),
                                      ((c,), 3, 9, 0, 1))],
}
SMOOTH_HW = [(37, 53), (17, 9), (16, 16), (9, 23)]


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_smoothed_progressive_matches_cv2(tmp_path, script):
    for i, hw in enumerate(SMOOTH_HW):
        img = _image(hw, seed=i)
        for src in (jpeg.encode_plain(img), jpeg.encode_plain(img, (1, 1)),
                    jpeg.encode_plain(img[..., 0])):
            frame = writer.parse(src)
            data = writer.progressive(frame,
                                      SCRIPTS[script](len(frame.comps)))
            assert assert_reads_like_cv2(data, tmp_path) == 4


@pytest.mark.parametrize("script", ["dc_only", "simple_cut_early"])
def test_smoothed_with_restarts_and_arithmetic_match_cv2(tmp_path, script):
    img = _image((37, 53), seed=9)
    for src in (jpeg.encode_plain(img), jpeg.encode_plain(img[..., 0])):
        frame = writer.parse(src)
        sc = SCRIPTS[script](len(frame.comps))
        for data in (writer.progressive(frame, sc, restart=2),
                     writer.arithmetic(frame, True, restart=3, script=sc)):
            assert assert_reads_like_cv2(data, tmp_path) == 4


# ---------------------------------------------------------------------------
# lossless
# ---------------------------------------------------------------------------

def _planes(n, hw, bits, seed):
    rng = np.random.default_rng(seed)
    h, w = hw
    ramp = np.add.outer(np.arange(h) * 3, np.arange(w) * 2)
    return [np.clip(ramp + rng.integers(0, 9, hw) + 20 * k, 0,
                    (1 << bits) - 1) for k in range(n)]


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_predictors_match_cv2(tmp_path, predictor):
    """Gray (colour read refused, as cv2 refuses it) and RGB (gray read
    refused) at 8 bits, with and without a point transform and a restart
    interval, and the samples those reads give back."""
    hw = (29, 41)
    for pt, rows in ((0, 0), (2, 3)):
        gray = _planes(1, hw, 8, predictor)
        data = writer.lossless(gray, predictor, pt, rows)
        assert assert_reads_like_cv2(data, tmp_path) == 2
        np.testing.assert_array_equal(
            codec.decode(data, True), (gray[0] >> pt) << pt)
        rgb = _planes(3, hw, 8, 10 + predictor)
        data = writer.lossless(rgb, predictor, pt, rows)
        assert assert_reads_like_cv2(data, tmp_path) == 2
        np.testing.assert_array_equal(
            codec.decode(data), np.stack([(p >> pt) << pt for p in rgb], -1))


LOSSLESS = {
    "2_bits": dict(n=1, bits=2),
    "5_bits_pt1": dict(n=1, bits=5, pt=1),
    "7_bits_rgb": dict(n=3, bits=7, predictor=5),
    "rgb_420": dict(n=3, sampling=((2, 2), (1, 1), (1, 1))),
    "rgb_scan_per_component": dict(n=3, interleave=False, predictor=6),
    "rgb_subsampled_scans": dict(n=3, sampling=((1, 2), (2, 1), (1, 1)),
                                 interleave=False),
    "rgb_ids_rgb": dict(n=3, ids=(82, 71, 66), predictor=2),
    "cmyk": dict(n=4, predictor=3, rows=2),
    "cmyk_subsampled": dict(n=4, sampling=((2, 2), (1, 1), (1, 1), (2, 1))),
    "gray_declared_22": dict(n=1, sampling=((2, 2),)),
}


@pytest.mark.parametrize("case", list(LOSSLESS))
def test_lossless_kinds_match_cv2(tmp_path, case):
    kw = dict(LOSSLESS[case])
    n, bits = kw.pop("n"), kw.pop("bits", 8)
    data = writer.lossless(
        _planes(n, (23, 31), bits, len(case)), kw.pop("predictor", 1),
        kw.pop("pt", 0), kw.pop("rows", 0), bits, **kw)
    assert assert_reads_like_cv2(data, tmp_path) == (4 if n == 4 else 2)


def _with_segment(data, segment):
    return data[:2] + segment + data[2:]


def _patched_scan(data, ss=None, al=None):
    i = data.index(b"\xff\xda")
    n = data[i + 4]
    at = i + 5 + 2 * n
    out = bytearray(data)
    if ss is not None:
        out[at] = ss
    if al is not None:
        out[at + 2] = al
    return bytes(out)


def _patched_dri(data, interval):
    i = data.index(b"\xff\xdd")
    return data[:i + 4] + struct.pack(">H", interval) + data[i + 6:]


JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
ADOBE_YCCK = writer.ADOBE[:15] + b"\x02"

# what cv2 refuses, each by its own file: the port refuses it too
LOSSLESS_REFUSED = {
    "9_bits": lambda p: writer.lossless(p(1, 9), precision=9),
    "12_bits": lambda p: writer.lossless(p(1, 12), precision=12),
    "16_bits": lambda p: writer.lossless(p(1, 16), precision=16),
    "2_components": lambda p: writer.lossless(p(2, 8)),
    "ycbcr_jfif": lambda p: _with_segment(writer.lossless(p(3, 8)), JFIF),
    "ycck": lambda p: _with_segment(writer.lossless(p(4, 8)), ADOBE_YCCK),
    "arithmetic_sof11": lambda p: writer.lossless(p(1, 8)).replace(
        b"\xff\xc3", b"\xff\xcb", 1),
    "predictor_0": lambda p: _patched_scan(writer.lossless(p(1, 8)), ss=0),
    "point_transform_8": lambda p: _patched_scan(writer.lossless(p(1, 8)),
                                                 al=8),
    "restart_part_of_a_row": lambda p: _patched_dri(
        writer.lossless(p(1, 8), restart_rows=2), 31 + 3),
    "mcu_of_11_samples": lambda p: writer.lossless(
        p(4, 8), sampling=((1, 1), (2, 2), (1, 2), (2, 2))),
}


@pytest.mark.parametrize("case", list(LOSSLESS_REFUSED))
def test_lossless_kinds_cv2_refuses_are_refused(tmp_path, case):
    data = LOSSLESS_REFUSED[case](
        lambda n, bits: _planes(n, (23, 31), bits, 3))
    assert assert_reads_like_cv2(data, tmp_path, f"{case}.jpg") == 0


def test_lossless_sizes_follow_the_read_mode(tmp_path):
    """``image_size`` answers for the read its caller makes: the JAX
    loader sizes its canvas from a gray read, which cv2 makes of a gray
    lossless file and refuses of an RGB one."""
    gray, rgb = tmp_path / "g.jpg", tmp_path / "c.jpg"
    gray.write_bytes(writer.lossless(_planes(1, (23, 31), 8, 0)))
    rgb.write_bytes(writer.lossless(_planes(3, (23, 31), 8, 0)))
    for path in (gray, rgb):
        for mode, is_gray in ((cv2.IMREAD_GRAYSCALE, True),
                              (cv2.IMREAD_COLOR, False)):
            want = cv2.imread(str(path), mode)
            got = codec.image_size(path, gray=is_gray)
            assert got == (None if want is None else want.shape[:2])


# ---------------------------------------------------------------------------
# where a file ends
# ---------------------------------------------------------------------------

def _sources():
    """(name, file) pairs: a baseline file cv2 writes, its progressive and
    arithmetic transcodes, a lossless file."""
    img = _image((37, 53), seed=5)
    base = cv2.imencode(".jpg", img[..., ::-1])[1].tobytes()
    frame = writer.parse(base)
    return [("baseline", base), ("progressive", writer.progressive(frame)),
            ("arithmetic", writer.arithmetic(frame)),
            ("lossless", writer.lossless(img[..., 0]))]


def test_jpeg_without_its_eoi_reads_as_cv2_reads_it(tmp_path):
    """Without its EOI marker, a file's bytes are refused where
    ``cv2.imdecode`` returns None (a file of several scans, and one whose
    scan data runs to its end: libjpeg's memory source cannot look past
    it), and decoded where a marker ends the scan; a path read decodes the
    whole scans, as ``cv2.imread`` does (libjpeg's stdio source supplies
    the EOI at the end of a file; arithmetic-coded data decodes on from
    the zero bits that the decoder is fed after a marker)."""
    for name, data in _sources():
        cut = data[:-2]
        assert_reads_like_cv2(cut, tmp_path, f"{name}.jpg")
        _, want = _reads(cut, tmp_path, f"{name}.jpg")
        assert all(v is None for (g, f), v in want.items() if not f), name
        # a marker after the scan data, and no EOI
        com = cut + b"\xff\xfe\x00\x04hi"
        assert_reads_like_cv2(com, tmp_path, f"{name}_com.jpg")
    # a progressive file cut between two scans: the path read decodes what
    # the scans before the cut hold, smoothed
    prog = _sources()[1][1]
    cut = prog[:prog.rfind(b"\xff\xda")]
    assert assert_reads_like_cv2(cut, tmp_path, "between_scans.jpg") == 2


def test_the_cuts_cv2_refuses(tmp_path):
    """What cv2 (OpenCV 5.0.0, libjpeg-turbo 3.1.2) does with a baseline
    file cut at the end of its scan (no EOI), in mid-scan, in its header,
    and after its EOI (bytes appended), and what the port does: the same
    (a mid-scan cut read from a path decodes with the rest gray)."""
    data = _sources()[0][1]
    scan = data.rfind(b"\xff\xda")
    cuts = {"scan_end": data[:-2], "mid_scan": data[:(scan + len(data)) // 2],
            "mid_header": data[:scan // 2], "after_eoi": data + b"\0junk"}
    # cv2's colour reads: bytes, file
    cv2_does = {"scan_end": (False, True), "mid_scan": (False, True),
                "mid_header": (False, False), "after_eoi": (True, True)}
    for name, cut in cuts.items():
        _, want = _reads(cut, tmp_path, f"{name}.jpg")
        assert (want[False, False] is not None,
                want[False, True] is not None) == cv2_does[name], name
        assert_reads_like_cv2(cut, tmp_path, f"{name}.jpg")


def test_known_differences_are_where_cv2_recovers(tmp_path):
    """Corrupt or cut data that libjpeg recovers from with a warning, once
    refused by the port and now read as cv2 reads it: an EOI-less file
    whose last bits libjpeg's bit reader took without looking past the end
    (``cv2.imdecode`` decodes it: a few files in a hundred), and a restart
    interval whose markers are missing (libjpeg resynchronises)."""
    for seed in range(200):
        img = _image((int(8 + seed % 40), int(9 + seed % 31)), seed)
        data = cv2.imencode(".jpg", img[..., ::-1])[1].tobytes()[:-2]
        got = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if got is not None:
            break
    assert got is not None
    np.testing.assert_array_equal(codec.decode(data), got[..., ::-1])
    assert_reads_like_cv2(data, tmp_path, "eoi_less.jpg")
    base = _sources()[0][1]
    no_rst = base[:2] + b"\xff\xdd\x00\x04\x00\x02" + base[2:]
    got = cv2.imdecode(np.frombuffer(no_rst, np.uint8), cv2.IMREAD_COLOR)
    assert got is not None
    np.testing.assert_array_equal(codec.decode(no_rst), got[..., ::-1])
    assert assert_reads_like_cv2(no_rst, tmp_path, "no_rst.jpg") == 4
