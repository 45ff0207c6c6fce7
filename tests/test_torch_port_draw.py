"""The port's OpenCV-free rasterisers and synthetic dataset against OpenCV
and the repository's generator, on the CPU.

- ``draw.fill_poly_mask`` equal to ``cv2.fillPoly`` on 240 lobed gland
  polygons (``_lobed_polygon``, about a third crossing the border) and on
  random self-intersecting polygons: 0 pixels differ;
- ``draw.circles`` equal to ``cv2.circle(..., -1)`` drawn one after
  another (float32 image, 3 channels, radii 1-4, overlapping discs,
  centres at and beyond the border);
- ``draw.polylines_mask`` against closed ``cv2.polylines`` of thickness
  2-8: equal for polygons inside the image; where a segment crosses the
  border at most 0.5% of the rim pixels OpenCV paints may differ;
- ``draw.resize_cubic`` against ``cv2.resize(INTER_CUBIC)`` of the
  generator's fields: within 2e-7 of OpenCV's own resize and 1e-5 of the
  Intel IPP resize OpenCV runs by default (both float rounding);
- ``scripts.make_dataset`` against ``tests/make_dataset.py``: masks and
  point CSVs equal for every seed and size, easy images equal, hard images
  equal but for samples 1 level apart (at most 1e-4 of them, the cubic
  field's rounding) and the polyline residue above.
"""

import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
import make_dataset as j_make  # noqa: E402

from wesup_tpu_torch.data import codec, draw  # noqa: E402
from wesup_tpu_torch.scripts import make_dataset as t_make  # noqa: E402

RESIDUE = 0.005      # of the rim pixels OpenCV paints
ROUNDING = 1e-4      # of the samples, 1 level apart


def _lobed(n, h, w, seed, r_div=(12, 3)):
    rng = np.random.default_rng(seed)
    polys = []
    for _ in range(n):
        cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
        r = int(rng.integers(min(h, w) // r_div[0], min(h, w) // r_div[1]))
        polys.append(j_make._lobed_polygon(rng, cy, cx, r))
    return polys


def _crosses(poly, h, w):
    return bool(((poly[:, 0] < 0) | (poly[:, 0] >= w) | (poly[:, 1] < 0)
                 | (poly[:, 1] >= h)).any())


def test_fill_poly_matches_cv2_on_lobed_polygons():
    h, w = 200, 300
    polys = _lobed(240, h, w, seed=0)
    assert sum(_crosses(p, h, w) for p in polys) >= 50
    diff = 0
    for poly in polys:
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [poly], 1)
        diff += int((draw.fill_poly_mask(h, w, poly) != want).sum())
    assert diff == 0


@pytest.mark.parametrize("n_pts", [3, 4, 6])
def test_fill_poly_matches_cv2_on_random_polygons(n_pts):
    """Vertices anywhere in and around a 20x20 image: clipped edges,
    self-intersections, horizontal edges."""
    rng = np.random.default_rng(n_pts)
    for _ in range(500):
        poly = np.stack([rng.integers(-8, 28, n_pts),
                         rng.integers(-8, 28, n_pts)], -1).astype(np.int32)
        want = np.zeros((20, 20), np.uint8)
        cv2.fillPoly(want, [poly], 1)
        got = draw.fill_poly_mask(20, 20, poly)
        assert (got == want.astype(bool)).all(), poly.tolist()


def test_circles_match_cv2_drawn_in_turn():
    h, w = 40, 50
    rng = np.random.default_rng(0)
    n = 400
    centers = np.stack([rng.integers(-3, w + 3, n),
                        rng.integers(-3, h + 3, n)], -1)
    centers[:8] = [(0, 0), (w - 1, h - 1), (0, h - 1), (w - 1, 0),
                   (-1, 5), (w, 7), (9, -2), (11, h + 1)]
    radii = rng.integers(1, 5, n)
    colors = rng.normal(150, 40, (n, 3))
    want = np.full((h, w, 3), -1, np.float32)
    for (x, y), r, c in zip(centers, radii, colors):
        cv2.circle(want, (int(x), int(y)), int(r), [float(v) for v in c], -1)
    got = np.full((h, w, 3), -1, np.float32)
    draw.circles(got, centers, radii, colors)
    assert np.array_equal(got, want)
    one = np.zeros((5, 5), np.uint8)
    draw.circles(one, [(0, 0)], [2], [[7]])
    assert one.sum() == 6 * 7          # a clipped 13-pixel diamond


def test_polylines_match_cv2():
    h, w = 200, 300
    rng = np.random.default_rng(1)
    rim = residue = inside_diff = 0
    for i, poly in enumerate(_lobed(200, h, w, seed=2)):
        t = int(rng.integers(2, 9))
        want = np.zeros((h, w), np.uint8)
        cv2.polylines(want, [poly], True, 1, thickness=t)
        got = draw.polylines_mask(h, w, poly, t)
        n = int((got != want.astype(bool)).sum())
        rim += int(want.sum())
        residue += n
        if not _crosses(poly, h, w):
            inside_diff += n
    assert inside_diff == 0
    assert residue <= RESIDUE * rim, (residue, rim)


@pytest.mark.parametrize("hw", [(522, 775), (64, 80), (96, 128), (33, 47)])
def test_resize_cubic_matches_cv2(hw):
    h, w = hw
    src = np.random.default_rng(h).normal(
        0, 1, (h // 32 + 2, w // 32 + 2)).astype(np.float32)
    got = draw.resize_cubic(src, (w, h))
    assert got.shape == (h, w) and got.dtype == np.float32
    ipp = cv2.ipp.useIPP()
    try:
        cv2.ipp.setUseIPP(False)
        plain = cv2.resize(src, (w, h), interpolation=cv2.INTER_CUBIC)
        cv2.ipp.setUseIPP(True)
        fast = cv2.resize(src, (w, h), interpolation=cv2.INTER_CUBIC)
    finally:
        cv2.ipp.setUseIPP(ipp)
    assert np.abs(got - plain).max() <= 2e-7 * np.abs(plain).max()
    assert np.abs(got - fast).max() <= 1e-5 * np.abs(fast).max()


# ---------------------------------------------------------------------------
# the dataset against tests/make_dataset.py
# ---------------------------------------------------------------------------

class _Residue:
    """Records, while the port's generator runs, each hard image's
    polyline residue: the pixels where ``draw.polylines`` and
    ``cv2.polylines`` of the same call differ, and the rim pixels OpenCV
    paints in all."""

    def __init__(self, monkeypatch):
        self.rim = 0
        self.images = []
        real_poly, real_image = draw.polylines, t_make.make_image_hard

        def polylines(img, poly, color, thickness):
            want = np.zeros(img.shape[:2], np.uint8)
            cv2.polylines(want, [np.asarray(poly, np.int32)], True, 1,
                          thickness=thickness)
            self.rim += int(want.sum())
            self.images[-1] |= draw.polylines_mask(
                img.shape[0], img.shape[1], poly, thickness) != want.astype(
                    bool)
            real_poly(img, poly, color, thickness)

        def make_image_hard(rng, h, w):
            self.images.append(np.zeros((h, w), bool))
            return real_image(rng, h, w)

        monkeypatch.setattr(draw, "polylines", polylines)
        monkeypatch.setattr(t_make, "make_image_hard", make_image_hard)

    def by_file(self, kw):
        """Each image file's residue, by its path under the root (the
        generator draws the splits' images in this order)."""
        names = [f"{split}/images/{split}_{i:02d}.png"
                 for split in ("train", "val", "testA", "testB")
                 for i in range(kw.get(f"n_{split}", 0))]
        assert len(names) == len(self.images)
        return dict(zip(names, self.images))


def _compare_trees(a, b, hard, residue=None):
    """Masks and point CSVs equal, easy images equal; for hard images the
    samples that differ lie on a polyline residue pixel or are 1 level
    apart, and those are at most ``ROUNDING`` of all samples.  Returns
    the number of files."""
    files = sorted(p.relative_to(a) for p in Path(a).rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(b) for p in Path(b).rglob("*")
                           if p.is_file())
    rounding = samples = 0
    for f in files:
        if f.suffix == ".csv":
            assert (a / f).read_bytes() == (b / f).read_bytes(), f
        elif "masks" in f.parts:
            want = cv2.imread(str(a / f), cv2.IMREAD_GRAYSCALE)
            assert np.array_equal(codec.imread_mask(b / f), want), f
            assert set(np.unique(want)) <= {0, 1}
        else:
            want = cv2.cvtColor(cv2.imread(str(a / f)), cv2.COLOR_BGR2RGB)
            got = codec.imread_rgb(b / f)
            if not hard:
                assert np.array_equal(got, want), f
                continue
            d = np.abs(got.astype(int) - want.astype(int))
            off = (d > 0) & ~residue[str(f)][..., None]
            assert d[off].max(initial=0) <= 1, f
            rounding += int(off.sum())
            samples += d.size
    assert rounding <= ROUNDING * max(samples, 1), (rounding, samples)
    return len(files)


def _check_residue(rec):
    residue = sum(int(r.sum()) for r in rec.images)
    assert residue <= RESIDUE * rec.rim, (residue, rec.rim)


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("seed", range(10))
def test_make_dataset_matches_repository(tmp_path, monkeypatch, hard, seed):
    hw = (64, 80) if seed % 2 else [(64, 80), (48, 72), (72, 56)]
    kw = dict(n_train=2, n_val=1, hw=hw, seed=seed, hard=hard, n_testA=1,
              n_testB=1)
    j_make.make_dataset(tmp_path / "j", **kw)
    rec = _Residue(monkeypatch)
    t_make.make_dataset(tmp_path / "t", **kw)
    residue = rec.by_file(kw) if hard else None
    assert _compare_trees(tmp_path / "j", tmp_path / "t", hard,
                          residue) == 5 * 2 + 2
    if hard:
        _check_residue(rec)


def test_hard_images_at_glas_size_match_repository(tmp_path, monkeypatch):
    """Two 522x775 hard images, compared after decoding both PNGs."""
    kw = dict(n_train=1, n_val=1, hw=(522, 775), seed=3, hard=True,
              with_points=False)
    j_make.make_dataset(tmp_path / "j", **kw)
    rec = _Residue(monkeypatch)
    t_make.make_dataset(tmp_path / "t", **kw)
    assert _compare_trees(tmp_path / "j", tmp_path / "t", True,
                          rec.by_file(kw)) == 4
    _check_residue(rec)
