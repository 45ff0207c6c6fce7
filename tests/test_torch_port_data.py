"""The port's data layer against cv2 and the JAX package, on the CPU.

- ``data/codec.py`` decodes byte-equal to ``cv2.imread`` (colour, then
  BGR -> RGB, and grayscale) on PNGs that cv2 writes, on PNGs that
  ``write_png`` writes with each row filter, on palette and gray + alpha
  PNGs, and on BMPs that cv2 and numpy write; its PNG and BMP encoders
  give files that cv2 reads back as the image (the BMP byte-equal to
  cv2's), and ``imwrite`` picks the format from the suffix;
- ``ops/train_resize.py`` is bitwise equal to ``cv2.resize`` (INTER_LINEAR
  on uint8, INTER_NEAREST on masks) and, as ``apply_resize``, to the JAX
  package's ``apply_resize`` and to ``place_on_canvas`` of the cv2 resize;
- the datasets and ``CanvasBatcher`` give batches ``np.array_equal`` in
  every key (and dtype) to the JAX package's, the cases of
  tests/test_loader.py and tests/test_train_resize.py run against the
  port;
- the port's training entry point imports with cv2, matplotlib, pandas,
  jax and ``wesup_tpu`` hidden.

Every comparison here is exact: the port's decode and resize are integer
arithmetic that reproduces cv2's, and the loader is numpy.
"""

import struct
import subprocess
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).parent.parent))
from make_dataset import make_dataset  # noqa: E402

from wesup_tpu.data import datasets as j_datasets  # noqa: E402
from wesup_tpu.data import loader as j_loader  # noqa: E402
from wesup_tpu.ops import train_resize as j_resize  # noqa: E402
from wesup_tpu_torch.data import codec  # noqa: E402
from wesup_tpu_torch.data import datasets as t_datasets  # noqa: E402
from wesup_tpu_torch.data import loader as t_loader  # noqa: E402
from wesup_tpu_torch.ops import train_resize as t_resize  # noqa: E402


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _image(seed=0, hw=(61, 83)):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, hw + (3,), np.uint8)
    img[:20, :20] = 100        # gray pixels take libpng's own branch
    smooth = cv2.GaussianBlur(img, (9, 9), 3)
    img[hw[0] // 2:] = smooth[hw[0] // 2:]
    return img


def _assert_reads_like_cv2(path):
    want_rgb = cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR),
                            cv2.COLOR_BGR2RGB)
    want_gray = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    got_rgb, got_gray = codec.imread_rgb(path), codec.imread_mask(path)
    assert got_rgb.dtype == np.uint8 and got_gray.dtype == np.uint8
    np.testing.assert_array_equal(got_rgb, want_rgb)
    np.testing.assert_array_equal(got_gray, want_gray)


def _png_chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _raw_png(path, pix, ctype, palette=None):
    """An unfiltered PNG of ``pix`` ((H, W, C) uint8) at colour type
    ``ctype``: the kinds that neither cv2 nor write_png produce."""
    h, w = pix.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), pix.reshape(h, -1)], 1)
    body = _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                           0))
    if palette is not None:
        body += _png_chunk(b"PLTE", palette.tobytes())
    body += _png_chunk(b"IDAT", zlib.compress(raw.tobytes()))
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + body
                           + _png_chunk(b"IEND", b""))


def _bmp32(path, rgb, top_down):
    """An uncompressed (BI_RGB) 32-bit BMP, written with numpy."""
    h, w = rgb.shape[:2]
    px = np.dstack([rgb[..., ::-1], np.full((h, w, 1), 255, np.uint8)])
    data = (px if top_down else px[::-1]).tobytes()
    header = (b"BM" + struct.pack("<IHHI", 54 + len(data), 0, 0, 54)
              + struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1,
                            32, 0, len(data), 2835, 2835, 0, 0))
    Path(path).write_bytes(header + data)


@pytest.mark.parametrize("kind", ["rgb", "gray", "rgba"])
def test_codec_reads_cv2_pngs(tmp_path, kind):
    img = _image()
    arr = {"rgb": cv2.cvtColor(img, cv2.COLOR_RGB2BGR), "gray": img[..., 0],
           "rgba": np.dstack([img[..., ::-1], img[..., :1]])}[kind]
    path = tmp_path / f"{kind}.png"
    cv2.imwrite(str(path), arr)
    _assert_reads_like_cv2(path)


@pytest.mark.parametrize("row_filter", [0, 1, 2, 3, 4, None])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_codec_reads_write_png(tmp_path, row_filter, channels):
    img = _image(seed=1)
    arr = {1: img[..., 1], 3: img, 4: np.dstack([img, img[..., 2:]])}[channels]
    path = tmp_path / "w.png"
    codec.write_png(path, arr, row_filter)
    _assert_reads_like_cv2(path)
    if channels != 4:
        np.testing.assert_array_equal(
            codec.imread_mask(path) if channels == 1
            else codec.imread_rgb(path), arr)


def test_codec_reads_palette_and_gray_alpha_pngs(tmp_path):
    rng = np.random.default_rng(2)
    palette = rng.integers(0, 256, (16, 3), np.uint8)
    _raw_png(tmp_path / "p.png", rng.integers(0, 16, (20, 30, 1), np.uint8),
             3, palette)
    _assert_reads_like_cv2(tmp_path / "p.png")
    _raw_png(tmp_path / "ga.png", _image()[..., :2], 4)
    _assert_reads_like_cv2(tmp_path / "ga.png")


def test_codec_reads_bmps(tmp_path):
    img = _image(seed=3, hw=(37, 53))   # rows padded to 4 bytes
    cv2.imwrite(str(tmp_path / "c24.bmp"), cv2.cvtColor(img,
                                                        cv2.COLOR_RGB2BGR))
    cv2.imwrite(str(tmp_path / "c8.bmp"), img[..., 0])
    _bmp32(tmp_path / "up.bmp", img, top_down=False)
    _bmp32(tmp_path / "down.bmp", img, top_down=True)
    for name in ("c24.bmp", "c8.bmp", "up.bmp", "down.bmp"):
        _assert_reads_like_cv2(tmp_path / name)
    assert codec.image_size(tmp_path / "c24.bmp") == (37, 53)


def test_codec_refuses_what_it_cannot_decode(tmp_path):
    cv2.imwrite(str(tmp_path / "a.jpg"), _image())
    with pytest.raises(ValueError, match="a.jpg.*ROADMAP"):
        codec.imread_rgb(tmp_path / "a.jpg")
    _raw_png(tmp_path / "16.png", np.zeros((4, 4, 2), np.uint8), 0)
    data = bytearray((tmp_path / "16.png").read_bytes())
    data[24] = 16                                   # bit depth 16
    (tmp_path / "16.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="bit depth 16"):
        codec.imread_mask(tmp_path / "16.png")
    with pytest.raises(FileNotFoundError):
        codec.imread_rgb(tmp_path / "missing.png")
    assert codec.image_size(tmp_path / "a.jpg") is None


@pytest.mark.parametrize("hw", [(37, 53), (1, 1), (6, 8)])
@pytest.mark.parametrize("channels", [1, 3])
def test_codec_encodes_like_cv2(hw, channels):
    """encode_png and encode_bmp decode under cv2.imread to the image they
    were given (colour as RGB); the BMP's bytes are cv2.imwrite's."""
    img = _image(seed=4, hw=hw) if min(hw) > 8 else np.random.default_rng(
        4).integers(0, 256, hw + (3,), np.uint8)
    arr = img[..., 0] if channels == 1 else img
    as_cv2 = arr if channels == 1 else cv2.cvtColor(arr, cv2.COLOR_RGB2BGR)
    for data in (codec.encode_png(arr), codec.encode_bmp(arr)):
        got = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, as_cv2)
        np.testing.assert_array_equal(codec.decode(data, gray=channels == 1),
                                      arr)
    assert codec.encode_bmp(arr) == cv2.imencode(".bmp", as_cv2)[1].tobytes()


def test_imwrite_picks_the_format_from_the_suffix(tmp_path):
    mask = (_image(seed=5)[..., 0] > 127).astype(np.uint8) * 255
    for name, magic in (("m.png", b"\x89PNG"), ("m.bmp", b"BM"),
                        ("M.BMP", b"BM"), ("m.PNG", b"\x89PNG")):
        codec.imwrite(tmp_path / name, mask)
        assert (tmp_path / name).read_bytes()[:len(magic)] == magic
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / name), cv2.IMREAD_GRAYSCALE), mask)
    for name in ("m.jpg", "m.tif", "m"):
        with pytest.raises(ValueError, match="only .png and .bmp"):
            codec.imwrite(tmp_path / name, mask)
        assert not (tmp_path / name).exists()
    with pytest.raises(ValueError, match="uint8"):
        codec.encode_bmp(mask.astype(np.int32))
    with pytest.raises(ValueError, match="corrupt or truncated"):
        codec.decode(codec.encode_bmp(mask)[:20], name="cut")


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

def test_resize_matches_cv2_over_a_sweep():
    """Seeded sizes and scales 0.3-1.0, exact halves among them (where
    cv2 switches to INTER_AREA, which the fixed-point taps reproduce)."""
    rng = np.random.default_rng(0)
    for k in range(60):
        h0, w0 = int(rng.integers(8, 200)), int(rng.integers(8, 200))
        s = float(rng.uniform(0.3, 1.0))
        th, tw = int(np.ceil(s * h0)), int(np.ceil(s * w0))
        if k % 10 == 0:
            th, tw = h0 // 2, w0 // 2
        img = rng.integers(0, 256, (h0, w0, 3), np.uint8)
        mask = rng.integers(0, 3, (h0, w0), np.int32)
        np.testing.assert_array_equal(
            t_resize.resize_img(img, (th, tw)),
            cv2.resize(img, (tw, th), interpolation=cv2.INTER_LINEAR))
        got = t_resize.resize_mask(mask, (th, tw))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(
            got, cv2.resize(mask, (tw, th), interpolation=cv2.INTER_NEAREST))


def _stack_items(items):
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def _cache_from(imgs, masks):
    h0 = max(i.shape[0] for i in imgs)
    w0 = max(i.shape[1] for i in imgs)
    c = {"imgs": np.zeros((len(imgs), h0, w0, 3), np.uint8),
         "masks": np.zeros((len(imgs), h0, w0), np.int8)}
    for i, (im, m) in enumerate(zip(imgs, masks)):
        c["imgs"][i, :im.shape[0], :im.shape[1]] = im
        c["masks"][i, :m.shape[0], :m.shape[1]] = m
    return c


def test_apply_resize_matches_jax_and_cv2():
    """Random full-res shapes and shrink targets mixed in one batch, one
    identity scale and a batch-padding blank (zero image, mask -1)."""
    import jax

    rng = np.random.default_rng(4)
    spec = t_loader.CanvasSpec(96, 128)
    imgs, masks, metas, hosts = [], [], [], []
    for i in range(6):
        h0, w0 = int(rng.integers(40, 200)), int(rng.integers(40, 200))
        s = float(rng.uniform(0.3, 0.45)) if i else 1.0
        th, tw = int(np.ceil(s * h0)), int(np.ceil(s * w0))
        if i == 0:
            h0, w0 = th, tw = 33, 47
        img = rng.integers(0, 256, (h0, w0, 3), np.uint8)
        mask = rng.integers(0, 2, (h0, w0), np.int32)
        imgs.append(img)
        masks.append(mask)
        metas.append(t_loader.place_meta_on_canvas(
            {"img_idx": i, "full_hw": (h0, w0), "target_hw": (th, tw),
             "points": None, "use_mask_as_points": False}, spec))
        hosts.append(t_loader.place_on_canvas(
            {"image": cv2.resize(img, (tw, th),
                                 interpolation=cv2.INTER_LINEAR),
             "pixel_mask": cv2.resize(mask.astype(np.uint8), (tw, th),
                                      interpolation=cv2.INTER_NEAREST
                                      ).astype(np.int32),
             "points": None, "use_mask_as_points": False}, spec))
    metas.append(t_loader._blank_meta_item(spec))
    batch = _stack_items(metas)
    cache = _cache_from(imgs, masks)

    got_img, got_mask = t_resize.apply_resize(
        {k: torch.from_numpy(v) for k, v in cache.items()},
        {k: torch.from_numpy(v) for k, v in batch.items()})
    got_img, got_mask = got_img.numpy(), got_mask.numpy()
    want_img, want_mask = jax.jit(j_resize.apply_resize)(cache, batch)
    np.testing.assert_array_equal(got_img, np.asarray(want_img))
    np.testing.assert_array_equal(got_mask, np.asarray(want_mask))
    assert got_img.dtype == np.uint8 and got_mask.dtype == np.int32
    for b, host in enumerate(hosts):
        np.testing.assert_array_equal(got_img[b], host["image"])
        np.testing.assert_array_equal(got_mask[b],
                                      host["pixel_mask"].astype(np.int32))
    assert (got_img[-1] == 0).all() and (got_mask[-1] == -1).all()


def test_resize_vectors_and_build_cache_match_jax():
    for full, target, canvas in (((33, 47), (33, 47), (48, 64)),
                                 ((522, 775), (183, 272), (192, 288)),
                                 ((1, 1), (0, 0), (32, 32))):
        got = t_resize.resize_vectors(full, target, canvas)
        want = j_resize.resize_vectors(full, target, canvas)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype

    class FakeDS:
        contour = False

        def __init__(self, masks):
            self._m = masks

        def __len__(self):
            return len(self._m)

        def full_res_item(self, i):
            return {"image": np.full((8, 8, 3), i, np.uint8),
                    "pixel_mask": self._m[i]}

    ok = t_resize.build_cache(FakeDS([np.zeros((8, 8), np.int32)] * 2))
    want = j_resize.build_cache(FakeDS([np.zeros((8, 8), np.int32)] * 2))
    for k in ("imgs", "masks"):
        np.testing.assert_array_equal(ok[k], want[k])
    assert t_resize.build_cache(
        FakeDS([np.full((8, 8), 255, np.int32)])) is None
    assert t_resize.build_cache(FakeDS([None])) is None
    assert t_resize.build_cache(
        FakeDS([np.zeros((8, 8), np.int32)]), max_bytes=10) is None


# ---------------------------------------------------------------------------
# datasets and loader
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_loader_ds")
    make_dataset(root, n_train=6, n_val=2, hw=[(60, 84), (96, 128)])
    # a DigestPath negative image: no points, its mask used as the points
    cv2.imwrite(str(root / "train" / "images" / "negative-01.png"),
                np.full((70, 90, 3), 200, np.uint8))
    cv2.imwrite(str(root / "train" / "masks" / "negative-01.png"),
                np.zeros((70, 90), np.uint8))
    (root / "train" / "points" / "negative-01.csv").write_text("")
    return root


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


CLASSES = ["SegmentationDataset", "PointSupervisionDataset",
           "Digest2019PointDataset"]


@pytest.mark.parametrize("device_resize", [False, True])
@pytest.mark.parametrize("bucket", [False, True])
@pytest.mark.parametrize("cls", CLASSES)
def test_batches_match_jax(dataset_root, cls, bucket, device_resize):
    """Shuffled over 2 epochs, with shard_multiple=2 and proportion=0.5
    (5 of the 7 images are PointSupervision-shaped; the negative image
    takes the Digest convention)."""
    out = []
    for m_ds, m_ld in ((t_datasets, t_loader), (j_datasets, j_loader)):
        ds = getattr(m_ds, cls)(dataset_root / "train",
                                multiscale_range=(0.3, 0.6), seed=3,
                                proportion=0.5)
        ds.device_resize = device_resize
        bat = m_ld.CanvasBatcher(ds, m_ld.CanvasSpec(64, 96), batch_size=2,
                                 shuffle=True, seed=0, bucket=bucket,
                                 shard_multiple=2)
        out.append([b for e in range(2) for b in bat.epoch_iter(e)])
    _assert_batches_equal(*out)


@pytest.mark.parametrize("cls", CLASSES)
def test_samples_and_canvas_match_jax(dataset_root, cls):
    kw = {"rescale_factor": 0.5, "train": False}
    t_ds = getattr(t_datasets, cls)(dataset_root / "train", **kw)
    j_ds = getattr(j_datasets, cls)(dataset_root / "train", **kw)
    assert len(t_ds) == len(j_ds) == 7
    assert (vars(t_loader.infer_canvas(t_ds))
            == vars(j_loader.infer_canvas(j_ds)))
    for i in range(len(t_ds)):
        got, want = t_ds[i], j_ds[i]
        assert got.keys() == want.keys()
        for k in got:
            if isinstance(want[k], np.ndarray):
                np.testing.assert_array_equal(got[k], want[k])
            else:
                assert got[k] == want[k]
        spec = t_loader.CanvasSpec(64, 96)
        _assert_batches_equal([t_loader.place_on_canvas(got, spec)],
                              [j_loader.place_on_canvas(want, spec)])
    neg = t_ds[t_ds.img_paths.index(dataset_root / "train" / "images"
                                    / "negative-01.png")]
    if cls == "Digest2019PointDataset":
        assert neg["use_mask_as_points"]
        np.testing.assert_array_equal(neg["points"], [[0, 0, 0]])


def test_contour_and_area_datasets_match_jax(dataset_root, tmp_path):
    kw = {"rescale_factor": 0.5, "train": False}
    t_ds = t_datasets.SegmentationDataset(dataset_root / "val", contour=True,
                                          **kw)
    j_ds = j_datasets.SegmentationDataset(dataset_root / "val", contour=True,
                                          **kw)
    for i in range(len(t_ds)):
        np.testing.assert_array_equal(t_ds[i]["contour"], j_ds[i]["contour"])
    root = dataset_root / "val"
    names = sorted(p.name for p in (root / "images").iterdir())
    (root / "area.csv").write_text("img,area\n" + "".join(
        f"{n},{0.1 * (i + 1)}\n" for i, n in enumerate(names)))
    try:
        for constraint in ("equality", "individual", "common"):
            t = t_datasets.AreaConstraintDataset(root, constraint=constraint,
                                                 rescale_factor=0.5)
            j = j_datasets.AreaConstraintDataset(root, constraint=constraint,
                                                 rescale_factor=0.5)
            for i in range(len(t)):
                np.testing.assert_array_equal(t[i]["area"], j[i]["area"])
    finally:
        (root / "area.csv").unlink()


def test_loader_cases_of_the_jax_suite(dataset_root):
    """tests/test_loader.py's cases on the port: padding of the last
    batch, shard-multiple padding, the learnt bucket-mode length,
    deterministic shuffles, proportion = seeded shuffle, slice, sort."""
    ds = t_datasets.SegmentationDataset(dataset_root / "train",
                                        multiscale_range=(0.3, 0.4))
    batches = list(t_loader.CanvasBatcher(ds, t_loader.CanvasSpec(64, 64),
                                          batch_size=2))
    assert len(batches) == 4 and batches[-1]["sample_valid"].tolist() == [
        True, False]
    assert not batches[-1]["valid"][1].any()
    sharded = t_loader.CanvasBatcher(ds, t_loader.CanvasSpec(64, 64),
                                     batch_size=3, shard_multiple=4)
    assert sharded.effective_batch_size == 4
    assert sum(int(b["sample_valid"].sum()) for b in sharded) == len(ds)
    bucketed = t_loader.CanvasBatcher(ds, t_loader.CanvasSpec(64, 64),
                                      batch_size=2, bucket=True)
    n = len(list(bucketed))
    assert len(bucketed) == n  # exact after the first epoch

    val = t_datasets.SegmentationDataset(dataset_root / "val",
                                         rescale_factor=0.5, train=False)
    sums = [[b["image"].sum() for b in t_loader.CanvasBatcher(
        val, t_loader.CanvasSpec(64, 64), shuffle=True, seed=3)]
        for _ in range(2)]
    assert sums[0] == sums[1]
    sub = t_datasets.SegmentationDataset(dataset_root / "train",
                                         proportion=0.6, seed=0)
    np.random.seed(0)
    picked = np.arange(7)
    np.random.shuffle(picked)
    np.testing.assert_array_equal(sub.picked, np.sort(picked[:4]))


def _canvas_hw(batch):
    if "image" in batch:
        return tuple(batch["image"].shape[1:3])
    return (batch["rsz_iy"].shape[1], batch["rsz_ix"].shape[1])


def test_bucketed_device_batches_group_like_host(dataset_root):
    """tests/test_train_resize.py's case on the port: in device-resize mode
    the bucket comes from the TARGET size, so batches group as on the
    host path."""
    def batches(device_mode):
        ds = t_datasets.PointSupervisionDataset(
            dataset_root / "train", multiscale_range=(0.3, 0.6), seed=3)
        ds.device_resize = device_mode
        bat = t_loader.CanvasBatcher(ds, t_loader.CanvasSpec(96, 128),
                                     batch_size=2, shuffle=True, seed=0,
                                     bucket=True)
        return [(_canvas_hw(b), b["content_hw"].tolist(),
                 b["sample_valid"].tolist()) for b in bat.epoch_iter(0)]

    assert batches(True) == batches(False)


# ---------------------------------------------------------------------------
# imports on a machine without cv2, matplotlib, pandas or jax
# ---------------------------------------------------------------------------

def test_train_entry_point_imports_without_cv2_plotting_or_jax():
    code = (
        "import sys\n"
        "for m in ('cv2', 'matplotlib', 'pandas', 'PIL', 'jax', 'flax',\n"
        "          'optax', 'wesup_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import wesup_tpu_torch.train\n"
        "from wesup_tpu_torch.data import codec, datasets, loader\n"
        "from wesup_tpu_torch.models import base, convert, trainer\n"
        "from wesup_tpu_torch.utils import history, record\n"
        "from wesup_tpu_torch.ops import train_resize\n"
        "import wesup_tpu_torch.serve\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=str(Path(__file__).parent.parent))
    assert res.returncode == 0, res.stderr
