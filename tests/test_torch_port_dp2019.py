"""The port's DigestPath2019 pipeline against the repository's, on the CPU.

``wesup_tpu_torch.test_dp2019_pipeline`` beside the root
``test_dp2019_pipeline.py`` (cv2 and joblib), on two JPEG slides
(``positive-00``, ``negative-00``) whose sides are not multiples of the
patch size:

- ``split_patches`` writes the same patch files, byte for byte (JPEG
  images and PNG masks), and the same ``info.csv``; a second call skips;
- ``main --skip-infer`` on identical result masks writes the same
  combined masks and prints the same Accuracy and Dice lines;
- ``combine_single``, ``oa`` and ``dice`` agree with the script's;
- ``-m fcn`` fails where the model is built, as in the script;
- one run with inference (``--device cpu``, superpixel and ``--pixel``)
  writes a {0, 255} mask per slide at the slide's size.
"""

import contextlib
import io
import shutil
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from torch_threads import worker_threads  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import test_dp2019_pipeline as j_dp  # noqa: E402

from wesup_tpu_torch import infer as t_infer  # noqa: E402
from wesup_tpu_torch import pixel_infer as t_pixel_infer  # noqa: E402
from wesup_tpu_torch import test_dp2019_pipeline as t_dp  # noqa: E402
from wesup_tpu_torch.models import initialize_trainer  # noqa: E402

SLIDES = {"positive-00": (120, 150), "negative-00": (131, 97)}
PATCH = 60


def _slides(root: Path, seed=0):
    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir(parents=True)
    for stem, (h, w) in SLIDES.items():
        y, x = np.mgrid[0:h, 0:w]
        img = np.stack([x * 255 // w, y * 255 // h, (x ^ y) & 255], -1)
        img = np.clip(img + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(
            np.uint8)
        mask = ((x - w / 2) ** 2 + (y - h / 2) ** 2 < (min(h, w) / 3) ** 2)
        cv2.imwrite(str(root / "images" / f"{stem}.jpg"), img)
        cv2.imwrite(str(root / "masks" / f"{stem}.png"),
                    mask.astype(np.uint8) * 255)
    return root


@pytest.fixture()
def two_roots(tmp_path):
    """The same slides under ``jax/dp`` and ``port/dp``."""
    _slides(tmp_path / "jax" / "dp")
    shutil.copytree(tmp_path / "jax" / "dp", tmp_path / "port" / "dp")
    return tmp_path / "jax" / "dp", tmp_path / "port" / "dp"


def _files(d: Path):
    return {p.relative_to(d).as_posix(): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def test_split_patches_writes_the_scripts_files(two_roots, capsys):
    j_root, t_root = two_roots
    j_out = j_dp.split_patches(j_root, PATCH)
    t_out = t_dp.split_patches(t_root, PATCH)
    want, got = _files(j_out), _files(t_out)
    assert got.keys() == want.keys()
    assert len(want) == 2 * (2 * 3 + 3 * 2) + 1      # padded grids + csv
    for name in want:
        assert got[name] == want[name], name
    assert (t_out / "info.csv").read_text() == (j_out / "info.csv").read_text()
    capsys.readouterr()
    assert t_dp.split_patches(t_root, PATCH) == t_out
    assert "Skipping" in capsys.readouterr().out


def _results(root: Path, seed=1):
    """Random {0, 255} result masks for every patch, under a record dir
    beside the data, and the checkpoint path the scripts take."""
    ckpt = root.parent / "rec" / "checkpoints" / "ckpt.0001.pth"
    results = ckpt.parent.parent / f"results-for-{ckpt.name}"
    results.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for p in sorted((root.parent / f"{root.name}-patches" / "masks").glob(
            "*.png")):
        mask = (rng.random((PATCH, PATCH)) < 0.4).astype(np.uint8) * 255
        cv2.imwrite(str(results / p.name), mask)
    return ckpt


def _run(main, argv, monkeypatch=None):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if monkeypatch is not None:
            monkeypatch.setattr(sys, "argv", ["test_dp2019_pipeline.py"]
                                + argv)
            main()
        else:
            main(argv)
    return [line for line in out.getvalue().splitlines()
            if line.startswith(("Accuracy:", "Dice:"))]


@pytest.mark.parametrize("pixel", [False, True], ids=["superpixel", "pixel"])
def test_skip_infer_combines_and_scores_as_the_script(two_roots, monkeypatch,
                                                      pixel):
    j_root, t_root = two_roots
    j_dp.split_patches(j_root, PATCH)
    t_dp.split_patches(t_root, PATCH)
    j_ckpt, t_ckpt = _results(j_root), _results(t_root)
    flags = ["--skip-infer", "-p", str(PATCH)] + (["--pixel"] if pixel
                                                  else [])
    want = _run(j_dp.main, [str(j_root), "-c", str(j_ckpt)] + flags,
                monkeypatch)
    got = _run(t_dp.main, [str(t_root), "-c", str(t_ckpt)] + flags)
    assert len(want) == 4 and got == want
    tag = "combined-results-pixel" if pixel else "combined-results"
    j_comb = j_ckpt.parent.parent / f"{tag}-for-{j_ckpt.name}"
    t_comb = t_ckpt.parent.parent / f"{tag}-for-{t_ckpt.name}"
    assert _files(t_comb) == _files(j_comb)
    for stem, hw in SLIDES.items():
        assert cv2.imread(str(t_comb / f"{stem}.png"), 0).shape == hw


def test_combine_and_metrics_agree(two_roots):
    j_root, t_root = two_roots
    t_dp.split_patches(t_root, PATCH)
    patches = sorted((t_root.parent / "dp-patches" / "masks").glob("0-*"))
    h, w = SLIDES["negative-00"]      # sorted: negative-00 is slide 0
    got = t_dp.combine_single(patches, (h, w))
    want = j_dp.combine_single(patches, (h, w))
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    gt = cv2.imread(str(t_root / "masks" / "negative-00.png"), 0)
    np.testing.assert_array_equal(got, gt)
    rng = np.random.default_rng(2)
    pred = (rng.random(gt.shape) < 0.5).astype(np.uint8) * 255
    assert t_dp.oa(pred, gt) == j_dp.oa(pred, gt)
    assert t_dp.dice(pred, gt) == j_dp.dice(pred, gt)
    canvas = np.array([[-3.0, 0.5, 1.5, 254.5, 300.0]])
    np.testing.assert_array_equal(t_dp.as_written(canvas),
                                  [[0, 0, 2, 254, 255]])


def test_other_models_fail_as_the_script_does(two_roots, monkeypatch):
    j_root, t_root = two_roots
    argv = ["-m", "fcn", "-p", str(PATCH), "-c"]
    for root in two_roots:
        (root.parent / "r").mkdir()
    with pytest.raises(ValueError, match="Unsupported model: fcn"):
        monkeypatch.setattr(sys, "argv", ["x", str(j_root)] + argv
                            + [str(j_root.parent / "r" / "c" / "k.pth")])
        j_dp.main()
    with pytest.raises(ValueError, match="Unsupported model: fcn"):
        t_dp.main([str(t_root)] + argv
                  + [str(t_root.parent / "r" / "c" / "k.pth"), "--device",
                     "cpu"])


def test_pipeline_with_inference_on_the_cpu(tmp_path, monkeypatch):
    """The plumbing: a random-weight checkpoint (the head narrowed to 64
    wide, so the command's model is built at that width), both routes."""
    root = _slides(tmp_path / "dp", seed=3)
    ckpt = tmp_path / "rec" / "checkpoints" / "ckpt.0000.pth"
    narrow = dict(fc_width=64, device="cpu")
    initialize_trainer("wesup", **narrow).save_checkpoint(ckpt)

    def narrowed(model_type, device=None, **kwargs):
        return initialize_trainer(model_type, **{**kwargs, **narrow})

    for module in (t_infer, t_pixel_infer):
        monkeypatch.setattr(module, "initialize_trainer", narrowed)
    for flags, tag in (([], "combined-results"),
                       (["--pixel"], "combined-results-pixel")):
        lines = _run(t_dp.main, [str(root), "-c", str(ckpt), "-p",
                                 str(PATCH), "--device", "cpu"] + flags)
        assert len(lines) == 4
        out = tmp_path / "rec" / f"{tag}-for-{ckpt.name}"
        for stem, hw in SLIDES.items():
            mask = cv2.imread(str(out / f"{stem}.png"), 0)
            assert mask.shape == hw
            assert set(np.unique(mask)) <= {0, 255}
