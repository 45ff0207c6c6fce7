"""The port's GlaS evaluation protocol against the JAX package and the
repository's scripts, on the CPU.

- the port's native library (``wesup_tpu_torch.native``, built from its own
  copy of the C++ source) bitwise equal to ``wesup_tpu.native`` and held
  against its plain scipy versions: the same labels (the native CCL numbers
  components in raster order, as ``scipy.ndimage.label`` does), the EDT
  within 1e-4 (f32 against f64), the Hausdorff distance within 1e-6 (the
  square root of an f32 squared distance against scipy's f64), the region
  flip equal, and 0 / ``inf`` for two empty / one empty side;
- the contest metrics (detection F1, object Dice, object Hausdorff) equal
  to ``wesup_tpu.utils.metrics`` within 1e-12: both run the same f64
  numpy on bitwise-equal labels and distances;
- ``evaluate_glas`` and ``evaluate_crag`` against ``scripts/`` on one tree:
  CSV header and index equal, values within 1e-12, the ``-new`` BMPs
  byte-equal (decoded PNGs equal: the two PNG encoders differ);
- ``generate_points`` CSVs byte-equal at ``--seed 0``; ``area.csv``
  parsed equal; ``prepare_glas``'s masks byte-equal, its per-grade val
  counts those of ``sklearn.train_test_split``, every ``train_`` name in
  exactly one split; the stratified allocation equal to sklearn's;
- a failed native build raises with the compiler's log;
- every new module imports, and the scripts run, with jax, ``wesup_tpu``,
  OpenCV, pandas, joblib and sklearn blocked;
- ``measure_eval_metrics``: the deferred and eager host metrics equal.

Masks are 60x80 (as tests/test_native.py) and 200x300, made with numpy
from seeds.
"""

import csv
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from wesup_tpu import native as j_native
from wesup_tpu.ops.morphology import flip_small_regions as j_flip
from wesup_tpu.utils import metrics as j_metrics
from wesup_tpu_torch import native
from wesup_tpu_torch.ops.morphology import flip_small_regions
from wesup_tpu_torch.utils import metrics

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"


def _random_mask(seed, h=60, w=80, p=0.3):
    """tests/test_native.py's masks: noise at density ``p`` and 3 disks."""
    rng = np.random.default_rng(seed)
    mask = rng.random((h, w)) < p
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(3):
        cy, cx, r = rng.integers(0, h), rng.integers(0, w), rng.integers(5, 15)
        mask |= (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
    return mask


def _glands(seed, h=200, w=300, n=(3, 9), jitter=0.0):
    """A gland-like mask: ``n`` ellipses, with a share ``jitter`` of its
    pixels flipped (a prediction's speckle)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    mask = np.zeros((h, w), np.uint8)
    for _ in range(int(rng.integers(*n))):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        ry, rx = rng.integers(8, 35, 2)
        mask[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1] = 1
    if jitter:
        mask[rng.random((h, w)) < jitter] ^= 1
    return mask


# ---------------------------------------------------------------------------
# the native library
# ---------------------------------------------------------------------------

MASKS = [(0, 60, 80), (1, 60, 80), (2, 60, 80), (7, 200, 300)]


@pytest.mark.parametrize("seed,h,w", MASKS)
def test_label8_matches_jax_and_plain(seed, h, w):
    mask = _random_mask(seed, h, w)
    got = native.label8(mask)
    assert got.dtype == np.int32 and got.max() > 1
    assert np.array_equal(got, j_native.label8(mask))
    want = native.label8_plain(mask)
    # the same partition, and in fact the same ids (raster order)
    for k in range(1, want.max() + 1):
        assert len(np.unique(got[want == k])) == 1
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed,h,w", [(0, 60, 80), (3, 60, 80),
                                      (8, 200, 300)])
def test_edt_matches_jax_and_plain(seed, h, w):
    mask = _random_mask(seed, h, w, p=0.05)
    got = native.edt_sq(mask)
    assert got.dtype == np.float32
    assert np.array_equal(got, j_native.edt_sq(mask))
    np.testing.assert_allclose(np.sqrt(got), np.sqrt(native.edt_sq_plain(mask)),
                               atol=1e-4)


@pytest.mark.parametrize("seed,h,w", [(0, 60, 80), (1, 60, 80), (5, 60, 80),
                                      (9, 200, 300)])
def test_hausdorff_matches_jax_and_plain(seed, h, w):
    a = _random_mask(seed, h, w, p=0.02)
    b = _random_mask(seed + 100, h, w, p=0.02)
    got = native.hausdorff(a, b)
    assert got == j_native.hausdorff(a, b)
    assert abs(got - native.hausdorff_plain(a, b)) < 1e-6


def test_hausdorff_empty_cases():
    z = np.zeros((10, 10), bool)
    o = np.zeros((10, 10), bool)
    o[5, 5] = True
    for fn in (native.hausdorff, native.hausdorff_plain):
        assert fn(z, z) == 0.0
        assert np.isinf(fn(z, o)) and np.isinf(fn(o, z))
        assert fn(o, o) == 0.0


@pytest.mark.parametrize("case", ["squares", "glands"])
def test_flip_small_regions_matches_jax_and_plain(case):
    if case == "squares":   # tests/test_native.py's case
        mask = np.zeros((100, 100), np.uint8)
        mask[10:60, 10:60] = 1
        mask[80:84, 80:84] = 1
        mask[30:34, 30:34] = 0
        threshold = 100
    else:
        mask = _glands(4, jitter=0.01)
        threshold = 50
    got = native.flip_small_regions(mask.copy(), threshold)
    assert np.array_equal(got, j_native.flip_small_regions(mask.copy(),
                                                           threshold))
    want = flip_small_regions(mask.copy(), threshold)
    assert np.array_equal(got, want)
    assert np.array_equal(want, j_flip(mask.copy(), threshold))
    assert not np.array_equal(got, mask)   # something was flipped


def test_failed_native_build_raises():
    """With ``CXX=false`` and an empty build directory the first use
    raises ``RuntimeError`` with the failed command; nothing falls back
    to scipy."""
    code = (
        "import sys, tempfile, pathlib, numpy as np\n"
        "import wesup_tpu_torch.native as n\n"
        "n.BUILD_DIR = pathlib.Path(tempfile.mkdtemp())\n"
        "try:\n"
        "    n.label8(np.ones((4, 4)))\n"
        "except RuntimeError as ex:\n"
        "    print('raised:', ex)\n"
        "    assert not list(n.BUILD_DIR.iterdir())\n"
        "    sys.exit(0)\n"
        "sys.exit('no error')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**_env(), "CXX": "false"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "raised: building wesup_native.cpp failed" in out.stdout
    assert "false " in out.stdout


# ---------------------------------------------------------------------------
# the contest metrics
# ---------------------------------------------------------------------------

def _pairs():
    """(prediction, ground truth) pairs: glands with speckle, shifted and
    merged glands, a prediction that misses everything, empty sides."""
    pairs = []
    for s in range(3):
        gt = _glands(10 + s)
        pred = np.roll(_glands(10 + s, jitter=5e-4), (3 * s, -2 * s), (0, 1))
        pairs.append((pred, gt))
    gt = _glands(20)
    pairs.append((_glands(21), gt))                 # unrelated glands
    pairs.append((np.zeros_like(gt), gt))           # empty prediction
    pairs.append((gt, np.zeros_like(gt)))           # empty ground truth
    pairs.append((np.zeros_like(gt), np.zeros_like(gt)))
    small = _random_mask(3, p=0.01) ^ _random_mask(4, p=0.01)
    pairs.append((small.astype(np.int32),
                  _random_mask(3, p=0.01).astype(np.uint8)))
    return pairs


@pytest.mark.parametrize("name", ["accuracy", "dice", "detection_f1",
                                  "object_dice", "hausdorff",
                                  "object_hausdorff"])
def test_metrics_match_jax(name):
    port, jax_fn = metrics.HOST_METRICS[name], getattr(j_metrics, name)
    vals = []
    for pred, gt in _pairs():
        got, want = port(pred, gt), jax_fn(pred, gt)
        assert type(got) is float
        if np.isinf(want):
            assert got == want
        else:
            assert abs(got - want) <= 1e-12, (name, got, want)
        vals.append(got)
    assert len(set(vals)) > 2, vals   # the pairs tell the metric's cases apart


# ---------------------------------------------------------------------------
# the scripts against the repository's
# ---------------------------------------------------------------------------

def _env():
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _run(args, cwd=REPO):
    out = subprocess.run([sys.executable, *map(str, args)], cwd=cwd,
                         capture_output=True, text=True, timeout=600,
                         env=_env())
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out.stdout


def _port(module, *args):
    return _run(["-m", f"wesup_tpu_torch.{module}", *args])


def _rows(path):
    with open(path, newline="") as fp:
        return list(csv.reader(fp))


@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    """Predictions (BMP, 0/255) and ground truth (PNG, 0/1) for testA and
    testB, and the same as PNG for CRAG: 3 images of 200x300 each."""
    root = tmp_path_factory.mktemp("port_eval")
    for split in ("testA", "testB"):
        (root / "preds" / split).mkdir(parents=True)
        (root / "gt" / split / "masks").mkdir(parents=True)
    (root / "crag" / "preds").mkdir(parents=True)
    (root / "crag" / "gt").mkdir(parents=True)
    for k, split in enumerate(("testA", "testB")):
        for i in range(3):
            s = 30 + 10 * k + i
            gt = _glands(s)
            pred = np.roll(_glands(s, jitter=0.01), (i, -i), (0, 1))
            name = f"{split}_{i}"
            cv2.imwrite(str(root / "gt" / split / "masks" / f"{name}.png"), gt)
            cv2.imwrite(str(root / "preds" / split / f"{name}.bmp"),
                        pred * 255)
            cv2.imwrite(str(root / "crag" / "gt" / f"{name}.png"), gt)
            cv2.imwrite(str(root / "crag" / "preds" / f"{name}.png"),
                        pred * 255)
    return root


def test_evaluate_glas_matches_the_repository_script(eval_tree, tmp_path):
    for who in ("repo", "port"):
        shutil.copytree(eval_tree / "preds", tmp_path / who / "preds")
    ref = _run([SCRIPTS / "evaluate_glas.py", tmp_path / "repo" / "preds",
                "--gt-root", eval_tree / "gt", "--threshold", "50"])
    got = _port("scripts.evaluate_glas", tmp_path / "port" / "preds",
                "--gt-root", eval_tree / "gt", "--threshold", "50")

    def means(text):
        return [float(line.split(":")[1]) for line in text.splitlines()
                if ":" in line]

    assert len(means(got)) == len(means(ref)) == 10
    np.testing.assert_allclose(means(got), means(ref), rtol=0, atol=1e-12)
    for split in ("testA", "testB"):
        want = _rows(tmp_path / "repo" / "preds" / f"{split}.csv")
        have = _rows(tmp_path / "port" / "preds" / f"{split}.csv")
        assert have[0] == want[0] == ["", "detection_f1", "object_dice",
                                      "object_hausdorff"]
        assert [r[0] for r in have] == [r[0] for r in want]
        np.testing.assert_allclose(
            np.array([r[1:] for r in have[1:]], float),
            np.array([r[1:] for r in want[1:]], float), rtol=0, atol=1e-12)
        new = {w: sorted((tmp_path / w / "preds-new" / split).iterdir())
               for w in ("repo", "port")}
        assert [p.name for p in new["port"]] == [p.name for p in new["repo"]]
        assert len(new["port"]) == 3
        for a, b in zip(new["port"], new["repo"]):
            assert a.read_bytes() == b.read_bytes(), a.name


def test_evaluate_crag_matches_the_repository_script(eval_tree, tmp_path):
    for who in ("repo", "port"):
        shutil.copytree(eval_tree / "crag" / "preds", tmp_path / who / "preds")
    ref = _run([SCRIPTS / "evaluate_crag.py", tmp_path / "repo" / "preds",
                "--gt-root", eval_tree / "crag" / "gt", "--threshold", "60"])
    got = _port("scripts.evaluate_crag", tmp_path / "port" / "preds",
                "--gt-root", eval_tree / "crag" / "gt", "--threshold", "60")
    pick = [line for line in ref.splitlines() if ":" in line]
    assert [line.split(":")[0] for line in got.splitlines() if ":" in line] \
        == [line.split(":")[0] for line in pick]
    np.testing.assert_allclose(
        [float(line.split(":")[1]) for line in got.splitlines()
         if ":" in line],
        [float(line.split(":")[1]) for line in pick], rtol=0, atol=1e-12)
    from wesup_tpu_torch.data import codec

    new = {w: sorted((tmp_path / w / "preds-new").iterdir())
           for w in ("repo", "port")}
    assert [p.name for p in new["port"]] == [p.name for p in new["repo"]]
    for a, b in zip(new["port"], new["repo"]):
        assert np.array_equal(codec.imread_mask(a), codec.imread_mask(b))


@pytest.fixture(scope="module")
def mask_root(tmp_path_factory):
    """``masks/`` of 4 gland masks (PNG, classes 0/1) and one with a third
    class, for the point and area tools."""
    root = tmp_path_factory.mktemp("port_points")
    (root / "masks").mkdir()
    for i in range(4):
        cv2.imwrite(str(root / "masks" / f"m{i}.png"), _glands(50 + i))
    three = _glands(60)
    three[:40, :60] = 2
    cv2.imwrite(str(root / "masks" / "m4.png"), three)
    return root


def test_generate_points_byte_equal(mask_root, tmp_path):
    for who in ("repo", "port"):
        shutil.copytree(mask_root, tmp_path / who)
    _run([SCRIPTS / "generate_points.py", tmp_path / "repo", "-p", "1e-3",
          "--seed", "0"])
    _port("scripts.generate_points", tmp_path / "port", "-p", "1e-3",
          "--seed", "0")
    ref = sorted((tmp_path / "repo" / "points-0.001").iterdir())
    got = sorted((tmp_path / "port" / "points-0.001").iterdir())
    assert [p.name for p in got] == [p.name for p in ref] == [
        f"m{i}.csv" for i in range(5)]
    for a, b in zip(got, ref):
        assert a.read_bytes() == b.read_bytes(), a.name
    rows = _rows(got[4])
    assert {r[2] for r in rows} == {"0", "1", "2"} and len(rows) > 20


def test_generate_area_parsed_equal(mask_root, tmp_path):
    for who in ("repo", "port"):
        shutil.copytree(mask_root, tmp_path / who)
    _run([SCRIPTS / "generate_area.py", tmp_path / "repo"])
    _port("scripts.generate_area", tmp_path / "port")
    want = _rows(tmp_path / "repo" / "area.csv")
    got = _rows(tmp_path / "port" / "area.csv")
    assert got[0] == want[0] == ["", "img", "area"]
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert [float(r[2]) for r in got[1:]] == [float(r[2]) for r in want[1:]]


# ---------------------------------------------------------------------------
# prepare_glas
# ---------------------------------------------------------------------------

GRADES = {"train": ["benign"] * 9 + ["malignant"] * 11,
          "testA": ["malignant", "benign", "benign"],
          "testB": ["benign", "malignant"]}


@pytest.fixture(scope="module")
def raw_glas(tmp_path_factory):
    """A raw GlaS-layout directory: ``<split>_<i>.bmp`` images, their
    ``_anno.bmp`` instance masks (gland ids 1..n, as GlaS ships them) and
    ``Grade.csv`` with GlaS's four columns, grades interleaved."""
    root = tmp_path_factory.mktemp("raw_glas")
    rng = np.random.default_rng(5)
    lines = ["name, patient ID,grade (GlaS),grade (Sirinukunwattana et al. "
             "2015)"]
    for split, grades in GRADES.items():
        order = rng.permutation(len(grades)) if split == "train" else \
            range(len(grades))
        for i in order:
            name = f"{split}_{i + 1}"
            img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
            anno = _glands(70 + i, 48, 64, n=(2, 5)).astype(np.uint8)
            anno[anno > 0] = rng.integers(1, 9, int(anno.sum()))
            cv2.imwrite(str(root / f"{name}.bmp"), img)
            cv2.imwrite(str(root / f"{name}_anno.bmp"), anno)
            grade = grades[i]
            lines.append(f"{name},{i % 5},{grade},{'adeno' + grade[:3]}")
    (root / "Grade.csv").write_text("\n".join(lines) + "\n")
    return root


def test_prepare_glas_matches_the_repository_script(raw_glas, tmp_path):
    _run([REPO / "prepare_glas.py", raw_glas, "-o", tmp_path / "repo"])
    _port("prepare_glas", raw_glas, "-o", tmp_path / "port", "--seed", "0")
    grade = {}
    for line in (raw_glas / "Grade.csv").read_text().splitlines()[1:]:
        name, _, _, g = line.split(",")
        grade[name] = g

    def layout(root):
        return {split: sorted(p.name for p in (root / split / "masks")
                              .iterdir())
                for split in ("train", "val", "testA", "testB")}

    ref, got = layout(tmp_path / "repo"), layout(tmp_path / "port")
    for split in ("testA", "testB"):
        assert got[split] == ref[split]
    train_names = {f"train_{i + 1}.bmp" for i in range(20)}
    assert sorted(got["train"] + got["val"]) == sorted(train_names)
    assert not set(got["train"]) & set(got["val"])

    from sklearn.model_selection import train_test_split

    names = sorted(train_names)
    y = [grade[n[:-4]] for n in names]
    _, val, _, _ = train_test_split(names, y, test_size=0.1, stratify=y,
                                    random_state=0)

    def counts(files):
        return sorted(np.unique([grade[f[:-4]] for f in files],
                                return_counts=True)[1].tolist())

    assert counts(got["val"]) == counts(ref["val"]) == counts(val)
    # each image and binarised mask byte-equal to the repository's copy,
    # wherever its random split put it
    for split, files in got.items():
        for f in files:
            where = next(s for s in ref if f in ref[s])
            for kind in ("images", "masks"):
                assert ((tmp_path / "port" / split / kind / f).read_bytes()
                        == (tmp_path / "repo" / where / kind / f)
                        .read_bytes()), (split, kind, f)
    mask = cv2.imread(str(tmp_path / "port" / "testA" / "masks"
                          / "testA_1.bmp"), cv2.IMREAD_GRAYSCALE)
    assert set(np.unique(mask)) == {0, 1}


@pytest.mark.parametrize("class_counts,test_size", [
    ((9, 11), 0.1), ((37, 48), 0.1), ((3, 5, 12), 0.25), ((30, 7), 0.2)])
def test_stratified_split_allocates_as_sklearn(class_counts, test_size):
    from sklearn.model_selection import StratifiedShuffleSplit

    from wesup_tpu_torch.prepare_glas import stratified_split

    y = np.repeat(np.arange(len(class_counts)), class_counts)
    np.random.default_rng(1).shuffle(y)
    want = set()
    for seed in range(4):
        split = StratifiedShuffleSplit(1, test_size=test_size,
                                       random_state=seed)
        train, test = next(split.split(np.zeros(len(y)), y))
        want.add((tuple(np.bincount(y[train])), tuple(np.bincount(y[test]))))
    assert len(want) == 1          # no tie: the allocation is fixed
    for seed in range(4):
        train, test = stratified_split(y, test_size,
                                       np.random.default_rng(seed))
        assert not set(train) & set(test)
        assert len(train) + len(test) == len(y)
        got = (tuple(np.bincount(y[train])), tuple(np.bincount(y[test])))
        assert {got} == want


# ---------------------------------------------------------------------------
# without jax, wesup_tpu, OpenCV, pandas, joblib and sklearn
# ---------------------------------------------------------------------------

NEW_MODULES = ("native", "utils.metrics", "ops.morphology", "models.base",
               "models.trainer", "train", "prepare_glas", "scripts",
               "scripts._common", "scripts.generate_points",
               "scripts.generate_area", "scripts.evaluate_glas",
               "scripts.evaluate_crag", "scripts.evaluate_pdl1",
               "scripts.measure_eval_metrics", "data.draw",
               "scripts.make_dataset", "scripts.quality_protocol",
               "scripts.quality_ablation", "scripts.quality_sweep")
BLOCKED = ("jax", "wesup_tpu", "cv2", "pandas", "joblib", "sklearn")


def test_new_modules_run_without_jax_opencv_pandas_joblib_sklearn(
        eval_tree, raw_glas, mask_root, tmp_path):
    """Each new module imports with those packages blocked, and
    prepare_glas, generate_points and evaluate_glas (with forked
    workers), the metrics and make_dataset (easy and hard) run there."""
    shutil.copytree(eval_tree / "preds", tmp_path / "preds")
    shutil.copytree(mask_root, tmp_path / "pts")
    code = f"""
import importlib, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None         # any import of these now fails
for m in {NEW_MODULES!r}:
    importlib.import_module("wesup_tpu_torch." + m)
from wesup_tpu_torch import prepare_glas
from wesup_tpu_torch.scripts import evaluate_glas, generate_points
from wesup_tpu_torch.utils import metrics
import numpy as np
a = np.zeros((20, 30), np.uint8); a[2:8, 3:9] = 1; a[12:18, 20:28] = 1
b = np.roll(a, 2, 0)
print("metrics", [metrics.HOST_METRICS[n](a, b) for n in metrics.HOST_METRICS])
prepare_glas.main([{str(raw_glas)!r}, "-o", {str(tmp_path / 'data')!r},
                   "--seed", "1"])
generate_points.main([{str(tmp_path / 'pts')!r}, "--seed", "0"])
evaluate_glas.main([{str(tmp_path / 'preds')!r}, "--gt-root",
                    {str(eval_tree / 'gt')!r}, "--threshold", "50"])
from wesup_tpu_torch.scripts.make_dataset import make_dataset
for hard in (False, True):
    make_dataset({str(tmp_path / 'synth')!r} + str(hard), n_train=1, n_val=1,
                 hw=(48, 64), hard=hard, n_testA=1)
bad = [m for m in sys.modules if sys.modules[m] is not None
       and m.split(".")[0] in {BLOCKED!r}]
assert not bad, bad
print("done")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=_env())
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert out.stdout.rstrip().endswith("done")
    assert (tmp_path / "preds" / "testB.csv").exists()
    assert len(list((tmp_path / "pts" / "points-0.0001").iterdir())) == 5
    assert len(list((tmp_path / "data" / "val" / "masks").iterdir())) == 2
    for hard in ("False", "True"):
        assert len(list(Path(f"{tmp_path / 'synth'}{hard}").rglob(
            "*.png"))) == 6


# ---------------------------------------------------------------------------
# measure_eval_metrics
# ---------------------------------------------------------------------------

def test_measure_eval_metrics_deferred_equals_eager(tmp_path):
    from wesup_tpu_torch.scripts import measure_eval_metrics as mem

    root = mem.write_dataset(tmp_path / "ds", n_train=2, n_val=3,
                             hw=(64, 80), seed=0)
    cfg = dict(canvas_size=(48, 64), slic_iters=2, compute_dtype="float32",
               sp_area=100, fc_width=64)
    runs = {label: mem.time_val_phase(root, m, eager, repeats=1,
                                      device="cpu", **cfg)
            for label, m, eager in mem.VARIANTS}
    default, deferred, eager = (runs[v[0]] for v in mem.VARIANTS)
    assert default[2:] == ({}, 0)          # nothing read back
    assert deferred[3] == eager[3] == 3    # one read per val batch
    assert deferred[2] == eager[2] and "object_dice" in deferred[2]
