"""The port's small tools against the repository's scripts, on the CPU.

Each tool of ``wesup_tpu_torch/scripts`` runs beside the root script of
the same name (``scripts/``, which need OpenCV and joblib, installed
here) on the same small inputs, and they must write the same files:

- ``count_points``: the same float;
- ``visualize_masks``, ``paint_masks``, ``visualize_points``: byte-equal
  PNGs (``data/codec.py`` writes ``cv2.imwrite``'s bytes;
  ``data/draw.circles`` is ``cv2.circle``);
- ``generate_patches``: byte-equal patches from the same state of numpy's
  global generator, and its CLI's 12 patches an image;
- ``generate_spl_masks``: byte-equal ``.npy`` files (the port's SLIC on
  the CPU against JAX's);
- ``search_slic_params``: the same printed oracle accuracies at each
  (sp_area, compactness) (cv2's resizes against ``ops/train_resize``);
- ``measure_connectivity``: the segs, the island statistics, both
  probability maps of the A/B and the figures made from them against the
  JAX script's functions and JAX's SLIC and bf16 forward on the same
  images, with a classifier spread so that the A/B moves the predictions
  (the limits at the test).

None of the port's tools imports cv2, joblib or JAX
(``test_no_tool_imports_opencv_joblib_or_jax``).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).parent.parent))
sys.path.insert(0, str(Path(__file__).parent.parent / "scripts"))

from make_dataset import make_dataset  # noqa: E402

from torch_threads import worker_threads  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
TOOLS = ("count_points", "visualize_masks", "paint_masks",
         "visualize_points", "generate_patches", "generate_spl_masks",
         "search_slic_params", "measure_connectivity", "profile_ops",
         "profile_train_step", "profile_epoch")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("port_tools"), n_train=3,
                        n_val=1, hw=(64, 80))


def _root_main(module, argv, monkeypatch):
    """Run a root script's ``main`` (which reads ``sys.argv``)."""
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(sys, "argv", [module] + [str(a) for a in argv])
    return mod.main()


def _same_files(a: Path, b: Path):
    names = sorted(p.name for p in a.iterdir())
    assert names and names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_no_tool_imports_opencv_joblib_or_jax():
    code = ("import sys, importlib\n"
            "for m in ('cv2', 'joblib', 'jax', 'wesup_tpu', 'sklearn'):\n"
            "    sys.modules[m] = None\n"
            f"for t in {TOOLS!r}:\n"
            "    importlib.import_module('wesup_tpu_torch.scripts.' + t)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-1500:]


def test_count_points(dataset, monkeypatch, capsys):
    from wesup_tpu_torch.scripts import count_points

    points = dataset / "train" / "points"
    _root_main("count_points", [points], monkeypatch)
    want = capsys.readouterr().out
    count_points.main([str(points)])
    got = capsys.readouterr().out
    assert got == want and float(got) > 0


def test_visualize_masks(dataset, tmp_path, monkeypatch):
    from wesup_tpu_torch.scripts import visualize_masks

    masks = dataset / "train" / "masks"
    _root_main("visualize_masks", [masks, "-o", tmp_path / "root"],
               monkeypatch)
    visualize_masks.main([str(masks), "-o", str(tmp_path / "port")])
    _same_files(tmp_path / "root", tmp_path / "port")


def test_paint_masks(dataset, tmp_path, monkeypatch, capsys):
    """Predictions: the ground truths with a band cleared (a gland cut in
    two) and a spurious disc, so that matched, split and unmatched
    instances all occur."""
    import cv2

    from wesup_tpu_torch.scripts import paint_masks

    gt = dataset / "train" / "masks"
    pred = tmp_path / "pred"
    pred.mkdir()
    for p in sorted(gt.iterdir()):
        m = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
        m[:, 38:41] = 0
        cv2.circle(m, (8, 8), 4, 1, -1)
        cv2.imwrite(str(pred / p.name), m)
    _root_main("paint_masks", [pred, gt, "-m", "net", "-o", tmp_path / "root"],
               monkeypatch)
    want = capsys.readouterr().out
    paint_masks.main([str(pred), str(gt), "-m", "net", "-o",
                      str(tmp_path / "port")])
    assert capsys.readouterr().out == want
    _same_files(tmp_path / "root", tmp_path / "port")
    np.testing.assert_array_equal(paint_masks.PALETTE,
                                  __import__("paint_masks").PALETTE)


def test_visualize_points(dataset, tmp_path, monkeypatch):
    from wesup_tpu_torch.scripts import visualize_points

    points = dataset / "train" / "points"
    _root_main("visualize_points", [points, "-r", 3, "-o", tmp_path / "root"],
               monkeypatch)
    visualize_points.main([str(points), "-r", "3", "-o",
                           str(tmp_path / "port")])
    _same_files(tmp_path / "root", tmp_path / "port")


def test_generate_patches(dataset, tmp_path, monkeypatch):
    import generate_patches as root_gp

    from wesup_tpu_torch.scripts import generate_patches

    train = dataset / "train"
    pairs = list(zip(sorted((train / "images").iterdir()),
                     sorted((train / "masks").iterdir())))
    for name, fn in (("root", root_gp.process_img_and_mask),
                     ("port", generate_patches.process_img_and_mask)):
        out = tmp_path / name
        (out / "images").mkdir(parents=True)
        (out / "masks").mkdir()
        np.random.seed(5)
        for ip, mp in pairs:
            fn(ip, mp, out / "images", out / "masks", 24)
    for sub in ("images", "masks"):
        _same_files(tmp_path / "root" / sub, tmp_path / "port" / sub)
    # the CLI, over the process pool
    generate_patches.main([str(train), "-o", str(tmp_path / "cli"), "-p",
                           "24"])
    assert len(list((tmp_path / "cli" / "images").iterdir())) == 12 * 3
    assert len(list((tmp_path / "cli" / "masks").iterdir())) == 12 * 3


def test_generate_spl_masks(dataset, tmp_path, monkeypatch):
    import shutil

    from wesup_tpu_torch.scripts import generate_spl_masks

    roots = {}
    for name in ("root", "port"):
        roots[name] = tmp_path / name
        shutil.copytree(dataset / "train", roots[name])
        (roots[name] / "points").rename(roots[name] / "points-0.001")
    _root_main("generate_spl_masks", [roots["root"], "--sp-area", 100],
               monkeypatch)
    generate_spl_masks.main([str(roots["port"]), "--sp-area", "100",
                             "--device", "cpu"])
    _same_files(roots["root"] / "spl-masks-0.001",
                roots["port"] / "spl-masks-0.001")
    spl = np.load(next((roots["port"] / "spl-masks-0.001").iterdir()))
    assert spl.shape == (64, 80, 2) and spl.any()


def test_search_slic_params(dataset, monkeypatch, capsys):
    from wesup_tpu_torch.scripts import search_slic_params

    argv = [dataset / "train", "-r", "0.5", "-a", "50,100", "-c", "20,40"]
    _root_main("search_slic_params", argv, monkeypatch)
    want = capsys.readouterr().out
    got = search_slic_params.main([str(a) for a in argv]
                                  + ["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert len(got) == 4 and all(0.5 < acc <= 1.0 for *_, acc in got)


def _spread_head(params, feats, real):
    """``params`` with the classifier scaled so that the superpixels'
    foreground-minus-background logits over ``feats`` (those of the real
    superpixels) spread with a standard deviation of 3, centred on 0: a
    fresh init puts every superpixel within about 1e-5 of one probability,
    where a forward that ignored its seg would look right."""
    import jax

    params = jax.tree.map(np.asarray, params)
    w, b = params["cls"]["w"], params["cls"]["b"]
    d = (feats.astype(np.float64) @ (w[:, 1] - w[:, 0]))[real]
    s = 3.0 / d.std()
    b = b.copy()
    b[1] = b[0] - s * np.median(d)
    params["cls"] = {"w": (w * s).astype(np.float32),
                     "b": b.astype(np.float32)}
    return params


# the superpixel forward's bf16 limit on probabilities (see
# test_torch_port_infer.py)
BF16_PROB = 3e-2


def test_measure_connectivity_matches_jax(tmp_path):
    """The port's run at 96x128 against the JAX script's pipeline on the
    same images: its canvas (cv2's resizes), JAX's SLIC in its jit, the
    script's ``island_stats`` and ``enforce_connectivity``, and JAX's bf16
    adjoint forward.  The weights are ``init_params(PRNGKey(0))`` with the
    classifier spread by :func:`_spread_head`, passed to the port as a
    ``--ckpt`` record, so the A/B moves the probabilities by far more than
    the two packages' bf16 forwards differ.

    The segs must be equal, and with them every island statistic.  Both
    probability maps of each image (with the production seg and with the
    enforced one) are held against JAX's within ``BF16_PROB`` (measured: at
    most 1.6e-2); JAX's A/B must move some pixel by more than twice that
    (measured: 0.80 and 0.90), so a port whose second forward ignored the
    enforced seg, or returned a constant, fails.  ``pred_mean_abs_delta``
    (measured: 0.033 and 0.029) is held within 10% of JAX's (measured:
    within 3.1%), ``pred_changed_px_pct`` and the two Dice within what the
    pixels that lie within ``BF16_PROB`` of 0.5 in JAX's maps could change
    (measured: the changed shares equal)."""
    import jax
    import jax.numpy as jnp
    import torch
    import measure_connectivity as root_mc

    from wesup_tpu.config import WESUPConfig
    from wesup_tpu.data.datasets import resize_img, resize_mask
    from wesup_tpu.models import wesup as j_wesup
    from wesup_tpu.ops.slic import n_clusters, slic
    from wesup_tpu_torch.data import codec
    from wesup_tpu_torch.models.convert import from_jax_params
    from wesup_tpu_torch.scripts import measure_connectivity
    from wesup_tpu_torch.scripts.make_dataset import make_dataset as mk

    n, hw = 2, (96, 128)
    root = tmp_path / "ds"
    mk(root, n_train=1, n_val=n, hw=hw, seed=7, hard=True)
    config = WESUPConfig()
    th, tw = 48, 64
    Hc, Wc = 64, 64
    K = n_clusters(Hc, Wc, config.sp_area)

    @jax.jit
    def seg_of(image_u8, valid):
        img = image_u8.astype(jnp.float32) / 255.0
        return jax.vmap(lambda i, v: slic(
            i, v, sp_area=config.sp_area, compactness=config.sp_compactness,
            n_iters=config.slic_iters,
            update_stride=config.slic_update_stride))(img, valid)

    @jax.jit
    def forward(params, image_u8, valid, seg):
        img = image_u8.astype(jnp.float32) / 255.0
        out = j_wesup.forward_superpixel(params, img, seg, K, valid,
                                         jnp.bfloat16, pooling="adjoint",
                                         plan=None)
        return out.pred, out.sp_features

    images = sorted((root / "val" / "images").iterdir())
    masks = sorted((root / "val" / "masks").iterdir())
    canvases, segs, enfs = [], [], []
    for ip in images:
        img = resize_img(codec.imread_rgb(ip), (th, tw))
        canvas = np.zeros((Hc, Wc, 3), np.uint8)
        canvas[:th, :tw] = img
        canvas[:th, tw:] = img[:, -1:]
        canvas[th:] = canvas[th - 1:th]
        valid = np.zeros((Hc, Wc), bool)
        valid[:th, :tw] = True
        canvases.append((jnp.asarray(canvas[None]), jnp.asarray(valid[None])))
        jseg = np.asarray(seg_of(*canvases[-1]))[0]
        enf = jseg.copy()
        enf[:th, :tw] = root_mc.enforce_connectivity(jseg[:th, :tw])
        segs.append(jseg)
        enfs.append(enf)

    params = j_wesup.init_params(jax.random.PRNGKey(0))
    feats = [np.asarray(forward(params, *c, jnp.asarray(s[None]))[1],
                        np.float32)[0] for c, s in zip(canvases, segs)]
    real = [np.isin(np.arange(K), s[:th, :tw]) for s in segs]
    params = _spread_head(params, np.concatenate(feats),
                          np.concatenate(real))
    ckpt = tmp_path / "rec" / "checkpoints" / "ckpt.0001.pth"
    ckpt.parent.mkdir(parents=True)
    torch.save({"model_state_dict": from_jax_params(params)}, ckpt)

    args = measure_connectivity.parse_args([
        "--n", str(n), "--hw", *map(str, hw), "--device", "cpu", "--root",
        str(root), "--ckpt", str(tmp_path / "rec"), "--out",
        str(tmp_path / "out.json")])
    report, got_segs, got_preds = measure_connectivity.run(args)
    assert report["canvas"] == [Hc, Wc] and report["K"] == K
    assert report["trained"] and len(report["images"]) == n

    def dice(pred, mask):
        p, m = pred > 0.5, mask > 0
        return 2.0 * (p & m).sum() / max(p.sum() + m.sum(), 1)

    for i, got in enumerate(report["images"]):
        np.testing.assert_array_equal(got_segs[i], segs[i])
        stats = root_mc.island_stats(segs[i][:th, :tw], config.sp_area)
        assert {k: got[k] for k in stats} == stats
        pa, pb = (np.asarray(forward(params, *canvases[i], jnp.asarray(
            s[None]))[0], np.float32)[0, :th, :tw]
            for s in (segs[i], enfs[i]))
        assert np.abs(pa - pb).max() > 2 * BF16_PROB, "the A/B moves nothing"
        for g, w in zip(got_preds[i], (pa, pb)):
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= BF16_PROB
        delta = float(np.abs(pa - pb).mean())
        assert abs(got["pred_mean_abs_delta"] - delta) <= 0.1 * delta
        near = ((np.abs(pa - 0.5) <= BF16_PROB)
                | (np.abs(pb - 0.5) <= BF16_PROB))
        changed = 100.0 * float(np.mean((pa > 0.5) != (pb > 0.5)))
        assert abs(got["pred_changed_px_pct"] - changed) <= (
            100.0 * near.mean() + 1e-4)
        mask = resize_mask(codec.imread_mask(masks[i]), (th, tw))
        for key, p in (("dice_ours", pa), ("dice_enforced", pb)):
            # k flipped pixels move 2|P & M| by at most 2k and |P| + |M| by
            # at most k
            k = int(near.sum())
            den = int((p > 0.5).sum() + (mask > 0).sum())
            assert abs(got[key] - dice(p, mask)) <= (
                3.0 * k / max(den - k, 1) + 1e-5)
