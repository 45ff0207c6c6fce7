"""The port's pixel head, padded and tiled inference and the five inference
CLIs, against the JAX package on the CPU.

Same weights (``from_jax_params``, or one JAX ``.msgpack`` checkpoint that
both trainers load), same numpy inputs made from a seed, fc_width 64.  The
random classifier's foreground bias is shifted so that about half the
pixels of an image are foreground (:func:`_balanced`): unshifted, it gives
one class nearly everywhere, and equal masks would show nothing.  Every
mask comparison checks that the reference's masks hold both classes.
Tolerances, with the errors measured on this suite's inputs:

- f32: 2e-4 on probabilities and on the fc1 map (measured at most 9e-8
  and 1.2e-6: the two packages round the same f32 sums in another order);
- bf16 pixel head: 3e-2 on probabilities (the superpixel forward's bf16
  limit; measured at most 2.2e-4).  bf16 rounds each stage map, the fc1
  map and the head's activations, at the same points in both packages,
  which accumulate in another order.  A random head puts every pixel's
  probability within about 0.01 of 0.5, so that noise flips 0.5-0.7% of
  the rounded pixels; the masks are held (at least 0.999 equal, measured:
  all equal) on the pixels that JAX's own bf16 rounding cannot flip:
  those farther from 0.5 than JAX's bf16 map is from its f32 map
  (about 93% of them);
- masks (rounded predictions, stitched tiles, the CLIs' decoded output
  files), in f32: at least 0.999 of pixels equal (measured: all equal).
"""

import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_threads import worker_threads  # noqa: E402,F401

REPO = Path(__file__).parent.parent
sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(REPO))

from make_dataset import make_dataset  # noqa: E402

from wesup_tpu import inference as j_inf  # noqa: E402
from wesup_tpu.config import WESUPConfig as JConfig  # noqa: E402
from wesup_tpu.models import initialize_trainer as j_init  # noqa: E402
from wesup_tpu.models import steps as j_steps  # noqa: E402
from wesup_tpu.models import wesup as j_wesup  # noqa: E402
from wesup_tpu_torch import inference as t_inf  # noqa: E402
from wesup_tpu_torch.config import WESUPConfig  # noqa: E402
from wesup_tpu_torch.models import steps, wesup  # noqa: E402
from wesup_tpu_torch.models.convert import from_jax_params  # noqa: E402

FC_WIDTH = 64
SMALL = dict(compute_dtype="float32", sp_area=100, slic_iters=3)
F32_TOL = 2e-4
BF16_TOL = 3e-2


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(200, 30, shape), 0, 255).astype(np.uint8)


_j_forward_pixel = jax.jit(j_wesup.forward_pixel, static_argnums=2)
FORWARD_IMAGES = (2, 48, 64, 3)


def _balanced(params, img_f):
    """``params`` with the classifier's foreground bias lowered by the
    median foreground-minus-background logit of the pixel head over
    ``img_f``, so that half its pixels are foreground."""
    p = np.asarray(_j_forward_pixel(params, img_f, jnp.float32), np.float64)
    shift = np.median(np.log(p[..., 1]) - np.log(p[..., 0]))
    params = jax.tree.map(np.asarray, params)
    params["cls"]["b"] = params["cls"]["b"] - np.float32(shift) * np.array(
        [0, 1], np.float32)
    return params


@pytest.fixture(scope="module")
def weights():
    """The JAX parameters (those of a JAX trainer at seed 0, fc_width 64)
    balanced on :data:`FORWARD_IMAGES`, and the port's model holding
    them."""
    params = _balanced(
        j_wesup.init_params(jax.random.PRNGKey(0), fc_width=FC_WIDTH),
        jnp.asarray(_images(FORWARD_IMAGES, 0), jnp.float32) / 255.0)
    model = wesup.WESUP(fc_width=FC_WIDTH)
    model.load_state_dict(from_jax_params(params))
    return jax.tree.map(jnp.asarray, params), model.eval()


def _agree(got, want):
    """Share of equal pixels; ``want`` must hold two values (both classes
    of a mask)."""
    assert len(np.unique(np.asarray(want))) >= 2, "a one-class mask"
    return (np.asarray(got) == np.asarray(want)).mean()


# ---------------------------------------------------------------------------
# the pixel head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_pixel_matches_jax(weights, dtype):
    params, model = weights
    img = jnp.asarray(_images(FORWARD_IMAGES, 0), jnp.float32) / 255.0
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(_j_forward_pixel(params, img, jdt))
    with torch.inference_mode():
        got = wesup.forward_pixel(model, torch.from_numpy(np.array(img)),
                                  getattr(torch, dtype)).numpy()
    assert got.shape == want.shape == (2, 48, 64, 2)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want,
                               atol=F32_TOL if dtype == "float32"
                               else BF16_TOL)
    fg, want_fg = got[..., 1], want[..., 1]
    sure = np.ones(fg.shape, bool)
    if dtype == "bfloat16":
        # the masks are held where JAX's own bf16 rounding cannot flip
        # them: farther from 0.5 than its bf16 map is from its f32 map
        ref = np.asarray(_j_forward_pixel(params, img, jnp.float32))[..., 1]
        sure = np.abs(ref - 0.5) > np.abs(want_fg - ref).max()
        assert sure.mean() >= 0.5
    assert _agree(np.round(fg)[sure], np.round(want_fg)[sure]) >= 0.999


def test_hypercolumn_projection_matches_jax_and_naive(weights):
    params, model = weights
    img = _images((1, 32, 48, 3), 1).astype(np.float32) / 255.0
    want = np.asarray(j_wesup.hypercolumn_projection(params,
                                                     jnp.asarray(img)))
    naive = np.asarray(j_wesup.naive_hypercolumn(params, jnp.asarray(img))
                       @ params["fc1"]["w"] + params["fc1"]["b"])
    with torch.inference_mode():
        got = wesup.hypercolumn_projection(model,
                                           torch.from_numpy(img)).numpy()
    assert got.shape == (1, 32, 48, FC_WIDTH) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=F32_TOL)
    np.testing.assert_allclose(got, naive, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pixel_predict_step_matches_jax(weights, dtype):
    params, model = weights
    canvas = (32, 64)
    imgs = _images((2,) + canvas + (3,), 2)
    valid = np.ones((2,) + canvas, bool)
    want = np.asarray(j_steps.make_predict_step(
        JConfig(compute_dtype=dtype), canvas, "pixel")(
            params, jnp.asarray(imgs), jnp.asarray(valid)))
    got = steps.make_predict_step(WESUPConfig(compute_dtype=dtype), canvas,
                                  "pixel", device="cpu")(
        model, torch.from_numpy(imgs), torch.from_numpy(valid)).numpy()
    assert got.shape == want.shape == (2,) + canvas
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL)
        assert _agree(np.round(got), np.round(want)) >= 0.999
    else:
        np.testing.assert_allclose(got, want, atol=BF16_TOL)


def test_pixel_scaled_predict_step_matches_jax(weights):
    """Down with align_corners=True, edge padding to 32, crop, and the f32
    probability resized back unrounded."""
    params, model = weights
    content, target, canvas = (45, 70), (22, 35), (64, 96)
    imgs = _images((2,) + canvas + (3,), 3)
    cfg = dict(compute_dtype="float32")
    want = np.asarray(j_steps.make_scaled_predict_step(
        JConfig(**cfg), content, target, canvas, "pixel")(
            params, jnp.asarray(imgs)))
    got = steps.make_scaled_predict_step(
        WESUPConfig(**cfg), content, target, canvas, "pixel",
        device="cpu")(model, torch.from_numpy(imgs)).numpy()
    assert got.dtype == np.float32 and got.shape == (2,) + content
    np.testing.assert_allclose(got, want, atol=F32_TOL)


# ---------------------------------------------------------------------------
# the inference engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def predictors(weights):
    """(JAX, port) predictors by mode, shared so that JAX compiles each
    step shape once."""
    params, model = weights
    return {mode: (j_inf.Predictor(params, JConfig(**SMALL), mode=mode),
                   t_inf.Predictor(model, WESUPConfig(**SMALL), mode=mode,
                                   device="cpu"))
            for mode in ("superpixel", "pixel")}


@pytest.mark.parametrize("scales", [(0.5,), (0.5, 0.4)])
def test_pixel_multiscale_batch_matches_jax(predictors, scales):
    """Floored sizes, f32 probabilities summed over scales, rounded after
    the mean, no opening; chunks of 2 (and at one scale, a second image
    size)."""
    jp, tp = predictors["pixel"]
    imgs = [_images((50, 70, 3), s) for s in (5, 6, 7)]
    if len(scales) == 1:
        imgs.append(_images((41, 59, 3), 4))
    want = j_inf.predict_multiscale_batch(jp, imgs, scales=scales,
                                          max_batch=2)
    got = t_inf.predict_multiscale_batch(tp, imgs, scales=scales,
                                         max_batch=2)
    for g, w, img in zip(got, want, imgs):
        assert g.shape == w.shape == img.shape[:2]
        assert set(np.unique(g)) <= {0.0, 1.0}
        assert _agree(g, w) >= 0.999


@pytest.mark.parametrize("mode", ["superpixel", "pixel"])
def test_predict_padded_matches_jax(predictors, mode):
    """(2, 45, 50) floats pad both axes to a 64x64 canvas."""
    jp, tp = predictors[mode]
    imgs = _images((2, 45, 50, 3), 8).astype(np.float32) / 255.0
    want = jp.predict_padded(imgs)
    got = tp.predict_padded(imgs)
    assert got.shape == want.shape == (2, 45, 50)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=F32_TOL)


@pytest.mark.parametrize("hw,patch", [((500, 700), 300), ((64, 80), 48),
                                      ((48, 48), 48)])
def test_tiling_helpers_equal_jax(hw, patch):
    img = _images(hw + (3,), 9)
    assert (t_inf.get_top_left_coordinates(*hw, patch)
            == j_inf.get_top_left_coordinates(*hw, patch))
    patches = t_inf.divide_image_to_patches(img, patch)
    assert np.array_equal(patches, j_inf.divide_image_to_patches(img, patch))
    probs = np.random.default_rng(10).random(patches.shape[:3])
    for p in (probs, np.round(probs), probs[..., None].repeat(2, -1)):
        got = t_inf.combine_patches_to_image(p, *hw)
        assert np.array_equal(got, j_inf.combine_patches_to_image(p, *hw))
    with pytest.raises(ValueError, match="H, W, 3"):
        t_inf.divide_image_to_patches(img[..., 0], patch)


@pytest.mark.parametrize("mode", ["superpixel", "pixel"])
def test_predict_tiled_matches_jax(predictors, mode):
    """Six 48-pixel patches of a 64x80 image in chunks of 4 (one chunk in
    flight, then a chunk of 2), on 64x64 canvases."""
    jp, tp = predictors[mode]
    img = _images((64, 80, 3), 11)
    rounded = mode == "superpixel"
    want = j_inf.predict_tiled(jp, img, 48, chunk=4, round_patches=rounded)
    got = t_inf.predict_tiled(tp, img, 48, chunk=4, round_patches=rounded)
    assert got.shape == want.shape == (64, 80)
    if rounded:
        assert _agree(got, want) >= 0.999
    else:
        np.testing.assert_allclose(got, want, atol=F32_TOL)
        assert _agree(np.round(got), np.round(want)) >= 0.999


# ---------------------------------------------------------------------------
# the tile cut and stitch on the device (their plain versions here)
# ---------------------------------------------------------------------------

def _bits(a):
    a = np.asarray(a)
    return a.view({4: np.uint32, 8: np.uint64, 1: np.uint8}[a.itemsize])


@pytest.mark.parametrize("hw,chunk,shards,mode", [
    ((64, 80), 4, 1, "pixel"), ((48, 48), 4, 1, "superpixel"),
    ((64, 80), 5, 2, "superpixel")])
def test_tile_cut_equals_the_host_canvas(weights, monkeypatch, hw, chunk,
                                         shards, mode):
    """Each chunk's canvas and ``valid``, cut from the slide by
    ``dispatch_tiles``, equal bitwise those that ``predict_padded`` builds
    on the host from ``divide_image_to_patches``, on every data shard's
    rows.  Six 48-pixel patches of 64x80 in chunks of 5 over 2 shards
    leave a chunk of 1 padded to 2 rows, the second shard's blank."""
    from wesup_tpu_torch.parallel.mesh import Mesh

    img = _images(hw + (3,), 12)
    patches = t_inf.divide_image_to_patches(img, 48)
    for rank in range(shards):
        mesh = (Mesh(shards, 1, rank=rank, world_group=object())
                if shards > 1 else None)
        pred = t_inf.Predictor(weights[1], WESUPConfig(**SMALL), mode=mode,
                               device="cpu", mesh=mesh)
        host, dev = [], []
        monkeypatch.setattr(pred, "run_rows", lambda step, *a: (
            host.append(a) or torch.zeros(a[1].shape)))
        monkeypatch.setattr(pred, "gather", lambda out: out)
        monkeypatch.setattr(pred, "predict_step", lambda hw: (
            lambda model, canvas, valid: dev.append((canvas, valid))))
        grid = pred.tile_grid(hw, 48)
        slide = torch.from_numpy(img)
        for first in range(0, len(patches), chunk):
            block = patches[first:first + chunk]
            pred.predict_padded(block.astype(np.float32) / 255.0)
            pred.dispatch_tiles(slide, grid, first, len(block))
        assert len(host) == len(dev) == -(-len(patches) // chunk)
        for (canvas, valid), (got, got_valid) in zip(host, dev):
            rows = (mesh.data_rows(len(canvas)) if mesh is not None
                    else slice(None))
            assert got.dtype == torch.float32
            assert np.array_equal(_bits(got), _bits(canvas[rows]))
            if mode == "pixel":
                assert got_valid is None
            else:
                assert np.array_equal(got_valid.numpy(), valid[rows])


@pytest.mark.parametrize("hw,patch", [((500, 700), 300), ((64, 80), 48),
                                      ((48, 48), 48)])
@pytest.mark.parametrize("kind", ["float32", "rounded", "uint8"])
def test_plain_tile_stitch_equals_combine_patches(hw, patch, kind):
    """The stitch's plain version equals, bitwise,
    ``combine_patches_to_image`` on float32 probabilities, raw or rounded
    inside the stitch, and on rounded uint8 ones."""
    from wesup_tpu_torch.ops import tile

    tops, lefts = t_inf.patch_grid(*hw, patch)
    n = len(tops) * len(lefts)
    h, w = min(patch, hw[0]), min(patch, hw[1])
    probs = np.random.default_rng(13).random((n, h, w)).astype(np.float32)
    probs[:, 0, :3] = [0.5, 1.5, 2.5]                    # ties to even
    if kind == "uint8":
        probs = np.round(probs).astype(np.uint8)
    rounded = kind == "rounded"
    want = t_inf.combine_patches_to_image(
        np.round(probs) if rounded else probs, *hw)
    got = tile.stitch(torch.from_numpy(probs),
                      *(torch.from_numpy(a.astype(np.int32))
                        for a in (tops, lefts)), hw, rounded)
    assert got.dtype == torch.float64 and got.shape == hw
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("call", [
    lambda tile, s, t, l: tile.cut(s, t, l, 0, 0, 0, (48, 48), (64, 64)),
    lambda tile, s, t, l: tile.stitch(torch.zeros((4, 48, 48)), t, l,
                                      (0, 80)),
    lambda tile, s, t, l: tile.stitch(torch.zeros((4, 48, 48)), t, l,
                                      (64, 0))])
def test_tile_wrappers_refuse_empty_work(call):
    """A cut of no canvas rows and a stitch into an empty map raise, so
    no launch is counted that would not run."""
    from wesup_tpu_torch.ops import tile

    tops, lefts = (torch.from_numpy(a.astype(np.int32))
                   for a in t_inf.patch_grid(64, 80, 48))
    slide = torch.zeros((64, 80, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        call(tile, slide, tops, lefts)


@pytest.mark.parametrize("mode", ["superpixel", "pixel"])
def test_predict_tiled_equals_the_host_route(predictors, mode):
    """``predict_tiled`` equals, bitwise, ``combine_patches_to_image`` over
    ``predict_padded`` of ``divide_image_to_patches`` chunk by chunk (the
    route that cut, copied back and stitched on the host): six patches in
    chunks of 4, rounded in superpixel mode."""
    tp = predictors[mode][1]
    img = _images((64, 80, 3), 11)
    rounded = mode == "superpixel"
    patches = t_inf.divide_image_to_patches(img, 48)
    probs = np.concatenate([tp.predict_padded(
        patches[i:i + 4].astype(np.float32) / 255.0)
        for i in range(0, len(patches), 4)])
    want = t_inf.combine_patches_to_image(
        np.round(probs) if rounded else probs, 64, 80)
    got = t_inf.predict_tiled(tp, img, 48, chunk=4, round_patches=rounded)
    assert got.dtype == np.float64
    assert np.array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# the five CLIs against the repository's
# ---------------------------------------------------------------------------

CLI_CFG = dict(fc_width=FC_WIDTH, **SMALL)


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory, weights):
    """A dataset whose val, testA and testB images are BMP (as GlaS ships
    them), and a JAX trainer's checkpoint of the balanced weights, copied
    into one record directory per package (test_glas writes beside the
    checkpoint)."""
    import shutil

    root = tmp_path_factory.mktemp("port_infer_cli")
    make_dataset(root / "png", n_train=0, n_val=2, hw=(64, 80),
                 with_points=False, n_testA=2, n_testB=1, seed=3)
    for split in ("val", "testA", "testB"):
        (root / "bmp" / split / "images").mkdir(parents=True)
        for png in sorted((root / "png" / split / "images").iterdir()):
            cv2.imwrite(str(root / "bmp" / split / "images"
                            / f"{png.stem}.bmp"), cv2.imread(str(png)))
    jt = j_init("wesup", **CLI_CFG)
    jt.params = weights[0]
    ckpts = {}
    for side in ("jax", "port"):
        ckpts[side] = root / side / "rec" / "checkpoints" / "ckpt.0000.msgpack"
        if side == "jax":
            jt.save_checkpoint(ckpts[side], epoch=0)
        else:
            ckpts[side].parent.mkdir(parents=True)
            shutil.copy(ckpts["jax"], ckpts[side])
    return root / "bmp", ckpts, root


def _assert_same_outputs(port_dir, jax_dir, n, hw=(64, 80)):
    port = sorted(Path(port_dir).iterdir())
    ref = sorted(Path(jax_dir).iterdir())
    assert [p.name for p in port] == [p.name for p in ref] and len(port) == n
    for p, r in zip(port, ref):
        assert p.read_bytes()[:2] == r.read_bytes()[:2]     # same format
        got = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
        want = cv2.imread(str(r), cv2.IMREAD_UNCHANGED)
        assert got.shape == want.shape == hw and got.dtype == np.uint8
        assert set(np.unique(got)) <= {0, 255}
        assert _agree(got, want) >= 0.999


def test_infer_cli_matches_jax(cli_data):
    import infer as j_cli

    from wesup_tpu_torch import infer

    data, ckpts, root = cli_data
    j_cli.main(str(data / "val"), checkpoint=str(ckpts["jax"]),
               output_dir=str(root / "j_infer"), scales=(0.5, 0.4),
               **CLI_CFG)
    infer.main(str(data / "val"), checkpoint=str(ckpts["port"]),
               output_dir=str(root / "t_infer"), scales=(0.5, 0.4),
               device="cpu", **CLI_CFG)
    _assert_same_outputs(root / "t_infer", root / "j_infer", 2)
    assert all(p.suffix == ".png" for p in (root / "t_infer").iterdir())


def test_infer_tile_cli_matches_jax(cli_data):
    """BMP in, BMP out (the name is the image's), with the stitched
    average truncated to uint8."""
    import infer_tile as j_cli

    from wesup_tpu_torch import infer_tile

    data, ckpts, root = cli_data
    j_cli.main(str(data / "val"), patch_size=48, checkpoint=str(ckpts["jax"]),
               output_dir=str(root / "j_tile"), chunk=3, **CLI_CFG)
    infer_tile.main(str(data / "val"), patch_size=48,
                    checkpoint=str(ckpts["port"]),
                    output_dir=str(root / "t_tile"), chunk=3, device="cpu",
                    **CLI_CFG)
    _assert_same_outputs(root / "t_tile", root / "j_tile", 2)
    assert all(p.suffix == ".bmp" for p in (root / "t_tile").iterdir())


def test_pixel_infer_cli_matches_jax(cli_data):
    import pixel_infer as j_cli

    from wesup_tpu_torch import pixel_infer

    data, ckpts, root = cli_data
    j_cli.main(str(data / "val"), checkpoint=str(ckpts["jax"]), scales=0.5,
               **CLI_CFG)
    out = pixel_infer.main(str(data / "val"), checkpoint=str(ckpts["port"]),
                           scales=0.5, device="cpu", **CLI_CFG)
    assert out == root / "port" / "rec" / "results-pixel-0.5" / "val"
    _assert_same_outputs(out, root / "jax" / "rec" / "results-pixel-0.5"
                         / "val", 2)


def test_pixel_infer_tile_cli_matches_jax(cli_data):
    import pixel_infer_tile as j_cli

    from wesup_tpu_torch import pixel_infer_tile

    data, ckpts, root = cli_data
    j_cli.main(str(data / "val"), checkpoint=str(ckpts["jax"]),
               patch_size=48, output=str(root / "j_ptile"), chunk=3,
               **CLI_CFG)
    pixel_infer_tile.main(str(data / "val"), checkpoint=str(ckpts["port"]),
                          patch_size=48, output=str(root / "t_ptile"),
                          chunk=3, device="cpu", **CLI_CFG)
    _assert_same_outputs(root / "t_ptile", root / "j_ptile", 2)


def test_test_glas_matches_jax(cli_data):
    """testA and testB into <record>/results-1scale/ (the multi-scale
    fusion is held through ``infer`` above)."""
    import test_glas as j_cli

    from wesup_tpu_torch import test_glas

    data, ckpts, root = cli_data
    j_cli.test(ckpts["jax"], scales=(0.5,), data_root=data, **CLI_CFG)
    out = test_glas.test(ckpts["port"], scales=(0.5,), data_root=data,
                         device="cpu", **CLI_CFG)
    assert out == root / "port" / "rec" / "results-1scale"
    for split, n in (("testA", 2), ("testB", 1)):
        _assert_same_outputs(out / split, root / "jax" / "rec"
                             / "results-1scale" / split, n)


def test_cli_entry_points_raise_without_cuda(monkeypatch, cli_data):
    """Without ``device=``, every CLI runs on the card and raises here."""
    from wesup_tpu_torch import (infer, infer_tile, pixel_infer,
                                 pixel_infer_tile, test_glas)

    data, ckpts, root = cli_data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    val = str(data / "val")
    out = str(root / "never")
    for run in (lambda: infer.main(val, output_dir=out),
                lambda: infer_tile.main(val, output_dir=out),
                lambda: pixel_infer.main(val, output=out),
                lambda: pixel_infer_tile.main(val, output=out),
                lambda: test_glas.main(["-c", str(ckpts["port"]),
                                        "--data-root", str(data)])):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()


def test_cli_module_runs_as_a_script():
    """``python -m wesup_tpu_torch.infer`` parses its arguments and asks
    for the card (missing here)."""
    out = subprocess.run(
        [sys.executable, "-m", "wesup_tpu_torch.infer", "x", "scales=0.5"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and "CUDA" in out.stderr, out.stderr
