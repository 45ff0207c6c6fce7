"""The PyTorch port's predict steps, inference and server, on the CPU.

End to end against the JAX package (same weights through
``from_jax_params``, same numpy inputs), plus the port's own rules: it
imports neither jax nor ``wesup_tpu``, and its entry points raise instead of
running on the CPU when no CUDA device is present and none was asked for.
"""

import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch_threads import worker_threads  # noqa: E402,F401

REPO = Path(__file__).parent.parent
sys.path.insert(0, str(REPO))

from wesup_tpu.config import WESUPConfig as JConfig  # noqa: E402
from wesup_tpu.inference import Predictor as JPredictor  # noqa: E402
from wesup_tpu.inference import predict_multiscale_batch as j_pmb  # noqa: E402
from wesup_tpu.models import steps as j_steps  # noqa: E402
from wesup_tpu.models import wesup as j_wesup  # noqa: E402
from wesup_tpu_torch import serve  # noqa: E402
from wesup_tpu_torch.config import WESUPConfig  # noqa: E402
from wesup_tpu_torch.inference import (Predictor,  # noqa: E402
                                       predict_multiscale_batch)
from wesup_tpu_torch.models import steps, wesup  # noqa: E402
from wesup_tpu_torch.models.convert import from_jax_params  # noqa: E402
import torch_predict_host_fuse as host_fuse  # noqa: E402

FC_WIDTH = 64


@pytest.fixture(scope="module")
def weights():
    params = j_wesup.init_params(jax.random.PRNGKey(0), fc_width=FC_WIDTH)
    model = wesup.WESUP(fc_width=FC_WIDTH)
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    return params, model.eval()


def _bench_batch(B, H, W, content, seed=0):
    rng = np.random.default_rng(seed)
    imgs = np.clip(rng.normal(200, 25, (B, H, W, 3)), 0, 255).astype(np.uint8)
    valid = np.zeros((B, H, W), bool)
    valid[:, :content[0], :content[1]] = True
    return imgs, valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_predict_step_matches_jax(weights, dtype):
    """Measured max |pred| difference: f32 6.0e-8; bf16 2.0e-3 (one bf16
    step near 0.5, from the bf16 paint); rounded masks 100% equal.  The
    bf16 bound is the forward's stated 3e-2."""
    params, model = weights
    canvas = (64, 160)
    imgs, valid = _bench_batch(2, *canvas, (58, 141))
    want = np.asarray(j_steps.make_predict_step(
        JConfig(compute_dtype=dtype), canvas, "superpixel")(
            params, jnp.asarray(imgs), jnp.asarray(valid)))
    step = steps.make_predict_step(WESUPConfig(compute_dtype=dtype), canvas,
                                   "superpixel", device="cpu")
    got = step(model, torch.from_numpy(imgs), torch.from_numpy(valid)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    tol = 2e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got, want, atol=tol)
    assert (np.round(got) == np.round(want)).mean() >= 0.999


def test_make_scaled_predict_step_matches_jax(weights):
    params, model = weights
    content, target, canvas = (70, 150), (35, 75), (96, 160)
    imgs, _ = _bench_batch(2, *canvas, content, seed=1)
    cfg = dict(compute_dtype="float32")
    want = np.asarray(j_steps.make_scaled_predict_step(
        JConfig(**cfg), content, target, canvas, "superpixel")(
            params, jnp.asarray(imgs)))
    got = steps.make_scaled_predict_step(
        WESUPConfig(**cfg), content, target, canvas, "superpixel",
        device="cpu")(model, torch.from_numpy(imgs)).numpy()
    assert got.dtype == np.uint8 and got.shape == (2,) + content
    assert (got == want).mean() >= 0.999


def test_predict_multiscale_batch_matches_jax(weights):
    params, model = weights
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 255, (50, 70, 3)).astype(np.uint8)
            for _ in range(3)] + [rng.integers(0, 255, (40, 60, 3)).astype(
                np.uint8)]
    cfg = dict(compute_dtype="float32", sp_area=100, slic_iters=4)
    want = j_pmb(JPredictor(params, JConfig(**cfg)), imgs, scales=(0.5,),
                 max_batch=2)
    got = predict_multiscale_batch(
        Predictor(model, WESUPConfig(**cfg), device="cpu"), imgs,
        scales=(0.5,), max_batch=2)
    for g, w in zip(got, want):
        assert g.shape == w.shape and set(np.unique(g)) <= {0.0, 1.0}
        assert (g == w).mean() >= 0.999


@pytest.mark.parametrize("env,dispatches", [(None, 1), ("2", 3), ("5", 1)])
def test_infer_max_batch_env_changes_only_the_chunking(weights, monkeypatch,
                                                       env, dispatches):
    """``WESUP_INFER_MAX_BATCH`` sets the chunk size when ``max_batch`` is
    not given (as ``wesup_tpu.inference.predict_multiscale_batch`` reads
    it): five same-shaped images go to the device in 1 batch by default,
    in 3 under 2, and the masks are those of the default run."""
    _, model = weights
    rng = np.random.default_rng(8)
    imgs = [rng.integers(0, 255, (40, 56, 3)).astype(np.uint8)
            for _ in range(5)]
    predictor = Predictor(model, WESUPConfig(compute_dtype="float32",
                                             sp_area=100, slic_iters=2),
                          device="cpu")
    monkeypatch.delenv("WESUP_INFER_MAX_BATCH", raising=False)
    want = predict_multiscale_batch(predictor, imgs, scales=(0.5,))
    if env is not None:
        monkeypatch.setenv("WESUP_INFER_MAX_BATCH", env)
    batches = []
    scaled_step = predictor._scaled_step

    def counting(*args):
        step = scaled_step(*args)

        def run(model, canvas):
            batches.append(canvas.shape[0])
            return step(model, canvas)
        return run

    monkeypatch.setattr(predictor, "_scaled_step", counting)
    got = predict_multiscale_batch(predictor, imgs, scales=(0.5,))
    assert len(batches) == dispatches and sum(batches) == len(imgs)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_multiscale_opening(weights):
    _, model = weights
    predictor = Predictor(model, WESUPConfig(compute_dtype="float32",
                                             sp_area=100, slic_iters=2),
                          device="cpu")
    img = np.random.default_rng(3).integers(0, 255, (44, 60, 3)).astype(
        np.uint8)
    (mask,) = predict_multiscale_batch(predictor, [img], scales=(0.5, 0.4))
    assert mask.shape == (44, 60) and set(np.unique(mask)) <= {0.0, 1.0}


# two shape groups, interleaved
SHAPES = [(40, 56), (33, 47), (40, 56), (40, 56), (33, 47), (40, 56),
          (40, 56)]


@pytest.fixture(scope="module")
def port_predictors(weights):
    """One CPU predictor per mode, shared so that each step shape is built
    once, on a head balanced over the test images."""
    model = host_fuse.balanced(weights[1], host_fuse.images(SHAPES, seed=20))
    cfg = WESUPConfig(compute_dtype="float32", sp_area=100, slic_iters=2)
    return {mode: Predictor(model, cfg, mode=mode, device="cpu")
            for mode in ("superpixel", "pixel")}


@pytest.mark.parametrize("max_batch", host_fuse.MAX_BATCHES)
@pytest.mark.parametrize("mode,scales,input_size", host_fuse.CASES)
def test_predict_multiscale_batch_equals_the_host_fuse(
        port_predictors, monkeypatch, mode, scales, input_size, max_batch):
    """Bitwise the host-fuse route, value and dtype (float64 superpixel
    masks, float32 pixel masks), whatever the chunk size: two shape groups
    of 5 and 2 images in chunks of 1, 3 and 32; the forwards inside return
    bitwise the same probabilities on both routes."""
    predictor = port_predictors[mode]
    imgs = host_fuse.images(SHAPES, seed=20)
    seen = host_fuse.record_forwards(monkeypatch)
    want = host_fuse.predict_multiscale_batch(predictor, imgs, scales,
                                           input_size, max_batch)
    want_probs = seen[:]
    seen.clear()
    got = predict_multiscale_batch(predictor, imgs, scales=scales,
                                   input_size=input_size, max_batch=max_batch)
    host_fuse.assert_same(got, want)
    host_fuse.assert_same_tensors(seen, want_probs)
    assert {g.dtype for g in got} == {
        np.dtype(np.float64 if mode == "superpixel" else np.float32)}


@pytest.mark.parametrize("mode,scales", [("superpixel", (0.5,)),
                                         ("pixel", (0.5, 0.4))])
def test_predict_multiscale_batch_results_are_not_reused(port_predictors,
                                                         mode, scales):
    """A second call, on other images of the same shape and of another,
    leaves the first call's results as they were; no two results share
    memory."""
    predictor = port_predictors[mode]
    first = predict_multiscale_batch(
        predictor, host_fuse.images(SHAPES[:4], seed=21), scales=scales,
        max_batch=2)
    kept = [a.copy() for a in first]
    second = predict_multiscale_batch(
        predictor, host_fuse.images([(40, 56), (36, 40), (40, 56)], seed=22),
        scales=scales, max_batch=2)
    host_fuse.assert_same(first, kept)
    arrays = first + second
    assert not any(np.shares_memory(a, b) for k, a in enumerate(arrays)
                   for b in arrays[k + 1:])


@pytest.mark.parametrize("shards", [1, 2])
def test_upload_rows_are_the_padded_batch(weights, shards):
    """Each data shard's uploaded rows are its rows of the batch of the
    images followed by blank rows: 3 images in 4 rows, one of them a
    mirrored view (a negative stride)."""
    from wesup_tpu_torch.parallel.mesh import Mesh

    imgs = host_fuse.images([(33, 47)] * 3, seed=23)
    imgs[1] = imgs[1][:, ::-1]
    batch = np.zeros((4, 33, 47, 3), np.uint8)
    batch[:3] = imgs
    for rank in range(shards):
        mesh = (Mesh(shards, 1, rank=rank, world_group=object())
                if shards > 1 else None)
        pred = Predictor(weights[1], WESUPConfig(), device="cpu", mesh=mesh)
        rows = (mesh.data_rows(4) if mesh is not None else slice(None))
        got = pred.upload_rows(imgs, 4)
        assert got.dtype == torch.uint8
        assert np.array_equal(got.numpy(), batch[rows])


@pytest.mark.parametrize("align_corners", [False, True])
def test_host_resizes_match_jax(align_corners):
    from wesup_tpu import inference as j_inf
    from wesup_tpu_torch import inference as t_inf

    x = np.random.default_rng(4).random((37, 41, 3)).astype(np.float32)
    for out_hw in ((23, 29), (60, 80)):
        assert np.array_equal(
            t_inf.host_resize_bilinear(x, out_hw, align_corners),
            j_inf.host_resize_bilinear(x, out_hw, align_corners))
        assert np.array_equal(t_inf.host_resize_nearest(x[..., 0], out_hw),
                              j_inf.host_resize_nearest(x[..., 0], out_hw))


# ---------------------------------------------------------------------------
# server (the pattern of tests/test_serve.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server():
    srv = serve.create_server(port=0, host="127.0.0.1", device="cpu",
                              scales=(0.5,), slic_iters=2, sp_area=100,
                              compute_dtype="float32", fc_width=32)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)


def _request(url, data=None):
    req = urllib.request.Request(url, data=data,
                                 method="POST" if data else "GET")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def test_server_healthz_and_predict(server):
    import cv2

    status, body, _ = _request(server + "/healthz")
    assert status == 200 and b'"status": "ok"' in body
    img = np.random.default_rng(0).integers(0, 255, (40, 56, 3)).astype(
        np.uint8)
    ok, png = cv2.imencode(".png", img)
    status, body, headers = _request(server + "/predict", png.tobytes())
    assert status == 200 and headers["Content-Type"] == "image/png"
    mask = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_GRAYSCALE)
    assert mask.shape == (40, 56) and set(np.unique(mask)) <= {0, 255}


def test_server_errors(server):
    assert _request(server + "/predict", b"not an image")[0] == 400
    assert _request(server + "/nope")[0] == 404


_NO_CV2_SERVER = """
import sys, threading, urllib.error, urllib.request
sys.modules["cv2"] = None            # any import of OpenCV now fails
import numpy as np
from wesup_tpu_torch import serve
from wesup_tpu_torch.data import codec

def post(url, data):
    try:
        with urllib.request.urlopen(urllib.request.Request(
                url, data=data, method="POST"), timeout=120) as resp:
            return resp.status, resp.read(), resp.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers["Content-Type"]

img = np.random.default_rng(0).integers(0, 255, (40, 56, 3)).astype(np.uint8)
for mode in ("superpixel", "pixel"):
    srv = serve.create_server(port=0, host="127.0.0.1", device="cpu",
                              mode=mode, scales=(0.5,), slic_iters=2,
                              sp_area=100, compute_dtype="float32",
                              fc_width=32)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_port}/predict"
    try:
        for body in (codec.encode_png(img), codec.encode_bmp(img),
                     codec.encode_bmp(img[..., 0]), codec.encode_jpeg(img),
                     codec.encode_jpeg(img[..., 0])):
            status, reply, kind = post(url, body)
            assert status == 200 and kind == "image/png", (status, reply)
            mask = codec.decode(reply, gray=True)
            assert mask.shape == (40, 56), mask.shape
            assert set(np.unique(mask)) <= {0, 255}
            print(mode, "ok")
        jpeg = codec.encode_jpeg(img)
        status, reply, _ = post(url, jpeg[:len(jpeg) // 2])
        assert (status == 400 and b"request body" in reply
                and b"truncated" in reply), (status, reply)
        status, reply, _ = post(url, codec.encode_png(img)[:40])
        assert status == 400 and b"request body" in reply, (status, reply)
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
assert "cv2" not in [m for m in sys.modules if sys.modules[m] is not None]
"""


def test_server_answers_without_opencv():
    """POST /predict in superpixel and pixel mode, with OpenCV blocked: the
    server decodes PNG, BMP and JPEG (the port's encoder's, colour and
    gray) and encodes the mask with ``data/codec.py``, and answers 400
    with the codec's message, naming the request body, for a cut JPEG or
    a truncated PNG."""
    out = subprocess.run([sys.executable, "-c", _NO_CV2_SERVER], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("superpixel ok") == 5
    assert out.stdout.count("pixel ok") == 10


# ---------------------------------------------------------------------------
# rules of the package
# ---------------------------------------------------------------------------

CLI_MODULES = ("infer", "infer_tile", "pixel_infer", "pixel_infer_tile",
               "test_glas", "serve", "train", "test_dp2019_pipeline")


def test_port_imports_no_jax():
    """Every module of the port (the CLIs among them) and chip_smoke.py
    import neither jax, ``wesup_tpu`` nor OpenCV, and no source file of the
    port imports cv2, even inside a function."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import wesup_tpu_torch\n"
        "for m in pkgutil.walk_packages(wesup_tpu_torch.__path__,"
        " 'wesup_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'wesup_tpu' or m.startswith('wesup_tpu.')"
        " or m == 'cv2' or m.startswith('cv2.')]\n"
        "assert not bad, bad\n"
        f"missing = [n for n in {CLI_MODULES!r}"
        " if 'wesup_tpu_torch.' + n not in sys.modules]\n"
        "assert not missing, missing\n"
        "print(len([m for m in sys.modules"
        " if m.startswith('wesup_tpu_torch.')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20
    import re

    cv2_import = re.compile(r"^\s*(import\s+cv2|from\s+cv2\b)", re.M)
    sources = list((REPO / "wesup_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    assert not [str(f) for f in sources if cv2_import.search(f.read_text())]


def test_entry_points_raise_without_cuda(monkeypatch, weights):
    _, model = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = WESUPConfig()
    for device in (None, "cuda"):
        for mode in ("superpixel", "pixel"):
            with pytest.raises(RuntimeError, match="CUDA"):
                steps.make_predict_step(cfg, (64, 160), mode, device)
            with pytest.raises(RuntimeError, match="CUDA"):
                steps.make_scaled_predict_step(cfg, (50, 70), (25, 35),
                                               (64, 96), mode, device)
            with pytest.raises(RuntimeError, match="CUDA"):
                Predictor(model, cfg, mode=mode, device=device)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.create_server(port=0, host="127.0.0.1", fc_width=8)


def test_pixel_mode_is_a_later_slice(weights):
    """The pixel mode, once refused, is taken by every entry point (its
    parity with JAX is tests/test_torch_port_infer.py's); an unknown mode
    raises ``ValueError``."""
    _, model = weights
    step = steps.make_predict_step(WESUPConfig(compute_dtype="float32"),
                                   (32, 48), "pixel", "cpu")
    prob = step(model, np.zeros((1, 32, 48, 3), np.uint8),
                np.ones((1, 32, 48), bool))
    assert prob.shape == (1, 32, 48) and torch.isfinite(prob).all()
    assert Predictor(model, WESUPConfig(), mode="pixel",
                     device="cpu").mode == "pixel"
    for make in (lambda: steps.make_predict_step(WESUPConfig(), (64, 160),
                                                 "patch", "cpu"),
                 lambda: Predictor(model, WESUPConfig(), mode="patch",
                                   device="cpu")):
        with pytest.raises(ValueError, match="unknown predict mode"):
            make()


def test_step_rejects_model_on_other_device(weights):
    _, model = weights
    step = steps.make_predict_step(WESUPConfig(), (64, 160), "superpixel",
                                   device="meta")
    with pytest.raises(ValueError, match="model is on"):
        step(model, np.zeros((1, 64, 160, 3), np.uint8),
             np.ones((1, 64, 160), bool))
