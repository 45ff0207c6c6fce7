"""A frozen copy of the host route that ``predict_multiscale_batch`` took
before each chunk's results were finished on the fly: a zeroed uint8
canvas rounded up to multiples of 32, each scale's map copied back on its
own, summed per image on the host, then divided by the number of scales,
rounded and (several superpixel scales) opened in float64.

The tests hold ``inference.predict_multiscale_batch`` to it bitwise, in
value and dtype.  The module imports neither jax nor ``wesup_tpu``, so the
card's tests use it too."""

import copy
import math

import numpy as np
import torch

from wesup_tpu_torch.inference import host_resize_bilinear
from wesup_tpu_torch.models import wesup
from wesup_tpu_torch.ops.morphology import opening, reference_cross_selem


def _round_up(x, m=32):
    return ((x + m - 1) // m) * m


def predict_multiscale_batch(predictor, imgs_u8, scales=(0.5,),
                             input_size=None, max_batch=8):
    """The masks of ``imgs_u8`` as the host-fuse route makes them, through the
    predictor's own scaled steps (one card, no mesh)."""
    sp_mode = predictor.mode == "superpixel"
    results = [None] * len(imgs_u8)
    groups = {}
    for idx, img in enumerate(imgs_u8):
        groups.setdefault(img.shape[:2], []).append(idx)
    for (H0, W0), idxs in groups.items():
        if input_size is not None:
            sizes = [tuple(input_size)]
        elif sp_mode:
            sizes = [(math.ceil(H0 * s), math.ceil(W0 * s)) for s in scales]
        else:
            sizes = [(int(H0 * s), int(W0 * s)) for s in scales]
        Hc, Wc = _round_up(H0), _round_up(W0)
        acc = [None] * len(idxs)
        for start in range(0, len(idxs), max_batch):
            chunk = idxs[start:start + max_batch]
            canvas = np.zeros((len(chunk), Hc, Wc, 3), np.uint8)
            for j, i in enumerate(chunk):
                canvas[j, :H0, :W0] = imgs_u8[i]
            rows = predictor._to_device(canvas)
            for sz in sizes:
                out = predictor._scaled_step((H0, W0), sz, (Hc, Wc))(
                    predictor.model, rows).cpu().numpy()
                for j in range(len(chunk)):
                    pos = start + j
                    acc[pos] = (out[j] if acc[pos] is None
                                else acc[pos] + out[j])
        for pos, i in enumerate(idxs):
            fused = acc[pos] / len(sizes)
            if not sp_mode:
                fused = np.round(fused)
            elif input_size is None:
                fused = np.round(fused)
                if len(scales) > 1:
                    fused = opening(fused, reference_cross_selem(9))
            results[i] = fused
    return results


# (mode, scales, input_size): one superpixel scale; five with the opening;
# a fixed input size; pixel mode at one and two scales
CASES = [("superpixel", (0.5,), None),
         ("superpixel", (0.5, 0.45, 0.4, 0.35, 0.3), None),
         ("superpixel", (0.5,), (24, 40)),
         ("pixel", (0.5,), None),
         ("pixel", (0.5, 0.4), None)]
MAX_BATCHES = [1, 3, 32]


def images(shapes, seed):
    """uint8 images of the given (H, W) shapes, in that order: blobs of two
    stains on a noisy background, at a phase drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for H, W in shapes:
        y, x = np.mgrid[:H, :W]
        phase = rng.uniform(0, 2 * np.pi, 2)
        blob = np.sin(x / 4 + phase[0]) + np.cos(y / 5 + phase[1]) > 0
        img = np.where(blob[..., None], [200, 110, 170], [70, 40, 120])
        out.append(np.clip(img + rng.normal(0, 20, (H, W, 3)), 0,
                           255).astype(np.uint8))
    return out


def assert_same(got, want):
    """Bitwise equal arrays of the same dtype and shape, pairwise."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8))


def balanced(model, imgs, hw=(32, 32)):
    """A copy of ``model``, on the CPU, whose classifier bias puts the
    median pixel of ``imgs`` resized to ``hw`` at probability 0.5, so that
    the masks hold both classes and their edges (a random head predicts
    one class nearly everywhere)."""
    model = copy.deepcopy(model).cpu().eval()
    with torch.inference_mode():
        batch = torch.from_numpy(np.stack([
            host_resize_bilinear(img, hw) for img in imgs]))
        probs = wesup.forward_pixel(model, batch / 255.0).reshape(-1, 2)
        gap = (probs[:, 1].log() - probs[:, 0].log()).median()
    with torch.no_grad():
        model.classifier[0].bias[1] -= gap
    return model


def record_forwards(monkeypatch):
    """The list that the superpixel and pixel forwards' probabilities are
    appended to, call by call, while ``monkeypatch`` holds (the steps look
    the forwards up at call time)."""
    seen = []
    for name in ("forward_superpixel", "forward_pixel"):
        def recorded(*args, forward=getattr(wesup, name), **kwargs):
            out = forward(*args, **kwargs)
            seen.append(getattr(out, "sp_pred", out))
            return out

        monkeypatch.setattr(wesup, name, recorded)
    return seen


def assert_same_tensors(got, want):
    """Bitwise equal tensors of the same dtype and shape, pairwise (at
    least one)."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.contiguous().view(torch.uint8),
                           w.contiguous().view(torch.uint8))
