"""Tiled pixel-wise inference of whole slides, one after another.

The window drives ``inference.predict_tiled(Predictor(mode="pixel"),
slide, patch_size, chunk, round_patches=False)``, the path of
``pixel_infer_tile``: the slide cut into overlapping patches, the
patches through the pixel head in chunks with one chunk in flight, and
the overlap-averaged stitch.  Slides are made from the seed at set-up
and held in memory; the window cycles over them (closed loop).  A unit
is one slide whose stitched map is back on the host.

The check keeps the newest stitched map of each of a sample of the
slides, drawn from the seed, and holds it against the plain reference
(``reference/tile.py``) run on the same slide: the widest gap between
the two probability maps.
"""

from __future__ import annotations

import math

import numpy as np

from ..gen import glands
from .common import DriverBase, check


class Driver(DriverBase):
    def setup(self):
        from wesup_tpu_torch import inference

        p = self.config["protocol"]
        t = self.traffic
        self.hw = tuple(p["slide_hw"])
        self.patch = int(p["patch_size"])
        self.chunk = int(t["chunk"])
        imgs, _ = glands.make_images(int(t["pool"]), *self.hw,
                                     self.generator(1), self.device)
        self.slides = list(imgs.cpu().numpy())
        self.phase("data")
        self.predictor = inference.Predictor(
            self.program_model(), self.wesup_config(), mode="pixel",
            device=self.device)
        self._predict = inference.predict_tiled
        self.phase("model")
        # keep the newest map of these slides (drawn from the seed)
        self.keep = set(self.sample(len(self.slides),
                                    int(t["check_slides"]), 2))
        self.kept = {}
        self.calls = 0
        for slide in self.slides[:2]:        # warm up: the one chunk shape
            self._predict(self.predictor, slide, self.patch, chunk=self.chunk,
                          round_patches=False)
        self.phase("warm-up")
        n_h = math.ceil(self.hw[0] / self.patch)
        n_w = math.ceil(self.hw[1] / self.patch)
        self.patches = n_h * n_w

    def unit(self) -> int:
        i = self.calls
        self.calls += 1
        self.attempted += 1
        j = i % len(self.slides)
        slide = self.slides[j]
        try:
            out = self._predict(self.predictor, slide, self.patch,
                                chunk=self.chunk, round_patches=False)
        except RuntimeError:
            self.failed += 1
            return 0
        if j in self.keep:
            self.kept[j] = out
        canvas = -(-self.patch // 32) * 32
        self.log_work(kind="pixel", rows=self.patches, H=canvas, W=canvas,
                      content=[(self.patch, self.patch)] * self.patches)
        return 1

    def release(self):
        self.predictor = None

    def readings(self, quant=None) -> dict:
        """The widest gap between the kept maps and the reference's; with
        ``quant``, of the reference computed with it in the program's
        place (the control)."""
        from ..reference import tile

        state = self.weights()
        gap = 0.0 if self.kept else float("inf")
        with tile.plain_precision():
            for j, out in sorted(self.kept.items()):
                ref = tile.stitched(state, self.slides[j], self.patch)
                if quant is not None:
                    out = tile.stitched(state, self.slides[j], self.patch,
                                        quant=quant)
                gap = max(gap, float(np.abs(out - ref).max()))
        return {"prob_gap": gap}

    def check(self) -> dict:
        got = self.readings()
        checks = {k: check(got[k], v) for k, v in self.limits.items()}
        checks["failed"] = check(self.failed, 0)
        return checks
