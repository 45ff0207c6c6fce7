"""Multi-scale superpixel inference over a folder of images, pass after
pass.

The window drives ``inference.predict_multiscale_batch(
Predictor(mode="superpixel"), images, scales, max_batch)``, the path of
``infer``: per chunk of ``max_batch`` same-sized images, the device
resize, SLIC, the superpixel forward (pooling kernels K1 and K2 under
``pooling="local"``), the painted map rounded and resized back; one chunk
in flight.  The images are made from the seed at set-up and held in
memory.  A unit is one pass over the folder, every mask back on the
host.

The check holds the newest pass against the plain reference
(``reference/predict.py``) twice: the superpixel foreground
probabilities that the superpixel forward returned inside the pass (an
observer of the benchmark's own keeps them: ``wesup.forward_superpixel``
wrapped), by their widest gap; and the masks the pass returned, by the
pixels that differ although the reference's probability lies further
from 0.5 than that gap's limit and one bfloat16 step (2^-8, the painted
map is in the compute dtype): the paint, the rounding and the resize
back, limit 0.
"""

from __future__ import annotations

import math

from ..gen import glands
from .common import DriverBase, check


class Driver(DriverBase):
    def setup(self):
        from wesup_tpu_torch import inference

        p = self.config["protocol"]
        t = self.traffic
        imgs, _ = glands.make_images(int(p["n_test"]), *p["image_hw"],
                                     self.generator(1), self.device)
        self.images = list(imgs.cpu().numpy())
        self.phase("data")
        self.scales = tuple(t["scales"])
        self.max_batch = int(t["max_batch"])
        self.predictor = inference.Predictor(
            self.program_model(), self.wesup_config(), mode="superpixel",
            device=self.device)
        self._predict = inference.predict_multiscale_batch
        from wesup_tpu_torch.models import wesup

        self._wesup = wesup
        self._forward = wesup.forward_superpixel
        wesup.forward_superpixel = self._observe
        self._preds = []
        self.masks = self.sp_probs = None
        self.phase("model")
        self.unit()                      # warm up: the chunk shapes used
        self.phase("warm-up")
        self.attempted = 0
        self.reset_work()

    def _observe(self, *args, **kwargs):
        out = self._forward(*args, **kwargs)
        self._preds.append(out.sp_pred[..., 1])
        return out

    def unit(self) -> int:
        n = len(self.images)
        self.attempted += n
        self._preds = []
        try:
            self.masks = self._predict(self.predictor, self.images,
                                       scales=self.scales,
                                       max_batch=self.max_batch)
        except RuntimeError:
            self.failed += n
            self.masks = None
            return 0
        self.sp_probs = self._preds
        H0, W0 = self.images[0].shape[:2]
        for s in self.scales:
            th, tw = math.ceil(H0 * s), math.ceil(W0 * s)
            self.log_work(kind="predict", rows=n, H=-(-th // 32) * 32,
                          W=-(-tw // 32) * 32, content=[(th, tw)] * n)
        return n

    def release(self):
        self.predictor = None

    def close(self):
        if getattr(self, "_wesup", None) is not None:
            self._wesup.forward_superpixel = self._forward

    def readings(self, quant=None) -> dict:
        """The widest superpixel probability gap and the decisive mask
        flips of the newest pass against the reference; with ``quant``,
        of the reference computed with it in the program's place (the
        control)."""
        from ..reference import predict

        if self.masks is None or len(self.scales) != 1:
            return {"prob_gap": float("inf"), "mask_flips": float("inf")}
        state = self.weights()
        args = (self.images, self.scales, self.max_batch,
                self.config["model"])
        ref = predict.run(state, *args)
        if quant is None:
            sp = [p.cpu().numpy() for chunk in self.sp_probs for p in chunk]
            masks = self.masks
        else:
            low = predict.run(state, *args, quant=quant)
            sp = [r[2] for r in low]
            masks = [r[0] for r in low]
        return {"prob_gap": predict.prob_gap(sp, ref),
                "mask_flips": predict.decisive_flips(
                    masks, ref, self.limits["prob_gap"] + 2.0 ** -8)}

    def check(self) -> dict:
        got = self.readings()
        checks = {k: check(got[k], v) for k, v in self.limits.items()}
        checks["failed"] = check(self.failed, 0)
        return checks
