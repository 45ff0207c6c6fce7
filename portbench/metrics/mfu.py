"""``mfu.<train|predict|tile>``: the whole step's share of the bf16 peak
over the measured window (%): the FLOPs of all the work the window
completed, counted from shapes, over the window's seconds times the peak.

The form counted is the least work the port computes today, whatever
implements it:

- VGG16's 13 convolutions (``conv_roofline.conv_flops``) on each image's
  content;
- each resolution stage's taps projected to ``fc_width`` (the side convs
  folded into fc1): per superpixel after pooling (superpixel paths), per
  pixel of the stage's own resolution (the pixel path), plus building the
  folded projections once per step;
- fc2, fc3 and the classifier per superpixel (``content / sp_area`` of
  them) or per pixel;
- SLIC, augmentation, resizes, pooling and painting as 0 FLOPs;
- a train step three times its forward.
"""

from __future__ import annotations

from ..gen.weights import CONV_CHANNELS, VGG16_CFG
from .conv_roofline import conv_flops
from .peaks import BF16_FLOPS


def _stage_channels() -> list:
    out, stage = [0] * 5, 0
    for c in VGG16_CFG:
        if c == "M":
            stage += 1
        elif stage < 5:
            out[stage] += c
    return out


def _head(n: float, r: dict) -> float:
    width, D = r["fc_width"], r["D"]
    return 2.0 * n * (width * width + width * D + D * r["n_classes"])


def record_flops(r: dict) -> float:
    """FLOPs of one record of work: its kind, content sizes and the
    head's widths (``fc_width``, ``D``, ``n_classes``)."""
    width = r["fc_width"]
    chans = _stage_channels()
    total = sum(c * c // 2 for c in CONV_CHANNELS) * 2.0 * width
    for h, w in r["content"]:
        total += conv_flops(h, w)
        if r["kind"] == "pixel":
            total += sum(2.0 * (h / 2 ** s) * (w / 2 ** s) * c * width
                         for s, c in enumerate(chans))
            total += _head(h * w, r)
        else:
            k = h * w / r["sp_area"]
            total += 2.0 * k * sum(chans) * width + _head(k, r)
    return total * (3 if r["kind"] == "train" else 1)


def read(name, ctx):
    seconds = ctx["window"]["seconds"]
    flops = sum(record_flops(r) for r in ctx["window_work"])
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (seconds * BF16_FLOPS)
